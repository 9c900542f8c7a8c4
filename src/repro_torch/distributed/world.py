"""Start a world of processes for the SPMD steps and collect what each
rank returns.

``spawn(fn, world)`` starts ``world`` processes with the ``spawn`` start
method, each of which joins one ``torch.distributed`` process group
through a ``file://`` rendezvous (no TCP port, so several worlds on one
host never collide), calls ``fn(rank, world, *args)``, destroys its
group and sends back what ``fn`` returned, or its traceback. With the
NCCL backend rank r runs on card r, set before its first launch. A hung
collective fails after ``timeout`` seconds (the process group's own
timeout), and the parent gives up on the world after ``join_timeout``.
The parent's process keeps its state: it joins no group and changes no
torch setting."""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import traceback


def _run(rank, world, backend, init_file, timeout, threads, fn, args, out):
    try:
        import torch
        import torch.distributed as dist
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:           # the parent reports it: nothing is lost
        out.put((rank, False, traceback.format_exc()))


class WorldError(RuntimeError):
    """A rank of a spawned world failed, or the world timed out."""


def spawn(fn, world: int, *args, backend: str = "gloo",
          timeout: float = 60.0, join_timeout: float = 600.0,
          threads: int = 0, rendezvous_dir=None):
    """[fn(0, world, *args), ..., fn(world - 1, ...)], each from its own
    process in one process group of ``backend``. ``fn`` and ``args`` are
    pickled (``fn`` by its import path); ``threads`` > 0 sets each rank's
    torch intra-op threads. Raises ``WorldError`` with every failing
    rank's traceback, or when the world does not finish in
    ``join_timeout`` seconds; every process is ended before it returns.
    The rendezvous file lives in a new directory under ``rendezvous_dir``
    (default: the system's temporary directory)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_run, args=(
            r, world, backend, init_file, timeout, threads, fn, args, out),
            daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        try:
            # drain the queue before joining: a rank blocks on a full pipe
            deadline = datetime.datetime.now() + datetime.timedelta(
                seconds=join_timeout)
            while len(results) + len(errors) < world:
                left = (deadline - datetime.datetime.now()).total_seconds()
                try:
                    rank, ok, res = out.get(timeout=min(max(left, 0.1), 5.0))
                except queue.Empty:
                    if left <= 0 or not any(p.is_alive() for p in procs):
                        missing = sorted(set(range(world)) - set(results)
                                         - set(errors))
                        raise WorldError(
                            f"ranks {missing} of a world of {world} did not "
                            f"report within {join_timeout} s"
                            + "".join(f"\n--- rank {r} ---\n{e}"
                                      for r, e in sorted(errors.items())))\
                            from None
                    continue
                (results if ok else errors)[rank] = res
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors:
        raise WorldError("".join(f"\n--- rank {r} ---\n{e}"
                                 for r, e in sorted(errors.items())))
    return [results[r] for r in range(world)]
