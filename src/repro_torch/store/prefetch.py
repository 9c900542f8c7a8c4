"""Async adapter staging, a copy of ``repro.store.prefetch``: a background
thread that overlaps the expensive part of a cache miss (disk read + CPU
pad/concat/block-diag into the fused server layout) with decode.

CaraServe's CPU-assisted pipeline (PAPERS.md): the scheduler fires a
prefetch hint at request ARRIVAL, the worker stages the adapter off the
critical path, and the serving loop drains finished stagings at round
boundaries (``Cluster.step_round``) — so by the time the request is
admitted the host->device upload is the only remaining cost.

Determinism: staging is pure data movement on immutable inputs, so the
staged tensors are bitwise identical to a synchronous conversion; the
ONLY thing the thread changes is when the work happens. Results are
handed over via a queue and consumed only at round boundaries on the
main thread. The worker makes no CUDA call: it reads disk and builds
CPU tensors, and the host -> card upload runs on the main thread at the
round boundary, never inside a graph capture.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
StageFn = Callable[[int], Tensors]


class Prefetcher:
    """Single background staging worker with a completion queue.

    ``request(aid)`` enqueues a staging job (deduped against in-flight
    ones); ``drain()`` returns every ``(aid, tensors)`` completed so far
    without blocking. A staging failure surfaces on the next drain as a
    raised exception rather than being swallowed — a miss that cannot
    stage would otherwise stall the request forever."""

    def __init__(self, stage_fn: StageFn):
        self._stage_fn = stage_fn
        self._in: "queue.Queue[Optional[int]]" = queue.Queue()
        self._out: "queue.Queue[Tuple[int, object]]" = queue.Queue()
        self._inflight: set = set()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.requests = 0
        self.completed = 0

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="adapter-prefetch", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            aid = self._in.get()
            if aid is None:
                return
            try:
                self._out.put((aid, self._stage_fn(aid)))
            except BaseException as exc:  # noqa: BLE001 - relayed at drain
                self._out.put((aid, exc))

    def request(self, adapter_id: int) -> bool:
        """Queue a staging job; False if one is already in flight."""
        with self._lock:
            if adapter_id in self._inflight:
                return False
            self._inflight.add(adapter_id)
        self.requests += 1
        self._ensure_thread()
        self._in.put(int(adapter_id))
        return True

    def drain(self) -> List[Tuple[int, Tensors]]:
        """All completed stagings so far (non-blocking). Re-raises the
        first staging exception encountered."""
        done: List[Tuple[int, Tensors]] = []
        while True:
            try:
                aid, result = self._out.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._inflight.discard(aid)
            if isinstance(result, BaseException):
                raise result
            self.completed += 1
            done.append((aid, result))
        return done

    def in_flight(self, adapter_id: int) -> bool:
        """Whether a job for ``adapter_id`` is queued, running, or done
        but not drained yet."""
        with self._lock:
            return adapter_id in self._inflight

    def wait(self, timeout: float = 30.0, adapter_id: Optional[int] = None
             ) -> List[Tuple[int, Tensors]]:
        """Drain, blocking until every in-flight job lands, or with
        ``adapter_id`` until that one does (a synchronous upload that
        needs an adapter the worker is staging)."""
        import time
        deadline = time.monotonic() + timeout
        done = self.drain()
        while True:
            with self._lock:
                idle = not self._inflight if adapter_id is None \
                    else adapter_id not in self._inflight
            if idle:
                return done
            if time.monotonic() >= deadline:
                raise TimeoutError("prefetch staging did not finish")
            try:
                aid, result = self._out.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._lock:
                self._inflight.discard(aid)
            if isinstance(result, BaseException):
                raise result
            self.completed += 1
            done.append((aid, result))

    def close(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._in.put(None)
            self._thread.join(timeout=5.0)
        self._thread = None
