"""The benchmark's one command: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the run's result as one JSON object on the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (and, traced, ``breakdown``) and last
``checks``, the numbers the correctness check compared with their limits,
which are also the last lines of standard error.

Exits with 3, printing no result, where CUDA is missing or the cell asks
for more cards than there are; with 4 where a module of the JAX stack or
of the JAX package is loaded once the window has closed; with 5 where a
traced run read no operation on the card.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root and the port's sources, not bench/ itself: the
# harness's module names must not shadow a library's top-level modules
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    del sys.path[0]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# a library that would load JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
# build caches at fixed paths inside the checkout (the port's own CUDA
# libraries go to build/repro_torch/, which it fixes itself)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def breakdown(trace):
    """The traced stretch's ten longest device operations (seconds by
    name) and its ten longest idle gaps (seconds, by what the host was
    doing)."""
    ops = sorted(((name, t / 1e6) for name, (t, _) in
                  trace["by_name"].items()), key=lambda x: -x[1])[:10]
    gaps = [[label, us / 1e6] for us, label in trace["gaps"][:10]]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}


def main(argv=None) -> int:
    args = parse(argv)
    seed = args.seed % (1 << 63)
    import torch

    from bench import harness
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out = harness.run(args.workload, seed, args.seconds, bool(args.trace),
                      START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: loaded modules of the JAX stack or package: {bad}",
              file=sys.stderr)
        return 4
    run = out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        tr = run.devtrace
        if tr is None or tr["busy_us"] <= 0:
            print("bench: the traced run read no device operation "
                  f"({None if tr is None else {k: tr[k] for k in ('n_device_events', 'n_host_spans', 'n_steps')}})",
                  file=sys.stderr)
            return 5
        device["busy_s"] = tr["busy_us"] / 1e6
        device["window_s"] = tr["window_us"] / 1e6
        result["breakdown"] = breakdown(tr)
    result["checks"] = out["checks"]
    lat = sorted(run.lateness)
    print(json.dumps({
        "setup_s": run.setup_s, "window_s": run.window_s(),
        "window_rounds": len(run.rounds), "queue_ran_dry": run.queue_ran_dry,
        "generator_late_ms": {"median": 1e3 * lat[len(lat) // 2],
                              "max": 1e3 * lat[-1]} if lat else None,
        "median_gap": out["gaps"]["median_gap"],
        "sample": [[r["idx"], len(r["prompt"]), len(r["tokens"]),
                    r["adapter"]] for r in out["sample"]]}),
        file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
