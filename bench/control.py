"""Readings that set the correctness limit (not part of a benchmark run).

For one cell and several seeds, in one process: a run of the cell as the
benchmark runs it (a short window at the cell's own load and sizes), with
the program's widest served-token gap and, on the same sample, the
control's: the reference in fp8 put in the program's place. One JSON line
a seed; the limit in the configuration's file lies between the two.

    python3 bench/control.py --workload <cell> --seconds 10 --seeds 1 2 3
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true",
                   help="the program's readings only")
    args = p.parse_args(argv)
    import torch

    from bench import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False,
                          time.perf_counter(),
                          control=not args.no_control)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": out["gaps"], "control": out["control"],
            "metrics": out["metrics"], "failed": out["failed"],
            "peak_bytes": out["memory_peak_bytes"],
            "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
