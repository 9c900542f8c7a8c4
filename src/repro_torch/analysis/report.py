"""The dry-run and roofline table from the records of
``launch/dryrun.py`` (experiments/dryrun_torch/*.json), the counterpart of
``repro.analysis.report``.

  PYTHONPATH=src python -m repro_torch.analysis.report
      [--mesh single|multi|debug] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.configs import ASSIGNED, SHAPES
from repro_torch.launch.dryrun import OUT_DIR, cell_id


def fmt_ms(s):
    return f"{s*1e3:8.2f}"


def table(mesh: str, out_dir=OUT_DIR) -> str:
    rows = []
    hdr = ("| arch | shape | t_comp ms | t_mem ms | t_coll ms | bottleneck |"
           " frac | peak GiB (analytic, as run) | fits 80 GB |")
    rows.append(hdr)
    rows.append("|" + "---|" * 9)
    for arch in sorted(ASSIGNED):
        for shape in SHAPES:
            p = pathlib.Path(out_dir) / f"{cell_id(arch, shape, mesh)}.json"
            if not p.exists():
                rows.append(f"| {arch} | {shape} | - | - | - | MISSING | | | |")
                continue
            rec = json.loads(p.read_text())
            if rec["status"] == "SKIP":
                rows.append(f"| {arch} | {shape} | — | — | — | SKIP | — | — "
                            f"| — |")
                continue
            if rec["status"] != "OK":
                rows.append(f"| {arch} | {shape} | - | - | - | FAIL | | | |")
                continue
            r, m = rec["roofline"], rec["memory"]
            rows.append(
                f"| {arch} | {shape} | {fmt_ms(r['t_compute'])} | "
                f"{fmt_ms(r['t_memory'])} | {fmt_ms(r['t_collective'])} | "
                f"{r['bottleneck']} | {r['roofline_fraction']:.3f} | "
                f"{m['peak_per_device'] / 2**30:.1f} | "
                f"{'Y' if m['fits_80g'] else 'N'} |")
    return "\n".join(rows)


def disagg_table(mesh: str, out_dir=OUT_DIR) -> str:
    """The disaggregated split's records (``dryrun --disagg``), one row a
    part."""
    rows = ["| arch | part | mesh | GFLOP a device | GB a device |",
            "|---|---|---|---|---|"]
    for p in sorted(pathlib.Path(out_dir).glob(f"*__{mesh}__disagg.json")):
        rec = json.loads(p.read_text())
        arch = p.stem.split("__")[0]
        if rec["status"] != "OK":
            rows.append(f"| {arch} | - | - | FAIL | |")
            continue
        for part, where in (("instance", rec["instance_mesh"]),
                            ("server_up", rec["server_mesh"]),
                            ("server_down", rec["server_mesh"])):
            r = rec[part]
            rows.append(f"| {arch} | {part} | {where} | "
                        f"{r['flops_per_device'] / 1e9:.1f} | "
                        f"{r['bytes_per_device'] / 1e9:.2f} |")
        rows.append(f"| {arch} | transfer a layer | - | - | "
                    f"{rec['transfer_bytes_per_layer'] / 1e9:.4f} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=None,
                    help="records directory (default experiments/"
                         "dryrun_torch)")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out) if args.out else OUT_DIR
    print(table(args.mesh, out_dir))
    split = disagg_table(args.mesh, out_dir)
    if split.count("\n") > 1:
        print()
        print(split)


if __name__ == "__main__":
    main()
