"""Re-run the roofline over stored dry-run records, from their counts (no
new trace), the counterpart of ``repro.analysis.reanalyze`` (which re-reads
stored HLO): after a change to the peaks or the ``Roofline`` terms.

  PYTHONPATH=src python -m repro_torch.analysis.reanalyze [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.analysis import roofline as RL
from repro_torch.configs import get_config, get_shape
from repro_torch.launch.dryrun import OUT_DIR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="records directory (default experiments/"
                         "dryrun_torch)")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out) if args.out else OUT_DIR
    for p in sorted(out_dir.glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") != "OK" or "counted" not in rec:
            continue
        r = rec["roofline"]
        rl = RL.analyze(r["arch"], r["shape"], r["mesh"], r["chips"],
                        rec["counted"], rec["memory"]["peak_per_device"],
                        get_config(r["arch"]), get_shape(r["shape"]))
        rec["roofline"] = rl.to_dict()
        p.write_text(json.dumps(rec, indent=1))
        print(p.stem, rl.bottleneck, f"frac={rl.roofline_fraction:.3f}")


if __name__ == "__main__":
    main()
