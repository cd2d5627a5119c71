"""Re-score the port's dry-run cells in place with the current roofline.

Usage: PYTHONPATH=src python -m repro_torch.launch.rescore [--dir experiments/dryrun_torch]

The JAX package's twin re-reads archived HLO; the port has none.  A cell's
JSON keeps what the dry run counted (per-rank FLOPs and bytes, each
collective with its group's ranks, the peak bytes, the model FLOPs), so
`roofline.analyze` prices it again with the current hardware model, with no
rebuild.  Re-scoring a re-scored file changes nothing.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import roofline
from repro_torch.launch.report import DEFAULT_DIR


def rescore_file(path: str) -> bool:
    """Re-price one cell's JSON in place; False for a cell that is not "ok"."""
    with open(path) as f:
        r = json.load(f)
    if r.get("status") != "ok":
        return False
    report = roofline.analyze(
        arch=r["arch"], shape=r["shape"], mesh_name=r["mesh"], chips=r["chips"],
        flops=r["hlo_flops"], nbytes=r["hlo_bytes"],
        collectives=roofline.collectives_from_json(r["collective_calls"]),
        model_flops=r["model_flops"], memory_per_device=r.get("memory_per_device"),
        notes=r.get("notes", ""))
    r.update(report.to_json())
    with open(path, "w") as f:
        json.dump(r, f, indent=1, default=str)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rescore")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    args = ap.parse_args(argv)
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if rescore_file(path):
            with open(path) as f:
                r = json.load(f)
            print(f"rescored {os.path.basename(path)}: dominant={r['dominant']} "
                  f"bound={r['step_time_bound']:.4f}s "
                  f"roofline={100 * r['roofline_fraction']:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
