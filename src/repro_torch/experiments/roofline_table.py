"""The dry-run JSONs as the roofline table's rows (one a cell), as
`benchmarks/roofline_table.py` makes them from the JAX package's sweep.

Reads `experiments/dryrun_torch/` (`python -m repro_torch.launch.dryrun`).
Each row is (name, step-time bound in µs, notes); every number is a dry-run
estimate priced with H100 data-sheet figures.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

from repro_torch.launch.report import DEFAULT_DIR

DRYRUN_DIR = DEFAULT_DIR


def load_reports(mesh: Optional[str] = None, dir_: Optional[str] = None) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dir_ or DRYRUN_DIR, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("status") != "ok":
            continue
        if mesh and r.get("mesh") != mesh:
            continue
        out.append(r)
    return out


def run(fast: bool = True, dir_: Optional[str] = None):
    rows = []
    for r in load_reports(mesh="single", dir_=dir_):
        rows.append((
            f"roofline/{r['arch']}/{r['shape']}",
            r["step_time_bound"] * 1e6,
            f"dominant={r['dominant']};roofline={100*r['roofline_fraction']:.1f}%;"
            f"Tc={r['t_comp']:.4f};Tm={r['t_mem']:.4f};Tx={r['t_coll']:.4f};"
            f"MF/HLO={r['flops_ratio']:.3f};peakGB={r['peak_bytes_per_device'] / 1e9:.2f}",
        ))
    if not rows:
        rows.append(("roofline/none", 0.0, "run repro_torch.launch.dryrun --all first"))
    return rows
