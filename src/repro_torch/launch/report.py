"""Tables of the port's dry-run sweep (`launch/dryrun.py`), for PERF.md.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
Prints markdown to stdout.  Every number is a dry-run estimate priced with
H100 data-sheet figures (`launch/roofline.py`), not a measurement on a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional, Tuple

HBM_PER_CHIP = 80e9  # an H100 SXM5 80GB's HBM3 (NVIDIA's data sheet)

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                           "dryrun_torch")


def load(dir_: str) -> Dict[Tuple[str, str, str], dict]:
    by_key = {}
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        by_key[(r["arch"], r["shape"], r["mesh"])] = r
    return by_key


def fmt_bytes(b: Optional[float]) -> str:
    if b is None:
        return "n/a"
    return f"{b / 1e9:.2f}"


def dryrun_table(by_key) -> str:
    rows = ["| arch | shape | mesh | status | build s | state GB/rank | peak GB/rank | "
            "peak / 80 GB |",
            "|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(by_key.items()):
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            rows.append(f"| {a} | {s} | {m} | {r['status']}: {reason} | | | | |")
            continue
        peak = r["peak_bytes_per_device"]
        rows.append(
            f"| {a} | {s} | {m} | ok | {r['build_s']:.1f} | "
            f"{fmt_bytes(r['state_bytes_per_device'])} | {fmt_bytes(peak)} | "
            f"{peak / HBM_PER_CHIP:.2f}{'' if peak <= HBM_PER_CHIP else ' (over)'} |")
    return "\n".join(rows)


def roofline_table(by_key, mesh: str = "single") -> str:
    rows = ["| arch | shape | T_comp s | T_mem s | T_coll s | bound s | dominant | MF/HLO | "
            "roofline% |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(by_key.items()):
        if m != mesh or r["status"] != "ok":
            continue
        rows.append(
            f"| {a} | {s} | {r['t_comp']:.4f} | {r['t_mem']:.4f} | {r['t_coll']:.4f} | "
            f"{r['step_time_bound']:.4f} | {r['dominant']} | {r['flops_ratio']:.3f} | "
            f"{100 * r['roofline_fraction']:.1f} |")
    return "\n".join(rows)


def collectives_summary(by_key, mesh: str = "single") -> str:
    rows = ["| arch | shape | all-reduce GB | all-gather GB | reduce-scatter GB | all-to-all GB "
            "| permute GB |",
            "|---|---|---|---|---|---|---|"]
    for (a, s, m), r in sorted(by_key.items()):
        if m != mesh or r["status"] != "ok":
            continue
        bk = r["collectives"]["bytes_by_kind"]

        def g(k):
            return f"{bk.get(k, 0) / 1e9:.3f}"

        rows.append(f"| {a} | {s} | {g('all-reduce')} | {g('all-gather')} | "
                    f"{g('reduce-scatter')} | {g('all-to-all')} | {g('collective-permute')} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    args = ap.parse_args(argv)
    by_key = load(args.dir)
    n_ok = sum(1 for r in by_key.values() if r["status"] == "ok")
    n_skip = sum(1 for r in by_key.values() if r["status"] == "skipped")
    n_err = sum(1 for r in by_key.values() if r["status"] == "error")
    print(f"### Dry-run matrix ({n_ok} ok / {n_skip} skipped / {n_err} error; dry run, priced "
          f"with H100 data-sheet figures)\n")
    print(dryrun_table(by_key))
    print("\n### Roofline (single-pod 16×16)\n")
    print(roofline_table(by_key, "single"))
    print("\n### Roofline (multi-pod 2×16×16)\n")
    print(roofline_table(by_key, "multi"))
    print("\n### Collective wire bytes per rank-step (single-pod)\n")
    print(collectives_summary(by_key, "single"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
