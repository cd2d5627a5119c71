"""Tables of the port's dry-run sweep (`launch/dryrun.py`), for PERF.md.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
       [--before DIR]
Prints markdown to stdout.  With `--before`, a second sweep's directory
(an earlier tree's), it prints one table of each cell's peak, roofline
terms and collective wire bytes by mesh axis, before → after.  Every number
is a dry-run estimate priced with H100 data-sheet figures
(`launch/roofline.py`), not a measurement on a card.
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


def wire_by_axis(record: dict, by_kind: bool = False) -> Dict[str, float]:
    """A cell's collective wire bytes a rank (the roofline's ring model),
    summed by the mesh axes of each collective's group ("data", "model",
    "pod+data", ...), or with `by_kind` by kind and axes ("all-gather over
    model", ...)."""
    from repro_torch.launch import roofline

    out: Dict[str, float] = {}
    for c in record.get("collective_calls", []):
        key = "+".join(c["axes"])
        if by_kind:
            key = f"{c['kind']} over {key}"
        out[key] = out.get(key, 0.0) + roofline._wire_bytes(c["kind"], c["bytes"],
                                                            len(c["ranks"]))
    return out


def compare_table(before, after, mesh: str = "single") -> str:
    """Cells run ok in both sweeps: peak GB, T_comp / T_mem / T_coll s and
    wire GB over "data" / "model", each before → after."""
    rows = ["| arch | shape | peak GB | T_comp s | T_mem s | T_coll s | "
            "wire GB data / model |",
            "|---|---|---|---|---|---|---|"]
    for key, r in sorted(after.items()):
        b = before.get(key)
        if key[2] != mesh or r["status"] != "ok" or b is None or b["status"] != "ok":
            continue
        wb, wa = wire_by_axis(b), wire_by_axis(r)
        terms = " | ".join(f"{b[t]:.3f} → {r[t]:.3f}" for t in ("t_comp", "t_mem", "t_coll"))
        rows.append(
            f"| {key[0]} | {key[1]} | {fmt_bytes(b['peak_bytes_per_device'])} → "
            f"{fmt_bytes(r['peak_bytes_per_device'])} | {terms} | "
            f"{fmt_bytes(wb.get('data', 0.0))} / {fmt_bytes(wb.get('model', 0.0))} → "
            f"{fmt_bytes(wa.get('data', 0.0))} / {fmt_bytes(wa.get('model', 0.0))} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--before", default=None,
                    help="an earlier sweep's directory: print before → after")
    args = ap.parse_args(argv)
    by_key = load(args.dir)
    if args.before:
        print("### Before → after (single-pod 16×16; dry run, priced with H100 data-sheet "
              "figures)\n")
        print(compare_table(load(args.before), by_key))
        return 0
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
