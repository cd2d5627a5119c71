"""Paper Table II benchmark: hardware-cost model, EASI vs RP→EASI.

The port of `benchmarks/table2_cost.py`; the rows are the reference's.  The
paper reports FPGA resources (DSPs/ALMs/registers); the equivalent budget
currencies here are MACs, parameter bytes and — the paper's headline —
their scaling in m/p.  It reproduces the claimed "factor of two" for the
paper's (32, 16, 8) row, sweeps m/p to show the general law, and adds the
int8-vs-f32 storage ratio of the ternary alphabet.  Costs come off the
stage graph (`DRModel.mac_counts()`): pure arithmetic, no device work.

Paper Table II reference (m=32, n=8): EASI only — 4052 DSPs / 38122 ALMs /
138368 reg-bits;  RP(16)+EASI — 2212 / 70031 / 75392  (≈2× DSPs+registers).

    python -m repro_torch.experiments.table2_cost
"""

from __future__ import annotations

import time

from repro_torch.core.random_projection import RPConfig
from repro_torch.dr import DRModel, EASIStage, RPStage


def cost_row(model: DRModel) -> dict:
    mac = model.mac_counts()
    out = {
        "rp_adds_per_sample": mac["rp_adds"],
        "easi_macs_per_sample": mac["easi_macs"],
        "total_mac_equiv": mac["rp_adds"] + mac["easi_macs"],
    }
    exe = model.execution
    rp_bytes_int8 = rp_bytes_f32 = 0
    weight_bytes = 0
    for stage in model.stages:
        if isinstance(stage, RPStage):
            cfg = stage.rp_cfg(exe)
            rp_bytes_int8 += cfg.bytes_int8()
            rp_bytes_f32 += cfg.bytes_f32()
        elif isinstance(stage, EASIStage):
            # weight bytes of the adaptive stage (FPGA register pressure analog)
            weight_bytes += 4 * stage.n * stage.m
    if rp_bytes_int8:
        out["rp_bytes_int8"] = rp_bytes_int8
        out["rp_bytes_f32"] = rp_bytes_f32
    out["easi_weight_bytes_f32"] = weight_bytes
    return out


def _easi(m, n):
    return DRModel(stages=(EASIStage.full(m, n),))


def _chain(m, p, n):
    return DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n)))


def run(fast: bool = True):
    rows = []
    t0 = time.perf_counter()

    # the paper's Table II pair
    ce, cc = cost_row(_easi(32, 8)), cost_row(_chain(32, 16, 8))
    ratio_mac = ce["easi_macs_per_sample"] / cc["easi_macs_per_sample"]
    ratio_w = ce["easi_weight_bytes_f32"] / cc["easi_weight_bytes_f32"]
    rows.append(("table2/mac_ratio_paper_row", 0.0,
                 f"easi={ce['easi_macs_per_sample']:.0f};chain={cc['easi_macs_per_sample']:.0f};"
                 f"ratio={ratio_mac:.2f};paper_dsp_ratio={4052/2212:.2f}"))
    rows.append(("table2/weight_bytes_ratio", 0.0,
                 f"ratio={ratio_w:.2f};paper_reg_ratio={138368/75392:.2f}"))

    # scaling law: savings ∝ m/p (paper §V-C)
    full = ce["easi_macs_per_sample"]
    for p in (24, 16, 8):
        r = full / cost_row(_chain(32, p, 8))["easi_macs_per_sample"]
        rows.append((f"table2/scaling_p{p}", 0.0, f"m_over_p={32/p:.2f};mac_ratio={r:.2f}"))

    # beyond the enum: a 3-stage cascade's aggregate cost vs its 2-stage peers
    cascade = DRModel(stages=(RPStage(32, 24), EASIStage.whiten(24, 16),
                              EASIStage.rotation(16, 8)))
    c3 = cost_row(cascade)
    rows.append(("table2/cascade_3stage", 0.0,
                 f"macs={c3['easi_macs_per_sample']:.0f};adds={c3['rp_adds_per_sample']:.0f};"
                 f"stages={len(cascade.stages)}"))

    # ternary int8 storage vs dense f32 (the memory-traffic analog)
    for m, p in ((1024, 256), (4096, 512)):
        rp = RPConfig(m=m, p=p)
        rows.append((f"table2/int8_storage_m{m}", 0.0,
                     f"int8={rp.bytes_int8()};f32={rp.bytes_f32()};ratio={rp.bytes_f32()/rp.bytes_int8():.1f}"))

    dt = (time.perf_counter() - t0) * 1e6
    rows = [(n, dt / max(len(rows), 1), d) for n, _, d in rows]
    return rows


def main():
    for row in run():
        print(*row, sep="\t")


if __name__ == "__main__":
    main()
