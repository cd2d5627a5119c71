"""Tiny sizes of the benchmark's configurations and traffic mixes for the
CPU tests: every run goes through the harness with the device's look aside
(`bench.run_cell(..., device=cpu)`), the port's kernel backend running its
plain versions.  They compute in float32, so a sound run reads far under the
limits set at the cells' own sizes, and a planted fault far over them."""

from __future__ import annotations

import atexit
import functools
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

CPU = torch.device("cpu")
SEED = 2 ** 33 + 12345          # more than 32 bits, as the driver's seeds are

ARCH = {
    "hubert-xlarge-dr": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                             vocab_size=64, frontend_dim=32, q_chunk=32, kv_chunk=32,
                             compute_dtype="float32",
                             dr_frontend={"kind": "rp_easi", "p": 16, "n": 8, "mu": 2e-4,
                                          "bypass_whitening": True}),
    "internvl2-1b-dr": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
                            vocab_size=512, frontend_dim=48, frontend_seq=8, q_chunk=32,
                            kv_chunk=32, compute_dtype="float32",
                            dr_frontend={"kind": "rp_easi", "p": 24, "n": 16, "mu": 2e-4,
                                         "bypass_whitening": True}),
}

TRAFFIC = {
    "train": dict(seq=64),
    "prefill": dict(sequences=4, prefix_rows=8, text_tokens=8, pool=6, sample_every=2,
                    trace_requests=4),
    "encode": dict(sequences=2, prefix_rows=32, pool=6, sample_every=2, trace_requests=4),
    "answer": dict(sequences=3, prefix_rows=8, text_tokens=8, decode_steps=5, pool=6,
                   sample_every=2, warmup=2, trace_requests=2),
}

CELLS = {"hubert-xlarge-dr.train": ("hubert-xlarge-dr", "train"),
         "internvl2-1b-dr.prefill": ("internvl2-1b-dr", "prefill"),
         "hubert-xlarge-dr.encode": ("hubert-xlarge-dr", "encode"),
         "internvl2-1b-dr.answer": ("internvl2-1b-dr", "answer")}

# Cells whose files are here but which BENCHMARK.json does not run yet
# (PERF.md §7): the tests run them from a copy of the manifest that lists
# them beside the serving cells, reporting what those report.
HELD = {"internvl2-1b-dr.answer": {
    "config": "internvl2-1b-dr", "traffic": "answer", "chips": 1,
    "why": "one client, 2 in flight, 16 images x (256 patches + 256 text): train-while-serve DR, "
           "a prefill into a 544-slot cache, then 32 greedy decode steps"}}


@functools.lru_cache(maxsize=None)
def held_root() -> Path:
    """A root whose manifest also lists the held cells; its `portbench` is
    this one."""
    root = Path(tempfile.mkdtemp(prefix="portbench-held-"))
    atexit.register(shutil.rmtree, root, True)
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["workloads"] += [dict(name=name, **cell) for name, cell in HELD.items()]
    for e in m["end_to_end"] + m["per_layer"]:
        if "internvl2-1b-dr.prefill" in e.get("workloads", ()):
            e["workloads"] += list(HELD)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    (root / "portbench").symlink_to(ROOT / "portbench")
    return root


def root_of(cell: str) -> Path:
    return held_root() if cell in HELD else ROOT


def run(cell: str, *, seed: int = SEED, seconds: float = 0.5, trace: bool = False,
        fault=None, root: Path = None):
    from portbench import bench

    config, traffic = CELLS[cell]
    return bench.run_cell(root or root_of(cell), cell, seed, seconds, trace, device=CPU,
                          fault=fault, arch_overrides=ARCH[config],
                          traffic_overrides=TRAFFIC[traffic], log=lambda s: None)
