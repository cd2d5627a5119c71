"""A configuration, a traffic mix and a per-layer metric are each added by a
new file and a manifest entry alone: in a copy of the benchmark, no file
that was there changes, and the new cell runs and reports the new metric."""

import pytest

pytest.importorskip("torch")

import hashlib
import json
import shutil
import subprocess
import sys

from portbench.tests import smoke

RUN = r"""
import json, sys
sys.path.insert(0, {copy!r}); sys.path.insert(0, {src!r})
import torch
from pathlib import Path
from portbench import bench
assert Path(bench.__file__).resolve().is_relative_to(Path({copy!r}).resolve())
out = {{}}
for trace in (False, True):
    res, _ = bench.run_cell(Path({copy!r}), "tiny-encoder.frames-tiny", 2 ** 40 + 3, 0.3, trace,
                            device=torch.device("cpu"), log=lambda s: None)
    out[str(trace)] = res
print(json.dumps(out))
"""


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_new_files_and_entries(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(smoke.ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(smoke.ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy / "portbench")
    pb = copy / "portbench"

    base = json.loads((pb / "configs" / "hubert-xlarge-dr.json").read_text())
    tiny = dict(base, name="tiny-encoder", arch=dict(base["arch"], name="tiny-encoder",
                                                     **smoke.ARCH["hubert-xlarge-dr"]))
    (pb / "configs" / "tiny-encoder.json").write_text(json.dumps(tiny))
    traffic = dict(json.loads((pb / "traffic" / "encode.json").read_text()),
                   **smoke.TRAFFIC["encode"])
    (pb / "traffic" / "frames-tiny.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny-encoder.frames-tiny.json").write_text(
        json.dumps({"rows": 1e-3, "logits": 0.2}))
    (pb / "metrics" / "requests_traced.serve.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx['units']) if 'units' in ctx else None\n")

    m = json.loads((copy / "BENCHMARK.json").read_text())
    cell = "tiny-encoder.frames-tiny"
    m["configs"].append({"name": "tiny-encoder", "source": base["source"],
                         "file": "portbench/configs/tiny-encoder.json", "reduced": [],
                         "why": "a tiny encoder"})
    m["workloads"].append({"name": cell, "config": "tiny-encoder", "traffic": "frames-tiny",
                           "chips": 1, "why": "a tiny encoder cell"})
    for e in m["end_to_end"]:
        if "workloads" in e and e["name"] != "train_tokens_per_s":
            e["workloads"].append(cell)
    m["per_layer"].append({"name": "requests_traced.serve", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "service",
                           "moves": "serve_tokens_per_s", "workloads": [cell]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))

    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == sorted([
        "configs/tiny-encoder.json", "traffic/frames-tiny.json",
        "limits/tiny-encoder.frames-tiny.json", "metrics/requests_traced.serve.py"])

    out = subprocess.run([sys.executable, "-c", RUN.format(copy=str(copy),
                                                           src=str(smoke.ROOT / "src"))],
                         capture_output=True, text=True, timeout=300, cwd=str(copy))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    plain, traced = res["False"], res["True"]
    assert plain["correct"] and set(plain["metrics"]) == {"serve_tokens_per_s", "latency_p95_ms",
                                                          "setup_s"}
    assert traced["correct"]
    assert traced["metrics"]["requests_traced.serve"]["value"] == traffic["trace_requests"]
