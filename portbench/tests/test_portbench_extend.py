"""A configuration, a traffic mix and a per-layer metric are each added by a
new file and a manifest entry alone: in a copy of the benchmark, no file
that was there changes, and the new cell runs and reports the new metric.
So is a model family (`families/<family>.py` and `reference/<name>.py`),
with a block of its own in its configuration and no front end."""

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


# A windowed causal decoder: the `window` block is the family's own, read by
# its sizes, its port config and its reference; the model has no front end.
FAMILY = r"""
import dataclasses
from typing import Any

from portbench.families import transformer as dense
from portbench.families.transformer import (decode_flops, flash_bound_s,  # noqa: F401
                                            leaf_specs, prefill_flops, train_flops)


@dataclasses.dataclass(frozen=True)
class Arch(dense.Arch):
    window: Any = None          # {"size": the keys a query sees, its own included}


def sizes(fields, dr):
    return Arch(dr_frontend=dr, **fields)


def port_config(a):
    from repro_torch.models.config import ArchConfig

    f = {k.name: getattr(a, k.name) for k in dataclasses.fields(a)
         if k.name not in ("window", "dr_frontend", "family")}
    return ArchConfig(family="transformer", sliding_window=a.window["size"], **f)
"""

REFERENCE = r"""
import math

import torch

from .transformer import Precision, mm, rms_norm, rope, act, strict_f32  # noqa: F401


def stream_logits(params, a, feats, tokens, start, mode):
    w = a.window["size"]
    with torch.no_grad():
        x = params["embed"].to(torch.float32)[tokens.long()]
        b, s, _ = x.shape
        i = torch.arange(s, device=x.device)
        hide = (i[None, :] > i[:, None]) | (i[:, None] - i[None, :] >= w)
        for n in range(a.n_layers):
            lp = {k: t[n].to(torch.float32) for k, t in params["layers"].items()}
            h = rms_norm(x, lp["ln1"], a.norm_eps)
            q = rope(mm(h, lp["wq"], mode).reshape(b, s, a.n_heads, a.dh), a.rope_theta)
            k = rope(mm(h, lp["wk"], mode).reshape(b, s, a.n_kv_heads, a.dh), a.rope_theta)
            v = mm(h, lp["wv"], mode).reshape(b, s, a.n_kv_heads, a.dh)
            g = a.n_heads // a.n_kv_heads
            qh, kh, vh = (t.permute(0, 2, 1, 3) for t in
                          (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
            sc = (mm(qh, kh.transpose(-1, -2), mode) / math.sqrt(a.dh)).masked_fill(
                hide, float("-inf"))
            o = mm(torch.softmax(sc, -1), vh, mode).permute(0, 2, 1, 3).reshape(b, s, -1)
            x = x + mm(o, lp["wo"], mode)
            h = rms_norm(x, lp["ln2"], a.norm_eps)
            x = x + mm(act(a.act, mm(h, lp["w_gate"], mode)) * mm(h, lp["w_in"], mode),
                       lp["w_out"], mode)
        x = rms_norm(x, params["final_norm"].to(torch.float32), a.norm_eps)
        return mm(x[:, start:], params["lm_head"], mode)


def last_logits(params, a, feats, tokens, mode):
    return stream_logits(params, a, feats, tokens, tokens.shape[1] - 1, mode)[:, 0]
"""

TEXT_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                 frontend=None, frontend_dim=0, frontend_seq=0, q_chunk=32, kv_chunk=32,
                 compute_dtype="float32", dr_frontend=None)

RUN_CELLS = r"""
import json, sys
sys.path.insert(0, {copy!r}); sys.path.insert(0, {src!r})
import torch
from pathlib import Path
from portbench import bench
out = {{}}
for cell, trace in {runs!r}:
    res, _ = bench.run_cell(Path({copy!r}), cell, 2 ** 40 + 5, 0.3, trace,
                            device=torch.device("cpu"), log=lambda s: None)
    out[cell + ":" + str(trace)] = res
print(json.dumps(out))
"""


def test_a_family_is_new_files_and_entries(tmp_path):
    """A windowed decoder family, text only, serves and decodes; a text-only
    dense configuration trains without a DR unit.  Both are new files."""
    copy = tmp_path / "checkout"
    shutil.copytree(smoke.ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(smoke.ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    pb = copy / "portbench"
    before = _digests(pb)

    base = json.loads((pb / "configs" / "internvl2-1b-dr.json").read_text())
    win = dict(base, name="tiny-windowed", reference="windowed",
               arch=dict(base["arch"], **TEXT_ARCH, name="tiny-windowed", family="windowed",
                         window={"size": 6}))
    text = dict(base, name="tiny-text",
                arch=dict(base["arch"], **TEXT_ARCH, name="tiny-text"))
    new = {
        "families/windowed.py": FAMILY,
        "reference/windowed.py": REFERENCE,
        "configs/tiny-windowed.json": json.dumps(win),
        "configs/tiny-text.json": json.dumps(text),
        "traffic/chat-tiny.json": json.dumps(
            {"driver": "serve", "sequences": 3, "prefix_rows": 0, "text_tokens": 12,
             "decode_steps": 4, "dr": "none", "promote_every": 0, "in_flight": 2, "pool": 4,
             "warmup": 2, "trace_requests": 2, "sample_every": 2, "reference_sample": 3}),
        "traffic/lm-train-tiny.json": json.dumps(
            {"driver": "train", "batch": 2, "seq": 16, "pool": 4, "checked_steps": 3,
             "log_every": 10, "trace_steps": 2}),
        "limits/tiny-windowed.chat-tiny.json": json.dumps(
            {"logits": 1e-4, "decode_logits": 1e-4}),
        "limits/tiny-text.lm-train-tiny.json": json.dumps(
            {"loss": 1e-4, "grad_norm": 1e-4, "update_norm": 1e-3}),
    }
    for rel, text_ in new.items():
        (pb / rel).write_text(text_)

    m = json.loads((copy / "BENCHMARK.json").read_text())
    chat, train = "tiny-windowed.chat-tiny", "tiny-text.lm-train-tiny"
    for name in ("tiny-windowed", "tiny-text"):
        m["configs"].append({"name": name, "source": base["source"],
                             "file": f"portbench/configs/{name}.json", "reduced": [],
                             "why": "a tiny text model"})
    m["workloads"] += [{"name": chat, "config": "tiny-windowed", "traffic": "chat-tiny",
                        "chips": 1, "why": "a tiny windowed chat cell"},
                       {"name": train, "config": "tiny-text", "traffic": "lm-train-tiny",
                        "chips": 1, "why": "a tiny text training cell"}]
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e and "internvl2-1b-dr.prefill" in e["workloads"]:
            e["workloads"].append(chat)
        if "workloads" in e and "hubert-xlarge-dr.train" in e["workloads"]:
            e["workloads"].append(train)
    (copy / "BENCHMARK.json").write_text(json.dumps(m))

    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == sorted(new)

    runs = [(chat, False), (chat, True), (train, False), (train, True)]
    out = subprocess.run([sys.executable, "-c", RUN_CELLS.format(
        copy=str(copy), src=str(smoke.ROOT / "src"), runs=runs)],
        capture_output=True, text=True, timeout=300, cwd=str(copy))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for key, r in res.items():
        assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, (key, r)
    assert set(res[f"{chat}:True"]["checks"]) == {"logits", "decode_logits"}
    assert set(res[f"{train}:True"]["checks"]) == {"loss", "grad_norm", "update_norm"}
    assert set(res[f"{chat}:False"]["metrics"]) == {"serve_tokens_per_s", "latency_p95_ms",
                                                     "setup_s"}
    # the DR unit's readers find nothing to read without one; the others do
    traced = res[f"{chat}:True"]["metrics"]
    assert not {"dr_host_ms.serve", "dr_device_ms.serve", "dr_roofline.serve"} & set(traced)
    assert traced["step_host_ms.serve"]["value"] > 0
    assert "forward_host_ms.train" in res[f"{train}:True"]["metrics"]
