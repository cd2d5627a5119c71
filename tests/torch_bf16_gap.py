"""The port's unmeshed Zamba-2 train step against the reference's, from the
reference's own initial state, in f32 and in bf16: the readings behind the
bf16 bounds that `tests/test_torch_mesh_recurrent.py` names (`BF16_NAMED`).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_bf16_gap.py

Prints one JSON object: per compute dtype, the state leaves farthest from
the reference (relative norm) after one step, after two, and after the
port's second step taken from the reference's own first-step state; and for
`conv_b`, which starts at zero so that AdamW's first step leaves ±lr by its
gradient's sign, the elements whose sign differs from the reference's after
one step and their reference gradient over the largest (AdamW's first
moment after one step is (1 − β1)·g, so it reads the gradient).  Under
"reference_own", for each leaf `BF16_NAMED` names and the rest of the
farthest: the reference's own bf16 state after two steps against its f32
state (the distance the bounds' rule scales by BF16_K), the port's bf16
against the reference's bf16, and the port's bf16 against the reference's
f32; under "port_over_reference_own", over the float leaves the port's
bf16 step moves by more than 1e-3 from the reference's, the least and the
largest ratio of the port's distance to the reference's own."""

import json

import numpy as np

import jax
import jax.numpy as jnp

from repro.models import ssm as j_ssm
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import bridge
from repro_torch import tree as tree_mod
from repro_torch.core.execution import Execution
from repro_torch.data import synthetic as t_synthetic
from repro_torch.dist import sharding
from repro_torch.models import ssm as t_ssm
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train import trainer as t_trainer
from test_torch_mesh import _reference_step
from test_torch_mesh_recurrent import (BF16_NAMED, SSD_CHUNK, TRAIN_OPT, ZAMBA, _cfgs, _leaves,
                                        _rel)
from torch_lm_parity import np_tree

TOP = 8


def _port_leaves(state):
    return {p: np.asarray(v) for p, v in tree_mod.flatten_with_path(sharding.to_numpy(state))}


def _farthest(got, want):
    rels = {p: _rel(got[p].astype(np.float32), w.astype(np.float32))
            for p, w in want.items() if w.dtype.kind == "f"}
    return dict(sorted(rels.items(), key=lambda kv: -kv[1])[:TOP])


def gap(dtype: str) -> tuple:
    """The readings for one compute dtype (zamba2 SMOKE at the test's dims,
    the test's two batches, no mesh), and the reference's and the port's
    state leaves after the two steps."""
    jc, tc = _cfgs("zamba2_7b", ZAMBA, dtype)
    jcfg = j_ts.TrainConfig(arch=jc, opt=j_opt.AdamWConfig(**TRAIN_OPT))
    tcfg = t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(**TRAIN_OPT))
    j_state = j_ts.init_state(jax.random.PRNGKey(0), jcfg)
    data = t_synthetic.TokenStreamConfig(vocab_size=jc.vocab_size, seq_len=24, global_batch=4,
                                         seed=3)
    batches = [t_trainer.make_batch(tc, data, i) for i in range(2)]
    j_step = _reference_step(jcfg)
    t_step = t_ts.make_train_step(tcfg, execution=Execution(device="cpu"))
    want, got, j_states = [], [], []
    js, ts_ = j_state, bridge.train_state_from_reference(np_tree(j_state), device="cpu")
    for b in batches:
        js, _ = j_step(js, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        ts_, _ = t_step(ts_, b)
        j_states.append(js)
        want.append(_leaves(js))
        got.append(_port_leaves(ts_))
    same_start, _ = t_step(bridge.train_state_from_reference(np_tree(j_states[0]), device="cpu"),
                           batches[1])
    out = {"step1": _farthest(got[0], want[0]), "step2": _farthest(got[1], want[1]),
           "step2_from_the_reference_step1": _farthest(_port_leaves(same_start), want[1])}
    key = ".params['layers']['conv_b']"
    flip = np.sign(got[0][key]) != np.sign(want[0][key])
    m = np.abs(want[0][".opt.m['layers']['conv_b']"].astype(np.float32))
    out["conv_b_step1"] = {"elements": int(flip.size), "sign_differs": int(flip.sum()),
                           "their_grad_over_max": sorted(float(v) for v in m[flip] / m.max())}
    return out, want[1], got[1]


def main() -> None:
    j_ssm.SSD_CHUNK = t_ssm.SSD_CHUNK = SSD_CHUNK
    res = {dtype: gap(dtype) for dtype in ("float32", "bfloat16")}
    (_, ref32, _), (_, ref16, port16) = res["float32"], res["bfloat16"]
    paths = list(BF16_NAMED) + [p for p in _farthest(port16, ref16) if p not in BF16_NAMED]
    f32 = lambda a: a.astype(np.float32)   # noqa: E731
    own = {p: {"reference_bf16_vs_f32": _rel(f32(ref16[p]), f32(ref32[p])),
               "port_bf16_vs_reference_bf16": _rel(f32(port16[p]), f32(ref16[p])),
               "port_bf16_vs_reference_f32": _rel(f32(port16[p]), f32(ref32[p]))}
           for p in paths}
    ratio = {}
    for p, w in ref32.items():
        if w.dtype.kind == "f" and _rel(f32(port16[p]), f32(ref16[p])) > 1e-3:
            ratio[p] = _rel(f32(port16[p]), f32(ref16[p])) / _rel(f32(ref16[p]), f32(w))
    spread = {"leaves": len(ratio), "min": min(ratio.values()), "max": max(ratio.values()),
              "max_at": max(ratio, key=ratio.get)}
    print(json.dumps({**{dtype: r[0] for dtype, r in res.items()}, "reference_own": own,
                      "port_over_reference_own": spread}, indent=1))


if __name__ == "__main__":
    main()
