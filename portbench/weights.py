"""The weights of a run, drawn on the device from its seed by the benchmark
and handed to both the program and the reference.

The parameter layout is the port's transformer's (`embed`, stacked
`layers` leaves `[L, ...]`, `final_norm`, `lm_head`, `frontend_proj`),
with its init's distributions: N(0, 1/d_in) for a dense leaf, the scaled
output projections, ones for the norms.  Each leaf is one call on a
generator of its own (`generate.generator(seed, "param:<path>", 0)`), so
the reference can draw a leaf again without holding the others.  The DR
unit's state is the paper's: a sparse ternary R (p, m) with s = p, an empty
row given one ±1, and an orthonormal B (n, p).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.generate import generator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaf_specs(arch) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter leaf, paths as `layers/wq`;
    a scale of 0 marks a norm's ones.  Dense transformers only."""
    if arch.family != "transformer" or arch.moe is not None:
        raise ValueError(f"{arch.name}: the benchmark draws dense transformers only")
    d, dh, hq, hkv, f, n_l = (arch.d_model, arch.dh, arch.n_heads, arch.n_kv_heads, arch.d_ff,
                              arch.n_layers)
    v = arch.padded_vocab
    out = [("embed", (v, d), 1.0),
           ("final_norm", (d,), 0.0),
           ("layers/ln1", (n_l, d), 0.0),
           ("layers/ln2", (n_l, d), 0.0),
           ("layers/wq", (n_l, d, hq * dh), 1.0 / math.sqrt(d)),
           ("layers/wk", (n_l, d, hkv * dh), 1.0 / math.sqrt(d)),
           ("layers/wv", (n_l, d, hkv * dh), 1.0 / math.sqrt(d)),
           ("layers/wo", (n_l, hq * dh, d), 1.0 / math.sqrt(2 * n_l * hq * dh)),
           ("layers/w_in", (n_l, d, f), 1.0 / math.sqrt(d)),
           ("layers/w_out", (n_l, f, d), 1.0 / math.sqrt(2 * n_l * f))]
    if arch.gated_mlp:
        out.append(("layers/w_gate", (n_l, d, f), 1.0 / math.sqrt(d)))
    if not arch.tie_embeddings:
        out.append(("lm_head", (d, v), 1.0 / math.sqrt(d)))
    if arch.frontend is not None:
        f_in = arch.dr_frontend.n if arch.dr_frontend is not None else arch.frontend_dim
        out.append(("frontend_proj", (f_in, d), 1.0 / math.sqrt(f_in)))
    return sorted(out)


def draw_leaf(seed: int, spec, device, dtype=torch.float32) -> torch.Tensor:
    path, shape, scale = spec
    if scale == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    g = generator(seed, "param:" + path, 0, device)
    w = torch.randn(shape, generator=g, device=device)
    w.mul_(scale)
    return w.to(dtype)


def draw_params(arch, seed: int, device) -> Dict:
    """The port's nested parameter dict, in the config's `param_dtype`."""
    dtype = DTYPES[arch.param_dtype]
    params: Dict = {"layers": {}}
    for spec in leaf_specs(arch):
        path = spec[0]
        t = draw_leaf(seed, spec, device, dtype)
        if path.startswith("layers/"):
            params["layers"][path.split("/", 1)[1]] = t
        else:
            params[path] = t
    return params


def draw_dr(arch, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R int8 (p, m), B f32 (n, p)) of the config's RP → EASI front end."""
    spec = arch.dr_frontend
    m, p, n = arch.frontend_dim, spec.p, spec.n
    g = generator(seed, "dr", 0, device)
    u = torch.rand((p, m), generator=g, device=device)
    half = 1.0 / (2.0 * p)
    r = (u < half).to(torch.int8) - ((u >= half) & (u < 2 * half)).to(torch.int8)
    dead = torch.all(r == 0, dim=1)
    cols = torch.randint(0, m, (p,), generator=g, device=device)
    signs = (torch.randint(0, 2, (p,), generator=g, device=device) * 2 - 1).to(torch.int8)
    plant = torch.zeros_like(r)
    plant[torch.arange(p, device=device), cols] = signs
    r = torch.where(dead[:, None], plant, r)
    q, _ = torch.linalg.qr(torch.randn((p, n), generator=g, device=device))
    return r, q.T.contiguous()
