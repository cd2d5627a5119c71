"""The weights of a run, drawn on the device from its seed by the benchmark
and handed to both the program and the reference.

The parameter leaves and their scales are the family's
(`families/<family>.py`: for the dense transformer `embed`, stacked
`layers` leaves `[L, ...]`, `final_norm`, `lm_head`, `frontend_proj`), a
path's groups nested as the port's dict nests them.  Each leaf is one call on a
generator of its own (`generate.generator(seed, "param:<path>", 0)`), so
the reference can draw a leaf again without holding the others.  The DR
unit's state is the paper's: a sparse ternary R (p, m) with s = p, an empty
row given one ±1, and an orthonormal B (n, p).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import arch as arch_mod
from portbench.generate import generator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaf_specs(arch) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter leaf, paths as `layers/wq`;
    a scale of 0 marks a norm's ones.  The family's (`families/`)."""
    return arch_mod.family(arch.family).leaf_specs(arch)


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
    specs = leaf_specs(arch)
    params: Dict = {}
    for path, _, _ in specs:            # every group first, as the port's dict lays them out
        node = params
        for g in path.split("/")[:-1]:
            node = node.setdefault(g, {})
    for spec in specs:
        *groups, name = spec[0].split("/")
        node = params
        for g in groups:
            node = node[g]
        node[name] = draw_leaf(seed, spec, device, dtype)
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
