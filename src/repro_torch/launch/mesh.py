"""Device meshes of the port: the production shapes and the smoke mesh.

Functions, not module-level constants: importing this module creates no
process group and touches no device.  A mesh is a `torch.distributed`
`DeviceMesh` with the reference's axis names:

  single pod   (data=16, model=16)          256 ranks
  multi-pod    (pod=2, data=16, model=16)   512 ranks

`pod` carries data parallelism across pods (gradient sync only, optionally
RP-compressed — `repro_torch.dist.compress.compress_sync`), `data` carries
data parallelism and the sharded storage of params and optimizer state,
`model` carries expert parallelism.  Each rank is one process on one
card (NCCL); `device="cpu"` builds the mesh over `gloo` ranks instead, as
the tests do.

With no process group yet, a launcher's environment (`RANK`,
`WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`) starts one; without that
environment the smoke mesh starts a one-rank group of its own.  Over the
dry run's fake process group (`launch/dryrun.py`, backend "fake", any world
size) the production mesh builds with no card and no communication.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.execution import resolve_device
from repro_torch.dist.sharding import fake_group

PRODUCTION: dict = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _launched() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def world_size() -> int:
    """Ranks of the current process group, or of the one a launcher's
    environment describes, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if _launched() else 1


def ensure_group(device="cuda") -> None:
    """Start the process group if none exists: NCCL for a card, gloo for
    `device="cpu"`; from a launcher's environment, else one rank alone."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if _launched():
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(device, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    # over the dry run's fake group a CUDA mesh needs no card
    kind = torch.device(device).type if fake_group() else resolve_device(device).type
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh; raises with the world size it has and the size
    it needs when there are fewer ranks than the shape."""
    shape, axes = PRODUCTION[multi_pod]
    need = math.prod(shape)
    have = world_size()
    if have < need:
        raise ValueError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh {shape} over {axes} "
            f"needs a world size of {need}; this run has a world size of {have}")
    ensure_group(device)
    return _mesh(device, shape, axes)


def make_smoke_mesh(n_devices: int = 1, *, device="cuda"):
    """(data=1, model=min(n_devices, world size)): a tiny mesh over the
    ranks that exist, one rank alone when no group was started."""
    ensure_group(device)
    n = max(1, min(n_devices, dist.get_world_size()))
    return _mesh(device, (1, n), ("data", "model"))
