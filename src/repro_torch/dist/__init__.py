"""Distribution layer: the mesh's sharding rules and the paper's ternary RP
sketch as a compressor.

  sharding — the reference's sharding rules (param / batch / cache specs),
             the layouts they give DTensors (`lay_out`, `full`,
             `to_numpy`), the ambient mesh (`use_mesh`) and the collectives
             the meshed steps use on local tensors.
  compress — `compress_sync`, the RP-sketched data-parallel gradient sync;
             staged-delta sketches for the serving fleet's merge rounds
             (`delta_sketch` / `merge_deltas`); the wire-byte accounting.
"""

from __future__ import annotations

from repro_torch.dist import compress, sharding

__all__ = ["compress", "sharding"]
