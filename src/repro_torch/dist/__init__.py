"""Distribution layer: the paper's ternary RP sketch as a compressor.

  compress — staged-delta sketches for the serving fleet's merge rounds
             (`delta_sketch` / `merge_deltas`, the least-squares projection
             decode with error feedback), and the wire-byte accounting.

The mesh half (`sharding`, and `compress.compress_sync`, the in-collective
gradient sync) is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

from repro_torch.dist import compress

__all__ = ["compress"]
