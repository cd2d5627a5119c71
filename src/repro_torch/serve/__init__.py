"""repro_torch.serve — the LM serving steps on one card.

  batching    — `BoundedCompileCache`, the LRU over built step callables
  serve_step  — `make_prefill` / `make_decode` over `models.api`

The DR serving engine, the scheduler and the fleet are not ported yet
(ROADMAP A7, A8).
"""

from repro_torch.serve import batching, serve_step
from repro_torch.serve.batching import BoundedCompileCache

__all__ = ["BoundedCompileCache", "batching", "serve_step"]
