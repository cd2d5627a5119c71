"""Checkpoint helpers of the port.

Only `config_hash` of the JAX package's `checkpoint/manager.py` is ported
so far (the checkpoint manager itself follows with training, ROADMAP A10).
The serving steps key their compile cache with it.
"""

from __future__ import annotations

import hashlib
from typing import Any


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]
