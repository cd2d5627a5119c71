"""A configuration file of `configs/`, read into the benchmark's own view of
its sizes (its family's `Arch`), and into the port's `ArchConfig` for the
program.

The benchmark's view holds only numbers, so the weights, the counts of
operations and bytes, and the reference read the sizes without importing
anything of the program.  What differs by family (the `Arch` and its
fields, the parameter leaves, the operations) is in `families/<family>.py`,
found by the `family` of the config's `arch`; the DR front end is any
family's.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class DRSpec:
    kind: str
    p: int
    n: int
    mu: float
    bypass_whitening: bool


def family(name: str):
    """The module of family `name`: `families/<name>.py`."""
    return importlib.import_module(f"portbench.families.{name}")


def read(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def sizes(arch_fields: Dict[str, Any], overrides: Optional[Dict[str, Any]] = None):
    """The benchmark's `Arch` of a configuration file's `arch` object."""
    f = dict(arch_fields, **(overrides or {}))
    dr = f.pop("dr_frontend", None)
    return family(f["family"]).sizes(f, None if dr is None else DRSpec(**dr))


def port_config(arch):
    """The port's `ArchConfig` of the same sizes."""
    return family(arch.family).port_config(arch)
