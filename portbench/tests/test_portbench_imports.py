"""Nothing the benchmark runs loads JAX or the JAX package (`repro`), by
whole top-level module names (the port's `repro_torch` begins with
`repro`), and the reference loads nothing of the port."""

import pytest

pytest.importorskip("torch")

import ast
import json
import subprocess
import sys

from portbench.tests import smoke

PB = smoke.ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_A_CELL = r"""
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {src!r})
from portbench.tests import smoke
from portbench import bench, calibrate
for cell in smoke.CELLS:
    smoke.run(cell, seconds=0.2, trace=cell.endswith("prefill"))
for m in (bench.HERE / "metrics").glob("*.py"):
    bench.load_source(m)
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.transformer
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(smoke.ROOT),
                                                            src=str(smoke.ROOT / "src"))],
                         capture_output=True, text=True, timeout=300, cwd=str(smoke.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_of_every_cell_loads_no_jax():
    top = set(_modules(RUN_A_CELL))
    assert "repro_torch" in top and "portbench" in top
    assert not (top & FORBIDDEN), sorted(top & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules(REFERENCE_ONLY)
    tops = {m.split(".", 1)[0] for m in mods}
    assert not (tops & (FORBIDDEN | {"repro_torch"}))
    assert not any(m.startswith("portbench.") and not m.startswith("portbench.reference")
                   for m in mods)


def test_no_source_of_the_benchmark_imports_jax_or_the_reference_the_port():
    for path in PB.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                top = n.split(".", 1)[0]
                assert top not in FORBIDDEN, f"{path}: imports {n}"
                if "reference" in path.parts:
                    assert top in {"torch", "math", "dataclasses", "typing", "__future__"}, \
                        f"{path}: the reference imports {n}"
