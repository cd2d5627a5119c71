"""The port stands alone: no file of `src/repro_torch/`, nor `chip_smoke.py`,
imports JAX or the JAX package; importing the port loads neither and builds
no kernel; and without a card an entry point that was not asked for the CPU
raises instead of running there."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import dr as tdr

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "print(len(" + repr(modules) + "))\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(modules) >= 15


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    model = tdr.DRModel(stages=(tdr.RPStage(32, 16), tdr.EASIStage.rotation(16, 8)),
                        execution=tdr.Execution(backend="kernel"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))
    cpu = model.with_execution(tdr.Execution(backend="kernel", device="cpu"))
    state = cpu.init(torch.Generator().manual_seed(0))
    x = torch.zeros((4, 32))
    for call in (lambda: model.transform(state, x), lambda: model.update(state, x),
                 lambda: model.fit(state, x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tuple(cpu.transform(state, x).shape) == (4, 8)


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
