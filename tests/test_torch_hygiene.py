"""Import hygiene of the port: ``m2mixer_tpu_torch`` and ``chip_smoke.py``
import neither JAX/flax nor anything of the JAX package, build nothing at
import, and the chip smoke refuses to run without a GPU or without the
package beside it."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "m2mixer_tpu_torch"
SOURCES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "m2mixer_tpu")


def module_name(rel: str) -> str:
    return rel[:-3].replace("/", ".").removesuffix(".__init__")


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_nothing_of_jax(rel):
    tree = ast.parse((REPO / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = [module_name(r) for r in SOURCES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "from m2mixer_tpu_torch.ops import _build\n"
        "assert _build._LIB is None, 'kernel library loaded at import'\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_without_gpu_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: chip_smoke.py runs for real there")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    from m2mixer_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_digest_follows_the_sources(tmp_path):
    from m2mixer_tpu_torch.ops import _build

    src = tmp_path / "k.cu"
    src.write_text("// a")
    first = _build._digest([src])
    assert _build._digest([src]) == first
    src.write_text("// b")
    assert _build._digest([src]) != first
    assert [p.name for p in _build._sources()] == ["dynamixer.cu", "gmlp.cu", "mixer_bwd.cu",
                                                   "mixer_fwd.cu"]
