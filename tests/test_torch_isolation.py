"""The port stands alone: no module of logparser_tpu_torch, and not
chip_smoke.py, imports jax or anything of the logparser_tpu package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "logparser_tpu")
SOURCES = sorted((ROOT / "logparser_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for must in ("logparser_tpu_torch/tpu/kernels.py", "logparser_tpu_torch/tpu/batch.py",
                 "logparser_tpu_torch/tpu/pipeline.py", "chip_smoke.py"):
        assert must in names
    assert not _forbidden("logparser_tpu_torch.tpu")
    assert _forbidden("logparser_tpu.tpu") and _forbidden("jax.numpy")
