"""The PyTorch port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the example twins import JAX or anything of the
JAX package ``repro`` — not even its framework-free modules (the port keeps
its own copies)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("*_torch.py")))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    names = {p.name for p in FILES}
    assert {"engine.py", "fused.py", "probe.py", "hashmix.py", "level.py", "baselines.py",
            "prefix_cache.py", "dedup.py", "pipeline.py", "chip_smoke.py",
            "quickstart_torch.py", "dedup_pipeline_torch.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & FORBIDDEN, sorted(roots & FORBIDDEN)
