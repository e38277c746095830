"""The PyTorch port stands alone: no module of ``repro_torch``, not
``chip_smoke.py``, not the example twins and not the script twins import
JAX or anything of the JAX package ``repro`` — not even its framework-free
modules (the port keeps its own copies)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("*_torch.py"))
         + sorted((ROOT / "scripts").glob("*_torch.py")))
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
            "quickstart_torch.py", "dedup_pipeline_torch.py", "dht.py",
            "forensics_torch.py", "distributed_dht_torch.py", "transformer.py",
            "layers.py", "kv_cache.py", "serve.py", "serve_prefix_cache_torch.py",
            "moe.py", "rglru.py", "rwkv6.py", "adamw.py", "schedule.py", "steps.py",
            "trainer.py", "manager.py", "train.py", "train_lm_torch.py", "sharding.py",
            "collectives.py", "compression.py", "mesh.py", "elastic.py", "shapes.py",
            "dryrun.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & FORBIDDEN, sorted(roots & FORBIDDEN)
