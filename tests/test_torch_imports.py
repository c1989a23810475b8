"""The PyTorch port stands alone: neither ``hoisdf_torch`` nor
``chip_smoke.py`` imports JAX, flax or the JAX package (checked on the
source with ``ast``, so a guarded or function-local import counts too)."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hoisdf_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "hoisdf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
