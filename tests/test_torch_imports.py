"""The PyTorch port stands alone: neither ``hoisdf_torch``, ``chip_smoke.py``
nor the data-fixture writer they share with the tests imports JAX, flax or
the JAX package (checked on the source with ``ast``, so a guarded or
function-local import counts too); the fixture writer imports numpy and PIL
only."""

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
    files = sorted((ROOT / "hoisdf_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_data_fixtures.py",
        ROOT / "scripts" / "bisect_card_repeat.py", ROOT / "scripts" / "probe_zero_memory.py",
        ROOT / "scripts" / "probe_serving_host.py"]
    assert len(files) > 15
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("train.py", "train_loop.py", "losses.py", "ops/heatmap.py",
                   "models/initializers.py", "utils/checkpoint.py", "utils/logger.py",
                   "utils/timer.py", "evaluate.py", "metrics.py", "ops/ik.py",
                   "data/ho3d.py", "data/loader.py", "data/dexycb.py", "data/transforms.py",
                   "data/image_io.py", "data/meshes.py", "predictor.py",
                   "native/__init__.py", "native/build.py", "ops/warp.py",
                   "models/experimental.py", "ops/selection_quality.py",
                   "parallel/mesh.py", "parallel/zero.py", "parallel/dryrun.py",
                   "tools/__init__.py", "tools/export.py", "tools/convert_mano_pkl.py",
                   "tools/preprocess_sdf.py", "tools/synth_weights.py", "utils/profiling.py",
                   "mano/demo.py", "ops/device_cache.py", "bench.py"):
        assert f"hoisdf_torch/{module}" in names, module
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    fixtures = ROOT / "tests" / "torch_data_fixtures.py"
    stdlib = {"__future__", "json", "os", "pickle", "time", "typing"}
    assert {n.split(".")[0] for n in _imports(fixtures)} - stdlib == {"numpy", "PIL"}
