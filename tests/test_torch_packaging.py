"""The port's sources that it compiles at first use ship as package data
(``pyproject.toml``), so an installed copy can build them: the CUDA kernels
and the native image pipeline.  Its console scripts stand beside the JAX
package's and name callables that exist, and its tools are a package."""

import glob
import importlib
import pathlib
import tomllib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_sources_ship_as_package_data():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["hoisdf_torch"]
    shipped = {pathlib.Path(p).relative_to(ROOT / "hoisdf_torch").as_posix()
               for pattern in data for p in glob.glob(str(ROOT / "hoisdf_torch" / pattern))}
    assert {"native/src/pipeline.cc", "csrc/sdf_mlp.cu", "csrc/gather_lerp.cu",
            "csrc/hopper.cuh"} <= shipped


PORT_SCRIPTS = {"hoisdf-torch-train": "hoisdf_torch.train_loop:main",
                "hoisdf-torch-eval": "hoisdf_torch.evaluate:main",
                "hoisdf-torch-export": "hoisdf_torch.tools.export:main"}


def test_port_console_scripts_beside_the_jax_ones():
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert {k: scripts.get(k) for k in PORT_SCRIPTS} == PORT_SCRIPTS
    assert {k: v for k, v in scripts.items() if k not in PORT_SCRIPTS} == {
        "hoisdf-train": "hoisdf_tpu.train_loop:main", "hoisdf-eval": "hoisdf_tpu.evaluate:main",
        "hoisdf-bench": "hoisdf_tpu.bench:main"}


@pytest.mark.parametrize("script", sorted(PORT_SCRIPTS))
def test_port_console_script_names_a_callable(script):
    module, _, attr = PORT_SCRIPTS[script].partition(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_port_tools_are_a_package():
    with open(ROOT / "pyproject.toml", "rb") as f:
        include = tomllib.load(f)["tool"]["setuptools"]["packages"]["find"]["include"]
    assert "hoisdf_torch*" in include
    assert (ROOT / "hoisdf_torch" / "tools" / "__init__.py").exists()
    for name in ("export", "convert_mano_pkl", "preprocess_sdf", "synth_weights"):
        importlib.import_module(f"hoisdf_torch.tools.{name}")
