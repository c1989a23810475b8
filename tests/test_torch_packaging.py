"""The port's sources that it compiles at first use ship as package data
(``pyproject.toml``), so an installed copy can build them: the CUDA kernels
and the native image pipeline."""

import glob
import pathlib
import tomllib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_sources_ship_as_package_data():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["hoisdf_torch"]
    shipped = {pathlib.Path(p).relative_to(ROOT / "hoisdf_torch").as_posix()
               for pattern in data for p in glob.glob(str(ROOT / "hoisdf_torch" / pattern))}
    assert {"native/src/pipeline.cc", "csrc/sdf_mlp.cu", "csrc/gather_lerp.cu",
            "csrc/hopper.cuh"} <= shipped
