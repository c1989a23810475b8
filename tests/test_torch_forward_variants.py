"""The port's eval forward with the non-merged field queries
(``merged_field_queries=False``: four pyramid gathers, the cross queries
through ``sdf_forward``) and with the paired cascade
(``paired_sdf_infer=True``, ``hier_levels_obj=None``) against
``HOISDF.apply``; and the paired cascade's refusal of a conflicting
``hier_levels_obj``, as the JAX package refuses it.

Tiny config, batch 2, f32 on both sides, one torch thread.  Tolerances: the
same selected lattice points (sets, per field and image); every output
within 1e-4 absolute + 1e-4 relative (``torch_port_util.FORWARD_TOL``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hoisdf_torch.models import hoisdf
from hoisdf_torch.models.experimental import paired_sdf_infer

from torch_port_util import (  # noqa: F401  (one_torch_thread is a fixture)
    assert_forward_matches_jax,
    forward_pair,
    forward_setup,
    one_torch_thread,
    port_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VARIANTS = {
    "unmerged": dict(merged_field_queries=False),
    "paired": dict(paired_sdf_infer=True),
}


@pytest.fixture(scope="module")
def setup():
    return forward_setup()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_matches_jax(setup, variant, monkeypatch):
    calls = []

    def counting(*args):
        calls.append(args[0])
        return paired_sdf_infer(*args)

    monkeypatch.setattr(hoisdf, "paired_sdf_infer", counting)
    got, want, pcfg = forward_pair(setup, **VARIANTS[variant])
    assert pcfg.hier_levels_obj is None
    assert len(calls) == (variant == "paired")
    assert_forward_matches_jax(got, want, pcfg)


def test_paired_sampler_refuses_a_per_field_cascade(setup):
    x = {k: torch.from_numpy(v) for k, v in setup["inputs"].items()}
    levels = setup["pcfg"].hier_levels
    for obj_levels, ok in ((((4, 8), (2, 24)), False), (levels, True)):
        pcfg = dataclasses.replace(setup["pcfg"], paired_sdf_infer=True,
                                   hier_levels_obj=obj_levels)
        model = port_model(pcfg, setup["params"], setup["stats"])
        with torch.inference_mode():
            if ok:
                assert np.isfinite(model(x, supervise_sdf=False)["obj_sdf"].numpy()).all()
            else:
                with pytest.raises(ValueError, match="paired_sdf_infer"):
                    model(x, supervise_sdf=False)
