"""The ho3d_render (IK head: one shape query, no pose head) and dexycb_full
presets against the JAX package at the tiny config: the weight bridge bit for
bit, and the whole eval step (1e-4 absolute + 1e-4 relative, the same
selected points, as ``test_torch_eval_step.py``).  Both sides run in f32 on
the CPU.  ``test_torch_presets.py`` covers ho3d."""

import pytest

from torch_port_util import check_bridge, check_eval_step, preset_setup


@pytest.fixture(scope="module", params=["ho3d_render", "dexycb_full"])
def preset(request):
    return preset_setup(request.param)


def test_bridge_matches_flax_to_torch_state_and_round_trips(preset):
    check_bridge(preset)


def test_eval_step_matches_jax(preset):
    check_eval_step(preset)
