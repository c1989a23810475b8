"""One presampled train step with the non-merged field queries
(``merged_field_queries=False``) against ``make_train_step``, at the tiny
dexycb config in f32, one JAX compile in a file of its own.  Token features
come from two gathers and the cross queries from two more through
``sdf_forward``, so the gather's backward runs on each token gather apart.  The tolerances are ``test_torch_train.py``'s
(``torch_port_util.check_train_step``): dropout off, no jitter, JAX's ReLUs
held to the port's pattern."""

import torch

from hoisdf_torch.ops.kernels import gather_lerp as gl

from torch_port_util import check_train_step, configs, one_torch_thread, train_setup  # noqa: F401


def test_unmerged_presampled_train_step_matches_jax(one_torch_thread, monkeypatch):
    calls = []
    plain = gl.gather_lerp_bwd_plain

    def counting(grid, *args):
        calls.append(grid.shape[1])
        return plain(grid, *args)

    monkeypatch.setattr(gl, "gather_lerp_bwd_plain", counting)
    jcfg, pcfg = configs(reference_init=False, merged_field_queries=False)
    assert not pcfg.merged_field_queries and not jcfg.merged_field_queries
    check_train_step(train_setup(jcfg, pcfg, ("presampled",)), "presampled")
    # the backward ran on the two token gathers, not on one merged [B, Ph+Po]
    # gather (the cross queries and the presampled sdf are detached)
    ph, po = pcfg.num_samp_hand, pcfg.num_samp_obj
    assert ph in calls and po in calls and ph + po not in calls, calls
    assert torch.get_num_threads() == 1
