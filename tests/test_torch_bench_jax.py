"""The eval step that ``hoisdf-torch-bench --cpu`` times, against the JAX
package's ``make_eval_step`` as ``bench.py --cpu`` builds it: the same
tiny config (ResNet-18, 16^3 lattice, the cascade ((4, 16), (2, 48)),
f32), the flax init's weights (BatchNorm statistics moved off (0, 1))
carried into the port by ``state_dict_from_jax``, the bench's synthetic
batch (the u8 wire on the port's side, its exact f32 values on JAX's).
One JAX compile.

Tolerance as ``tests/test_torch_eval_step.py``'s: 1e-4 absolute + 1e-4
relative on every output, the selected hand points one set, per-point rows
compared after sorting by lattice point, object rows matched one to one
(``torch_port_util.assert_eval_matches_jax``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch import bench
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.mano.model import make_synthetic_mano
from hoisdf_tpu.train import make_eval_step as jax_make_eval_step
from torch_port_util import (assert_eval_matches_jax, init_jax, one_torch_thread,  # noqa: F401
                             perturb_batch_stats)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_bench_cpu_step_matches_jax():
    pcfg = bench.build_config("dexycb", cpu=True)
    # bench.py's --cpu config (its CPU branch at the default hier sampler)
    jcfg = jax_get_config("dexycb", **bench.CPU_OVERRIDES, sdf_infer_mode="hier",
                          fused_sdf_infer=True, hier_levels=bench.CPU_HIER_LEVELS,
                          hier_levels_obj=None)
    assert (pcfg.hier_levels, pcfg.hier_levels_obj, pcfg.compute_dtype) == (
        jcfg.hier_levels, jcfg.hier_levels_obj, jcfg.compute_dtype) == (
        bench.CPU_HIER_LEVELS, None, "float32")
    jmodel, params, stats = init_jax(jcfg)
    stats = perturb_batch_stats(stats)
    dev = torch.device("cpu")
    step = bench.make_bench_step(pcfg, dev, state_dict=state_dict_from_jax(params, stats))
    inputs = bench.eval_inputs(pcfg, bench.CPU_MAX_BATCH, dev)
    assert inputs["img"].dtype == torch.uint8
    got = {k: v.numpy() for k, v in step(inputs).items()}

    jinputs = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    jinputs["img"] = jnp.asarray(inputs["img"].numpy().astype(np.float32) / 255.0)
    jstep = jax_make_eval_step(jcfg, jmodel, JaxManoBuffers.from_model(make_synthetic_mano(0)))
    want = {k: np.asarray(v) for k, v in jstep(params, stats, jinputs).items()}
    assert_eval_matches_jax(got, want, pcfg)
