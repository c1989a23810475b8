"""Shared set-up of the PyTorch-port parity tests: one tiny HOISDF built by
the JAX package, its weights carried into the port through the port's bridge.

Both packages run on the CPU in f32; JAX at matmul precision "highest"
(tests/conftest.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES as PORT_TINY
from hoisdf_torch.config import get_config as port_get_config
from hoisdf_torch.models.hoisdf import HOISDF as PortHOISDF
from hoisdf_torch.weights import state_dict_from_jax
from hoisdf_tpu.config import SYNTHETIC_TINY_OVERRIDES as JAX_TINY
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.models.hoisdf import build_model as jax_build_model


def configs(**over):
    """(jax cfg, port cfg) at the tiny size with one shared cascade."""
    over = {"hier_levels_obj": None, **over}
    return (jax_get_config("dexycb", **{**JAX_TINY, **over}),
            port_get_config("dexycb", **{**PORT_TINY, **over}))


def init_jax(jcfg, seed: int = 0):
    """The flax model and its (params, batch_stats) as numpy trees."""
    model = jax_build_model(jcfg)
    inputs, _ = split_inputs_targets(synthetic_batch(jcfg, 1, train=True))
    init = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(seed), "sample_noise": jax.random.PRNGKey(seed + 1)},
        x, use_presampled=True, dist_range=0.0))
    variables = init({k: jnp.asarray(v) for k, v in inputs.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return model, to_np(variables["params"]), to_np(variables.get("batch_stats", {}))


def port_model(pcfg, params, batch_stats) -> PortHOISDF:
    model = PortHOISDF(pcfg)
    model.load_state_dict(state_dict_from_jax(params, batch_stats), strict=True)
    return model.eval()


def perturb_batch_stats(batch_stats, seed: int = 0):
    """BN running stats away from (0, 1), so the tests see them used."""
    rng = np.random.RandomState(seed)

    def f(path, v):
        name = path[-1].key
        if name == "mean":
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, batch_stats)

