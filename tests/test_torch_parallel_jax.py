"""The port's data-parallel train step on 2 gloo CPU ranks against the JAX
package's step on a 2-device mesh (``hoisdf_tpu.parallel.mesh``), at the
tiny config, f32, over two presampled steps.

Both start from the same bridged weights and BatchNorm statistics
(``torch_port_util``), with a global batch of 4: JAX's arrays sharded over
the mesh's ``data`` axis, the port's ranks 2 rows each.  Random streams
cannot match, so both run without them: ``dist_range=0`` and every dropout
an identity (flax's ``nn.Dropout`` patched for the JAX compile).  JAX's
gradients come from its first moments: g1 = mu1 / 0.1 after the first step,
g2 = (mu2 - 0.9 mu1) / 0.1 after the second.

The port's one-process first step records which elements of each ReLU pass
(``chip_smoke.relu_pattern``), and JAX's steps (``torch_port_util.
_imposed_relu``) and every rank (its rows) pass exactly those, at both
steps (an element that the mask passes gives max(x, the smallest normal
float) with gradient 1 on every side): the three compute one function,
whose second step starts from parameters that differ only where the first
step's gradient was rounding noise.  Tolerances, those of ``test_torch_train.py``: losses 1e-4
relative + 1e-6; gradients 3e-2
relative in norm per tensor + 1e-5, 1e-3 over all; a bias whose
convolution feeds a train-mode BN held on each side under
``BNCancelledBiases``' floor (the ranks' terms); the running statistics
after both steps within lr elementwise (``test_torch_parallel.py`` says
why); the frozen BN affines unchanged on both sides.

ZeRO-1 (``--zero zero1`` against ``parallel/zero.shard_state``) at the
tolerances of ``tests/test_train.py::test_zero_sharded_state_matches_
replicated``: the losses of both steps within 1e-3 relative and
``linear_shape``'s first kernel within 1e-3 relative + 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_util as U
from chip_smoke import TIE_REL
from hoisdf_tpu import train as jtrain
from hoisdf_tpu.data.synthetic import split_inputs_targets, synthetic_batch
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.mano.model import make_synthetic_mano
from hoisdf_tpu.parallel.mesh import make_mesh, shard_batch
from hoisdf_tpu.parallel.zero import shard_state
from hoisdf_torch.train import is_frozen, lr_for_step
from hoisdf_torch.weights import state_dict_from_jax, state_dict_numpy_from_jax
from torch_port_util import (STEPS_PER_EPOCH, _imposed_relu, configs, init_jax,  # noqa: F401
                             one_torch_thread, perturb_batch_stats)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEPT = "linear_shape.layers.0.weight"


def _moments(opt_state):
    return opt_state.inner_states["trainable"].inner_state[0].mu


def _jax_steps(jcfg, jmodel, params, stats, inputs, targets, masks, zero: bool):
    """Two presampled steps on a 2-device mesh, every ReLU passing the
    elements of the port's recorded ``masks`` -> per step the losses, the
    gradients (port names) and the masks, JAX's own decisions after the
    first step, and the final state (port names)."""
    tx = jtrain.make_optimizer(jcfg, params, STEPS_PER_EPOCH)
    state = jtrain.TrainState(step=jnp.asarray(0), params=params, batch_stats=stats,
                              opt_state=tx.init(params), tx=tx)
    mesh = make_mesh(jax.devices()[:2])
    mano = JaxManoBuffers.from_model(make_synthetic_mano(0))
    ties = {}
    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        relu = _imposed_relu(masks, ties, lift=True)
        mp.setattr(fnn, "relu", relu)
        mp.setattr(jax.nn, "relu", relu)
        if zero:
            state, sh = shard_state(state, mesh, shard_params=False, min_size=1024)
            sharded = [x for x in jax.tree.leaves(state.opt_state) if hasattr(x, "sharding")
                       and x.size >= 1024 and x.sharding.spec != jax.sharding.PartitionSpec()]
            assert sharded, "no moment of the JAX state is sharded"
            step = jtrain.make_train_step(jcfg, jmodel, mano, state_shardings=sh)
        else:
            state = jax.device_put(state, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()))
            step = jtrain.make_train_step(jcfg, jmodel, mano)
        bi = shard_batch({k: jnp.asarray(v) for k, v in inputs.items()}, mesh)
        bt = shard_batch({k: jnp.asarray(v) for k, v in targets.items()}, mesh)
        steps, mu_prev, first_ties = [], None, None
        for _ in range(2):
            state, losses = step(state, bi, bt, jax.random.PRNGKey(0), jnp.asarray(0.0),
                                 use_presampled=True)
            jax.effects_barrier()
            first_ties = dict(ties) if first_ties is None else first_ties
            mu = jax.tree.map(lambda x: np.asarray(x, np.float64), _moments(state.opt_state))
            g = mu if mu_prev is None else jax.tree.map(lambda a, b: a - 0.9 * b, mu, mu_prev)
            g = jax.tree.map(lambda x: (x / 0.1).astype(np.float32), g)
            mu_prev = mu
            grads = {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in state_dict_numpy_from_jax(_trainable(params, g), {}).items()}
            steps.append({"losses": {k: float(v) for k, v in losses.items()}, "grads": grads,
                          "relu_masks": masks, "selections": []})
    final = state_dict_numpy_from_jax(jax.tree.map(np.asarray, state.params),
                                      jax.tree.map(np.asarray, state.batch_stats))
    return {"steps": steps, "ties": first_ties,
            "state": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in final.items()}}


def _trainable(params, moments):
    """The moment tree's leaves at the trainable parameters (the frozen ones
    are optax.MaskedNode there)."""
    import optax

    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = moments
        for k in path:
            node = node[k.key]
        if isinstance(node, optax.MaskedNode):
            continue
        sub = out
        for k in path[:-1]:
            sub = sub.setdefault(k.key, {})
        sub[path[-1].key] = node
    return out


@pytest.fixture(scope="module")
def runs(one_torch_thread, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_jax")
    jcfg, pcfg = configs(reference_init=False)
    jmodel, params, stats = init_jax(jcfg)
    stats = perturb_batch_stats(stats)
    inputs, targets = split_inputs_targets(synthetic_batch(jcfg, 4, seed=3, train=True))
    weights = state_dict_from_jax(params, stats)
    # the ReLU pattern of the port's one-process first step, which JAX's
    # steps and every rank's impose
    record = U.train_run(None, pcfg, (inputs, targets), [True], weights=weights, record=True)
    masks = record["steps"][0]["relu_masks"]
    del record
    refs = {}
    for zero in ("off", "zero1"):
        ref = _jax_steps(jcfg, jmodel, params, stats, inputs, targets, masks, zero == "zero1")
        refs[zero] = (ref, str(tmp / f"jax_{zero}.pt"))
        torch.save(ref, refs[zero][1])
    ranks = U.run_ranks(U.train_runs, 2, tmp, pcfg, (inputs, targets), [True, True],
                        {z: path for z, (_, path) in refs.items()}, weights, (KEPT,))
    return pcfg, {z: ref for z, (ref, _) in refs.items()}, ranks


def test_two_ranks_match_the_jax_mesh_step(runs):
    pcfg, refs, ranks = runs
    ref, got = refs["off"], ranks[0]["off"]
    lr = lr_for_step(pcfg, 0, STEPS_PER_EPOCH)
    # JAX's own ReLU decisions, and every rank's, differ from the imposed
    # pattern at near-ties only (at the first step, from the same weights)
    assert ref["ties"] and all(n == 0 or near <= TIE_REL * top
                               for n, near, top in ref["ties"].values())
    for r in ranks:
        assert all(n == 0 or near <= TIE_REL * top
                   for n, near, top, _ in r["off"]["steps"][0]["relu_ties"])
    for i, (want, step) in enumerate(zip(ref["steps"], got["steps"])):
        assert set(step["losses"]) == set(want["losses"])
        for k, v in want["losses"].items():
            assert np.isfinite(v)
            np.testing.assert_allclose(step["losses"][k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        floors = U.floors_of(U.global_terms([r["off"]["steps"][i]["bn_terms"] for r in ranks]))
        assert floors and set(floors) <= set(want["grads"])
        trainable = {n for n in step["grad_errors"] if not is_frozen(n)}
        assert set(want["grads"]) == trainable
        err2 = ref2 = 0.0
        for k, (err, norm_ref, norm_got, _) in step["grad_errors"].items():
            if k in floors:
                assert norm_got <= floors[k] and norm_ref <= floors[k], (i, k, norm_ref, norm_got)
                continue
            assert err <= 3e-2 * norm_ref + 1e-5, (i, k, err, norm_ref)
            err2, ref2 = err2 + err ** 2, ref2 + norm_ref ** 2
        assert np.sqrt(err2 / ref2) <= 1e-3, (i, np.sqrt(err2 / ref2))
    for k, (_, _, _, max_abs) in got["state_errors"].items():
        if k.endswith(("running_mean", "running_var")):
            assert max_abs <= lr, (k, max_abs)
        elif is_frozen(k):
            assert max_abs == 0.0, k


def test_zero1_matches_the_jax_zero1_step(runs):
    _, refs, ranks = runs
    ref, got = refs["zero1"], ranks[0]["zero1"]
    for want, step in zip(ref["steps"], got["steps"]):
        np.testing.assert_allclose(step["losses"]["total"], want["losses"]["total"], rtol=1e-3)
    np.testing.assert_allclose(got["kept"][KEPT].numpy(), ref["state"][KEPT].numpy(),
                               rtol=1e-3, atol=1e-5)
    # and ZeRO-1 is the replicated step: the port's two modes agree closely
    off = ranks[0]["off"]
    for a, b in zip(off["steps"], got["steps"]):
        np.testing.assert_allclose(b["losses"]["total"], a["losses"]["total"], rtol=1e-6)
    torch.testing.assert_close(got["kept"][KEPT], off["kept"][KEPT], rtol=0, atol=0)
