"""The IK head's hand solved inside the eval step (the ho3d_render preset).

- The solve's custom op ``hoisdf_torch::ik_solve`` through
  ``torch.library.opcheck``; ``ops/ik.py::ik_solver_mano`` (the dispatcher)
  against the solver as it stood before the op (the two MANO forwards
  around the plain solve, composed here), bit for bit, with frames forced
  to a reflection; and the CUDA kernel's arithmetic (``csrc/ik.cu``: the
  fixed-sweep one-sided Jacobi SVD, its U from a cross product, the finger
  chains) walked in numpy against the plain twin.
- The eval step's ``mano_joints`` / ``mano_verts`` against the evaluator's
  former path (the solver on the voted joints with the root prepended and
  the predicted shape), bit for bit; the Predictor serves ``SERVE_KEYS`` for
  ho3d_render and its warmed step builds no tensor from host data.
- The eval step against the benchmark's plain reference of the IK head
  (``benchmark/reference/model_ik.py`` and ``ik.py``) on seeded weights.
- On a card only: the kernel against its twin.

Tiny model, f32, the CPU, one torch thread; no JAX.
"""

import numpy as np
import pytest
import torch

import hoisdf_torch.ops.kernels  # noqa: F401  (registers the ops)
from hoisdf_torch.config import SYNTHETIC_TINY_OVERRIDES, get_config
from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.ops.ik import ik_solver_mano
from hoisdf_torch.ops.kernels.ik import FINGER_LIST, KNUCKLES, ik_solve_plain


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (the suite's parallel workers share the cores);
    a fixture of its own, so that the file collects where flax is absent
    (the card's machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T = torch.from_numpy
f32 = np.float32
TINY = dict(SYNTHETIC_TINY_OVERRIDES, compute_dtype="float32",
            hier_levels=((4, 16), (2, 32)), hier_levels_obj=None)


@pytest.fixture(scope="module")
def mano():
    return ManoBuffers.from_model(make_synthetic_mano(0))


def _fk_joints(buf, seed, b, mirror_every=2):
    """FK joints in metres, 0.5 m in front of the camera, 2 mm of noise;
    every ``mirror_every``-th frame mirrored (a left hand: Kabsch finds a
    reflection)."""
    rng = np.random.RandomState(seed)
    pose = T((rng.randn(b, 48) * 0.3).astype(f32))
    shape = T((rng.randn(b, 10) * 0.3).astype(f32))
    _, joints = mano_forward(buf, pose, shape)
    joints = joints / 1000.0 + torch.tensor([0.0, 0.0, 0.5])
    joints = joints + T((rng.randn(b, 21, 3) * 0.002).astype(f32))
    joints[::mirror_every, :, 0] *= -1
    return joints, shape


def _solve_inputs(buf, joints, shape):
    target = joints - joints[:, :1]
    _, template = mano_forward(buf, torch.zeros(joints.shape[0], 48), shape)
    return target.contiguous(), (template / 1000.0).contiguous()


def test_ik_solve_op_passes_opcheck(mano):
    joints, shape = _fk_joints(mano, 0, 4)
    torch.library.opcheck(torch.ops.hoisdf_torch.ik_solve.default,
                          _solve_inputs(mano, joints, shape))


def test_dispatcher_equals_the_solver_before_the_op(mano):
    joints, shape = _fk_joints(mano, 1, 6)
    got = ik_solver_mano(mano, joints, shape)
    target, template = _solve_inputs(mano, joints, shape)
    pose, valid = ik_solve_plain(target, template)
    verts, out_joints = mano_forward(mano, pose, shape)
    root = joints[:, :1]
    assert torch.equal(got["pose"], pose) and torch.equal(got["vis"][:, 0], valid)
    assert torch.equal(got["verts"], verts / 1000.0 + root)
    assert torch.equal(got["joints"], out_joints / 1000.0 + root)
    assert valid.tolist() == [0, 1, 0, 1, 0, 1]  # the mirrored frames are reflections
    assert float(got["pose"][::2].abs().max()) == 0.0 and float(got["pose"][1::2].abs().max()) > 0


# ---- the kernel's arithmetic, walked in numpy ----------------------------------

SWEEPS = 6  # csrc/ik.cu's kSweeps


def _kabsch_rotation(h):
    """csrc/ik.cu::kabsch_rotation: one-sided Jacobi on h's columns."""
    w, v = h.astype(f32).copy(), np.eye(3, dtype=f32)
    for _ in range(SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            a, b, g = (f32((w[:, p] * w[:, p]).sum()), f32((w[:, q] * w[:, q]).sum()),
                       f32((w[:, p] * w[:, q]).sum()))
            if g == 0:
                continue
            zeta = (b - a) / (f32(2) * g)
            t = np.copysign(f32(1), zeta) / (abs(zeta) + np.sqrt(f32(1) + zeta * zeta))
            c = f32(1) / np.sqrt(f32(1) + t * t)
            s = c * t
            for m in (w, v):
                mp, mq = m[:, p].copy(), m[:, q].copy()
                m[:, p], m[:, q] = c * mp - s * mq, s * mp + c * mq
    n = np.sqrt((w * w).sum(0))
    k3 = int(np.argmin(n))
    k1, k2 = [k for k in range(3) if k != k3]
    u = np.zeros((3, 3), f32)
    u[:, k1], u[:, k2] = w[:, k1] / n[k1], w[:, k2] / n[k2]
    cr = np.cross(u[:, k1], u[:, k2])
    u[:, k3] = cr * (f32(-1) if (w[:, k3] * cr).sum() < 0 else f32(1))
    return v @ u.T


def _kernel_solve(target, template):
    """csrc/ik.cu's solve of each frame, in f32 numpy (the rotation's
    axis-angle and the Rodrigues matrices through the port's own
    ``mat2aa`` / ``batch_rodrigues``, whose conventions the kernel copies)."""
    from hoisdf_torch.ops.rotations import batch_rodrigues, mat2aa

    pose = np.zeros((target.shape[0], 48), f32)
    valid = np.zeros(target.shape[0], np.int32)
    for i, (x, t) in enumerate(zip(target, template)):
        a = np.stack([t[k] - t[0] for k in KNUCKLES], 1)
        b = np.stack([x[k] - x[0] for k in KNUCKLES], 1)
        rot = _kabsch_rotation(a @ b.T)
        if np.linalg.det(rot.astype(np.float64)) <= 0:  # a reflection
            continue
        valid[i] = 1
        pose[i, :3] = mat2aa(T(rot)[None])[0].numpy()
        for g, chain in enumerate(FINGER_LIST):
            recon, rpa = np.zeros(3, f32), rot
            for j in range(2, 5):
                vt = t[chain[j]] - t[chain[j - 1]]
                recon = rpa @ (t[chain[j - 1]] - t[chain[j - 2]]) + recon
                vx = rpa.T @ (x[chain[j]] - recon)
                axis = np.cross(vt, vx)
                axis = axis / (np.sqrt((axis * axis).sum()) + f32(1e-7))
                cos = (vt * vx).sum() / (np.sqrt((vt * vt).sum()) + f32(1e-7)) / (
                    np.sqrt((vx * vx).sum()) + f32(1e-7))
                aa = (np.arccos(np.clip(cos, f32(-1 + 1e-7), f32(1 - 1e-7))) * axis).astype(f32)
                pose[i, 3 * (3 * g + j - 1):3 * (3 * g + j)] = aa
                rpa = rpa @ batch_rodrigues(T(aa)[None])[0].numpy()
    return pose, valid


@pytest.mark.parametrize("case", ["hands", "random_joints"])
def test_kernel_arithmetic_matches_the_plain_twin(mano, case):
    """The flag bit for bit; the pose within 1e-4 rad on hands (FK joints,
    half of them mirrored) and on random joints (the voted joints of an
    untrained model look like these)."""
    if case == "hands":
        joints, shape = _fk_joints(mano, 2, 16)
    else:
        rng = np.random.RandomState(3)
        joints = T((rng.randn(16, 21, 3) * 0.05).astype(f32))
        shape = T((rng.randn(16, 10) * 0.3).astype(f32))
    target, template = _solve_inputs(mano, joints, shape)
    want_pose, want_valid = ik_solve_plain(target, template)
    pose, valid = _kernel_solve(target.numpy(), template.numpy())
    np.testing.assert_array_equal(valid, want_valid.numpy())
    assert 0 < valid.sum() < len(valid)
    np.testing.assert_allclose(pose, want_pose.numpy(), rtol=0, atol=1e-4)


# ---- the eval step and the predictor ----------------------------------------------

def _step(setting, mano, seed=0):
    from hoisdf_torch.models.hoisdf import build_model
    from hoisdf_torch.train import make_eval_step

    cfg = get_config(setting, **TINY)
    return cfg, make_eval_step(cfg, build_model(cfg, seed), mano, device="cpu")


def test_eval_step_solves_the_hand_as_the_evaluator_did(mano):
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch

    cfg, step = _step("ho3d_render", mano)
    inputs, _ = split_inputs_targets(synthetic_batch(cfg, 3, seed=4))
    out = step(inputs)
    joints = torch.cat([torch.zeros_like(out["hand_joints"][:, :1]), out["hand_joints"]], 1)
    want = ik_solver_mano(mano, joints, out["mano_shape"])
    assert torch.equal(out["mano_joints"], want["joints"])
    assert torch.equal(out["mano_verts"], want["verts"])
    assert torch.equal(out["mano_pose"], want["pose"])
    assert torch.equal(out["ik_valid"], want["vis"][:, 0])
    assert out["mano_verts"].shape == (3, 778, 3) and out["mano_pose"].shape == (3, 48)
    _, dex = _step("dexycb", mano)
    dex_out = dex(split_inputs_targets(synthetic_batch(get_config("dexycb", **TINY), 2))[0])
    assert "mano_pose" not in dex_out and "ik_valid" not in dex_out


def test_predictor_serves_the_meshes_for_ho3d_render(monkeypatch):
    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.predictor import INPUT_KEYS, SERVE_KEYS, Predictor

    cfg = get_config("ho3d_render", **TINY)
    pred = Predictor(cfg, batch_size=2, transfer_dtype="uint8", device="cpu")
    pred.warmup()
    assert tuple(pred.output_shapes) == SERVE_KEYS
    frames = {k: v for k, v in synthetic_batch(cfg, 2, seed=5).items() if k in INPUT_KEYS}
    pred.materialize(*pred.predict_async(frames))
    calls = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                           _fn(*a, **k))[1])
    handle, n = pred.predict_async(frames)
    monkeypatch.undo()
    assert calls == []
    served = pred.materialize(handle, n)
    assert set(served) == set(SERVE_KEYS) and served["mano_verts"].shape == (2, 778, 3)
    assert np.isfinite(served["mano_verts"]).all() and np.abs(served["mano_joints"]).max() > 0


def test_eval_step_matches_the_benchmark_reference(mano):
    """The port's step on the benchmark's seeded weights and frames against
    ``reference/model_ik.py`` (following the port's points, which in f32 are
    the reference's own) and the reference IK on the port's joints."""
    from benchmark import judge, shared
    from benchmark.core import reference_config
    from benchmark.inputs.frames import make_batch
    from benchmark.inputs.seeds import rng
    from benchmark.inputs.weights_ik import make_state_dict_ik
    from benchmark.reference.ik import ik_hand
    from benchmark.reference.mano_layer import ManoBuffers as RefBuffers
    from benchmark.reference.model_ik import HOISDFIK
    from hoisdf_torch.models.hoisdf import HOISDF
    from hoisdf_torch.train import make_eval_step

    from benchmark.tests.tiny import TINY_F32

    cfg = get_config("ho3d_render", **TINY_F32, transfer_dtype="uint8")
    ref_cfg = reference_config(cfg)
    sd = make_state_dict_ik(ref_cfg, 11, torch.device("cpu"))
    model = HOISDF(cfg)
    model.load_state_dict(sd, strict=True)
    step = make_eval_step(cfg, model, mano, device="cpu")
    reader = shared.ProgramReader(model)
    batch_np = make_batch(cfg, 3, rng(5, "frames"), supervise=False)
    prog = step(batch_np)
    picks = reader.take()
    reader.remove()
    ref = HOISDFIK(ref_cfg).eval()
    ref.load_state_dict(sd, strict=True)
    batch = shared.on_device(batch_np, torch.device("cpu"))
    with torch.no_grad():
        own = ref(dict(batch), supervise_sdf=False)
    assert torch.equal(own["hand_points"], picks["hand"])
    assert torch.equal(own["obj_points"], picks["obj"])
    from benchmark.reference.steps import vote_hand_joints

    want = {"hand_joints": vote_hand_joints(own), "mano_shape": own["mano_shape"][-1],
            "obj_rot": own["obj_rot"][-1], "obj_trans": own["obj_trans"][-1],
            "hand_off": own["hand_off"], "hand_cls": own["hand_cls"]}
    assert judge.worst(judge.output_gaps(prog, want, list(want)))[0] < 1e-5
    ref_mano = RefBuffers(*mano)
    hand = ik_hand(ref_mano, prog["hand_joints"], prog["mano_shape"])
    for k in ("mano_joints", "mano_verts", "mano_pose"):
        assert float((prog[k] - hand[k]).abs().max()) < 1e-5, k
    assert torch.equal(prog["ik_valid"], hand["ik_valid"])


# ---- on a card --------------------------------------------------------------------

def test_kernel_matches_the_plain_twin_on_the_card(mano):
    """The flag bit for bit, the pose within 1e-4 rad, on hands with
    reflected frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU build")
    from hoisdf_torch.ops.kernels import launch_counts
    from hoisdf_torch.ops.kernels.ik import ik_solve

    joints, shape = _fk_joints(mano, 6, 64)
    target, template = _solve_inputs(mano, joints, shape)
    want_pose, want_valid = ik_solve_plain(target, template)
    before = launch_counts["ik_solve"]
    pose, valid = ik_solve(target.cuda(), template.cuda())
    assert launch_counts["ik_solve"] == before + 1
    assert torch.equal(valid.cpu(), want_valid)
    assert float((pose.cpu() - want_pose).abs().max()) < 1e-4
