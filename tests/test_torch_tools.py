"""The port's numpy tools and its profiling module against the JAX
package's, on the JAX tests' synthetic inputs: MANO ``.pkl`` conversion
(plain, scipy-sparse and chumpy-wrapped arrays, ``tests/test_utils_tools.py``)
and the ``.npz`` round trip; SDF preprocessing on synthetic AlignSDF dumps
(``tests/test_tools.py``), the CLI with and without ``--index-dict``;
``synth_weights``; ``StepStats`` fed the same durations; ``capture_trace``.
Every comparison is bit for bit: both sides run the same numpy."""

import glob
import os
import pickle
import sys
import time
import types

import numpy as np
import pytest
import torch

from hoisdf_torch.mano import model as pmodel
from hoisdf_torch.tools import preprocess_sdf as psdf
from hoisdf_torch.tools import synth_weights as psynth
from hoisdf_torch.tools.convert_mano_pkl import main as convert_main
from hoisdf_torch.utils import profiling as pprof
from hoisdf_tpu.mano import model as jmodel
from hoisdf_tpu.tools import preprocess_sdf as jsdf
from hoisdf_tpu.tools import synth_weights as jsynth
from hoisdf_tpu.utils import profiling as jprof

from test_tools import _make_alignsdf_fixture
from test_utils_tools import _mano_pkl_payload

FIELDS = ("betas", "shapedirs", "posedirs", "v_template", "j_regressor", "weights", "faces",
          "hands_components", "hands_mean", "side")


def _assert_models_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y), f


def test_convert_mano_pkl_plain_and_sparse(tmp_path):
    scipy_sparse = pytest.importorskip("scipy.sparse")
    data = _mano_pkl_payload(np.random.default_rng(0))
    plain = tmp_path / "MANO_RIGHT.pkl"
    with open(plain, "wb") as f:
        pickle.dump(data, f)
    data["J_regressor"] = scipy_sparse.csc_matrix(data["J_regressor"])
    sparse = tmp_path / "MANO_LEFT.pkl"
    with open(sparse, "wb") as f:
        pickle.dump(data, f)
    for path, side in ((plain, "right"), (sparse, "left")):
        got = pmodel.convert_mano_pkl(str(path))
        assert got.side == side
        _assert_models_equal(got, jmodel.convert_mano_pkl(str(path)))


def test_convert_mano_pkl_chumpy_objects(tmp_path, monkeypatch):
    """chumpy.Ch-wrapped arrays (the real pkl layout) unpickle through the
    port's own stub, without chumpy."""
    fake = types.ModuleType("chumpy")

    class Ch:
        pass

    Ch.__module__, Ch.__qualname__ = "chumpy", "Ch"
    fake.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", fake)
    data = _mano_pkl_payload(np.random.default_rng(1))
    want = data["shapedirs"].copy()
    wrapped = Ch()
    wrapped.__dict__["x"] = data["shapedirs"]
    data["shapedirs"] = wrapped
    path = tmp_path / "MANO_RIGHT.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    monkeypatch.delitem(sys.modules, "chumpy")
    got = pmodel.convert_mano_pkl(str(path), side="right")
    assert sys.modules["chumpy"].Ch.__module__ == pmodel.__name__
    np.testing.assert_array_equal(got.shapedirs, want.astype(np.float32))
    monkeypatch.delitem(sys.modules, "chumpy")
    _assert_models_equal(got, jmodel.convert_mano_pkl(str(path), side="right"))


def test_save_load_npz_round_trip_and_cli(tmp_path):
    m = pmodel.make_synthetic_mano(2, side="left")
    npz = tmp_path / "m.npz"
    pmodel.save_mano_npz(m, str(npz))
    _assert_models_equal(pmodel.load_mano_npz(str(npz)), m)
    _assert_models_equal(jmodel.load_mano_npz(str(npz)), m)
    assert m.tips == jmodel.make_synthetic_mano(2, side="left").tips == pmodel.TIPS_LEFT

    pkl = tmp_path / "MANO_LEFT.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(_mano_pkl_payload(np.random.default_rng(3)), f)
    out = tmp_path / "left.npz"
    sys_argv = sys.argv
    try:
        sys.argv = ["convert_mano_pkl", str(pkl), str(out)]
        convert_main()
    finally:
        sys.argv = sys_argv
    _assert_models_equal(pmodel.load_mano_npz(str(out)), jmodel.convert_mano_pkl(str(pkl)))


@pytest.mark.parametrize("hand", [True, False])
@pytest.mark.parametrize("opts", [{}, {"clamp": 0.05, "filter_dist": True, "dist": 0.15}])
def test_unpack_sdf_samples_matches_jax(tmp_path, hand, opts):
    key = _make_alignsdf_fixture(str(tmp_path))
    got = psdf.unpack_sdf_samples(str(tmp_path), key, hand=hand, **opts)
    want = jsdf.unpack_sdf_samples(str(tmp_path), key, hand=hand, **opts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_process_frame_and_scales_match_jax(tmp_path):
    key = _make_alignsdf_fixture(str(tmp_path))
    counts = psdf.process_frame(str(tmp_path), key, str(tmp_path / "port"))
    assert counts == jsdf.process_frame(str(tmp_path), key, str(tmp_path / "jax"))
    a, b = (np.load(tmp_path / side / "sdf_processed" / f"{key}.npy") for side in ("port", "jax"))
    assert a.dtype == np.float32 and np.array_equal(a, b)

    joints = lambda k: np.asarray([[0.05, -0.02, 0.4]], np.float32)
    for g, w in zip(psdf.compute_scales(str(tmp_path), [key], joints),
                    jsdf.compute_scales(str(tmp_path), [key], joints)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("index_dict", [False, True])
def test_preprocess_cli_matches_jax(tmp_path, monkeypatch, index_dict):
    src = tmp_path / "dump"
    keys = [_make_alignsdf_fixture(str(src), key=k) for k in ("s1_0002", "s1_0001")]
    for mod, out in ((psdf, "port"), (jsdf, "jax")):
        argv = ["preprocess_sdf", str(src), str(tmp_path / out)]
        monkeypatch.setattr(sys, "argv", argv + (["--index-dict"] if index_dict else []))
        mod.main()
    for key in keys:
        a, b = (np.load(tmp_path / out / "sdf_processed" / f"{key}.npy") for out in ("port", "jax"))
        assert np.array_equal(a, b)
    a, b = (np.load(tmp_path / out / "sdf_index.npy", allow_pickle=index_dict)
            for out in ("port", "jax"))
    if index_dict:
        a, b = a.item(), b.item()
        assert sorted(a) == sorted(keys) and all(np.array_equal(a[k], b[k]) for k in keys)
    else:
        assert a.shape == (2, 2) and np.array_equal(a, b)


def test_synth_weights_match_jax():
    items = [("conv1.weight", (8, 3, 7, 7)), ("bn1.running_var", (8,)),
             ("bn1.running_mean", (8,)), ("bn1.weight", (8,)), ("bn1.bias", (8,)),
             ("fc.weight", (10, 8)), ("deconv.weight", (8, 4, 4, 4))]
    spec = psynth.spec_from_items(items)
    assert spec == jsynth.spec_from_items(items)
    for seed in (0, 5):
        got, want = psynth.synth_state_dict(spec, seed), jsynth.synth_state_dict(spec, seed)
        assert list(got) == list(want)
        assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                   for k in got)
    assert np.array_equal(psynth.synth_value("x.bias", (3,), 1),
                          jsynth.synth_value("x.bias", (3,), 1))


def _fed(stats, durations, monkeypatch):
    """Run ``stats.measure`` over ``durations`` on a fake clock; a step that
    raises is not a sample."""
    clock = iter(np.cumsum([0.0] + [d for dur in durations for d in (dur, 0.5)]).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    for i, _ in enumerate(durations):
        try:
            with stats.measure():
                if i == 3:
                    raise RuntimeError("step failed")
        except RuntimeError:
            pass
    monkeypatch.undo()
    return stats.summary()


@pytest.mark.parametrize("n,window", [(0, 200), (7, 200), (250, 200), (9, 4)])
def test_step_stats_summaries_match_jax(monkeypatch, n, window):
    durations = np.random.RandomState(n).uniform(0.001, 0.05, n).tolist()
    got = _fed(pprof.StepStats(window), durations, monkeypatch)
    want = _fed(jprof.StepStats(window), durations, monkeypatch)
    assert got == want and (got == {} if n == 0 else got["n"] == min(n - (n > 3), window))


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with pprof.capture_trace(d):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1 and "aten::mm" in open(files[0]).read()


def test_capture_trace_prints_and_carries_on_when_start_fails(tmp_path, monkeypatch, capsys):
    def boom(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", boom)
    ran = []
    with pprof.capture_trace(str(tmp_path / "trace")):
        ran.append(1)
    assert ran == [1] and "trace capture unavailable" in capsys.readouterr().out
    assert not (tmp_path / "trace").exists()
