"""The port's kernels as ``torch.library`` custom ops (``hoisdf_torch::
sdf_mlp``, ``gather_lerp``, ``gather_lerp_bwd``), on the CPU: each op's CPU
implementation (the plain version) through ``torch.library.opcheck`` (its
schema, fake implementation, autograd registration and traced dispatch);
the fake implementations at a symbolic batch through ``torch.export``; the
gather's gradient through ``register_autograd`` against
``gather_lerp_bwd_plain``, bit for bit; and that a trace's fake tensors
never reach the per-device constant caches.  The CUDA implementations run
only on the card (``chip_smoke.py``)."""

import pytest
import torch

import hoisdf_torch.ops.kernels  # noqa: F401  (registers the ops)
from hoisdf_torch.ops.device_cache import device_cache
from hoisdf_torch.ops.kernels.gather_lerp import (
    bwd_plan,
    gather_lerp,
    gather_lerp_bwd,
    gather_lerp_bwd_plain,
    gather_lerp_plain,
    gather_nearest_plain,
)
from hoisdf_torch.ops.kernels.sdf_mlp import prepare_weights, sdf_mlp, sdf_mlp_plain

from torch_port_util import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPS = torch.ops.hoisdf_torch
# two levels past 256 cells (the backward's global route) and two within it
# (its shared route), so the global route's buffer holds more than one level
LEVELS = ((20, 20, 8), (17, 17, 4), (8, 8, 16), (4, 4, 12))
IN_DIM, HIDDEN = 12, (16, 16, 16, 16)


def _maps(dtype, b=2, grad=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, *s, generator=g).to(dtype).requires_grad_(grad) for s in LEVELS]


def _grid(b=2, p=9, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, p, 2, generator=g) * 2.2 - 1.1


def _mlp_weights(dtype, seed=2):
    g = torch.Generator().manual_seed(seed)
    h, shapes = HIDDEN, []
    for fan_in, fan_out in ((IN_DIM, h[0]), (h[0], h[1]), (h[1] + IN_DIM, h[2]), (h[2], h[3]),
                            (h[3], 1)):
        shapes += [(fan_in, fan_out), (fan_out,)]
    return prepare_weights([torch.randn(*s, generator=g) * 0.3 for s in shapes], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdf_mlp_op_passes_opcheck(dtype):
    w = _mlp_weights(dtype)
    x = torch.randn(33, IN_DIM).to(dtype)
    torch.library.opcheck(OPS.sdf_mlp.default, (x, list(w.plain), *w.packed))
    assert torch.equal(sdf_mlp(x, w), sdf_mlp_plain(x, w.plain))


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_lerp_op_passes_opcheck(dtype, nearest):
    maps = _maps(dtype, grad=not nearest)
    torch.library.opcheck(OPS.gather_lerp.default, (_grid(), maps, nearest))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_lerp_bwd_op_passes_opcheck(dtype):
    g = torch.randn(2, 9, sum(s[2] for s in LEVELS)).to(dtype)
    dims = [d for s in LEVELS for d in s]
    torch.library.opcheck(OPS.gather_lerp_bwd.default, (_grid(), g, dims, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_give_the_plain_versions(dtype):
    grid, maps = _grid(), _maps(dtype)
    assert torch.equal(gather_lerp(grid, maps), gather_lerp_plain(grid, maps))
    assert torch.equal(gather_lerp(grid, maps, nearest=True), gather_nearest_plain(grid, maps))
    g = torch.randn(2, 9, sum(s[2] for s in LEVELS)).to(dtype)
    got = gather_lerp_bwd(grid, g, LEVELS, dtype)
    want = gather_lerp_bwd_plain(grid, g, LEVELS, dtype)
    assert [tuple(t.shape) for t in got] == [(2, *s) for s in LEVELS]
    assert all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert sum(sl == 0 for sl, _ in bwd_plan(LEVELS)) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_gradient_through_register_autograd_is_the_plain_backward(dtype):
    grid, maps = _grid().requires_grad_(True), _maps(dtype, grad=True)
    out = gather_lerp(grid, maps)
    g = torch.randn(out.shape).to(dtype)
    out.backward(g)
    want = gather_lerp_bwd_plain(grid.detach(), g, LEVELS, dtype)
    assert all(m.grad.dtype == dtype and torch.equal(m.grad, w) for m, w in zip(maps, want))
    assert grid.grad is None  # the grid is detached
    with pytest.raises(ValueError, match="forward only"):
        gather_lerp(grid, maps, nearest=True)


class _Kernels(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = _mlp_weights(torch.float32)

    def forward(self, grid, *maps):
        feats = gather_lerp(grid, maps)
        near = gather_lerp(grid, maps, nearest=True)
        sdf = sdf_mlp(feats[..., :IN_DIM].reshape(-1, IN_DIM).contiguous(), self.w)
        return feats, near, sdf


def test_ops_export_at_a_symbolic_batch():
    b = torch.export.Dim("b", min=1, max=64)
    grid, maps = _grid(), _maps(torch.float32)
    prog = torch.export.export(_Kernels(), (grid, *maps),
                               dynamic_shapes=({0: b}, ({0: b},) * len(maps)))
    targets = {str(n.target) for n in prog.graph.nodes if n.op == "call_function"}
    assert {"hoisdf_torch.gather_lerp.default", "hoisdf_torch.sdf_mlp.default"} <= targets
    feats, near, sdf = (n.meta["val"] for n in prog.graph.nodes if n.op == "output"
                        for n in n.args[0])
    assert all(isinstance(t.shape[0], torch.SymInt) for t in (feats, near, sdf))
    assert feats.shape[2] == sum(s[2] for s in LEVELS) and sdf.shape[1] == 1
    for batch in (1, 3):
        grid, maps = _grid(batch, seed=batch), _maps(torch.float32, batch, seed=batch)
        got = prog.module()(grid, *maps)
        want = _Kernels()(grid, *maps)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_device_constants_stay_out_of_a_trace():
    made = []

    @device_cache()
    def constant(device):
        made.append(device)
        return torch.arange(4, device=device)

    class Uses(torch.nn.Module):
        def forward(self, x):
            return x + constant(x.device)

    torch.export.export(Uses(), (torch.zeros(4),))
    assert constant.cache_info().currsize == 0  # the trace built its own
    eager = constant(torch.device("cpu"))
    assert type(eager) is torch.Tensor and constant(torch.device("cpu")) is eager
    assert len(made) == 2
