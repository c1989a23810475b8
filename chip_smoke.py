"""Drive the PyTorch port (hoisdf_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   - nvcc builds the CUDA kernels from hoisdf_torch/csrc into
             hoisdf_torch/_build (sm_90a); seconds, card name, power limit.
2. kernel  - each kernel against its plain PyTorch version on the card, f32
             and bf16, at the serving shapes, with its time, the plain
             version's time, one stock PyTorch call's time and its bound.
             The SDF MLP is checked at ragged row counts around its tile
             sizes (32 rows f32, 64 bf16), smallest first, and timed in bf16
             at each of the eight row counts of a serving step (their sum is
             step_ms).  Its biases are drawn, and each must move the output
             by more than the tolerance.  The gather is also timed on its
             fine levels (0-2) and its coarse levels (3-4) alone.  The SDF
             MLP is also timed in f32 at the same eight row counts (the
             field-guided train step's launches; f32_step_ms), at the
             largest alone (f32_ms), and with the f32 weight packing that
             each field runs before its launches (f32_pack_ms,
             f32_step_with_packing_ms).  The gather's backward is checked at
             the train step's largest launch, f32 and bf16 maps, on a uniform, a
             clustered and a border grid, and timed per level group; its byte
             bound counts g and the grid read and d/dfeat written once (the
             f32 zero-fill of its global route is printed beside).
             The gather is also checked and timed on the ho3d preset's
             DecoderBig pyramid (3,968 channels, no level staged), bf16 and
             f32, bit-identical to its plain version.
3. forward - the full-width eval forward of dexycb, ho3d (DecoderBig) and
             ho3d_render (the IK head), batch 2, f32 with TF32 off: card
             (through the kernels) against CPU (plain versions), with drawn
             SDF decoder biases; one line each, with whether two card
             forwards are bitwise equal.
4. serve   - the main path: a dexycb Predictor at bf16, batch 22, answers
             40 requests on each of the u8 and the f32 wire, in turn; p50
             and p90 latency, frames/s, peak memory, kernel launches per step
             (from the wrappers' counters, zeroed just before the requests).
5. train   - the dexycb preset at full width (f32, batch 22) trains through
             the port's make_train_step: presampled and field-guided steps
             (branches forced through presample_gate), median ms per step,
             peak memory, per-step launches of each kernel (counts zeroed
             just before each branch's timed steps), finite losses, a
             torch.profiler breakdown of one field-guided step, and the
             gather's backward held and timed on the grids and gradients of
             one field-guided step's launches (the kernels line quotes its
             largest).  TF32 stays off, as the port's entry points set it.
6. train_check - one presampled train step on the card against the CPU at
             full width, batch 2, f32, TF32 off, dropout off, no jitter:
             every loss and the gradient norm of every parameter group, the
             card's ReLUs passing the elements that the CPU's passed
             (differing from its own decisions at near-ties only).
   Then the same two phases (without the profile) for ho3d, whose DecoderBig
   runs the gather's backward at 3,968 channels, and ho3d_render, which
   trains the IK head's shape losses; before them the backward is checked on
   the ho3d pyramid as on the dexycb one (`"pyramid": "ho3d"` kernel lines),
   and each train phase holds and times it on one field-guided step's
   launches.  The train, train_check and kernel lines carry `setting`.
7. data    - DexYCB and HO3D from disk: trees in the original's layout at
             640 x 480 (tests/torch_data_fixtures.py) in a temporary
             directory; the loader timed in thread and process mode beside
             the dexycb train step; train_loop.main trains dexycb at full
             width for three iterations with the test split's eval at its
             snapshot; evaluate.main evaluates that snapshot on the DexYCB
             test split and random weights on the HO3D evaluation split (the
             codalab JSON); outputs present and finite, kernels launched.
8. eval    - each preset (dexycb, dexycb_full, ho3d, ho3d_render) at full
             width, bf16, batch 22, u8 wire: the port's Evaluator over three
             synthetic batches through make_eval_step on the card, by
             evaluate_batches (the lookahead loop of evaluate.main): every
             result, the eval step's device ms and the metrics' ms per batch
             apart, peak memory, kernel launches (counts zeroed just before
             the three batches).  The mesh metrics of dexycb_full and the IK
             of ho3d_render run on the card.  Then eval_check: one batch of
             card outputs through the Evaluator on the card and on the CPU.
9. kernels - one line listing every kernel with the numbers this run took
             (the backward's `ho3d_*` fields from the ho3d train step, and
             every kernel's launches per preset's train phase).

Any failed check raises, and the script exits non-zero.  The last line is
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints no result.
Weights are random, made from a seed; MANO is the synthetic stand-in.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12  # CUDA-core f32 peak
H100_HBM_BYTES = 3.35e12

SDF_TPU = "hoisdf_tpu/ops/pallas/sdf_mlp.py:63"
# Rows per image that the dexycb hier cascade scores, stage by stage: the
# hand field, then the object field.  One serving step launches the SDF MLP
# once for each, on batch x rows.
SERVING_ROWS_PER_IMAGE = (512, 1024, 1792, 3584, 512, 832, 1472, 2944)
# around the f32 tile (32 rows), 48 rows, and the bf16 tile (64 rows)
RAGGED_ROWS = (1, 31, 32, 33, 47, 48, 49, 63, 64, 65, 127, 128, 129, 255, 257)
GATHER_TPU = "hoisdf_tpu/ops/pallas/gather_lerp.py:89"
GATHER_BWD_TPU = "hoisdf_tpu/ops/grid_sample.py:239"  # _gsb_fast_bwd (a custom VJP)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events).
    The card first sleeps for longer than the host takes to enqueue the calls
    (measured on the warmup), so a call whose host time exceeds its device
    time is still timed on the device and not on the host."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # 2e9 cycles a second bounds the card's clock from above
    torch.cuda._sleep(int(min(2.0 * iters * host_s, 1.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, flop_rate: float, nbytes: float):
    t_ops, t_bytes = flops / flop_rate * 1e3, nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- phase 2: kernels against their plain versions ---------------------------

def _bias_effect(x, weights) -> float:
    """The least change in the plain output, over the five biases, that
    zeroing one bias makes: a kernel that drops a bias misses by this much."""
    import torch

    from hoisdf_torch.ops.kernels.sdf_mlp import sdf_mlp_plain

    base = sdf_mlp_plain(x, weights)
    effects = []
    for j in (1, 3, 5, 7, 9):
        w = list(weights)
        w[j] = torch.zeros_like(w[j])
        effects.append((sdf_mlp_plain(x, w) - base).abs().max().item())
    return min(effects)


def check_sdf_mlp(device, batch: int, seed: int = 0):
    """Check the SDF MLP at ragged row counts (smallest first, so that a
    kernel that cannot finish is met at a few rows), then time it in bf16 at
    the row counts of a serving step."""
    import torch
    import torch.nn.functional as F

    from hoisdf_torch.models.hoisdf import init_weights
    from hoisdf_torch.models.sdf_decoder import SDFDecoder
    from hoisdf_torch.ops.kernels.sdf_mlp import (
        fold_weight_norm, prepare_weights, sdf_mlp, sdf_mlp_plain)

    g = torch.Generator().manual_seed(seed)
    step_rows = [batch * r for r in SERVING_ROWS_PER_IMAGE]
    rows_big = max(step_rows)
    timed = None
    for latent in (256, 64):
        sizes = RAGGED_ROWS + (rows_big + 37 if latent == 256 else 2 * 3584 + 37,)
        dec = init_weights(SDFDecoder(latent, 33), seed)
        # Spread the gains so every layer's output matters, and draw every
        # bias (the init zeroes them), so that a dropped or misread bias shows.
        with torch.no_grad():
            for i in range(5):
                lin = getattr(dec, f"linh{i}")
                lin.bias.uniform_(-0.5, 0.5, generator=g)
                if i < 4:
                    lin.weight_g.uniform_(0.5, 1.5, generator=g)
        folded = [w.to(device) for w in fold_weight_norm(dec)]
        x32 = (torch.randn(sizes[-1], latent + 33, generator=g) * 0.5).to(device)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            weights = prepare_weights(folded, dtype)
            errs, finite = {}, True
            for n in sizes:
                x = x32[:n].to(dtype).contiguous()
                got = sdf_mlp(x, weights)
                torch.cuda.synchronize()
                want = sdf_mlp_plain(x, weights.plain)
                errs[n] = (got - want).abs().max().item()
                finite = finite and bool(torch.isfinite(got).all())
                if not (finite and errs[n] <= tol):
                    raise AssertionError(
                        f"sdf_mlp ({latent + 33} wide, {dtype}) disagrees with its plain "
                        f"version at {n} rows: max abs err {errs[n]}, tol {tol}")
            # a view that starts one row in: rows of odd width then sit on
            # 2-byte, not 16-byte, addresses, and the kernel loads them singly
            x_off = x[1:130]
            got = sdf_mlp(x_off, weights)
            torch.cuda.synchronize()
            errs["129 from row 1"] = (got - sdf_mlp_plain(x_off, weights.plain)).abs().max().item()
            if not errs["129 from row 1"] <= tol:
                raise AssertionError(f"sdf_mlp ({latent + 33} wide, {dtype}) disagrees with its "
                                     f"plain version on an unaligned view: {errs}")
            err = max(errs.values())
            effect = _bias_effect(x, weights.plain)
            ok = finite and err <= tol < effect
            res = {"phase": "kernel", "kernel": "sdf_mlp", "in_dim": latent + 33,
                   "hidden": folded[0].shape[1], "rows": list(sizes), "dtype": str(dtype)[6:],
                   "max_abs_err": err, "err_by_rows": errs, "tol": tol,
                   "least_bias_effect": effect, "ok": ok}
            if latent == 256:
                wb = weights.plain
                size = 2 if dtype == torch.bfloat16 else 4
                rate = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
                macs = sum(w.numel() for w in wb[0::2])
                w_bytes = sum(w.numel() * size for w in wb)

                def library(xs):  # the stock matmul chain (cuBLAS; TF32 off in f32)
                    h = F.relu(F.linear(xs, wb[0].t(), wb[1]))
                    h = F.relu(F.linear(h, wb[2].t(), wb[3]))
                    h = F.relu(F.linear(torch.cat([h, xs], -1), wb[4].t(), wb[5]))
                    h = F.relu(F.linear(h, wb[6].t(), wb[7]))
                    return torch.tanh(F.linear(h, wb[8].t(), wb[9]))

                def bound_for(rows):
                    return bound(2.0 * rows * macs, rate,
                                 rows * (x.shape[1] * size + 4) + w_bytes)

                # one step: the eight launches of the two cascades (serving in
                # bf16, the field-guided train step in f32)
                by_rows, lib_by_rows, plain_by_rows = {}, {}, {}
                for rows in sorted(set(step_rows)):
                    xr = x[:rows].contiguous()
                    by_rows[rows] = time_ms(lambda: sdf_mlp(xr, weights))
                    lib_by_rows[rows] = time_ms(lambda: library(xr))
                    plain_by_rows[rows] = time_ms(lambda: sdf_mlp_plain(xr, wb), iters=3)
                step = {"step_rows": step_rows, "ms_by_rows": by_rows,
                        "step_ms": sum(by_rows[r] for r in step_rows),
                        "step_bound_ms": sum(bound_for(r)[0] for r in step_rows),
                        "step_library_ms": sum(lib_by_rows[r] for r in step_rows),
                        "step_plain_ms": sum(plain_by_rows[r] for r in step_rows)}
                if dtype == torch.float32:
                    # the eight launches, and the largest alone
                    f32_step = {"f32_" + k: v for k, v in step.items() if k != "step_rows"}
                    f32_step.update({
                        "f32_ms": by_rows[rows_big], "f32_bound_ms": bound_for(rows_big)[0],
                        "f32_library_ms": lib_by_rows[rows_big],
                        "f32_plain_ms": plain_by_rows[rows_big], "f32_max_abs_err": err})
                    f32_step.update(time_f32_packing(folded, x, step_rows))
                    res.update(f32_step)
                else:
                    b_ms, b_by = bound_for(rows_big)
                    timed = {"ms": by_rows[rows_big], "plain_ms": plain_by_rows[rows_big],
                             "library_ms": lib_by_rows[rows_big], "bound_ms": b_ms,
                             "bound_by": b_by, "max_abs_err": err, "rows": rows_big,
                             "dtype": "bfloat16", **step, **f32_step}
                    res.update({k: timed[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", *step)})
            emit(res)
            if not ok:
                raise AssertionError(f"sdf_mlp disagrees with its plain version, or a "
                                     f"bias would go unseen: {res}")
    return timed


def time_f32_packing(folded, x, step_rows, iters: int = 10):
    """The f32 weight packing (prepare_weights) that each field's forward
    runs once before its launches, two a field-guided step, and which the
    cuBLAS chain does not need: its device time, its host time per call
    (enqueue only), and the device time of a step's f32 work as the kernel
    does it, two packings and the eight launches."""
    import torch

    from hoisdf_torch.ops.kernels.sdf_mlp import prepare_weights, sdf_mlp

    xs = [x[:rows].contiguous() for rows in step_rows]

    def step():
        for i, xr in enumerate(xs):
            if i % (len(xs) // 2) == 0:  # each field packs its decoder once
                weights = prepare_weights(folded, torch.float32)
            sdf_mlp(xr, weights)

    prepare_weights(folded, torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        prepare_weights(folded, torch.float32)
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return {"f32_pack_ms": time_ms(lambda: prepare_weights(folded, torch.float32)),
            "f32_pack_host_ms": host_ms, "f32_step_with_packing_ms": time_ms(step)}


PYRAMID = (("stride2", 128, 32), ("stride4", 64, 64), ("stride8", 32, 128),
           ("stride16", 16, 256), ("stride32", 8, 512))


def check_gather_lerp(device, batch: int, points: int, seed: int = 1):
    import torch
    import torch.nn.functional as F

    from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp, gather_lerp_plain

    g = torch.Generator().manual_seed(seed)
    grid = (torch.rand(batch, points, 2, generator=g) * 2.2 - 1.1).to(device)
    maps32 = [torch.randn(batch, s, s, c, generator=g).to(device) for _, s, c in PYRAMID]
    timed = None
    for n_levels in (3, 5):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            maps = [m.to(dtype) for m in maps32[:n_levels]]
            got = gather_lerp(grid, maps)
            torch.cuda.synchronize()
            want = gather_lerp_plain(grid, maps)
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= tol
            res = {"phase": "kernel", "kernel": "gather_lerp", "levels": n_levels,
                   "batch": batch, "points": points, "channels": got.shape[-1],
                   "dtype": str(dtype)[6:], "max_abs_err": err,
                   "bitwise_equal": bool(torch.equal(got, want)), "tol": tol, "ok": ok}
            if n_levels == 5 and dtype == torch.bfloat16:
                grid4 = grid[:, None].to(dtype)  # grid_sample wants the maps' type

                def library():  # stock grid_sample per level + concat
                    return torch.cat([F.grid_sample(
                        m.permute(0, 3, 1, 2), grid4, mode="bilinear",
                        padding_mode="border", align_corners=True) for m in maps], 1)

                nbytes = (got.numel() * 2 + sum(m.numel() * 2 for m in maps)
                          + grid.numel() * 4)
                # three lerps of four f32 operations per output value
                b_ms, b_by = bound(12.0 * got.numel(), H100_F32_FLOPS, nbytes)
                timed = {"ms": time_ms(lambda: gather_lerp(grid, maps)),
                         "plain_ms": time_ms(lambda: gather_lerp_plain(grid, maps)),
                         "library_ms": time_ms(library), "bound_ms": b_ms,
                         "bound_by": b_by, "max_abs_err": err, "dtype": "bfloat16"}
                # where the time goes: the fine and the coarse levels alone
                timed["ms_levels_0_2"] = time_ms(lambda: gather_lerp(grid, maps[:3]))
                timed["ms_levels_3_4"] = time_ms(lambda: gather_lerp(grid, maps[3:]))
                res.update({k: timed[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "ms_levels_0_2", "ms_levels_3_4")})
            emit(res)
            if not ok:
                raise AssertionError(f"gather_lerp disagrees with its plain version: {res}")
    return timed


# DecoderBig's pyramid (the ho3d preset): 3968 channels, every level larger
# per image than the kernel's shared-memory staging, so none is staged
PYRAMID_HO3D = (("stride2", 128, 128), ("stride4", 64, 256), ("stride8", 32, 512),
                ("stride16", 16, 1024), ("stride32", 8, 2048))


def check_gather_lerp_ho3d(device, batch: int, points: int, seed: int = 3):
    """The gather on the ho3d pyramid at a serving step's largest launch: the
    kernel's unstaged branch at production width.  Bit-identical to its plain
    version in f32 and bf16; timed in both against its byte bound, the plain
    version and stock grid_sample per level + concat."""
    import torch
    import torch.nn.functional as F

    from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp, gather_lerp_plain

    g = torch.Generator(device=device).manual_seed(seed)
    grid = torch.rand(batch, points, 2, generator=g, device=device) * 2.2 - 1.1
    maps32 = [torch.randn(batch, s, s, c, generator=g, device=device)
              for _, s, c in PYRAMID_HO3D]
    res = {"phase": "kernel", "kernel": "gather_lerp", "pyramid": "ho3d", "batch": batch,
           "points": points, "channels": sum(c for _, _, c in PYRAMID_HO3D),
           "levels": [list(lv[1:]) for lv in PYRAMID_HO3D]}
    ok = True
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        maps = [m.to(dtype) for m in maps32]
        got = gather_lerp(grid, maps)
        torch.cuda.synchronize()
        want = gather_lerp_plain(grid, maps)
        err = (got.float() - want.float()).abs().max().item()
        bitwise = bool(torch.equal(got, want))
        ok = ok and bitwise and bool(torch.isfinite(got).all())
        del want
        size = got.element_size()
        nbytes = got.numel() * size + sum(m.numel() * size for m in maps) + grid.numel() * 4
        b_ms, b_by = bound(12.0 * got.numel(), H100_F32_FLOPS, nbytes)
        del got
        grid4 = grid[:, None].to(dtype)

        def library():  # stock grid_sample per level + concat
            return torch.cat([F.grid_sample(
                m.permute(0, 3, 1, 2), grid4, mode="bilinear", padding_mode="border",
                align_corners=True) for m in maps], 1)

        res.update({f"{name}_max_abs_err": err, f"{name}_bitwise_equal": bitwise,
                    f"{name}_ms": time_ms(lambda: gather_lerp(grid, maps), iters=5),
                    f"{name}_plain_ms": time_ms(lambda: gather_lerp_plain(grid, maps), iters=3),
                    f"{name}_library_ms": time_ms(library, iters=3),
                    f"{name}_bound_ms": b_ms, f"{name}_bound_by": b_by,
                    f"{name}_bytes": nbytes})
        del maps
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError(f"gather_lerp on the ho3d pyramid is not bit-identical: {res}")
    return res


def _bwd_grid(kind: str, batch: int, points: int, g):
    """A uniform grid over the image and a little beyond; points packed into
    four small cells per image, as the cascade's selections are; or points
    on the corners, edges and beyond the border."""
    import torch

    if kind == "uniform":
        return torch.rand(batch, points, 2, generator=g) * 2.2 - 1.1
    if kind == "clustered":
        centres = torch.rand(batch, 4, 2, generator=g) * 1.6 - 0.8
        pick = torch.randint(0, 4, (batch, points), generator=g)
        return (torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2))
                + torch.randn(batch, points, 2, generator=g) * 0.02)
    edge = torch.tensor([-1.0, 1.0])[torch.randint(0, 2, (batch, points, 2), generator=g)]
    free = torch.rand(batch, points, 2, generator=g) * 2.4 - 1.2
    axis = torch.randint(0, 2, (batch, points, 1), generator=g).bool()
    return torch.where(axis, torch.stack([edge[..., 0], free[..., 1]], -1),
                       torch.stack([free[..., 0], edge[..., 1]], -1))


def time_gather_lerp_bwd(grid, grad, shapes, dtype):
    """The gather's backward on these inputs: the kernel's time, its plain
    version's, grid_sample's backward x5 through autograd, and the kernel on
    the fine levels (0-2) and the coarse levels (3-4) alone.  The bound
    counts what the function must move: g and the grid read once, d/dfeat
    written once in the maps' type, for all five levels and for each level
    group.  The kernel also zero-fills an f32 accumulator for the levels on
    its global route, a cost of its atomic design and not of the function:
    its bytes are printed beside the bound, not in it."""
    import torch
    import torch.nn.functional as F

    from hoisdf_torch.ops.kernels.gather_lerp import (
        bwd_plan, gather_lerp_bwd, gather_lerp_bwd_plain)

    batch, size = grid.shape[0], torch.finfo(dtype).bits // 8
    maps = [torch.zeros(batch, h, w, c, device=grid.device, requires_grad=True)
            for h, w, c in shapes]
    out = torch.cat([F.grid_sample(
        m.permute(0, 3, 1, 2), grid[:, None], mode="bilinear",
        padding_mode="border", align_corners=True)[:, :, 0] for m in maps], 1)
    grad_nchw = grad.float().permute(0, 2, 1).contiguous()

    def library():  # grid_sample's backward x5 through autograd
        return torch.autograd.grad(out, maps, grad_nchw, retain_graph=True)

    c_fine = sum(c for _, _, c in shapes[:3])
    grad_fine = grad[..., :c_fine].contiguous()
    grad_coarse = grad[..., c_fine:].contiguous()

    def bound_of(g_part, shapes_part):
        dfeat = sum(batch * h * w * c for h, w, c in shapes_part)
        nbytes = g_part.numel() * g_part.element_size() + grid.numel() * 4 + dfeat * size
        # per g value and corner: a weight product and an add
        return bound(8.0 * g_part.numel(), H100_F32_FLOPS, nbytes) + (nbytes, dfeat)

    b_ms, b_by, nbytes, dfeat = bound_of(grad, shapes)
    fine_left = [shape for shape, (sl, _) in zip(shapes, bwd_plan(shapes)) if sl == 0]
    return {"ms": time_ms(lambda: gather_lerp_bwd(grid, grad, shapes, dtype)),
            "plain_ms": time_ms(lambda: gather_lerp_bwd_plain(grid, grad, shapes, dtype),
                                iters=3),
            "library_ms": time_ms(library, iters=3),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "zero_fill_bytes": sum(batch * h * w * c for h, w, c in fine_left) * 4,
            "ms_levels_0_2": time_ms(lambda: gather_lerp_bwd(grid, grad_fine, shapes[:3], dtype)),
            "bound_levels_0_2_ms": bound_of(grad_fine, shapes[:3])[0],
            "ms_levels_3_4": time_ms(lambda: gather_lerp_bwd(grid, grad_coarse, shapes[3:],
                                                             dtype)),
            "bound_levels_3_4_ms": bound_of(grad_coarse, shapes[3:])[0]}


def bwd_error(grid, grad, shapes, dtype):
    """The backward kernel against its plain version: the largest absolute
    error, and the largest error scaled by max(1, the largest |d/dfeat|).
    The plain version's f32 sums are the reference for bf16 results too: two
    roundings to bf16 of f32 sums taken in other orders may land one bf16
    step apart (twice the one rounding that the bf16 tolerance allows)."""
    import torch

    from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp_bwd, gather_lerp_bwd_plain

    got = gather_lerp_bwd(grid, grad, shapes, dtype)
    torch.cuda.synchronize()
    want = gather_lerp_bwd_plain(grid, grad, shapes, torch.float32)
    abs_err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    scaled = max((a.float() - w.float()).abs().max().item()
                 / max(w.float().abs().max().item(), 1.0) for a, w in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    return abs_err, scaled, finite


BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def check_gather_lerp_bwd(device, batch: int, points: int, seed: int = 2,
                          pyramid=PYRAMID, pyramid_name: str = "dexycb"):
    """The gather's backward kernel against its plain version (the 4-corner
    index_add_) at the train step's largest launch on ``pyramid`` (the
    dexycb one, 992 channels, or DecoderBig's, 3,968), f32 and bf16 maps, on a
    uniform, a clustered and a border grid.  The kernel adds with f32 atomics
    in no fixed order: f32 results must agree within 1e-5 of the largest
    |d/dfeat| (or 1e-5 absolute below 1), bf16 results within one bf16
    rounding (2^-8 relative) of the plain version's f32 sums.  The uniform and the clustered grid are timed
    in f32; the train phase times the kernel on a train step's own grid."""
    import torch

    from hoisdf_torch.ops.kernels.gather_lerp import bwd_plan

    g = torch.Generator().manual_seed(seed)
    shapes = [(s, s, c) for _, s, c in pyramid]
    c_total = sum(c for _, _, c in shapes)
    grad32 = torch.randn(batch, points, c_total, generator=g).to(device)
    timed, errs = {}, {}
    for kind in ("uniform", "clustered", "border"):
        grid = _bwd_grid(kind, batch, points, g).to(device).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            abs_err, err, finite = bwd_error(grid, grad32.to(dtype), shapes, dtype)
            ok = finite and err <= BWD_TOL[name]
            errs[f"{kind}/{name}"] = abs_err
            res = {"phase": "kernel", "kernel": "gather_lerp_bwd", "pyramid": pyramid_name,
                   "grid": kind, "batch": batch, "points": points, "channels": c_total,
                   "plan": bwd_plan(shapes),
                   "dtype": name, "max_abs_err": abs_err, "max_scaled_err": err,
                   "tol_scaled": BWD_TOL[name], "ok": ok}
            if kind != "border" and dtype == torch.float32:
                timed[kind] = time_gather_lerp_bwd(grid, grad32, shapes, dtype)
                res.update(timed[kind])
            emit(res)
            if not ok:
                raise AssertionError(f"gather_lerp_bwd disagrees with its plain version: {res}")
    return {"ms_clustered": timed["clustered"]["ms"], "ms_uniform": timed["uniform"]["ms"],
            "max_abs_err": max(errs.values()), "err_by_case": errs}


# ---- phase 3: card against CPU ---------------------------------------------

def _lattice_ids(points_scaled, bins_n):
    import torch

    step = 2.0 / (bins_n - 1)
    ijk = torch.round((points_scaled.double() + 1.0) / step).long()
    return (ijk[..., 0] * bins_n + ijk[..., 1]) * bins_n + ijk[..., 2]


def build_biased_model(cfg, seed: int = 0):
    """``build_model``'s seeded weights, with the two SDF decoders' biases
    drawn uniform(-0.1, 0.1): the init zeroes them, and a kernel that
    dropped or misread a bias would then agree with its plain version."""
    import torch

    from hoisdf_torch.models.hoisdf import build_model

    model = build_model(cfg, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for dec in (model.hand_sdf_decoder, model.obj_sdf_decoder):
            for i in range(5):
                getattr(dec, f"linh{i}").bias.uniform_(-0.1, 0.1, generator=g)
    return model


HAND_KEYS = ("hand_points", "hand_sdf", "hand_points_notrans", "hand_off", "hand_cls")
OBJ_KEYS = ("obj_points", "obj_sdf", "obj_rot", "obj_trans")


def _by_lattice_id(v, ids):
    """Reorder the point axis of ``v`` ([B, P, ...] or [L, B, P, ...]) by
    lattice id, so outputs compare independently of selection order."""
    import torch

    idx = torch.argsort(ids, dim=1)
    axis = 2 if v.dim() == 4 else 1
    shape = [1] * v.dim()
    shape[axis - 1], shape[axis] = idx.shape
    idx = idx.reshape(shape).expand(*v.shape[:axis], idx.shape[1], *v.shape[axis + 1:])
    return torch.gather(v, axis, idx)


def compare_forward(cfg, batch_size: int, device, seed: int = 0, tol: float = 1e-4):
    """Eval forward on ``device`` (kernels) and on the CPU (plain versions)
    from the same seeded weights and inputs, both f32.

    The selected lattice points must agree as sets.  Per-point outputs are
    compared after sorting by lattice id: the order inside the selection
    follows |sdf|, whose near-ties can order differently when sums are taken
    in another order.  Errors are scaled by max(1, max |cpu value|).  Two
    forwards on the card must be bitwise equal."""
    import torch

    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.train import make_eval_step

    inputs = synthetic_batch(cfg, batch_size, seed=seed)
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    runs, repeat_equal, cpu_s = {}, None, 0.0
    for dev in (device, "cpu"):
        model = build_biased_model(cfg, seed)
        step = make_eval_step(cfg, model, mano, supervise_sdf=False, device=dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
            raw = model(batch, supervise_sdf=False)
            if dev != "cpu":  # is the card's forward bitwise repeatable?
                again = model(batch, supervise_sdf=False)
                repeat_equal = all(torch.equal(raw[k], again[k]) for k in raw)
        preds = step(inputs)
        runs[dev] = ({k: v.cpu() for k, v in raw.items()},
                     {k: v.cpu() for k, v in preds.items()})
        cpu_s = time.perf_counter() - t0
    (raw_d, preds_d), (raw_c, preds_c) = runs[device], runs["cpu"]

    overlap, errs, finite = {}, {}, True
    for field in ("hand", "obj"):
        ids_d = _lattice_ids(raw_d[f"{field}_points"], cfg.bins_n)
        ids_c = _lattice_ids(raw_c[f"{field}_points"], cfg.bins_n)
        overlap[field] = min(
            len(set(ids_d[b].tolist()) & set(ids_c[b].tolist())) / ids_d.shape[1]
            for b in range(ids_d.shape[0]))

    def ids_of(out, field):
        if f"{field}_points" in out:
            return _lattice_ids(out[f"{field}_points"], cfg.bins_n)
        # the eval step reports hand points as camera offsets from the root
        return _lattice_ids(out["hand_points_notrans"] * cfg.hand_sdf_scale, cfg.bins_n)

    for name, d, c in (("raw", raw_d, raw_c), ("eval", preds_d, preds_c)):
        for key in c:
            if key == "attn_wts" or (name == "eval" and key in OBJ_KEYS):
                continue  # compared through their consumers / in the raw outputs
            dv, cv = d[key].float(), c[key].float()
            field = "hand" if key in HAND_KEYS else "obj" if key in OBJ_KEYS else None
            if field is not None:
                dv, cv = _by_lattice_id(dv, ids_of(d, field)), _by_lattice_id(cv, ids_of(c, field))
            finite = finite and bool(torch.isfinite(dv).all())
            errs[f"{name}.{key}"] = (dv - cv).abs().max().item() / max(cv.abs().max().item(), 1.0)
    worst = max(errs.values())
    res = {"phase": "forward", "setting": cfg.setting, "batch": batch_size, "dtype": "float32",
           "overlap_hand": overlap["hand"], "overlap_obj": overlap["obj"],
           "max_scaled_err": worst, "worst_key": max(errs, key=errs.get), "tol": tol,
           "card_repeat_bitwise": repeat_equal, "cpu_seconds": cpu_s,
           "finite": finite, "errors": errs}
    res["ok"] = (finite and overlap["hand"] == 1.0 and overlap["obj"] == 1.0 and worst <= tol
                 and repeat_equal)
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"card and CPU disagree on the {cfg.setting} eval forward, or two "
                             "card forwards differ")
    return res


# ---- phase 8: evaluation ---------------------------------------------------------

EVAL_PRESETS = ("dexycb", "dexycb_full", "ho3d", "ho3d_render")
TEMPLATE_VERTS = 1000  # vertices of a simplified YCB mesh, as the evaluator reads them


def _eval_batches(cfg, n: int, batch_size: int, seed: int = 300):
    """``n`` synthetic eval batches as ``evaluate_batches`` takes them: the
    image on the u8 grid (so the host's f32 inputs are what the wire
    decodes), random object templates, and for HO3D object classes that put
    019_pitcher_base (class 5) in every batch."""
    import numpy as np

    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
    from hoisdf_torch.ops import wire

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        inputs, targets = split_inputs_targets(synthetic_batch(cfg, batch_size, seed=seed + i))
        inputs["img"] = wire.quantize_image_u8(inputs["img"]).astype(np.float32) / 255.0
        if cfg.dataset == "ho3d":
            inputs["obj_cls"] = (np.arange(batch_size) + i) % 10
        templates = (rng.randn(batch_size, TEMPLATE_VERTS, 3) * 0.05).astype(np.float32)
        out.append((inputs, targets, templates, batch_size))
    return out


def _rel_errs(a, b):
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b}


def check_evaluator(cfg, preds, batch, mano, device, tol: float = 1e-5):
    """``Evaluator.feed`` of one batch of card outputs, on the card and on
    the CPU: every result within ``tol`` relative; dexycb_full's mesh EPE and
    AUC within ``tol`` and its F-scores within 2/778 (a vertex whose nearest
    distance lies at a threshold may count on one side only); HO3D's codalab
    lists within 1e-4 m (the IK parity tolerance)."""
    import numpy as np

    from hoisdf_torch.evaluate import Evaluator

    inputs, targets, templates, _ = batch
    evs = []
    for dev in (device, "cpu"):
        ev = Evaluator(cfg, mano, device=dev)
        ev.feed({k: v.to(dev) for k, v in preds.items()}, targets, inputs, templates)
        evs.append(ev)
    card, cpu = evs
    errs = _rel_errs({k: v / card.total for k, v in card.results.items()},
                     {k: v / cpu.total for k, v in cpu.results.items()})
    res = {"setting": cfg.setting, "total": card.total, "max_rel_err": max(errs.values()),
           "worst_key": max(errs, key=errs.get), "tol": tol}
    ok = card.total == cpu.total and res["max_rel_err"] <= tol
    if cfg.eval_mesh:
        mesh_err = max(abs(a - b) / max(abs(b), 1e-12)
                       for n in ("mesh_err", "mesh_err_aligned")
                       for a, b in zip(getattr(card, n).get_measures(0.0, 0.05, 100)[:3],
                                       getattr(cpu, n).get_measures(0.0, 0.05, 100)[:3]))
        f_err = float(np.abs(np.asarray(card.f_scores + card.f_scores_aligned)
                             - np.asarray(cpu.f_scores + cpu.f_scores_aligned)).max())
        res.update(mesh_max_rel_err=mesh_err, fscore_max_abs_err=f_err, fscore_tol=2 / 778)
        ok = ok and mesh_err <= tol and f_err <= 2 / 778
    if cfg.dataset == "ho3d":
        lists_err = max(float(np.abs(np.stack(getattr(card, n)) - np.stack(getattr(cpu, n))).max())
                        for n in ("joint_list", "mesh_list"))
        res.update(codalab_max_abs_err_m=lists_err, codalab_tol_m=1e-4)
        ok = ok and lists_err <= 1e-4
    res["ok"] = ok
    return res


def evaluate_preset(setting: str, device, batch_size: int = 22, n_batches: int = 3):
    """The eval path of one preset at full published width, bf16, on the u8
    wire: ``evaluate_batches`` (the lookahead loop of ``evaluate.main``)
    drives ``make_eval_step`` and the ``Evaluator`` on the card over
    ``n_batches`` synthetic batches, kernel counts zeroed just before and
    read just after; the loop is held against a serial feed of the same
    outputs.  The eval step and the metrics are timed apart, on one batch,
    after a warmup: the step's device time from torch.profiler (it
    synchronises inside, so CUDA events around it would read the host) and
    its host time around a synchronize; the metrics' host time around
    ``Evaluator.feed`` (which ends in its host transfer), and their device
    time and top operators from the profiler.  Then ``check_evaluator`` on
    that batch's card outputs."""
    import numpy as np
    import torch

    from hoisdf_torch.config import get_config
    from hoisdf_torch.evaluate import Evaluator, evaluate_batches
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.ops import wire
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.train import make_eval_step

    cfg = get_config(setting, compute_dtype="bfloat16", transfer_dtype="uint8")
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    step = make_eval_step(cfg, build_biased_model(cfg), mano, device=device)
    batches = _eval_batches(cfg, n_batches, batch_size)
    inputs0, targets0, templates0, _ = batches[0]
    wire0 = wire.encode_inputs({k: v for k, v in inputs0.items() if k != "obj_cls"})

    scratch = Evaluator(cfg, mano, device=device)
    preds0 = step(wire0)  # warmup of both
    scratch.feed(preds0, targets0, inputs0, templates0)
    torch.cuda.synchronize(device)
    step_prof = device_breakdown(lambda: step(wire0), 1)
    step_host, metric_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(wire0)
        torch.cuda.synchronize(device)
        step_host.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        scratch.feed(preds0, targets0, inputs0, templates0)
        metric_ms.append((time.perf_counter() - t0) * 1e3)
    metric_prof = device_breakdown(lambda: scratch.feed(preds0, targets0, inputs0, templates0), 1)

    evaluator, recorded = Evaluator(cfg, mano, device=device), []

    def recording_step(x):
        recorded.append(step(x))
        return recorded[-1]

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    evaluate_batches(cfg, recording_step, evaluator, batches, batch_size)
    torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(launch_counts)
    # the lookahead's side stream against a serial feed of the same outputs
    serial = Evaluator(cfg, mano, device=device)
    for preds, (inputs, targets, templates, _) in zip(recorded, batches):
        serial.feed(preds, targets, inputs, templates)
    lookahead_err = max(_rel_errs(evaluator.results, serial.results).values())

    results = {k: v / max(evaluator.total, 1) for k, v in evaluator.results.items()}
    ho3d = cfg.dataset == "ho3d"
    want_total = n_batches * batch_size - (
        sum(int((b[0]["obj_cls"] == 5).sum()) for b in batches) if ho3d else 0)
    res = {"phase": "eval", "setting": setting, "batch": batch_size, "batches": n_batches,
           "compute_dtype": cfg.compute_dtype, "wire": cfg.transfer_dtype,
           "template_verts": TEMPLATE_VERTS, "results": results, "total": evaluator.total,
           "step_device_ms": step_prof["device_ms_per_step"],
           "step_device_launches": step_prof["launches_per_step"],
           "step_device_by_group": step_prof["by_group"],
           "step_host_ms": float(np.median(step_host)), "step_host_ms_runs": step_host,
           "metrics_ms": float(np.median(metric_ms)), "metrics_ms_runs": metric_ms,
           "metrics_device_ms": metric_prof["device_ms_per_step"],
           "metrics_device_launches": metric_prof["launches_per_step"],
           "metrics_top_ops": metric_prof["top_ops"][:6],
           "wall_ms_per_batch": wall_ms / n_batches, "lookahead_vs_serial_rel_err": lookahead_err,
           "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "launches": counts, "launches_per_step": {k: v / n_batches for k, v in counts.items()},
           "tf32": tf32_on()}
    finite = all(np.isfinite(v) for v in results.values())
    if cfg.eval_mesh:
        m, _, auc, _, _ = evaluator.mesh_err.get_measures(0.0, 0.05, 100)
        ma, _, auca, _, _ = evaluator.mesh_err_aligned.get_measures(0.0, 0.05, 100)
        fs = np.asarray(evaluator.f_scores).mean(0).tolist()
        fsa = np.asarray(evaluator.f_scores_aligned).mean(0).tolist()
        res["mesh"] = {"epe_cm": m * 100, "auc": auc, "epe_aligned_cm": ma * 100,
                       "auc_aligned": auca, "f5_f15": fs, "f5_f15_aligned": fsa}
        finite = finite and bool(np.isfinite([m, auc, ma, auca, *fs, *fsa]).all())
    if ho3d:
        res["codalab_lists"] = len(evaluator.joint_list)
        finite = finite and bool(np.isfinite(np.stack(evaluator.joint_list)).all()
                                 and np.isfinite(np.stack(evaluator.mesh_list)).all())
        finite = finite and len(evaluator.joint_list) == n_batches * batch_size
    res["finite"] = finite
    res["ok"] = (finite and not res["tf32"] and evaluator.total == want_total
                 and counts["sdf_mlp"] > 0 and counts["gather_lerp"] > 0
                 and lookahead_err <= 1e-6)
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"eval of {setting} failed: a result is not finite, the count "
                             "is wrong, TF32 is on, a kernel of the path never ran or the "
                             "lookahead loop disagrees with a serial feed")
    check = check_evaluator(cfg, preds0, batches[0], mano, device)
    return res, check


# ---- phase 4: serving ----------------------------------------------------------

def serve(cfg, batch_size: int, requests: int, device):
    import numpy as np
    import torch

    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.ops import wire
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.predictor import Predictor

    state = build_biased_model(cfg).state_dict()
    f32 = Predictor(cfg, batch_size, "float32", device=device, state_dict=state)
    u8 = Predictor(cfg, batch_size, "uint8", device=device, state_dict=state)
    # eight distinct batches, sent in turn: u8 frames, as a camera gives
    # them, for the u8 wire; the same values normalized on the host for the
    # f32 wire
    frames = [synthetic_batch(cfg, batch_size, seed=100 + i) for i in range(8)]
    frames_u8 = [dict(fr, img=wire.quantize_image_u8(fr["img"])) for fr in frames]
    frames = [dict(fr, img=fr["img"].astype(np.float32) / 255.0) for fr in frames_u8]
    f32.warmup()
    u8.warmup()
    torch.cuda.reset_peak_memory_stats(device)

    reset_launch_counts()
    outs = {"uint8": [], "float32": []}
    for i in range(requests):  # the wires take turns
        outs["uint8"].append(u8.predict(frames_u8[i % len(frames)]))
        outs["float32"].append(f32.predict(frames[i % len(frames)]))
    torch.cuda.synchronize(device)
    counts = dict(launch_counts)
    steps = 2 * requests
    per_step = {k: v / steps for k, v in counts.items()}

    shapes = {"mano_joints": (batch_size, 21, 3), "mano_verts": (batch_size, 778, 3),
              "hand_joints": (batch_size, 20, 3), "obj_rot": (batch_size, cfg.num_samp_obj, 3),
              "obj_trans": (batch_size, cfg.num_samp_obj, 3)}
    ok_shapes = all(o[k].shape == s for wire_outs in outs.values() for o in wire_outs
                    for k, s in shapes.items())
    finite = all(np.isfinite(o[k]).all() for wire_outs in outs.values() for o in wire_outs
                 for k in shapes)
    wire_diff = max(float(np.abs(a[k] - b[k]).max()) for a, b in
                    zip(outs["uint8"], outs["float32"]) for k in shapes)
    lat = {w: p.latency_summary() for w, p in (("uint8", u8), ("float32", f32))}
    res = {"phase": "serve", "batch": batch_size, "compute_dtype": cfg.compute_dtype,
           "requests_per_wire": requests,
           "p50_ms": {w: s["p50_ms"] for w, s in lat.items()},
           "p90_ms": {w: s["p90_ms"] for w, s in lat.items()},
           "frames_per_s": {w: batch_size / s["p50_ms"] * 1e3 for w, s in lat.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "launches": counts, "launches_per_step": per_step,
           "wire_max_abs_diff": wire_diff, "shapes_ok": ok_shapes, "finite": finite}
    res["ok"] = (ok_shapes and finite and per_step["sdf_mlp"] >= 8
                 and per_step["gather_lerp"] >= 9 and wire_diff <= 1e-2)
    emit(res)
    if not res["ok"]:
        raise AssertionError("serving check failed")
    return res, f32


PROFILE_GROUPS = ("gather_lerp_bwd", "gather_lerp", "sdf_mlp", "Memcpy")


def profile_breakdown(fn, steps: int, phase: str, **extra):
    """Device time by kernel name over ``steps`` calls of ``fn``
    (torch.profiler), grouped: each kernel of the port, the host-device
    copies, and everything else."""
    out = {"phase": phase, "steps": steps, **extra, **device_breakdown(fn, steps)}
    emit(out)
    return out


def device_breakdown(fn, steps: int):
    """``profile_breakdown``'s numbers, without a line of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / steps / 1e3, ev.count // steps, ev.key[:80]))
    rows.sort(reverse=True)
    groups = {}
    for ms, calls, key in rows:
        name = next((g for g in PROFILE_GROUPS if g in key), "other")
        acc = groups.setdefault(name, {"ms": 0.0, "launches": 0})
        acc["ms"] += ms
        acc["launches"] += calls
    # the operators that launched the most device time, kernels included
    ops = sorted(((getattr(ev, "device_time_total", 0.0) / steps / 1e3, ev.count // steps,
                   ev.key[:60]) for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CPU
                  and ev.key.startswith("aten::")), reverse=True)
    return {"device_ms_per_step": sum(r[0] for r in rows),
            "launches_per_step": sum(r[1] for r in rows), "by_group": groups,
            "top": [{"ms": r[0], "calls": r[1], "kernel": r[2]} for r in rows[:15]],
            "top_ops": [{"ms": r[0], "calls": r[1], "op": r[2]} for r in ops[:12]]}


def profile_step(predictor, frames_seed: int = 7):
    """Device time by kernel name over two serving steps."""
    from hoisdf_torch.data.synthetic import synthetic_batch

    fr = synthetic_batch(predictor.cfg, predictor.batch_size, seed=frames_seed)
    return profile_breakdown(lambda: predictor.predict(fr), 2, "profile")


# ---- phases 5 and 6: training ------------------------------------------------

def _train_parts(cfg, device, seed: int = 0, dropout: bool = True):
    """A seeded model in a train state on ``device``, and the train step."""
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.models.hoisdf import build_model
    from hoisdf_torch.models.layers import Dropout
    from hoisdf_torch.train import create_train_state, make_train_step

    model = build_model(cfg, seed)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    state = create_train_state(cfg, model, steps_per_epoch=100, device=device)
    return state, make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)),
                                  device=device)


def tf32_on() -> bool:
    import torch

    return torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32


def capture_bwd_launches(run):
    """Call ``run`` once and keep the inputs of every launch of the gather's
    backward (through the module attribute its autograd Function calls)."""
    from hoisdf_torch.ops.kernels import gather_lerp as module

    kernel, seen = module.gather_lerp_bwd, []

    def keep(grid, g, shapes, dtype):
        seen.append((grid.clone(), g.clone(), list(shapes), dtype))
        return kernel(grid, g, shapes, dtype)

    module.gather_lerp_bwd = keep
    try:
        run()
    finally:
        module.gather_lerp_bwd = kernel
    return seen


def time_bwd_in_step(run, batch_size: int, setting: str = "dexycb", pyramid_name: str = "dexycb"):
    """The gather's backward on the grids and gradients of one train step:
    its largest launch (the merged token gather) timed as the kernel line
    quotes it, each launch's time beside the step profile's, and each held
    against the plain version."""
    from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp_bwd

    launches = capture_bwd_launches(run)
    errs, ms_by_launch = [], []
    for grid, grad, shapes, dtype in launches:
        abs_err, err, finite = bwd_error(grid, grad, shapes, dtype)
        errs.append(abs_err)
        ms_by_launch.append(time_ms(lambda: gather_lerp_bwd(grid, grad, shapes, dtype)))
        tol = BWD_TOL[str(dtype)[6:]]
        if not (finite and err <= tol):
            raise AssertionError(f"gather_lerp_bwd disagrees with its plain version on a train "
                                 f"step's launch of {grid.shape[1]} points: {err} > {tol}")
    grid, grad, shapes, dtype = max(launches, key=lambda a: a[0].shape[1])
    res = {"phase": "kernel", "kernel": "gather_lerp_bwd", "pyramid": pyramid_name,
           "setting": setting, "grid": "field_guided train step",
           "launches_per_step": len(launches),
           "batch": batch_size, "points": grid.shape[1], "channels": grad.shape[-1],
           "dtype": str(dtype)[6:], "max_abs_err": max(errs),
           "points_by_launch": [a[0].shape[1] for a in launches], "ms_by_launch": ms_by_launch,
           "ms_step": sum(ms_by_launch), **time_gather_lerp_bwd(grid, grad, shapes, dtype)}
    emit(res)
    return res


def train(cfg, batch_size: int, device, steps: int = 3, seed: int = 0, profile: bool = True):
    """The main train path of ``cfg``'s preset: presampled and field-guided
    steps at full width, the branch and the jitter distance from
    presample_gate (p = 0.0 and 0.9 at the point-sampling epoch, halfway
    through it).  With ``profile``, a torch.profiler breakdown of one
    field-guided step; then the gather's backward held and timed on one
    field-guided step's launches."""
    import numpy as np
    import torch

    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.train import presample_gate

    state, step = _train_parts(cfg, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    batches = [split_inputs_targets(synthetic_batch(cfg, batch_size, seed=200 + i, train=True))
               for i in range(2)]
    epoch = cfg.point_sampling_epoch
    branches = {"presampled": presample_gate(cfg, epoch, 0.5, 0.0),
                "field_guided": presample_gate(cfg, epoch, 0.5, 0.9)}
    if not branches["presampled"][0] or branches["field_guided"][0]:
        raise AssertionError(f"presample_gate did not give both branches: {branches}")
    for pre, dist in branches.values():  # warmup: one step of each
        step(state, *batches[0], gen, dist, use_presampled=pre)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)

    res = {"phase": "train", "setting": cfg.setting, "batch": batch_size,
           "compute_dtype": cfg.compute_dtype, "steps_per_branch": steps, "tf32": tf32_on()}
    counts_all = {k: 0 for k in launch_counts}
    finite = True
    for name, (pre, dist) in branches.items():
        reset_launch_counts()
        times, last = [], None
        for i in range(steps):
            t0 = time.perf_counter()
            _, last = step(state, *batches[i % 2], gen, dist, use_presampled=pre)
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(launch_counts)
        last = {k: float(v) for k, v in last.items()}
        finite = finite and all(np.isfinite(v) for v in last.values())
        for k, v in counts.items():
            counts_all[k] += v
        res[name] = {"dist_range": dist, "median_ms": float(np.median(times)), "ms": times,
                     "launches_per_step": {k: v / steps for k, v in counts.items()},
                     "losses": last}
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["launches"] = counts_all
    res["finite"] = finite
    need = {"presampled": ("gather_lerp", "gather_lerp_bwd"),
            "field_guided": ("sdf_mlp", "gather_lerp", "gather_lerp_bwd")}
    res["ok"] = not res["tf32"] and finite and all(res[b]["launches_per_step"][k] > 0
                                                   for b, keys in need.items() for k in keys)
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"train phase of {cfg.setting} failed: TF32 is on, a loss is not "
                             "finite or a kernel never ran")
    pre, dist = branches["field_guided"]
    if profile:
        profile_breakdown(lambda: step(state, *batches[0], gen, dist, use_presampled=pre), 1,
                          "train_profile", setting=cfg.setting, branch="field_guided",
                          batch=batch_size)
    bwd = time_bwd_in_step(lambda: step(state, *batches[0], gen, dist, use_presampled=pre),
                           batch_size, cfg.setting, "ho3d" if cfg.use_big_decoder else "dexycb")
    return res, bwd


SCALAR_GROUPS = ("hand_sigmoid_beta", "obj_sigmoid_beta")
# a ReLU input within this share of its call's largest |x| is a near-tie: on the
# H100 the card's own decisions differ from the CPU's up to 1.1e-4 of it
TIE_REL = 1e-3


def relu_pattern(masks=None):
    """A dispatch mode over every ReLU (``aten::relu``, ``aten::relu_``), in
    call order.  Without ``masks`` it records which elements pass (x > 0) into
    ``.masks`` (on the host; None for a call outside autograd, such as the
    point sampler's, whose rows need not come in the same order on another
    run).  With them it imposes them: each call passes exactly the recorded
    elements (a passing element below zero is lifted to the smallest normal
    float, so that the backward, which reads the output, lets it through),
    and ``.ties`` notes for each call how many of its own decisions differ
    from the recorded ones, the largest |x| among those, and the call's
    largest |x| and size."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    relus = (torch.ops.aten.relu.default, torch.ops.aten.relu_.default)

    class ReluPattern(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.masks = [] if masks is None else masks
            self.ties = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func not in relus:
                return func(*args, **(kwargs or {}))
            x = args[0].clone()  # relu_ overwrites its input
            out = func(*args, **(kwargs or {}))
            own = x > 0
            if masks is None:
                self.masks.append(own.cpu() if torch.is_grad_enabled() else None)
                return out
            i = len(self.ties)
            if i >= len(masks) or (masks[i] is not None) != torch.is_grad_enabled() or (
                    masks[i] is not None and masks[i].shape != x.shape):
                raise AssertionError("the ReLU calls differ from the recorded run's")
            if masks[i] is None:
                self.ties.append((0, 0.0, 0.0, 0))
                return out
            want = masks[i].to(x.device)
            differ = own != want
            mag = x.abs()
            self.ties.append((int(differ.sum()), float(mag[differ].max()) if differ.any() else 0.0,
                              float(mag.max()), x.numel()))
            return out.copy_(torch.where(want, x.clamp_min(torch.finfo(x.dtype).tiny), 0.0))

    return ReluPattern()


@contextlib.contextmanager
def beta_terms(model, terms):
    """Within it, each scalar SDF beta's gradient of ``model`` is also taken
    apart.  A beta enters the step only through the attention weights sigma =
    sigmoid(s / b) / b (b the beta clamped to >= 2e-3) of the tokens, so its
    gradient is the sum over every token of g * dsigma/dbeta, with g the
    gradient that reaches sigma; those terms are put, in f64 on the host and
    in forward order, into ``terms[name]``."""
    import torch

    from hoisdf_torch.models import hoisdf as H

    betas = {id(p): n for n, p in model.named_parameters() if n in SCALAR_GROUPS}
    plain, calls = H.sdf_attention_weight, {}

    def weight(sdf, beta):
        sigma = plain(sdf, beta)
        name = betas.get(id(beta))
        if name is not None and sigma.requires_grad:
            s, b = sdf.detach().double(), beta.detach().double()
            sg = torch.sigmoid(s / b.clamp(min=2e-3))
            dsig = -(sg * (1 - sg) * s / b + sg) / b ** 2 * (b >= 2e-3)
            key = (name, len(calls))
            calls[key] = torch.zeros(sigma.numel(), dtype=torch.float64)  # if no g comes
            sigma.register_hook(lambda g: calls.__setitem__(
                key, (g.double() * dsig).reshape(-1).cpu()))
        return sigma

    H.sdf_attention_weight = weight
    try:
        yield
    finally:
        H.sdf_attention_weight = plain
        for (name, _), t in sorted(calls.items(), key=lambda kv: kv[0][1]):
            terms.setdefault(name, []).append(t)


def compare_train_step(cfg, batch_size: int, device, seed: int = 0, loss_tol: float = 1e-4,
                       grad_tol: float = 1e-3, scalar_grad_tol: float = 5e-3,
                       terms_tol: float = 1e-2, tie_rel: float = TIE_REL):
    """One presampled train step on the card and on the CPU from the same
    seeded weights and inputs, f32, TF32 off, dropout off, no jitter.  Each
    loss must agree within ``loss_tol`` relative (absolute below 1e-3), and
    the gradient norm of each parameter group (the model's top-level
    modules) within ``grad_tol`` relative.

    A ReLU whose input lies within rounding of zero passes on one device and
    not on the other, and each such switch moves the gradient by a step that
    no tolerance on rounding covers (at full width over a thousand switch in
    a step).  So the CPU's step records which elements of each ReLU pass,
    and the card's step passes exactly those (``relu_pattern``): the two
    compute one function and differ in rounding alone.  The card's own
    decisions must differ from the CPU's only at near-ties, inputs within
    ``tie_rel`` of the call's largest |x|.  The card's step on its own
    decisions runs too; its losses must agree as above, and its gradients'
    errors are printed (``natural_grad_norm_rel_err``) beside the gated ones.

    Each scalar SDF beta's gradient is one sum of terms that cancel
    (``beta_terms``; its ``condition``, sum |t| / |sum t|, multiplies the
    terms' relative rounding into the sum).  On each device the terms must
    add up to its gradient (within 1e-5 of sum |t|); as a vector they must
    agree within ``terms_tol`` in norm (each carries dsigma/dbeta, which
    multiplies the rounding of its SDF value s by |s| / beta); and the sum
    within ``scalar_grad_tol``, or within the most that the terms'
    differences can move it (``terms_bound``, sum |t_card - t_cpu| /
    |sum t_cpu|) where that is more."""
    import math

    import torch

    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch

    inputs, targets = split_inputs_targets(synthetic_batch(cfg, batch_size, seed=seed + 5,
                                                           train=True))

    def run(dev, mode, terms=None):
        state, step = _train_parts(cfg, dev, seed, dropout=False)
        with mode, (beta_terms(state.model, terms) if terms is not None
                    else contextlib.nullcontext()):
            _, losses = step(state, inputs, targets, None, 0.0, use_presampled=True)
        norms = {}
        for name, p in state.model.named_parameters():
            group = name.split(".")[0]
            norms[group] = norms.get(group, 0.0) + p.grad.double().pow(2).sum().item()
        return {k: float(v) for k, v in losses.items()}, {k: math.sqrt(v) for k, v in norms.items()}

    record, terms_c, terms_d = relu_pattern(), {}, {}
    loss_c, norm_c = run("cpu", record, terms_c)
    impose = relu_pattern(record.masks)
    loss_d, norm_d = run(device, impose, terms_d)
    loss_n, norm_n = run(device, contextlib.nullcontext())

    def rel(got, want, floor):
        return {k: abs(got[k] - v) / max(abs(v), floor) for k, v in want.items()}

    loss_err, loss_err_n = rel(loss_d, loss_c, 1e-3), rel(loss_n, loss_c, 1e-3)
    grad_err, grad_err_n = rel(norm_d, norm_c, 1e-12), rel(norm_n, norm_c, 1e-12)
    beta = {}
    for name in SCALAR_GROUPS:
        t_c, t_d = torch.cat(terms_c[name]), torch.cat(terms_d[name])
        total = abs(float(t_c.sum()))
        beta[name] = {"terms": t_c.numel(), "condition": float(t_c.abs().sum()) / total,
                      "terms_rel_err": float((t_d - t_c).norm() / t_c.norm()),
                      "terms_bound": float((t_d - t_c).abs().sum()) / total,
                      "terms_sum_vs_grad": max(
                          abs(abs(float(t.sum())) - norm[name]) / float(t_c.abs().sum())
                          for t, norm in ((t_c, norm_c), (t_d, norm_d)))}
    flips = [t for t in impose.ties if t[0]]
    ties_ok = (len(impose.ties) == len(record.masks)
               and all(near <= tie_rel * top for _, near, top, _ in flips))
    finite = all(math.isfinite(v) for v in (*loss_d.values(), *norm_d.values(),
                                            *loss_n.values(), *norm_n.values()))
    res = {"phase": "train_check", "setting": cfg.setting, "batch": batch_size,
           "dtype": "float32", "tf32": tf32_on(), "dropout": False, "dist_range": 0.0,
           "relu_calls": len(record.masks), "relu_elements": sum(t[3] for t in impose.ties),
           "relu_switched": sum(t[0] for t in flips),
           "relu_switched_max_rel": max((near / top for _, near, top, _ in flips), default=0.0),
           "tie_rel": tie_rel, "losses_card": loss_d, "loss_rel_err": loss_err,
           "natural_loss_rel_err": loss_err_n, "loss_tol": loss_tol, "grad_norm_card": norm_d,
           "grad_norm_rel_err": grad_err, "natural_grad_norm_rel_err": grad_err_n,
           "grad_tol": grad_tol, "beta_terms": beta, "terms_tol": terms_tol,
           "scalar_grad_tol": scalar_grad_tol, "finite": finite}
    grads_ok = all(e <= grad_tol for k, e in grad_err.items() if k not in SCALAR_GROUPS)
    betas_ok = all(b["terms_rel_err"] <= terms_tol and b["terms_sum_vs_grad"] <= 1e-5
                   and grad_err[k] <= max(scalar_grad_tol, b["terms_bound"])
                   for k, b in beta.items())
    res["ok"] = (finite and ties_ok and grads_ok and betas_ok and not res["tf32"]
                 and set(loss_d) == set(loss_n) == set(loss_c)
                 and set(norm_d) == set(norm_n) == set(norm_c)
                 and max(*loss_err.values(), *loss_err_n.values()) <= loss_tol)
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"card and CPU disagree on the {cfg.setting} train step")
    return res


# ---- phase 7: datasets from disk -----------------------------------------------

def _cfg_args(overrides) -> list:
    return [a for k, v in overrides.items() for a in ("--cfg", f"{k}={json.dumps(v)}")]


def _results_txt(path) -> dict:
    with open(path) as f:
        return {k.strip(): float(v) for k, _, v in (ln.partition(":") for ln in f if " :  " in ln)}


def time_loader(dataset, batch_size: int, workers: int, mode: str, epochs: int = 2) -> dict:
    """The loader over ``epochs`` shuffled epochs of ``dataset``, with no
    consumer work: its start-up ms (the process workers' spawn), the first
    batch's ms and the mean ms per batch (first included), host clock."""
    from hoisdf_torch.data.loader import DataLoader

    t0 = time.perf_counter()
    with DataLoader(dataset, batch_size, shuffle=True, num_workers=workers, drop_last=True,
                    worker_mode=mode) as loader:
        start_ms = (time.perf_counter() - t0) * 1e3
        per_batch, first_ms = [], None
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            for batch in loader:
                per_batch.append((time.perf_counter() - t0) * 1e3)
                first_ms = per_batch[-1] if first_ms is None else first_ms
                t0 = time.perf_counter()
    return {"startup_ms": start_ms, "first_batch_ms": first_ms,
            "ms_per_batch": sum(per_batch) / len(per_batch), "batches": len(per_batch),
            "batch_img_shape": list(batch["img"].shape)}


def data_phase(device, step_ms: float, batch_size: int = 22, n_batches: int = 3) -> dict:
    """DexYCB and HO3D read from disk: a DexYCB tree in the small split's
    layout and an HO3D tree, at the datasets' 640 x 480, are written to a
    temporary directory (``tests/torch_data_fixtures.py``).  ``train_loop.
    main`` trains the dexycb preset at full width on the card for
    ``n_batches`` iterations (one epoch), with the test split's eval at its
    snapshot; ``evaluate.main`` evaluates that snapshot on the DexYCB test
    split and random weights on the HO3D evaluation split (the codalab JSON
    written).  Each split's tail is a short batch.  The loader is timed in
    thread and in process mode at ``num_data_workers``, beside the train
    step's ``step_ms``: the card waits on it when it takes longer a batch.
    Kernel counts are zeroed before each main and read after."""
    import os
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_data_fixtures import write_dexycb, write_ho3d, write_simple_models

    from hoisdf_torch import evaluate, train_loop
    from hoisdf_torch.config import get_config
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts

    res = {"phase": "data", "batch": batch_size, "cpu_count": os.cpu_count()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        simple = write_simple_models(os.path.join(tmp, "simple"), verts=TEMPLATE_VERTS)
        dex = dict(write_dexycb(os.path.join(tmp, "dexycb"), n_train=n_batches * batch_size,
                                n_test=batch_size + 1, cut=True, n_hand=1000, n_obj=400),
                   simple_object_models_dir=simple)
        ho3d = dict(write_ho3d(os.path.join(tmp, "ho3d"), n_eval=batch_size + 1,
                               n_hand=1000, n_obj=400), simple_object_models_dir=simple)
        res["write_s"] = time.perf_counter() - t0
        cfg = get_config("dexycb", **dex)
        dataset = evaluate.open_dataset(cfg, "train", make_synthetic_mano(0))
        res["samples"] = {"dexycb_train": len(dataset), "dexycb_test": batch_size + 1,
                          "ho3d_evaluation": batch_size + 1}
        res["num_data_workers"] = cfg.num_data_workers
        res["loader"] = {mode: time_loader(dataset, batch_size, cfg.num_data_workers, mode)
                         for mode in ("thread", "process")}
        res["train_step_ms"] = step_ms
        res["card_waits_on_loader"] = {mode: r["ms_per_batch"] > step_ms
                                       for mode, r in res["loader"].items()}

        run = os.path.join(tmp, "run")
        torch.cuda.synchronize(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        train_loop.main(["--setting", "dexycb", "--end_epoch", "1", "--run_dir_name", "data",
                         *_cfg_args(dict(dex, output_dir=run))])
        torch.cuda.synchronize(device)
        res["train_loop_s"] = time.perf_counter() - t0
        res["train_loop_launches"] = dict(launch_counts)
        out = os.path.join(run, "data")
        with open(os.path.join(out, "tensorboard", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out, "log", "train_logs.txt")) as f:
            iters = sum(" itr " in line for line in f)
        res["train_loop"] = {"iterations": iters, "first_loss": rows[0]["train_total"],
                             "eval": {k: v for k, v in rows[-1].items() if k != "step"},
                             "snapshot": os.listdir(os.path.join(out, "model_dump")),
                             "debug_images": os.listdir(os.path.join(out, "debug_images"))}

        evals = {}
        for setting, paths, extra in (
                ("dexycb", dex, ["--ckpt", os.path.join(out, "model_dump")]),
                ("ho3d", ho3d, [])):
            reset_launch_counts()
            t0 = time.perf_counter()
            path = evaluate.main(["--setting", setting, "--batch-size", str(batch_size),
                                  "--out", os.path.join(tmp, f"eval_{setting}"), *extra,
                                  *_cfg_args(paths)])
            torch.cuda.synchronize(device)
            evals[setting] = {"s": time.perf_counter() - t0, "results": _results_txt(path),
                              "launches": dict(launch_counts)}
        with open(os.path.join(tmp, "eval_ho3d", "pred_mano.json")) as f:
            xyz, verts = json.load(f)
        evals["ho3d"]["codalab_entries"] = [len(xyz), len(verts)]
        res["evaluate"] = evals

    tl = res["train_loop"]
    finite = bool(np.isfinite([tl["first_loss"], *tl["eval"].values(),
                               *(v for e in evals.values() for v in e["results"].values())]).all())
    res["finite"] = finite
    res["ok"] = (finite and tl["iterations"] == n_batches and "snapshot_0.pth.tar" in tl["snapshot"]
                 and len(tl["debug_images"]) == 1 and "ADDS_error" in tl["eval"]
                 and evals["ho3d"]["codalab_entries"] == [batch_size + 1] * 2
                 and all(res["train_loop_launches"][k] > 0
                         for k in ("gather_lerp", "gather_lerp_bwd", "sdf_mlp"))
                 and all(e["launches"]["sdf_mlp"] > 0 for e in evals.values()))
    emit(res)
    if not res["ok"]:
        raise AssertionError("data phase failed: a result is not finite, an output is missing "
                             "or a kernel never ran")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    from hoisdf_torch.config import get_config
    from hoisdf_torch.ops.kernels import build

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = smi_line()

    info = build.build()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": regs})

    serve_batch = 22
    train_cfg = get_config("dexycb")  # the preset: f32 compute, train batch 22
    sdf_timed = check_sdf_mlp(device, batch=serve_batch)
    gather_timed = check_gather_lerp(device, batch=serve_batch, points=3584)
    gather_ho3d = check_gather_lerp_ho3d(device, batch=serve_batch, points=3584)
    # the gather backward's largest train launch: the merged token gather
    bwd_timed = check_gather_lerp_bwd(device, batch=train_cfg.train_batch_size,
                                      points=train_cfg.num_samp_hand + train_cfg.num_samp_obj)

    for setting in ("dexycb", "ho3d", "ho3d_render"):
        compare_forward(get_config(setting, compute_dtype="float32"), 2, device)

    serve_res, predictor = serve(get_config("dexycb", compute_dtype="bfloat16"),
                                 serve_batch, requests=40, device=device)
    profile_step(predictor)
    del predictor

    train_res, bwd_step = train(train_cfg, train_cfg.train_batch_size, device)
    compare_train_step(train_cfg, 2, device)
    # the other trained presets: ho3d (DecoderBig, the backward at 3,968
    # channels) and ho3d_render (the IK losses)
    bwd_ho3d = check_gather_lerp_bwd(device, batch=train_cfg.train_batch_size,
                                     points=train_cfg.num_samp_hand + train_cfg.num_samp_obj,
                                     pyramid=PYRAMID_HO3D, pyramid_name="ho3d")
    trains = {"dexycb": train_res}
    for setting in ("ho3d", "ho3d_render"):
        cfg = get_config(setting)
        trains[setting], bwd = train(cfg, cfg.train_batch_size, device, profile=False)
        if setting == "ho3d":
            bwd_step_ho3d = bwd
        compare_train_step(cfg, 2, device)
    data_phase(device, train_res["presampled"]["median_ms"])

    evals, checks = {}, []
    for setting in EVAL_PRESETS:
        evals[setting], check = evaluate_preset(setting, device, batch_size=serve_batch)
        checks.append(check)
    eval_check = {"phase": "eval_check", "batch": serve_batch, "presets": checks,
                  "ok": all(c["ok"] for c in checks)}
    emit(eval_check)
    if not eval_check["ok"]:
        raise AssertionError("the evaluator's results on the card and on the CPU disagree")

    launches, train_launches = serve_res["launches"], train_res["launches"]
    kernels = [
        {"name": "sdf_mlp", "route": "cuda", "source": "hoisdf_torch/csrc/sdf_mlp.cu",
         "replaces": SDF_TPU, "launches": launches["sdf_mlp"],
         "launches_eval": {s: r["launches"]["sdf_mlp"] for s, r in evals.items()},
         "max_abs_err": sdf_timed["max_abs_err"], "ms": sdf_timed["ms"],
         "plain_ms": sdf_timed["plain_ms"], "bound_ms": sdf_timed["bound_ms"],
         "bound_by": sdf_timed["bound_by"], "library_ms": sdf_timed["library_ms"],
         **{k: sdf_timed[k] for k in ("step_ms", "step_bound_ms", "step_library_ms",
                                      "step_plain_ms", "f32_ms", "f32_bound_ms",
                                      "f32_library_ms", "f32_plain_ms", "f32_max_abs_err",
                                      "f32_step_ms", "f32_step_bound_ms",
                                      "f32_step_library_ms", "f32_step_plain_ms",
                                      "f32_pack_ms", "f32_pack_host_ms",
                                      "f32_step_with_packing_ms")}},
        {"name": "gather_lerp", "route": "cuda",
         "source": "hoisdf_torch/csrc/gather_lerp.cu", "replaces": GATHER_TPU,
         "launches": launches["gather_lerp"],
         "max_abs_err": gather_timed["max_abs_err"],
         "ms": gather_timed["ms"], "plain_ms": gather_timed["plain_ms"],
         "bound_ms": gather_timed["bound_ms"], "bound_by": gather_timed["bound_by"],
         "library_ms": gather_timed["library_ms"],
         "launches_eval": {s: r["launches"]["gather_lerp"] for s, r in evals.items()},
         **{f"ho3d_{k}": gather_ho3d[k] for k in gather_ho3d
            if k.startswith(("bf16_", "f32_"))}},
        {"name": "gather_lerp_bwd", "route": "cuda",
         "source": "hoisdf_torch/csrc/gather_lerp.cu", "replaces": GATHER_BWD_TPU,
         "launches": train_launches["gather_lerp_bwd"],
         "max_abs_err": max(bwd_timed["max_abs_err"], bwd_step["max_abs_err"]),
         "ms": bwd_step["ms"], "plain_ms": bwd_step["plain_ms"],
         "bound_ms": bwd_step["bound_ms"], "bound_by": bwd_step["bound_by"],
         "library_ms": bwd_step["library_ms"], "ms_step": bwd_step["ms_step"],
         "ms_clustered": bwd_timed["ms_clustered"], "ms_uniform": bwd_timed["ms_uniform"],
         **{f"ho3d_{k}": bwd_step_ho3d[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_step", "channels",
             "points", "launches_per_step")},
         "ho3d_max_abs_err": max(bwd_ho3d["max_abs_err"], bwd_step_ho3d["max_abs_err"]),
         "ho3d_ms_clustered": bwd_ho3d["ms_clustered"], "ho3d_ms_uniform": bwd_ho3d["ms_uniform"]},
    ]
    for entry in kernels:  # launches in each preset's train phase
        entry["launches_train"] = {s: r["launches"][entry["name"]] for s, r in trains.items()}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
