"""Drive the PyTorch port (hoisdf_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   - nvcc builds the CUDA kernels from hoisdf_torch/csrc into
             hoisdf_torch/_build (sm_90a); seconds, card name, power limit.
   native  - beside it, g++ builds the native image pipeline
             (hoisdf_torch/native/src/pipeline.cc) into the same directory:
             seconds, g++'s version, whether the jpeg/png headers were found,
             and the decode route ("libjpeg", or "pil" where the library was
             built without its decoders).  A failed build fails the run.
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
   sampler - every sampler and field-query setting besides the default
             ("full", "coarse2fine", "unmerged" field queries, the "paired"
             cascade, the "nearest" gather in the probes), one line each
             ("phase": "sampler", "check" naming the part).  nearest_kernel:
             the gather's nearest mode against its plain twin on the card,
             bitwise, bf16 and f32, on the dexycb (22 x 3,584 x 992) and
             ho3d (3,968 channels) pyramids, a quarter of the points at
             exact .5 texel positions; its ms, the plain twin's, stock
             grid_sample(mode="nearest") x5 + cat and the byte bound (the
             distinct texels the grid rounds to, the output and the grid).
             gather_past_2_31: one chunk of the dense scan's gather on the
             ho3d pyramid (22 x 32,768 x 3,968 bf16 values, past 2^31), the
             images past 2^31 bitwise against the plain twin, bilinear and
             nearest.  forward: card against CPU on each setting's
             full-width forward (batch 2, f32, TF32 off), as the forward
             phase; the selections must be one set, except in "full", where
             the CPU takes the card's selected points (the dense scan's K-th
             place has rivals within rounding; the two selections must be
             one set or differ by near-ties).  eval_step: the dexycb eval step of each setting
             ("hier" too), and ho3d's in "full" (a gather output past 2^31
             values), at bf16, batch 22, u8 wire: device ms (torch.profiler)
             and its top operators, host ms, kernel launches (counts zeroed
             just before one step), peak memory, and no synchronizing call
             under set_sync_debug_mode.  gate: the
             dense-scan oracle's gate (ops/selection_quality.py) on the card
             at 64^3 on the stress scene: the hier defaults pass (hand K =
             600, object K = 200, overlap >= 0.99), ((4, 128), (2, 256))
             fails.
4. serve   - the main path: a dexycb Predictor at bf16, batch 22, answers
             40 requests on each of the u8 and the f32 wire, in turn; p50
             and p90 latency, frames/s, peak memory, kernel launches per step
             (from the wrappers' counters, zeroed just before the requests);
             then the same batches with two steps in flight
             (predict_async ahead, materialize behind): the p50 interval
             between results and frames/s beside the blocking figures.
   serve_closed - 66 closed-loop clients (3 x batch 22) submit single u8
             frames to a BatchingServer (max_wait_ms 5, two steps in
             flight) for 10 s: frames/s, mean batch fill, request
             p50/p95/p99 (np.percentile), every response of its shape and
             finite, kernel launches (counts zeroed just before).
   serve_poisson - run_poisson_load (seed 7, 10 s, u8, max_wait_ms 5) at
             0.25, 0.5, 0.8 and 1.2 times serve_closed's frames/s: offered
             rate, goodput, submitted and completed (which must be equal),
             mean batch fill, p50/p95/p99.
   serve_async - then, on both wires: one warmed predict_async under
             torch.cuda.set_sync_debug_mode (sync_sites: where a "warn" run
             saw a synchronizing call; then "error", the gate);
             materialize(predict_async(b)) bitwise equal to predict(b) on
             eight batches; predict_async's host ms (median of 20) beside
             the step's device ms (torch.profiler).  Then the sync check on
             ho3d (DecoderBig) at u8.
   export  - the u8 serving Predictor's step exported with torch.export
             (tools/export.py) at batch 22, fixed and polymorphic, each
             loaded back and called on the card (the polymorphic one also at
             batch 8) against the eager step on the same inputs: bitwise, or
             within 2e-2 of the output's scale on mano_joints and obj_trans
             (every output's error printed); per call the kernels' launches
             (equal to the eager step's); export and load seconds; the fixed
             program's host and device ms beside eager's.
   profile_trace - utils/profiling.py's capture_trace around one serving
             step: its Chrome trace must name both kernels.
   mano    - every option of mano/layer.py (PCA 6 and 45, flat_hand_mean
             off, center_idx None, trans, the left hand, rotation matrices)
             and mano/demo.py's random hand, card against CPU, within 1e-3 mm.
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
   backbone_init - train_loop's --backbone-init: a synthetic torchvision
             ResNet-50 .pth grafted into the full-width dexycb train state,
             which must hold it, then one presampled f32 train step.
7. data    - DexYCB and HO3D from disk: trees in the original's layout at
             640 x 480 (tests/torch_data_fixtures.py) in a temporary
             directory.  The loader on the DexYCB train split (9 batches of
             22), with the native image pipeline and with PIL, in 1, 2, 4, 8
             and 15 threads and in 15 processes: start-up, first batch and
             steady-state ms per batch beside the dexycb train step
             (card_waits_on_loader); each backend's sample split by seam in
             one thread, each seam's calls replayed in 1 and 8 threads; the
             two backends' eval samples bitwise equal on the DexYCB test and
             HO3D evaluation splits.  train_loop.main trains dexycb at full
             width for one epoch on the native backend, with the test split's
             eval at its snapshot; evaluate.main evaluates that snapshot on
             the DexYCB test split and random weights on the HO3D evaluation
             split (the codalab JSON); outputs present and finite, kernels
             launched.
   warp    - ops/warp.py's affine_warp_image at batch 22, 640 x 480 -> 256
             x 256 u8 (train crops with a spin, eval crops without): the card
             against the CPU (nearest: differing pixels, which must be 0;
             bilinear: max abs error), the eval crops against PIL, and the
             times on the card and on the CPU.
8. eval    - each preset (dexycb, dexycb_full, ho3d, ho3d_render) at full
             width, bf16, batch 22, u8 wire: the port's Evaluator over three
             synthetic batches through make_eval_step on the card, by
             evaluate_batches (the lookahead loop of evaluate.main): every
             result, the eval step's device ms and the metrics' ms per batch
             apart, peak memory, kernel launches (counts zeroed just before
             the three batches).  The mesh metrics of dexycb_full and the IK
             of ho3d_render run on the card.  Then eval_check: one batch of
             card outputs through the Evaluator on the card and on the CPU.
9. parallel - the data-parallel wrappers (hoisdf_torch/parallel), the dexycb
             preset at full width, batch 22, f32, TF32 off, dropout off, no
             jitter; one line per check ("phase": "parallel", "check").
             world1: a child process on a world-size-1 NCCL group runs the
             train step in DDP, ZeRO-1 and FSDP against the plain step,
             presampled twice and field-guided twice, each step from the
             plain run's state of that step (the field-guided steps on one
             recorded selection, cuDNN deterministic): every loss within
             1e-6 relative and each parameter group's gradient within 1e-5
             scaled, a second plain run as the card's floor, every kernel
             launched; each wrapper's host ms per step (median of 3) beside
             the plain step's, and its peak memory.  two_ranks: two child
             processes share the card (gloo), 11 rows each of one 22-row
             batch, DDP and ZeRO-1, every ReLU passing the one-process
             step's elements: the losses within 1e-5 relative, each group's
             gradient within 1e-3 (the betas 5e-3) of the one-process step's,
             FSDP's gradients gathered from the ranks' shards as host copies;
             each rank's peak memory in the first step and in a second (with
             the AdamW moments), where ZeRO-1's must not exceed DDP's.  eval: evaluate_batches at two ranks (gloo,
             the predictions gathered to rank 0) against one rank, f32, on
             one recorded selection: every result within 1e-5.  A rank that
             fails fails the run.  Two ranks on one card measure correctness
             and memory, not scaling.
10. kernels - one line listing every kernel with the numbers this run took
             (the gather's nearest mode in its `nearest_*` fields, from the
             sampler phase; the backward's `ho3d_*` fields from the ho3d train step,
             every kernel's launches per preset's train phase, and the two
             serving kernels' launches in serve_closed, `launches_server`,
             and in one call of the exported program, `launches_export`, and
             each kernel's launches in the world1 check's four steps under
             each wrapper, `launches_parallel`).  Every kernel is reached
             through its torch.library custom op (hoisdf_torch/ops/kernels).

Throughout, plain_guard notes every call of a kernel's plain version that
the port makes with a CUDA tensor; one such call fails the run (the
plain_guard line, before the kernels line).  Any failed check raises, and
the script exits non-zero.  The last line is
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


# |sdf| within which two lattice points tie for a place in a selection when
# the card and the CPU score them (the f32 SDF MLP's card-CPU gap is ~4e-7)
SELECTION_TIE = 1e-5


@contextlib.contextmanager
def recorded_selections(impose=None):
    """Record every field-guided sampler call of the model (the three
    samplers of ``models/hoisdf.py`` and the paired cascade's), in call
    order: its selected points.  With ``impose`` (another run's recorded
    points, in call order) each call returns those points instead, their sdf
    from the call's own ``sdf_fn``, and records the scores of both sets
    under that ``sdf_fn`` (|sdf|, +inf outside the bbox)."""
    import torch

    from hoisdf_torch.models import experimental, hoisdf
    from hoisdf_torch.ops.point_sampling import _in_bbox

    record = []

    def wrap(fn):
        def sampler(sdf_fn, center, cam_intr, bbox, *, sdf_scale, clamp, **kw):
            pts, sdf = fn(sdf_fn, center, cam_intr, bbox, sdf_scale=sdf_scale, clamp=clamp,
                          **kw)
            entry = {"points": pts.cpu()}
            if impose is not None:
                def scores(p):
                    raw = sdf_fn(p)
                    inside = _in_bbox(p, center, cam_intr, bbox, sdf_scale)
                    return raw, torch.where(inside, raw.abs(), torch.full_like(raw, float("inf")))

                entry["own"] = scores(pts)[1].cpu()
                pts = impose[len(record)].to(pts.device)
                raw, imposed = scores(pts)
                entry["imposed"] = imposed.cpu()
                sdf = torch.clamp(raw, -clamp, clamp)[..., None]
            record.append(entry)
            return pts, sdf
        return sampler

    saved = [(m, n, getattr(m, n)) for m, n in (
        (hoisdf, "sdf_guided_sample"), (hoisdf, "sdf_guided_sample_coarse2fine"),
        (hoisdf, "sdf_guided_sample_hierarchical"),
        (experimental, "sdf_guided_sample_hierarchical"))]
    for m, n, f in saved:
        setattr(m, n, wrap(f))
    try:
        yield record
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def selection_agreement(card, cpu, bins_n: int):
    """The card's selections against the CPU's own (``recorded_selections``
    records of one forward each, the CPU's with the card's imposed): the
    least share of common lattice points over calls and images, and the
    largest gap between the sorted CPU scores of the two selections (0 when
    they are one set; at most ``SELECTION_TIE`` when they differ by
    near-ties), with the differing points' scores."""
    import torch

    overlap, gap, differing = 1.0, 0.0, []
    for d, c in zip(card, cpu):
        ids_d, ids_c = _lattice_ids(d["points"], bins_n), _lattice_ids(c["points"], bins_n)
        for b in range(ids_d.shape[0]):
            sd, sc = set(ids_d[b].tolist()), set(ids_c[b].tolist())
            overlap = min(overlap, len(sd & sc) / len(sc))
            own, imp = torch.sort(c["own"][b]).values, torch.sort(c["imposed"][b]).values
            same = (own == imp) | (torch.isinf(own) & torch.isinf(imp))
            gap = max(gap, float(torch.where(same, 0.0, (own - imp).abs()).max()))
            if sd != sc and len(differing) < 4:
                differing.append({"image": b, "kth_score": float(own[-1]),
                                  "card_only": sorted(sd - sc)[:3], "cpu_only": sorted(sc - sd)[:3],
                                  "card_only_scores": [float(c["imposed"][b][i]) for i, k in
                                                       enumerate(ids_d[b].tolist())
                                                       if k not in sc][:3]})
    return overlap, gap, differing


def compare_forward(cfg, batch_size: int, device, seed: int = 0, tol: float = 1e-4,
                    phase: str = "forward", sampler: str = "hier", eval_step: bool = True,
                    impose_selection: bool = False):
    """Eval forward on ``device`` (kernels) and on the CPU (plain versions)
    from the same seeded weights and inputs, both f32; with ``eval_step``
    the eval step's outputs too.

    The selected lattice points must agree as sets.  Per-point outputs are
    compared after sorting by lattice id: the order inside the selection
    follows |sdf|, whose near-ties can order differently when sums are taken
    in another order.  Errors are scaled by max(1, max |cpu value|).  Two
    forwards on the card must be bitwise equal.

    With ``impose_selection`` (the dense scan ranks every lattice point, so
    its K-th place has close rivals) the CPU's forward takes the card's
    selected points (``recorded_selections``): the two selections must be
    one set or differ by near-ties only (``selection_agreement``), and every
    output is compared on the card's points."""
    import torch

    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.train import make_eval_step

    inputs = synthetic_batch(cfg, batch_size, seed=seed)
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    runs, repeat_equal, cpu_s, records = {}, None, 0.0, {}
    for dev in (device, "cpu"):
        model = build_biased_model(cfg, seed)
        step = make_eval_step(cfg, model, mano, supervise_sdf=False, device=dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
            impose = ([e["points"] for e in records[device]]
                      if impose_selection and dev == "cpu" else None)
            with (recorded_selections(impose) if impose_selection
                  else contextlib.nullcontext([])) as records[dev]:
                raw = model(batch, supervise_sdf=False)
            if dev != "cpu":  # is the card's forward bitwise repeatable?
                again = model(batch, supervise_sdf=False)
                repeat_equal = all(torch.equal(raw[k], again[k]) for k in raw)
        preds = step(inputs) if eval_step else {}
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
    res = {"phase": phase, "check": "forward", "setting": cfg.setting, "sampler": sampler,
           "batch": batch_size, "dtype": "float32",
           "overlap_hand": overlap["hand"], "overlap_obj": overlap["obj"],
           "max_scaled_err": worst, "worst_key": max(errs, key=errs.get), "tol": tol,
           "card_repeat_bitwise": repeat_equal, "cpu_seconds": cpu_s,
           "finite": finite, "errors": errs}
    same_points = overlap["hand"] == 1.0 and overlap["obj"] == 1.0
    if impose_selection:
        sel, gap, differing = selection_agreement(records[device], records["cpu"], cfg.bins_n)
        res.update({"selection_imposed": True, "selection_overlap": sel,
                    "selection_tie_gap": gap, "selection_tie": SELECTION_TIE,
                    "selection_differing": differing})
        same_points = same_points and (sel == 1.0 or gap <= SELECTION_TIE)
    res["ok"] = finite and same_points and worst <= tol and repeat_equal
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"card and CPU disagree on the {cfg.setting} eval forward "
                             f"({sampler} sampler), or two card forwards differ")
    return res


# ---- phase 3b: the sampler settings ---------------------------------------------

# Every sampler and field-query setting besides the default "hier" cascade
# with merged queries, as Config overrides of the dexycb preset.  The paired
# cascade shares hier_levels, so it runs with hier_levels_obj=None.
SAMPLER_SETTINGS = {
    "full": dict(sdf_infer_mode="full"),
    "coarse2fine": dict(sdf_infer_mode="coarse2fine"),
    "unmerged": dict(merged_field_queries=False),
    "paired": dict(paired_sdf_infer=True, hier_levels_obj=None),
    "nearest": dict(infer_gather_nearest=True),
}
# The settings whose card-vs-CPU forward takes the card's selection on the
# CPU: the dense scan ranks every lattice point, so its K-th place has close
# rivals.  The cascades' selections must be one set.
IMPOSED_SELECTION = ("full",)


def _half_texel_grid(sizes, batch: int, points: int, seed: int):
    """A [batch, points, 2] f32 grid: a quarter of the points at exact .5
    texel positions of one of the levels of edge ``sizes`` (x and y computed
    as the gather computes them, in f32), where rounding half to even
    decides, the rest uniform over the image and a little beyond."""
    import numpy as np
    import torch

    from hoisdf_torch.ops.kernels.gather_lerp import half_texel_coords

    rng = np.random.RandomState(seed)
    half = half_texel_coords(sizes)
    grid = rng.uniform(-1.1, 1.1, size=(batch, points, 2)).astype(np.float32)
    n = points // 4
    grid[:, :n] = rng.choice(half, size=(batch, n, 2))
    return torch.from_numpy(grid)


def _nearest_map_bytes(grid, maps) -> int:
    """Bytes of the maps that the nearest mode must read for ``grid``: each
    distinct texel that its points round to, per image and level, once."""
    import torch

    from hoisdf_torch.ops.kernels.gather_lerp import nearest_index

    total = 0
    for m in maps:
        b, h, w, c = m.shape
        idx = nearest_index(grid, h, w) + torch.arange(b, device=grid.device)[:, None] * (h * w)
        total += torch.unique(idx).numel() * c * m.element_size()
    return total


def check_gather_nearest(device, batch: int, points: int, pyramid, pyramid_name: str,
                         seed: int = 5):
    """The gather's nearest mode against its plain twin on the card, bitwise,
    bf16 and f32, timed against its byte bound (each distinct texel that the
    grid rounds to read once per image and level, the output written once: a
    copy does no arithmetic), the plain twin and
    stock ``grid_sample(mode="nearest")`` per level + concat."""
    import torch
    import torch.nn.functional as F

    from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp, gather_nearest_plain

    grid = _half_texel_grid([s for _, s, _ in pyramid], batch, points, seed).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    maps32 = [torch.randn(batch, s, s, c, generator=g, device=device) for _, s, c in pyramid]
    res = {"phase": "sampler", "check": "nearest_kernel", "kernel": "gather_lerp",
           "mode": "nearest", "pyramid": pyramid_name, "batch": batch, "points": points,
           "channels": sum(c for _, _, c in pyramid)}
    ok = True
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        maps = [m.to(dtype) for m in maps32]
        got = gather_lerp(grid, maps, nearest=True)
        torch.cuda.synchronize()
        want = gather_nearest_plain(grid, maps)
        bitwise = bool(torch.equal(got, want))
        err = (got.float() - want.float()).abs().max().item()
        ok = ok and bitwise and bool(torch.isfinite(got).all())
        size = got.element_size()
        nbytes = got.numel() * size + _nearest_map_bytes(grid, maps) + grid.numel() * 4
        b_ms, b_by = bound(0.0, H100_F32_FLOPS, nbytes)
        del got, want
        grid4 = grid[:, None].to(dtype)

        def library():  # stock grid_sample per level + concat
            return torch.cat([F.grid_sample(
                m.permute(0, 3, 1, 2), grid4, mode="nearest", padding_mode="border",
                align_corners=True) for m in maps], 1)

        res.update({f"{name}_max_abs_err": err, f"{name}_bitwise_equal": bitwise,
                    f"{name}_ms": time_ms(lambda: gather_lerp(grid, maps, nearest=True)),
                    f"{name}_plain_ms": time_ms(lambda: gather_nearest_plain(grid, maps),
                                                iters=3),
                    f"{name}_library_ms": time_ms(library, iters=3),
                    f"{name}_bound_ms": b_ms, f"{name}_bound_by": b_by, f"{name}_bytes": nbytes})
        if pyramid_name == "dexycb" and dtype == torch.bfloat16:  # the bilinear mode beside it
            res["bf16_bilinear_ms"] = time_ms(lambda: gather_lerp(grid, maps))
        del maps
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError(f"the gather's nearest mode differs from its plain twin: {res}")
    return res


def check_gather_past_2_31(device, batch: int, points: int = 32768, seed: int = 7):
    """One chunk of the dense scan's gather on DecoderBig's pyramid, as the
    ho3d "full" eval step launches it: ``batch`` x ``points`` (the default
    sdf_infer_chunk) x 3,968 bf16 values, past 2^31 at batch 22.  The images
    whose output rows reach past 2^31 values are held bitwise against the
    plain twin on those images alone, in both modes of the kernel."""
    import torch

    from hoisdf_torch.ops.kernels.gather_lerp import (gather_lerp, gather_lerp_plain,
                                                      gather_nearest_plain)

    c_total = sum(c for _, _, c in PYRAMID_HO3D)
    first = 2**31 // (points * c_total)  # the image whose rows cross 2^31 values
    grid = _half_texel_grid([s for _, s, _ in PYRAMID_HO3D], batch, points, seed).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    maps = [torch.randn(batch, s, s, c, generator=g, device=device).to(torch.bfloat16)
            for _, s, c in PYRAMID_HO3D]
    res = {"phase": "sampler", "check": "gather_past_2_31", "kernel": "gather_lerp",
           "pyramid": "ho3d", "dtype": "bf16", "batch": batch, "points": points,
           "channels": c_total, "output_values": batch * points * c_total,
           "checked_images": [first, batch], "checked_from_value": first * points * c_total}
    ok = batch * points * c_total > 2**31
    for mode, plain in (("bilinear", gather_lerp_plain), ("nearest", gather_nearest_plain)):
        got = gather_lerp(grid, maps, nearest=mode == "nearest")[first:]
        want = plain(grid[first:].contiguous(), [m[first:].contiguous() for m in maps])
        res[f"{mode}_bitwise_equal"] = bool(torch.equal(got, want))
        res[f"{mode}_max_abs_err"] = (got.float() - want.float()).abs().max().item()
        ok = ok and res[f"{mode}_bitwise_equal"]
        del got, want
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError(f"the gather past 2^31 output values differs from its plain twin "
                             f"(or the case does not reach 2^31): {res}")
    return res


def sampler_eval_step(name: str, over: dict, device, batch_size: int,
                      setting: str = "dexycb"):
    """The ``setting`` preset's eval step at full width, bf16, batch
    ``batch_size``, u8 wire, in one sampler setting: a warmed step under ``set_sync_debug_mode``
    (inputs already on the card, so the gate sees the step alone), its device
    ms (torch.profiler) and host ms (median of three, around a synchronize),
    then one step with the kernel counts zeroed just before and read just
    after, and its peak memory."""
    import numpy as np
    import torch

    from hoisdf_torch.config import get_config
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.ops import wire
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.train import make_eval_step

    cfg = get_config(setting, compute_dtype="bfloat16", transfer_dtype="uint8", **over)
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    step = make_eval_step(cfg, build_biased_model(cfg), mano, device=device)
    inputs = _eval_batches(cfg, 1, batch_size)[0][0]
    wire0 = {k: torch.from_numpy(v).to(device) for k, v in
             wire.encode_inputs({k: v for k, v in inputs.items() if k != "obj_cls"}).items()}
    step(wire0)  # warmup
    sites, error, _ = sync_gate(lambda: step(wire0))
    torch.cuda.synchronize(device)
    prof = device_breakdown(lambda: step(wire0), 1)
    host = []
    for _ in range(3):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(wire0)
        torch.cuda.synchronize(device)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    out = step(wire0)
    torch.cuda.synchronize(device)
    counts = dict(launch_counts)
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    nearest = cfg.infer_gather_nearest
    res = {"phase": "sampler", "check": "eval_step", "setting": setting, "sampler": name,
           "overrides": over, "batch": batch_size, "compute_dtype": cfg.compute_dtype, "wire": cfg.transfer_dtype,
           "step_device_ms": prof["device_ms_per_step"],
           "step_device_launches": prof["launches_per_step"], "step_device_by_group":
           prof["by_group"], "step_top_ops": prof["top_ops"][:8],
           "step_host_ms": float(np.median(host)), "step_host_ms_runs": host,
           "launches": counts, "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "sync_sites": sites, "sync_error": error, "finite": finite, "tf32": tf32_on()}
    res["ok"] = (finite and error is None and not sites and not res["tf32"]
                 and counts["sdf_mlp"] > 0 and counts["gather_lerp"] > 0
                 and (counts["gather_lerp_nearest"] > 0) == nearest)
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"the {name} eval step failed: a synchronizing call, an output "
                             "not finite, TF32 on, or a kernel of its path never ran: "
                             f"{sites} {error} {counts}")
    return res


def sampler_gate(device):
    """The dense-scan oracle's gate on the card at the production scale
    (64^3 lattice, stress scene of ops/selection_quality.py): the hier
    defaults pass it, the hand at K = 600 and the object at K = 200, with
    overlap >= 0.99; the cheaper ((4, 128), (2, 256)) fails it."""
    from hoisdf_torch.config import Config
    from hoisdf_torch.ops.selection_quality import gate, selection_quality, stress_geometry

    field, center, cam, bbox = stress_geometry(batch=2, seed=3, device=device)
    cases = {"hand": (600, Config().hier_levels), "obj": (200, Config().hier_levels_obj),
             "hand_bad_levels": (600, ((4, 128), (2, 256)))}
    res = {"phase": "sampler", "check": "gate", "bins_n": 64, "scene": "stress_geometry seed 3"}
    t0 = time.perf_counter()
    for name, (k, levels) in cases.items():
        rep = selection_quality(field, center, cam, bbox, sdf_scale=3.1, num_points=k,
                                bins_n=64, levels=levels)
        res[name] = {"k": k, "levels": levels, "gate": gate(rep),
                     **{key: v.tolist() for key, v in rep.items()}}
    res["seconds"] = time.perf_counter() - t0
    res["ok"] = (res["hand"]["gate"] and res["obj"]["gate"] and not res["hand_bad_levels"]["gate"]
                 and min(res["hand"]["overlap_at_k"] + res["obj"]["overlap_at_k"]) >= 0.99)
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"the dense-scan gate failed on the card: {res}")
    return res


def sampler_phase(device, batch_size: int):
    """The sampler settings: the gather's nearest mode on both pyramids, the
    card against the CPU on each setting's f32 forward (batch 2), the eval
    step of each (the default "hier" too), and the dense-scan gate.  ->
    (nearest kernel lines by pyramid, eval-step lines by setting)."""
    from hoisdf_torch.config import get_config

    t0 = time.perf_counter()
    nearest = {name: check_gather_nearest(device, batch_size, 3584, pyr, name)
               for name, pyr in (("dexycb", PYRAMID), ("ho3d", PYRAMID_HO3D))}
    check_gather_past_2_31(device, batch_size)
    for name, over in SAMPLER_SETTINGS.items():
        compare_forward(get_config("dexycb", compute_dtype="float32", **over), 2, device,
                        phase="sampler", sampler=name, eval_step=False,
                        impose_selection=name in IMPOSED_SELECTION)
    steps = {name: sampler_eval_step(name, over, device, batch_size)
             for name, over in {"hier": {}, **SAMPLER_SETTINGS}.items()}
    # the dense scan on DecoderBig's pyramid: a chunk's gather output is
    # 720,896 x 3,968 values, past 2^31 (its offsets: check_gather_past_2_31)
    steps["full_ho3d"] = sampler_eval_step("full", SAMPLER_SETTINGS["full"], device,
                                           batch_size, setting="ho3d")
    sampler_gate(device)
    print(f"chip_smoke: sampler phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return nearest, steps


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
    after a warmup: the step's device time from torch.profiler (the step is
    host-bound, so CUDA events around it would read the host's enqueueing)
    and its host time around a synchronize; the metrics' host time around
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

SERVE_SECONDS = 10.0  # each closed-loop and Poisson run
POISSON_LOADS = (0.25, 0.5, 0.8, 1.2)  # offered rate / closed-loop frames per second


def serving_predictors(cfg, batch_size: int, device):
    """A warmed Predictor per wire, one set of drawn weights."""
    from hoisdf_torch.predictor import Predictor

    state = build_biased_model(cfg).state_dict()
    preds = {w: Predictor(cfg, batch_size, w, device=device, state_dict=state)
             for w in ("uint8", "float32")}
    for p in preds.values():
        p.warmup()
    return preds


def serving_frames(cfg, batch_size: int):
    """Eight distinct batches per wire: u8 frames, as a camera gives them,
    for the u8 wire; the same values normalized on the host for the f32
    wire."""
    import numpy as np

    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.ops import wire
    from hoisdf_torch.predictor import INPUT_KEYS

    u8 = [{k: v for k, v in synthetic_batch(cfg, batch_size, seed=100 + i).items()
           if k in INPUT_KEYS} for i in range(8)]
    u8 = [dict(fr, img=wire.quantize_image_u8(fr["img"])) for fr in u8]
    return {"uint8": u8,
            "float32": [dict(fr, img=fr["img"].astype(np.float32) / 255.0) for fr in u8]}


def _serve_shapes(cfg):
    return {"mano_joints": (21, 3), "mano_verts": (778, 3), "hand_joints": (20, 3),
            "obj_rot": (cfg.num_samp_obj, 3), "obj_trans": (cfg.num_samp_obj, 3)}


def pipelined_intervals(predictor, frames, n: int, depth: int = 2):
    """ms between successive results when ``depth`` steps are kept in flight
    (predict_async ahead, materialize behind), over ``n`` batches."""
    import collections

    import numpy as np
    import torch

    torch.cuda.synchronize()
    inflight, stamps = collections.deque(), [time.perf_counter()]
    for i in range(n):
        inflight.append(predictor.predict_async(frames[i % len(frames)]))
        if len(inflight) == depth:
            predictor.materialize(*inflight.popleft())
            stamps.append(time.perf_counter())
    while inflight:
        predictor.materialize(*inflight.popleft())
        stamps.append(time.perf_counter())
    return np.diff(stamps) * 1e3


def serve(preds, frames, cfg, batch_size: int, requests: int, device):
    """Blocking predict calls, the wires in turn, then the same batches with
    two steps in flight (the pipelined figure beside the blocking p50)."""
    import numpy as np
    import torch

    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    outs = {"uint8": [], "float32": []}
    for i in range(requests):  # the wires take turns
        for w in ("uint8", "float32"):
            outs[w].append(preds[w].predict(frames[w][i % len(frames[w])]))
    torch.cuda.synchronize(device)
    counts = dict(launch_counts)
    steps = 2 * requests
    per_step = {k: v / steps for k, v in counts.items()}
    pipelined = {w: pipelined_intervals(preds[w], frames[w], requests) for w in preds}

    shapes = {k: (batch_size, *s) for k, s in _serve_shapes(cfg).items()}
    ok_shapes = all(o[k].shape == s for wire_outs in outs.values() for o in wire_outs
                    for k, s in shapes.items())
    finite = all(np.isfinite(o[k]).all() for wire_outs in outs.values() for o in wire_outs
                 for k in shapes)
    wire_diff = max(float(np.abs(a[k] - b[k]).max()) for a, b in
                    zip(outs["uint8"], outs["float32"]) for k in shapes)
    lat = {w: p.latency_summary() for w, p in preds.items()}
    pipe_p50 = {w: float(np.percentile(v, 50)) for w, v in pipelined.items()}
    res = {"phase": "serve", "batch": batch_size, "compute_dtype": cfg.compute_dtype,
           "requests_per_wire": requests,
           "p50_ms": {w: s["p50_ms"] for w, s in lat.items()},
           "pipelined_interval_p50_ms": pipe_p50,
           "p90_ms": {w: s["p90_ms"] for w, s in lat.items()},
           "frames_per_s": {w: batch_size / s["p50_ms"] * 1e3 for w, s in lat.items()},
           "pipelined_frames_per_s": {w: batch_size * len(v) / float(v.sum()) * 1e3
                                      for w, v in pipelined.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "launches": counts, "launches_per_step": per_step,
           "wire_max_abs_diff": wire_diff, "shapes_ok": ok_shapes, "finite": finite}
    res["ok"] = (ok_shapes and finite and per_step["sdf_mlp"] >= 8
                 and per_step["gather_lerp"] >= 9 and wire_diff <= 1e-2)
    emit(res)
    if not res["ok"]:
        raise AssertionError("serving check failed")
    return res


def sync_gate(fn):
    """Call ``fn`` twice under ``set_sync_debug_mode``: first "warn",
    recording where each synchronizing call was made (for the line), then
    "error", the gate.  The mode is restored after each.  -> (sites, error,
    the calls' results)."""
    import warnings

    import torch

    prev = torch.cuda.get_sync_debug_mode()
    results, sites, error = [], [], None
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            results.append(fn())
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    # torch's own notice that the mode is a prototype is not a sync
    sites = sorted({f"{w.filename}:{w.lineno}" for w in caught
                    if "called a synchronizing CUDA operation" in str(w.message)})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        results.append(fn())
    except RuntimeError as exc:
        error = str(exc)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return sites, error, results


def sync_check(predictor, frames):
    """One warmed predict_async under :func:`sync_gate`.  -> (sites, error)."""
    sites, error, handles = sync_gate(lambda: predictor.predict_async(frames))
    for h in handles:
        predictor.materialize(*h)
    return sites, error


def serve_async(preds, frames, cfg, batch_size: int, device):
    """The async split on both wires of the dexycb serving predictors: no
    synchronizing call in a warmed predict_async (sync_check),
    materialize(predict_async(b)) bitwise equal to predict(b) on eight
    batches, predict_async's host ms (median of 20, the card idle at each
    call) beside the step's device ms (torch.profiler over two steps).  Then
    the sync check on ho3d (DecoderBig) at u8.  Any failure raises."""
    import numpy as np
    import torch

    from hoisdf_torch.config import get_config
    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.ops import wire
    from hoisdf_torch.predictor import INPUT_KEYS, Predictor

    res = {"phase": "serve_async", "setting": cfg.setting, "batch": batch_size,
           "compute_dtype": cfg.compute_dtype, "wires": {}}
    ok = True
    for w, p in preds.items():
        sites, error = sync_check(p, frames[w][0])
        bitwise = True
        for fr in frames[w]:
            a, b = p.materialize(*p.predict_async(fr)), p.predict(fr)
            bitwise = bitwise and all(np.array_equal(a[k], b[k]) for k in b)
        host_ms = []
        for i in range(20):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            handle = p.predict_async(frames[w][i % len(frames[w])])
            host_ms.append((time.perf_counter() - t0) * 1e3)
            p.materialize(*handle)
        dev = device_breakdown(lambda: p.materialize(*p.predict_async(frames[w][0])), 2)
        res["wires"][w] = {"sync_free": error is None and not sites, "sync_sites": sites,
                           "sync_error": error, "bitwise_equal_to_predict": bitwise,
                           "predict_async_host_ms": float(np.median(host_ms)),
                           "predict_async_host_ms_range": [min(host_ms), max(host_ms)],
                           "step_device_ms": dev["device_ms_per_step"],
                           "step_device_launches": dev["launches_per_step"]}
        ok = ok and error is None and not sites and bitwise

    ho3d_cfg = get_config("ho3d", compute_dtype="bfloat16")
    ho3d = Predictor(ho3d_cfg, batch_size, "uint8", device=device,
                     state_dict=build_biased_model(ho3d_cfg).state_dict())
    ho3d.warmup()
    fr = {k: v for k, v in synthetic_batch(ho3d_cfg, batch_size, seed=100).items()
          if k in INPUT_KEYS}
    fr["img"] = wire.quantize_image_u8(fr["img"])
    sites, error = sync_check(ho3d, fr)
    out = ho3d.predict(fr)
    good = all(out[k].shape == (batch_size, *s) and np.isfinite(out[k]).all()
               for k, s in _serve_shapes(ho3d_cfg).items())
    res["ho3d_uint8"] = {"sync_free": error is None and not sites, "sync_sites": sites,
                         "sync_error": error, "outputs_ok": good}
    res["ok"] = ok and error is None and not sites and good
    emit(res)
    if not res["ok"]:
        raise AssertionError("serve_async failed: a synchronizing call in predict_async, "
                             "or its results differ from predict's")
    return res


def _percentiles(lat_s):
    import numpy as np

    lat = np.asarray(lat_s) * 1e3
    if not lat.size:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    return {f"p{q}_ms": float(np.percentile(lat, q)) for q in (50, 95, 99)}


def single_frames(predictor, frames):
    """The serving batches of ``predictor``'s wire as single frames."""
    return [{k: v[i] for k, v in fr.items()} for fr in frames[predictor.transfer_dtype]
            for i in range(predictor.batch_size)]


def serve_closed(predictor, frames, cfg, clients: int, device, seconds: float = SERVE_SECONDS,
                 max_wait_ms: float = 5.0):
    """``clients`` closed-loop clients, each submitting one frame at a time to
    a BatchingServer for ``seconds`` (as ``bench_components.py --serve``):
    frames/s, mean batch fill, request p50/p95/p99; every response has its
    shapes and is finite; kernel counts zeroed just before, read just
    after."""
    import threading

    import numpy as np
    import torch

    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.predictor import BatchingServer

    pool = single_frames(predictor, frames)
    shapes = _serve_shapes(cfg)
    latencies, bad, errors, lock = [], [0], [], threading.Lock()

    def client(i: int):
        frame = pool[i % len(pool)]
        try:
            while time.perf_counter() < stop_at:
                t0 = time.perf_counter()
                out = srv.submit(frame).result(timeout=300)
                dt = time.perf_counter() - t0
                good = all(out[k].shape == s and np.isfinite(out[k]).all()
                           for k, s in shapes.items())
                with lock:
                    latencies.append(dt)
                    bad[0] += not good
        except Exception as exc:  # recorded; the phase fails below
            with lock:
                errors.append(repr(exc)[:200])

    torch.cuda.synchronize(device)
    reset_launch_counts()
    with BatchingServer(predictor, max_wait_ms=max_wait_ms) as srv:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        t0 = time.perf_counter()
        stop_at = t0 + seconds
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 600)
        elapsed = time.perf_counter() - t0
        served, batches = srv.frames_served, srv.batches_dispatched
    torch.cuda.synchronize(device)
    counts = dict(launch_counts)
    res = {"phase": "serve_closed", "setting": cfg.setting, "batch": predictor.batch_size,
           "wire": predictor.transfer_dtype, "clients": clients, "seconds": elapsed,
           "max_wait_ms": max_wait_ms, "frames_per_s": served / elapsed,
           "frames_served": served, "batches": batches,
           "mean_batch_fill": served / max(batches, 1), **_percentiles(latencies),
           "responses": len(latencies), "bad_responses": bad[0], "errors": errors[:5],
           "launches": counts,
           "launches_per_batch": {k: v / max(batches, 1) for k, v in counts.items()}}
    res["ok"] = (not errors and bad[0] == 0 and len(latencies) == served > 0
                 and not any(t.is_alive() for t in threads)
                 and counts["sdf_mlp"] >= 8 * batches and counts["gather_lerp"] >= 9 * batches)
    emit(res)
    if not res["ok"]:
        raise AssertionError("serve_closed failed: a request failed, a response was not "
                             "finite or of its shape, or the kernels did not run")
    return res


def serve_poisson(predictor, frames, cfg, capacity_fps: float, seconds: float = SERVE_SECONDS,
                  max_wait_ms: float = 5.0, seed: int = 7):
    """run_poisson_load at each of POISSON_LOADS times ``capacity_fps`` (the
    closed-loop frames/s), one BatchingServer per rate: offered rate,
    goodput, submitted and completed, mean batch fill, p50/p95/p99.  Fails
    unless every submitted request completed at every rate."""
    from hoisdf_torch.predictor import BatchingServer, run_poisson_load

    pool = single_frames(predictor, frames)
    rates = []
    for load in POISSON_LOADS:
        with BatchingServer(predictor, max_wait_ms=max_wait_ms) as srv:
            rep = run_poisson_load(srv, pool, load * capacity_fps, seconds, seed=seed)
            batches = srv.batches_dispatched
        rates.append({"load": load, "offered_hz": rep["offered_hz"],
                      "goodput_hz": rep["goodput_hz"], "submitted": rep["submitted"],
                      "completed": rep["completed"], "elapsed_s": rep["elapsed_s"],
                      "batches": batches,
                      "mean_batch_fill": rep["completed"] / max(batches, 1),
                      **_percentiles(rep["latencies_s"])})
    res = {"phase": "serve_poisson", "setting": cfg.setting, "batch": predictor.batch_size,
           "wire": predictor.transfer_dtype, "max_wait_ms": max_wait_ms, "seed": seed,
           "seconds": seconds, "capacity_fps": capacity_fps, "rates": rates}
    res["ok"] = all(r["completed"] == r["submitted"] > 0 for r in rates)
    emit(res)
    if not res["ok"]:
        raise AssertionError("serve_poisson failed: a submitted request did not complete")
    return res


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


EXPORT_RTOL = 2e-2  # bf16: the program's and eager's cuDNN algorithms may differ


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|: a difference measured against the output's
    scale (elementwise rtol is meaningless where outputs cross zero)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _host_ms(fn, n: int = 10) -> list:
    """Host ms of each of ``n`` calls of ``fn``, the card idle at each."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return out


def export_phase(pred, frames) -> dict:
    """The serving export (hoisdf_torch/tools/export.py) on the card: the
    warmed dexycb Predictor (bf16, u8 wire) exported with torch.export at its
    batch, fixed and polymorphic, each loaded back with torch.export.load and
    called on the card (the polymorphic one also at batch 8), against the
    eager step on the same inputs (at batch 8 too; beside it, the error
    against the Predictor's padded batch-22 step): bitwise, or within
    EXPORT_RTOL of the
    output's scale on mano_joints and obj_trans (every output's error
    printed); per exported call the kernels' launches, which must equal the
    eager step's; export and load seconds; the fixed program's host and
    device ms beside eager's."""
    import importlib
    import json as _json
    import os
    import statistics
    import tempfile

    import numpy as np
    import torch

    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.predictor import INPUT_KEYS
    from hoisdf_torch.tools.export import OUTPUT_KEYS, export_serving_module

    dev, batch = pred.device, pred.batch_size
    res = {"phase": "export", "setting": pred.cfg.setting, "batch": batch,
           "compute_dtype": pred.cfg.compute_dtype, "wire": pred.transfer_dtype,
           "sdf_infer_mode": pred.cfg.sdf_infer_mode, "rtol_of_scale": EXPORT_RTOL,
           "torch": torch.__version__, "card": smi_line(), "programs": {}}

    def eager(inputs):
        out = pred._eval_step(dict(zip(INPUT_KEYS, inputs)))
        return dict({k: out[k] for k in ("mano_joints", "mano_verts", "hand_joints")},
                    obj_rot=out["obj_rot"].mean(dim=1), obj_trans=out["obj_trans"].mean(dim=1))

    def on_card(fr, n):
        return [torch.from_numpy(np.ascontiguousarray(fr[k][:n])).to(dev) for k in INPUT_KEYS]

    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as root, torch.inference_mode():
        full = on_card(frames[0], batch)
        reset_launch_counts()
        want_full = eager(full)
        torch.cuda.synchronize()
        eager_launches = dict(launch_counts)
        for kind, poly in (("fixed", False), ("polymorphic", True)):
            out_dir = os.path.join(root, kind)
            t0 = time.perf_counter()
            with torch.inference_mode(False):
                export_serving_module(pred, out_dir, polymorphic_batch=poly)
            export_s = time.perf_counter() - t0
            sig = _json.load(open(os.path.join(out_dir, "signature.json")))
            importlib.import_module(sig["ops"])
            t0 = time.perf_counter()
            prog = torch.export.load(os.path.join(out_dir, "model.pt2")).module()
            load_s = time.perf_counter() - t0
            flat = np.load(os.path.join(out_dir, "params.npz"))
            params = [torch.from_numpy(flat[k]).to(dev) for k in sig["param_order"]]
            entry = {"export_s": export_s, "load_s": load_s, "batch_size": sig["batch_size"],
                     "calls": {}}
            for n in ((batch, 8) if poly else (batch,)):
                inputs = full if n == batch else on_card(frames[0], n)
                torch.cuda.synchronize()
                reset_launch_counts()
                got = prog(*params, *inputs)
                torch.cuda.synchronize()
                launches = dict(launch_counts)
                want = want_full if n == batch else eager(inputs)
                bitwise = all(torch.equal(got[k], want[k]) for k in OUTPUT_KEYS)
                errs = {k: _rel_err(got[k].cpu(), want[k].cpu()) for k in OUTPUT_KEYS}
                shapes = all(tuple(got[k].shape) == tuple(want[k].shape) and
                             bool(torch.isfinite(got[k]).all()) for k in OUTPUT_KEYS)
                call = {"bitwise": bitwise, "rel_err_of_scale": errs,
                        "max_abs_err": {k: float((got[k] - want[k]).abs().max())
                                        for k in OUTPUT_KEYS},
                        "launches": launches, "eager_launches": eager_launches,
                        "outputs_ok": shapes}
                if n != batch:  # beside: the Predictor's rows, the batch padded to its own
                    padded = eager([torch.cat([t, t[-1:].expand(batch - n, *t.shape[1:])])
                                    for t in inputs])
                    call["rel_err_of_scale_vs_padded_batch"] = {
                        k: _rel_err(got[k].cpu(), padded[k][:n].cpu()) for k in OUTPUT_KEYS}
                if n == batch and not poly:
                    host = _host_ms(lambda: prog(*params, *inputs))
                    host_eager = _host_ms(lambda: eager(inputs))
                    call.update(
                        host_ms=statistics.median(host), host_ms_range=[min(host), max(host)],
                        eager_host_ms=statistics.median(host_eager),
                        eager_host_ms_range=[min(host_eager), max(host_eager)],
                        device_ms=device_breakdown(lambda: prog(*params, *inputs), 2)[
                            "device_ms_per_step"],
                        eager_device_ms=device_breakdown(lambda: eager(inputs), 2)[
                            "device_ms_per_step"])
                close = bitwise or all(errs[k] <= EXPORT_RTOL for k in ("mano_joints", "obj_trans"))
                kernels_ran = all(launches[k] == eager_launches[k] and launches[k] > 0
                                  for k in ("sdf_mlp", "gather_lerp"))
                call["ok"] = close and shapes and kernels_ran
                ok = ok and call["ok"]
                entry["calls"][str(n)] = call
            res["programs"][kind] = entry
            del prog, params
    res["ok"] = ok
    emit(res)
    if not ok:
        raise AssertionError("the exported serving program disagrees with the eager step, or "
                             "did not launch the kernels as the eager step does")
    return res


def profile_trace_phase(pred, frames) -> dict:
    """utils/profiling.py's capture_trace around one serving step: the Chrome
    trace it writes must name both kernels among its CUDA kernel events."""
    import glob
    import json as _json
    import os
    import tempfile

    import torch

    from hoisdf_torch.utils.profiling import capture_trace

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        t0 = time.perf_counter()
        with capture_trace(d):
            pred.predict(frames[0])
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        files = glob.glob(os.path.join(d, "*.pt.trace.json"))
        events = [ev for f in files for ev in _json.load(open(f)).get("traceEvents", [])]
    kernels = sorted({ev["name"] for ev in events if ev.get("cat") == "kernel"})
    named = {k: [n for n in kernels if k in n] for k in ("sdf_mlp", "gather_lerp")}
    res = {"phase": "profile_trace", "files": len(files), "events": len(events),
           "kernel_names": len(kernels), "port_kernels": named, "seconds": seconds,
           "ok": len(files) == 1 and all(named.values())}
    emit(res)
    if not res["ok"]:
        raise AssertionError("capture_trace wrote no trace that names both kernels")
    return res


MANO_TOL_MM = 1e-3


def mano_phase(device, batch: int = 22) -> dict:
    """mano/layer.py's options and mano/demo.py on the card against the CPU on
    the same inputs (f32, TF32 off): axis-angle, PCA at 6 and 45,
    flat_hand_mean off, center_idx None, trans, the left hand, rotation
    matrices; generate_random_hand's draws run through the CPU layer.  Max
    abs error in mm, within MANO_TOL_MM."""
    import numpy as np
    import torch

    from hoisdf_torch.mano.demo import generate_random_hand
    from hoisdf_torch.mano.layer import ManoBuffers, ManoLayer, mano_forward
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.ops.rotations import batch_rodrigues

    rng = np.random.RandomState(5)
    model = make_synthetic_mano(0)
    cpu, card = ManoBuffers.from_model(model), ManoBuffers.from_model(model, device)
    betas = torch.from_numpy((rng.randn(batch, 10) * 0.5).astype(np.float32))
    trans = torch.from_numpy((rng.randn(batch, 3) * 0.1).astype(np.float32))
    aa = lambda n: torch.from_numpy((rng.randn(batch, 3 + n) * 0.4).astype(np.float32))
    rotmats = batch_rodrigues(aa(45)[:, :48].reshape(-1, 3)).reshape(batch, 16, 3, 3)
    cases = {"axisang": (aa(45), {}), "pca6": (aa(6), dict(use_pca=True, ncomps=6)),
             "pca45": (aa(45), dict(use_pca=True, ncomps=45)),
             "not_flat": (aa(45), dict(flat_hand_mean=False)),
             "uncentred": (aa(45), dict(center_idx=None)), "trans": (aa(45), dict(trans=True)),
             "left": (aa(45), dict(side="left")),
             "rotmat": (rotmats + 0.01, dict(joint_rot_mode="rotmat"))}
    errs = {}
    for name, (pose, opts) in cases.items():
        t = trans if opts.pop("trans", False) else None
        want = mano_forward(cpu, pose, betas, t, **opts)
        got = mano_forward(card, pose.to(device), betas.to(device),
                           None if t is None else t.to(device), **opts)
        errs[name] = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    hand = generate_random_hand(batch, 6, seed=3, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    pose = torch.randn(batch, 9, generator=gen, device=device).cpu()
    shape = torch.randn(batch, 10, generator=gen, device=device).cpu()
    want = ManoLayer(model, use_pca=True, ncomps=6, center_idx=None)(pose, shape)
    errs["generate_random_hand"] = max(float((hand[k].cpu() - w).abs().max())
                                       for k, w in zip(("verts", "joints"), want))
    res = {"phase": "mano", "batch": batch, "max_abs_err_mm": errs, "tol_mm": MANO_TOL_MM,
           "ok": all(e <= MANO_TOL_MM for e in errs.values())}
    emit(res)
    if not res["ok"]:
        raise AssertionError("the MANO layer on the card disagrees with the CPU")
    return res


def backbone_init_phase(device, batch_size: int = 22) -> dict:
    """train_loop's --backbone-init on the card: a synthetic torchvision
    ResNet-50 state dict (.pth, fc.* included, tools/synth_weights.py's
    values from seed 11) grafted into the
    full-width dexycb train state, which must then hold it; then one
    presampled train step (f32, batch 22): finite losses, both kernels and
    the backward launched."""
    import os
    import tempfile

    import numpy as np
    import torch

    from hoisdf_torch.config import get_config
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.tools.synth_weights import synth_value
    from hoisdf_torch.train_loop import BACKBONE_PREFIX, load_backbone_init

    cfg = get_config("dexycb")
    state, step = _train_parts(cfg, device)
    shapes = {k[len(BACKBONE_PREFIX):]: tuple(v.shape)
              for k, v in state.module.state_dict().items()
              if k.startswith(BACKBONE_PREFIX) and not k.endswith("num_batches_tracked")}
    shapes.update({"fc.weight": (1000, 2048), "fc.bias": (1000,)})
    # tools/synth_weights.py's values: a random ResNet-50 that stays finite
    tv = {k: torch.from_numpy(synth_value(k, s, 11)) for k, s in shapes.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_backbone_") as d:
        path = os.path.join(d, "resnet50.pth")
        torch.save(tv, path)
        t0 = time.perf_counter()
        load_backbone_init(state, path)
        graft_s = time.perf_counter() - t0
    sd = state.module.state_dict()
    held = all(torch.equal(sd[BACKBONE_PREFIX + k].cpu(), v) for k, v in tv.items()
               if not k.startswith("fc."))
    inputs, targets = _train_batches(cfg, batch_size, 1)[0]
    reset_launch_counts()
    _, losses = step(state, inputs, targets, None, 0.0, use_presampled=True)
    torch.cuda.synchronize(device)
    launches = dict(launch_counts)
    losses = {k: float(v) for k, v in losses.items()}
    res = {"phase": "backbone_init", "setting": cfg.setting, "batch": batch_size,
           "keys_grafted": len(tv) - 2, "graft_s": graft_s, "backbone_holds_file": held,
           "losses": losses, "launches": launches,
           "ok": held and all(np.isfinite(v) for v in losses.values())
           and all(launches[k] > 0 for k in ("gather_lerp", "gather_lerp_bwd"))}
    emit(res)
    if not res["ok"]:
        raise AssertionError("the backbone graft did not hold, or the step after it failed")
    del state
    torch.cuda.empty_cache()
    return res


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
    backward (through the module attribute its autograd formula calls)."""
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


def shard_rows(mask, shape, shard):
    """The rows of a recorded global-batch ``mask`` that rank ``shard[0]`` of
    ``shard[1]`` holds, for a call whose input has ``shape``: the one
    dimension where the two differ is the batch's (the leading one, the
    second under a leading layer axis, or a row axis flattened batch-major),
    and the rank holds a contiguous block of it."""
    if shard is None or tuple(mask.shape) == tuple(shape):
        return mask
    rank, world = shard
    dims = [d for d, (m, x) in enumerate(zip(mask.shape, shape)) if m != x]
    if (len(mask.shape) != len(shape) or len(dims) != 1
            or mask.shape[dims[0]] != world * shape[dims[0]]):
        raise AssertionError(f"a ReLU input of {tuple(shape)} is no rank's share of "
                             f"{tuple(mask.shape)}")
    n = shape[dims[0]]
    return mask.narrow(dims[0], rank * n, n)


def relu_pattern(masks=None, shard=None):
    """A dispatch mode over every ReLU (``aten::relu``, ``aten::relu_``), in
    call order.  Without ``masks`` it records which elements pass (x > 0) into
    ``.masks`` (on the host; None for a call outside autograd, such as the
    point sampler's, whose rows need not come in the same order on another
    run).  With them it imposes them on the calls inside autograd, in order
    (a call outside autograd passes untouched and takes no mask): each
    passes exactly the recorded elements (a passing element below zero is
    lifted to the smallest normal float, so that the backward, which reads
    the output, lets it through), and ``.ties`` notes for each how many of
    its own decisions differ from the recorded ones, the largest |x| among
    those, and the call's largest |x| and size.  With ``shard=(rank,
    world)`` the masks are a global batch's, and a rank of a data-parallel
    step imposes its rows (``shard_rows``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    relus = (torch.ops.aten.relu.default, torch.ops.aten.relu_.default)

    class ReluPattern(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.masks = [] if masks is None else [m for m in masks if m is not None]
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
            if not torch.is_grad_enabled():
                return out
            i = len(self.ties)
            if i >= len(self.masks):
                raise AssertionError("the ReLU calls differ from the recorded run's")
            want = shard_rows(self.masks[i], x.shape, shard)
            if want.shape != x.shape:
                raise AssertionError("the ReLU calls differ from the recorded run's")
            want = want.to(x.device)
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
    ties_ok = (len(impose.ties) == len(impose.masks)
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


LOADER_THREADS = (1, 2, 4, 8, 15)  # thread workers timed per backend; then 15 processes
LOADER_BATCHES = 9  # batches a loader epoch: the first, then eight in steady state
SEAMS = ("open_image", "flip_image", "finalize_image", "warp_seg", "to_float_image")


def time_loader(dataset, batch_size: int, workers: int, mode: str, epochs: int = 1) -> dict:
    """``epochs`` shuffled epochs of ``dataset`` with no consumer work, host
    clock: the loader's start-up ms (for processes, until one probe task per
    worker has run), the first batch's ms, every batch's ms, and
    ``steady_ms_per_batch``, the mean over the last epoch's batches (the
    first batch left out).  Spawned workers keep joining for seconds after
    the start-up probe returns (``scripts/probe_torch_loader.py --trace``),
    so process mode takes two epochs and its first is the warm-up."""
    from hoisdf_torch.data.loader import DataLoader

    t0 = time.perf_counter()
    with DataLoader(dataset, batch_size, shuffle=True, num_workers=workers, drop_last=True,
                    worker_mode=mode) as loader:
        start_ms = (time.perf_counter() - t0) * 1e3
        per_batch = []
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            for batch in loader:
                per_batch.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
    steady = per_batch[1:] if epochs == 1 else per_batch[-len(loader):]
    return {"workers": workers, "mode": mode, "epochs": epochs, "startup_ms": start_ms,
            "first_batch_ms": per_batch[0], "steady_ms_per_batch": sum(steady) / len(steady),
            "steady_ms_min": min(steady), "steady_ms_max": max(steady),
            "steady_batches": len(steady), "batch_ms": per_batch,
            "batch_img_shape": list(batch["img"].shape)}


class _TimedNpz:
    """An ``np.load`` result whose array reads (a zip member each) count to
    the load's time."""

    def __init__(self, npz, add):
        self._npz, self._add = npz, add

    def __getitem__(self, key):
        t0 = time.perf_counter()
        out = self._npz[key]
        self._add(time.perf_counter() - t0)
        return out


def sample_split(dataset, n: int) -> dict:
    """ms per sample of each image seam (``data/image_io.py``), of ``np.load``
    with its npz reads (the label and SDF files), and of the rest (MANO and
    augmentation numpy, the seg comparisons, assembly), over ``n`` samples in
    one thread, host clock.  Then each seam's recorded calls run again in
    1 and in 8 threads: a seam whose work holds the GIL gains little."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from hoisdf_torch.data import image_io as IIO

    spent = dict.fromkeys(SEAMS + ("np_load",), 0.0)
    calls = {k: [] for k in spent}
    originals = {name: getattr(IIO, name) for name in SEAMS}
    np_load = np.load

    def add(name):
        def f(dt):
            spent[name] += dt
        return f

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            calls[name].append((fn, args, kwargs))
            return out
        return wrapper

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = np_load(*args, **kwargs)
        spent["np_load"] += time.perf_counter() - t0
        calls["np_load"].append((np_load, args, kwargs))
        return _TimedNpz(out, add("np_load")) if isinstance(out, np.lib.npyio.NpzFile) else out

    try:
        for name in SEAMS:
            setattr(IIO, name, timed(name, originals[name]))
        np.load = timed_load
        t0 = time.perf_counter()
        for idx in range(n):
            dataset.__getitem__(idx, epoch=0)
        total = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(IIO, name, fn)
        np.load = np_load
    out = {f"{k}_ms": v / n * 1e3 for k, v in spent.items()}
    out["rest_ms"] = (total - sum(spent.values())) / n * 1e3
    out["sample_ms"] = total / n * 1e3

    def replay(call):
        fn, args, kwargs = call
        res = fn(*args, **kwargs)
        if isinstance(res, np.lib.npyio.NpzFile):
            res = [res[k] for k in res.files]
        return res

    scaling = {}
    for name, recorded in calls.items():
        ms = {}
        for threads in (1, 8):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(replay, recorded))
                ms[threads] = (time.perf_counter() - t0) * 1e3
        scaling[name] = {"calls": len(recorded), "ms_1_thread": ms[1], "ms_8_threads": ms[8],
                         "speedup_8": ms[1] / ms[8]}
    out["seam_scaling"] = scaling
    return out


def backend_agreement(native_ds, pil_ds) -> dict:
    """Every eval sample of the native and the PIL dataset: the keys that
    differ and the image bytes that differ (expected none)."""
    import numpy as np

    keys, img_bytes = set(), 0
    for idx in range(len(native_ds)):
        a, b = native_ds.__getitem__(idx), pil_ds.__getitem__(idx)
        keys |= {k for k in set(a) | set(b) if k not in a or k not in b
                 or not np.array_equal(a[k], b[k])}
        img_bytes += int((np.rint(a["img"] * 255) != np.rint(b["img"] * 255)).sum())
    return {"samples": len(native_ds), "keys_differing": sorted(keys),
            "img_bytes_differing": img_bytes, "bitwise": not keys}


def data_phase(device, step_ms: float, native: dict, batch_size: int = 22) -> dict:
    """DexYCB and HO3D read from disk: a DexYCB tree in the small split's
    layout (``LOADER_BATCHES`` train batches, a test split of one batch and a
    tail) and an HO3D tree, at the datasets' 640 x 480, are written to a
    temporary directory (``tests/torch_data_fixtures.py``).  The loader is
    timed on the train split with the native pipeline (``native_pipeline=
    "on"``; ``native`` is its build report) and with PIL ("off"), in threads
    (``LOADER_THREADS``) and in 15 processes, each in steady state, beside the
    train step's ``step_ms``: the card waits on a backend whose steady ms at
    ``num_data_workers`` threads exceeds it.  Each backend's sample is split
    by seam in one thread (:func:`sample_split`), and its eval samples are held
    against the other backend's on the DexYCB test and the HO3D evaluation
    splits.  Then ``train_loop.main`` trains the dexycb preset at full width
    on the card on the native backend for one epoch, with the test split's
    eval at its snapshot, and ``evaluate.main`` evaluates that snapshot on the
    DexYCB test split and random weights on the HO3D evaluation split (the
    codalab JSON written).  Kernel counts are zeroed before each main and
    read after."""
    import os
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_data_fixtures import write_dexycb, write_ho3d, write_simple_models

    from hoisdf_torch import evaluate, train_loop
    from hoisdf_torch.config import get_config
    from hoisdf_torch.data.ho3d import HO3DDataset
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts

    n_batches = LOADER_BATCHES
    res = {"phase": "data", "batch": batch_size, "cpu_count": os.cpu_count(),
           "decode": native["decode"]}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        simple = write_simple_models(os.path.join(tmp, "simple"), verts=TEMPLATE_VERTS)
        dex = dict(write_dexycb(os.path.join(tmp, "dexycb"), n_train=n_batches * batch_size,
                                n_test=batch_size + 1, cut=True, n_hand=1000, n_obj=400),
                   simple_object_models_dir=simple)
        ho3d = dict(write_ho3d(os.path.join(tmp, "ho3d"), n_eval=batch_size + 1,
                               n_hand=1000, n_obj=400), simple_object_models_dir=simple)
        res["write_s"] = time.perf_counter() - t0
        mano = make_synthetic_mano(0)
        cfgs = {b: get_config("dexycb", native_pipeline=m, **dex)
                for b, m in (("native", "on"), ("pil", "off"))}
        train_sets = {b: evaluate.open_dataset(c, "train", mano) for b, c in cfgs.items()}
        if not train_sets["native"].native or train_sets["pil"].native:
            raise AssertionError("native_pipeline 'on' / 'off' did not pick the backends")
        res["samples"] = {"dexycb_train": len(train_sets["pil"]), "dexycb_test": batch_size + 1,
                          "ho3d_evaluation": batch_size + 1}
        workers = cfgs["pil"].num_data_workers
        res["num_data_workers"] = workers
        res["loader"] = {b: {**{f"thread_{w}": time_loader(ds, batch_size, w, "thread")
                                for w in LOADER_THREADS},
                             f"process_{workers}": time_loader(ds, batch_size, workers, "process",
                                                               epochs=2)}
                         for b, ds in train_sets.items()}
        res["split"] = {b: sample_split(ds, 3 * batch_size) for b, ds in train_sets.items()}
        res["train_step_ms"] = step_ms
        res["card_waits_on_loader"] = {
            b: {mode: r[f"{mode}_{workers}"]["steady_ms_per_batch"] > step_ms
                for mode in ("thread", "process")} for b, r in res["loader"].items()}
        res["eval_backends_agree"] = {
            "dexycb_test": backend_agreement(
                *(evaluate.open_dataset(cfgs[b], "test", mano) for b in ("native", "pil"))),
            "ho3d_evaluation": backend_agreement(
                *(HO3DDataset(get_config("ho3d", native_pipeline=m, **ho3d), "evaluation", mano)
                  for m in ("on", "off")))}

        run = os.path.join(tmp, "run")
        torch.cuda.synchronize(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        train_loop.main(["--setting", "dexycb", "--end_epoch", "1", "--run_dir_name", "data",
                         *_cfg_args(dict(dex, output_dir=run, native_pipeline="on"))])
        torch.cuda.synchronize(device)
        res["train_loop_s"] = time.perf_counter() - t0
        res["train_loop_launches"] = dict(launch_counts)
        out = os.path.join(run, "data")
        with open(os.path.join(out, "tensorboard", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out, "log", "train_logs.txt")) as f:
            iters = sum(" itr " in line for line in f)
        res["train_loop"] = {"native_pipeline": "on", "iterations": iters,
                             "first_loss": rows[0]["train_total"],
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
    shapes = {r["batch_img_shape"] == [batch_size, 256, 256, 3]
              and len(r["batch_ms"]) == n_batches * r["epochs"]
              for b in res["loader"].values() for r in b.values()}
    res["ok"] = (finite and tl["iterations"] == n_batches and "snapshot_0.pth.tar" in tl["snapshot"]
                 and shapes == {True}
                 and all(a["bitwise"] for a in res["eval_backends_agree"].values())
                 and len(tl["debug_images"]) == 1 and "ADDS_error" in tl["eval"]
                 and evals["ho3d"]["codalab_entries"] == [batch_size + 1] * 2
                 and all(res["train_loop_launches"][k] > 0
                         for k in ("gather_lerp", "gather_lerp_bwd", "sdf_mlp"))
                 and all(e["launches"]["sdf_mlp"] > 0 for e in evals.values()))
    emit(res)
    if not res["ok"]:
        raise AssertionError("data phase failed: a result is not finite, an output is missing, "
                             "a kernel never ran, or the backends' eval samples differ")
    return res


# ---- phase 7, then: the affine warp on the card ------------------------------------

def warp_phase(device, batch: int = 22, src_hw=(480, 640), res: int = 256, seed: int = 11) -> dict:
    """``ops/warp.py::affine_warp_image`` on ``batch`` u8 frames of
    ``src_hw`` to ``res`` x ``res``: train crops (a spin drawn) for the first
    half of the batch, eval crops (scale and shift) for the rest.  The card
    against the CPU (nearest: differing pixels, expected 0; bilinear: max abs
    error), the eval crops against PIL's NEAREST transform on the CPU, and
    each mode's time on the card (CUDA events) and on the CPU (host clock)."""
    import numpy as np
    import torch
    from PIL import Image

    from hoisdf_torch.data import transforms as T
    from hoisdf_torch.ops.warp import affine_warp_image

    rng = np.random.RandomState(seed)
    h, w = src_hw
    imgs = rng.randint(0, 256, (batch, h, w, 3), dtype=np.uint8)
    affs = np.stack([T.get_affine_transform(
        rng.uniform([100, 80], [w - 100, h - 80]), rng.uniform(150, 400), [res, res],
        rot=rng.uniform(-np.pi, np.pi) if i < batch // 2 else 0.0)[0]
        for i in range(batch)]).astype(np.float32)
    img, aff = torch.from_numpy(imgs), torch.from_numpy(affs)
    img_d, aff_d = img.to(device), aff.to(device)
    out = {"phase": "warp", "batch": batch, "src_hw": list(src_hw), "res": res, "dtype": "uint8"}
    for mode in ("nearest", "bilinear"):
        t0 = time.perf_counter()
        cpu = affine_warp_image(img, aff, (res, res), mode=mode)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        card = affine_warp_image(img_d, aff_d, (res, res), mode=mode)
        torch.cuda.synchronize(device)
        card = card.cpu()
        entry = {"card_ms": time_ms(lambda: affine_warp_image(img_d, aff_d, (res, res), mode=mode)),
                 "cpu_ms": cpu_ms, "out_dtype": str(card.dtype).replace("torch.", "")}
        if mode == "nearest":
            entry["differing_pixels"] = int((card != cpu).any(-1).sum())
            pil = np.stack([np.asarray(T.transform_img(Image.fromarray(imgs[i]), affs[i],
                                                        [res, res]))
                            for i in range(batch // 2, batch)])
            entry["eval_crops_differing_from_pil"] = int((cpu[batch // 2:].numpy() != pil)
                                                         .any(-1).sum())
        else:
            entry["max_abs_err"] = float((card - cpu).abs().max())
            entry["finite"] = bool(torch.isfinite(card).all())
        out[mode] = entry
    out["ok"] = (out["nearest"]["differing_pixels"] == 0
                 and out["nearest"]["eval_crops_differing_from_pil"] == 0
                 and out["bilinear"]["finite"] and out["bilinear"]["max_abs_err"] <= 1e-3)
    emit(out)
    if not out["ok"]:
        raise AssertionError("the warp on the card disagrees with the CPU or with PIL")
    return out


# ---- phase 10: the data-parallel wrappers --------------------------------------

PARALLEL_MODES = ("off", "zero1", "fsdp")
# the world-size-1 comparison: presampled twice, then field-guided twice, on
# the two batches in turn
WORLD1_STEPS = ((True, 0), (True, 1), (False, 0), (False, 1))
WORLD1_LOSS_TOL, WORLD1_GROUP_TOL = 1e-6, 1e-5
TWO_RANKS_LOSS_TOL = 1e-5
PARALLEL_EVAL_TOL = 1e-5


def _plain_model(cfg, seed: int = 0):
    """``build_model``'s seeded weights with every dropout off, on the host."""
    from hoisdf_torch.models.hoisdf import build_model
    from hoisdf_torch.models.layers import Dropout

    model = build_model(cfg, seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _train_batches(cfg, batch_size: int, n: int = 2):
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch

    return [split_inputs_targets(synthetic_batch(cfg, batch_size, seed=200 + i, train=True))
            for i in range(n)]


def _groups_of(state_dict, names) -> dict:
    """Per top-level module: its parameters' values, flat f64 on the host."""
    import torch

    groups = {}
    for name in names:
        groups.setdefault(name.split(".")[0], []).append(
            state_dict[name].detach().double().reshape(-1).cpu())
    return {k: torch.cat(v) for k, v in groups.items()}


def _world1_child(mesh, cfg, batch_size: int):
    """On a world-size-1 NCCL group: the train step in plain (no group), DDP,
    ZeRO-1 and FSDP through WORLD1_STEPS, each step from the same state:
    before each step every mode loads the plain run's state of that step
    (weights and moments, ``parallel.zero.load_full_state``), and the
    field-guided steps take the selections of a first, recording plain run
    (``recorded_selections``).  cuDNN picks deterministic algorithms for
    these steps.  Per mode and step: the losses and each parameter group's
    gradient, held against the plain run's (the gradient's scaled
    difference: ||g - g_plain|| / ||g_plain||); a second plain run gives the
    card's own floor.  Then each mode's host ms per presampled step (median
    of 3, cuDNN's default algorithms).  Per mode also the kernel launches of
    the four steps and the peak memory."""
    import copy
    import gc

    import numpy as np
    import torch

    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.parallel.zero import full_state_dicts, load_full_state
    from hoisdf_torch.train import create_train_state, make_train_step

    dev = mesh.device
    base = _plain_model(cfg)
    names = [n for n, _ in base.named_parameters()]
    batches = _train_batches(cfg, batch_size)
    step = make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device=dev)

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else
                (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else copy.deepcopy(v))
                for k, v in tree.items()}

    def grads_of(state):
        from torch.distributed.tensor import DTensor

        return _groups_of({n: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad)
                           for n, p in state.module.named_parameters()}, names)

    out, selections, ref_states, ref = {}, [], [], None
    torch.backends.cudnn.deterministic = True
    for mode in ("plain_record", "plain", *PARALLEL_MODES, "plain_repeat"):
        plain = mode.startswith("plain")
        state = create_train_state(cfg, copy.deepcopy(base), 100, device=dev,
                                   mesh=None if plain else mesh,
                                   zero="off" if plain else mode)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        losses, grads = [], []
        for i, (pre, b) in enumerate(WORLD1_STEPS):
            if mode == "plain":
                ref_states.append(tuple(host(d) for d in full_state_dicts(state)))
            elif mode != "plain_record":
                load_full_state(state, *ref_states[i])
                state.step = i
            impose = None if mode == "plain_record" else selections[i]
            with recorded_selections(impose) as seen:
                state, l = step(state, *batches[b], None, 0.0, use_presampled=pre)
            if mode == "plain_record":
                selections.append([s["points"] for s in seen])
                continue
            losses.append({k: float(v) for k, v in l.items()})
            grads.append(grads_of(state))
        torch.cuda.synchronize(dev)
        entry = {"launches": dict(launch_counts),
                 "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if mode == "plain":
            ref = (losses, grads)
        if mode != "plain_record":
            entry["losses"] = losses
            entry["grad_scaled_diff"] = [
                {k: float((g[k] - w[k]).norm() / max(float(w[k].norm()), 1e-30)) for k in w}
                for g, w in zip(grads, ref[1])]
        if mode != "plain_repeat" and mode != "plain_record":
            torch.backends.cudnn.deterministic = False
            times = []
            for _ in range(4):  # the first as a warmup
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                step(state, *batches[0], None, 0.0, use_presampled=True)
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            torch.backends.cudnn.deterministic = True
            entry.update(ms_per_step=float(np.median(times[1:])), ms_runs=times[1:])
        out[mode] = entry
        del state, l
        gc.collect()  # the wrappers hold reference cycles: free the mode before the next
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    out["tf32"] = tf32_on()
    return out


def _loss_rel_err(got, want) -> float:
    return max(abs(got[k] - v) / max(abs(v), 1e-3) for k, v in want.items())


def world1_check(cfg, batch_size: int, device, workdir: str) -> dict:
    """The parallel phase's ``world1`` line: the wrappers on one card through
    a world-size-1 NCCL group (a child process) against the plain step, step
    by step from the same state (``_world1_child``): each loss within
    WORLD1_LOSS_TOL relative, each group's gradient within WORLD1_GROUP_TOL
    scaled or within twice the card's own floor (a second plain run's,
    ``card_floor``), where that is more; every kernel of the path launched;
    the wrappers' host ms per step beside the plain step's."""
    import numpy as np

    from hoisdf_torch.parallel.dryrun import run_ranks

    runs = run_ranks(_world1_child, 1, workdir, cfg, batch_size, backend="nccl",
                     device=str(device), timeout=900)[0]
    ref = runs["plain"]
    res = {"phase": "parallel", "check": "world1", "setting": cfg.setting, "batch": batch_size,
           "backend": "nccl", "world": 1, "dtype": cfg.compute_dtype, "tf32": runs["tf32"],
           "dropout": False, "dist_range": 0.0,
           "steps": ["presampled" if pre else "field_guided" for pre, _ in WORLD1_STEPS],
           "losses_plain": ref["losses"], "loss_tol": WORLD1_LOSS_TOL,
           "group_tol": WORLD1_GROUP_TOL, "card": smi_line()}
    # the gather's backward adds its fine levels with f32 atomics, so two
    # plain runs differ too: a group may reach twice that floor
    floor = max(max(d.values()) for d in runs["plain_repeat"]["grad_scaled_diff"])
    group_tol = max(WORLD1_GROUP_TOL, 2 * floor)
    res.update(card_floor=floor, group_tol_applied=group_tol)
    ok = True
    for mode in (*PARALLEL_MODES, "plain_repeat"):
        r = runs[mode]
        loss_err = max(_loss_rel_err(g, w) for g, w in zip(r["losses"], ref["losses"]))
        group_err = max(max(d.values()) for d in r["grad_scaled_diff"])
        res[mode] = {"loss_rel_err": loss_err, "grad_scaled_diff_max": group_err,
                     "grad_scaled_diff": r["grad_scaled_diff"],
                     "bitwise": r["losses"] == ref["losses"] and group_err == 0.0,
                     "peak_mem_gib": r["peak_mem_gib"], "launches": r["launches"]}
        if mode in PARALLEL_MODES:
            res[mode].update(ms_per_step=r["ms_per_step"], ms_runs=r["ms_runs"])
            ok = ok and (loss_err <= WORLD1_LOSS_TOL and group_err <= group_tol
                         and all(r["launches"][k] > 0
                                 for k in ("sdf_mlp", "gather_lerp", "gather_lerp_bwd")))
    res["plain"] = {"ms_per_step": ref["ms_per_step"], "ms_runs": ref["ms_runs"],
                    "peak_mem_gib": ref["peak_mem_gib"], "launches": ref["launches"]}
    finite = all(np.isfinite(v) for m in ("plain", *PARALLEL_MODES)
                 for l in runs[m]["losses"] for v in l.values())
    res["finite"] = finite
    res["ok"] = ok and finite and not res["tf32"]
    emit(res)
    if not res["ok"]:
        raise AssertionError("the data-parallel wrappers at world size 1 disagree with the "
                             "plain step, a loss is not finite or a kernel never ran")
    return res


def _host_grads(module, mesh) -> dict:
    """The parameters' gradients, whole, on the host of every rank: an FSDP
    gradient (a DTensor sharded on dim 0) is gathered from each rank's local
    shard as a host copy (``all_gather_object``), never by a collective on
    the card's tensors over gloo."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    out = {}
    for n, p in module.named_parameters():
        g = p.grad
        if isinstance(g, DTensor):
            if tuple(g.placements) != (Shard(0),):
                raise AssertionError(f"{n}: FSDP gradient placed as {g.placements}")
            parts = [None] * mesh.world
            dist.all_gather_object(parts, g.to_local().detach().cpu(), group=mesh.group)
            out[n] = torch.cat(parts).reshape(g.shape)
        else:
            out[n] = g.detach().cpu()
    return out


def _two_ranks_child(mesh, cfg, ref_path: str):
    """One of two ranks on one card (gloo): its 11 rows of the 22-row batch,
    one presampled step in DDP, ZeRO-1 and FSDP from the reference's weights,
    every ReLU passing the reference's rows (``relu_pattern(shard=...)``);
    rank 0 holds each mode's gradients (FSDP's gathered to the host,
    ``_host_grads``) against the one-process step's.  Then a second step (its
    own ReLUs), whose peak is the steady state's: the AdamW moments exist
    from the first step on.  cuBLAS's workspaces are made before the first
    mode, so every mode starts holding them.  Per mode: losses, ReLU ties,
    the memory held before the mode's state is made (nothing of the
    previous mode may stay),
    the first step's and the second step's peak; rank 0: each group's
    gradient error."""
    import copy
    import gc

    import torch

    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.parallel.mesh import shard_batch
    from hoisdf_torch.train import create_train_state, make_train_step

    dev = mesh.device
    ref = torch.load(ref_path, map_location="cpu", mmap=True, weights_only=False)
    base = _plain_model(cfg)
    inputs, targets = ref["batch"]
    inputs, targets = shard_batch(inputs, mesh), shard_batch(targets, mesh)
    step = make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device=dev)
    w = torch.randn(64, 64, device=dev, requires_grad=True)
    (w @ w).sum().backward()  # cuBLAS's two workspaces (forward, backward thread) held by all
    del w
    out = {}
    for mode in PARALLEL_MODES:
        torch.cuda.synchronize(dev)
        held_before = torch.cuda.memory_allocated(dev) / 2**30
        state = create_train_state(cfg, copy.deepcopy(base), 100, device=dev, mesh=mesh,
                                   zero=mode)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        impose = relu_pattern(ref["relu_masks"], shard=(mesh.rank, mesh.world))
        reset_launch_counts()
        with impose:
            state, losses = step(state, inputs, targets, None, 0.0, use_presampled=True)
        torch.cuda.synchronize(dev)
        entry = {"losses": {k: float(v) for k, v in losses.items()},
                 "ties": impose.ties, "launches": dict(launch_counts),
                 "held_before_gib": held_before,
                 "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        grads = _host_grads(state.module, mesh)
        if mesh.rank == 0:
            got = _groups_of(grads, ref["names"])
            entry["grad_rel_err"] = {k: float((v - ref["grads"][k]).norm()
                                              / max(float(ref["grads"][k].norm()), 1e-30))
                                     for k, v in got.items()}
        del grads
        torch.cuda.reset_peak_memory_stats(dev)
        state, _ = step(state, inputs, targets, None, 0.0, use_presampled=True)
        torch.cuda.synchronize(dev)
        entry["peak_mem_steady_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out[mode] = entry
        del state, losses, impose
        gc.collect()
        torch.cuda.empty_cache()
    return out


def two_ranks_check(cfg, batch_size: int, device, workdir: str, grad_tol: float = 1e-3,
                    scalar_grad_tol: float = 5e-3, tie_rel: float = TIE_REL) -> dict:
    """The parallel phase's ``two_ranks`` line: two processes on the one card
    (NCCL refuses two ranks on a device; gloo all-reduces and broadcasts
    CUDA tensors), each with half of a ``batch_size``-row batch, in DDP,
    ZeRO-1 and FSDP, against this process's one-process step on the whole
    batch: the losses within TWO_RANKS_LOSS_TOL relative; each parameter
    group's gradient within ``grad_tol`` relative in norm, the scalar SDF
    betas within ``scalar_grad_tol`` (``compare_train_step``'s tolerances),
    the ranks' ReLUs passing the one-process step's elements (its own
    decisions differing at near-ties only).  Memory per rank: the first
    step's peak and the second step's (the steady state, with the AdamW
    moments), where ZeRO-1's must not exceed DDP's.  Two ranks that share a
    card measure correctness and per-rank memory, not scaling."""
    import os

    import torch

    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.parallel.dryrun import run_ranks
    from hoisdf_torch.train import create_train_state, make_train_step

    batch = _train_batches(cfg, batch_size, 1)[0]
    state = create_train_state(cfg, _plain_model(cfg), 100, device=device)
    record = relu_pattern()
    with record:
        _, losses = make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)),
                                    device=device)(state, *batch, None, 0.0, use_presampled=True)
    names = [n for n, _ in state.model.named_parameters()]
    grads = _groups_of({n: p.grad for n, p in state.model.named_parameters()}, names)
    ref_losses = {k: float(v) for k, v in losses.items()}
    ref_path = os.path.join(workdir, "two_ranks_ref.pt")
    torch.save({"batch": batch, "relu_masks": record.masks, "grads": grads, "names": names},
               ref_path)
    del state, record
    torch.cuda.empty_cache()
    ranks = run_ranks(_two_ranks_child, 2, workdir, cfg, ref_path, backend="gloo",
                      device=str(device), timeout=900)
    res = {"phase": "parallel", "check": "two_ranks", "setting": cfg.setting,
           "batch": batch_size, "rows_per_rank": batch_size // 2, "backend": "gloo",
           "world": 2, "shared_card": True, "dtype": cfg.compute_dtype, "tf32": tf32_on(),
           "losses_one_process": ref_losses, "loss_tol": TWO_RANKS_LOSS_TOL,
           "grad_tol": grad_tol, "scalar_grad_tol": scalar_grad_tol, "tie_rel": tie_rel,
           "card": smi_line(),
           "note": "two ranks share one card: correctness and per-rank memory, not scaling"}
    ok = True
    for mode in PARALLEL_MODES:
        flips = [t for r in ranks for t in r[mode]["ties"] if t[0]]
        errs = ranks[0][mode]["grad_rel_err"]
        entry = {"peak_mem_gib_per_rank": [r[mode]["peak_mem_gib"] for r in ranks],
                 "peak_mem_steady_gib_per_rank": [r[mode]["peak_mem_steady_gib"]
                                                  for r in ranks],
                 "held_before_gib_per_rank": [r[mode]["held_before_gib"] for r in ranks],
                 "launches_rank0": ranks[0][mode]["launches"],
                 "loss_rel_err": max(_loss_rel_err(r[mode]["losses"], ref_losses)
                                     for r in ranks),
                 "ranks_agree": ranks[0][mode]["losses"] == ranks[1][mode]["losses"],
                 "grad_rel_err": errs, "relu_switched": sum(t[0] for t in flips),
                 "relu_switched_max_rel": max((n / t for _, n, t, _ in flips), default=0.0)}
        entry["ok"] = (entry["loss_rel_err"] <= TWO_RANKS_LOSS_TOL and entry["ranks_agree"]
                       and all(e <= (scalar_grad_tol if k in SCALAR_GROUPS else grad_tol)
                               for k, e in errs.items())
                       and entry["relu_switched_max_rel"] <= tie_rel)
        ok = ok and entry["ok"]
        res[mode] = entry
    res["zero1_steady_at_or_below_ddp"] = all(
        r["zero1"]["peak_mem_steady_gib"] <= r["off"]["peak_mem_steady_gib"] for r in ranks)
    res["ok"] = ok and res["zero1_steady_at_or_below_ddp"] and not res["tf32"]
    emit(res)
    if not res["ok"]:
        raise AssertionError("two ranks on the card disagree with the one-process step, or "
                             "ZeRO-1 holds more memory than DDP")
    return res


def _parallel_eval_child(mesh, cfg, ref_path: str):
    """Rank ``mesh.rank`` of a data-parallel ``evaluate_batches`` on the
    card, each sampler call taking the one-process run's selections."""
    import torch

    from hoisdf_torch.evaluate import Evaluator, evaluate_batches
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.parallel.mesh import rows_of
    from hoisdf_torch.train import make_eval_step

    ref = torch.load(ref_path, map_location="cpu", weights_only=False)
    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    step = make_eval_step(cfg, build_biased_model(cfg), mano, device=mesh.device)
    evaluator = Evaluator(cfg, mano, device=mesh.device) if mesh.rank == 0 else None
    rows = rows_of(ref["batch_size"], mesh)
    with recorded_selections([p[rows] for p in ref["selections"]]):
        evaluate_batches(cfg, step, evaluator, ref["batches"], ref["batch_size"], mesh=mesh)
    if evaluator is None:
        return None
    return {"results": {k: v / evaluator.total for k, v in evaluator.results.items()},
            "total": evaluator.total}


def parallel_eval_check(cfg, batch_size: int, device, workdir: str,
                        n_batches: int = 2) -> dict:
    """The parallel phase's ``eval`` line: ``evaluate_batches`` at two ranks
    on the card (gloo, half of each batch a rank, the predictions gathered
    to rank 0) against one rank here, f32, every sampler call taking this
    run's selections: every result within PARALLEL_EVAL_TOL relative."""
    import os

    import numpy as np
    import torch

    from hoisdf_torch.evaluate import Evaluator, evaluate_batches
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.parallel.dryrun import run_ranks
    from hoisdf_torch.train import make_eval_step

    mano = ManoBuffers.from_model(make_synthetic_mano(0))
    batches = _eval_batches(cfg, n_batches, batch_size)
    evaluator = Evaluator(cfg, mano, device=device)
    step = make_eval_step(cfg, build_biased_model(cfg), mano, device=device)
    with recorded_selections() as seen:
        evaluate_batches(cfg, step, evaluator, batches, batch_size)
    want = {k: v / evaluator.total for k, v in evaluator.results.items()}
    ref_path = os.path.join(workdir, "eval_ref.pt")
    torch.save({"batches": batches, "batch_size": batch_size,
                "selections": [s["points"] for s in seen]}, ref_path)
    del step
    torch.cuda.empty_cache()
    got = run_ranks(_parallel_eval_child, 2, workdir, cfg, ref_path, backend="gloo",
                    device=str(device), timeout=900)[0]
    errs = _rel_errs(got["results"], want)
    res = {"phase": "parallel", "check": "eval", "setting": cfg.setting, "batch": batch_size,
           "batches": n_batches, "world": 2, "backend": "gloo", "shared_card": True,
           "dtype": cfg.compute_dtype, "results_one_rank": want, "results_two_ranks":
           got["results"], "total": got["total"], "max_rel_err": max(errs.values()),
           "tol": PARALLEL_EVAL_TOL, "card": smi_line()}
    res["ok"] = (got["total"] == evaluator.total == n_batches * batch_size
                 and res["max_rel_err"] <= PARALLEL_EVAL_TOL
                 and all(np.isfinite(v) for v in got["results"].values()))
    emit(res)
    if not res["ok"]:
        raise AssertionError("data-parallel eval on the card disagrees with one rank")
    return res


def parallel_phase(device, batch_size: int = 22) -> dict:
    """The data-parallel wrappers on the card: ``world1``, ``two_ranks`` and
    ``eval`` lines (the dexycb preset at full width, f32, TF32 off, dropout
    off, no jitter).  Each starts its ranks as child processes and fails on
    a rank that fails."""
    import tempfile

    from hoisdf_torch.config import get_config

    cfg = get_config("dexycb")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as workdir:
        world1 = world1_check(cfg, batch_size, device, workdir)
        two = two_ranks_check(cfg, batch_size, device, workdir)
        ev = parallel_eval_check(get_config("dexycb", compute_dtype="float32"), batch_size,
                                 device, workdir)
    return {"world1": world1, "two_ranks": two, "eval": ev}


PLAIN_VERSIONS = ("gather_lerp_plain", "gather_nearest_plain", "gather_lerp_bwd_plain",
                  "sdf_mlp_plain")


@contextlib.contextmanager
def plain_guard(seen: list):
    """Within it, every call of a kernel's plain version that code of the
    port (a module under ``hoisdf_torch``) makes with a CUDA tensor is noted
    in ``seen``: on the card the port must reach each kernel, never its
    plain twin.  This script's own comparisons call the plain versions on
    the card on purpose and are not noted.  Covers this process only (not
    the spawned ranks or the mains' loader workers)."""
    import torch

    from hoisdf_torch.ops.kernels import gather_lerp, sdf_mlp

    def on_card(args):
        for a in args:
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    return True
        return False

    saved = []
    for mod in (gather_lerp, sdf_mlp):
        for name in PLAIN_VERSIONS:
            if not hasattr(mod, name):
                continue
            fn = getattr(mod, name)

            def noted(*args, _fn=fn, _name=name, **kwargs):
                caller = sys._getframe(1).f_globals.get("__name__", "")
                if caller.startswith("hoisdf_torch") and on_card(args):
                    seen.append(f"{_name} called by {caller}")
                return _fn(*args, **kwargs)

            saved.append((mod, name, fn))
            setattr(mod, name, noted)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from hoisdf_torch.native.build import build as build_native
    from hoisdf_torch.ops.kernels import build

    t_start = time.perf_counter()

    def mark(name: str) -> None:  # each phase's end, on stderr
        print(f"chip_smoke: {name} done at {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr, flush=True)

    device = torch.device("cuda", 0)
    smi = smi_line()

    # the image pipeline's g++ build runs beside the kernels' nvcc builds; a
    # failed build of either fails the run
    with ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(build_native)
        info = build.build()
        native = native_build.result()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": regs})
    emit({"phase": "native", **{k: native[k] for k in (
        "seconds", "built", "cxx", "headers", "codecs", "decode", "path")}})

    plain_calls: list = []
    with plain_guard(plain_calls):
        return _phases(device, smi, native, t_start, mark, plain_calls)


def _phases(device, smi, native, t_start, mark, plain_calls) -> int:
    """Every phase after the builds, in order (``main``)."""
    import torch

    from hoisdf_torch.config import get_config

    serve_batch = 22
    train_cfg = get_config("dexycb")  # the preset: f32 compute, train batch 22
    sdf_timed = check_sdf_mlp(device, batch=serve_batch)
    gather_timed = check_gather_lerp(device, batch=serve_batch, points=3584)
    gather_ho3d = check_gather_lerp_ho3d(device, batch=serve_batch, points=3584)
    # the gather backward's largest train launch: the merged token gather
    bwd_timed = check_gather_lerp_bwd(device, batch=train_cfg.train_batch_size,
                                      points=train_cfg.num_samp_hand + train_cfg.num_samp_obj)
    mark("build and kernel")

    for setting in ("dexycb", "ho3d", "ho3d_render"):
        compare_forward(get_config(setting, compute_dtype="float32"), 2, device)
    nearest, sampler_steps = sampler_phase(device, serve_batch)
    mark("forward and sampler")

    serve_cfg = get_config("dexycb", compute_dtype="bfloat16")
    predictors = serving_predictors(serve_cfg, serve_batch, device)
    frames = serving_frames(serve_cfg, serve_batch)
    serve_res = serve(predictors, frames, serve_cfg, serve_batch, requests=40, device=device)
    closed = serve_closed(predictors["uint8"], frames, serve_cfg, 3 * serve_batch, device)
    serve_poisson(predictors["uint8"], frames, serve_cfg, closed["frames_per_s"])
    # the phases that run torch.profiler come after the host-timed ones
    serve_async(predictors, frames, serve_cfg, serve_batch, device)
    profile_step(predictors["float32"])
    mark("serving")
    exported = export_phase(predictors["uint8"], frames["uint8"])
    profile_trace_phase(predictors["uint8"], frames["uint8"])
    del predictors
    mano_phase(device)
    mark("export, profile_trace and mano")

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
    mark("train")
    backbone_init_phase(device, train_cfg.train_batch_size)
    data_phase(device, train_res["presampled"]["median_ms"], native)
    warp_phase(device)
    mark("backbone_init, data and warp")

    evals, checks = {}, []
    for setting in EVAL_PRESETS:
        evals[setting], check = evaluate_preset(setting, device, batch_size=serve_batch)
        checks.append(check)
    eval_check = {"phase": "eval_check", "batch": serve_batch, "presets": checks,
                  "ok": all(c["ok"] for c in checks)}
    emit(eval_check)
    if not eval_check["ok"]:
        raise AssertionError("the evaluator's results on the card and on the CPU disagree")
    mark("eval")

    par = parallel_phase(device, batch_size=train_cfg.train_batch_size)
    mark("parallel")

    launches, train_launches = serve_res["launches"], train_res["launches"]
    kernels = [
        {"name": "sdf_mlp", "route": "cuda", "source": "hoisdf_torch/csrc/sdf_mlp.cu",
         "replaces": SDF_TPU, "launches": launches["sdf_mlp"],
         "launches_server": closed["launches"]["sdf_mlp"],
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
         "launches_server": closed["launches"]["gather_lerp"],
         "max_abs_err": gather_timed["max_abs_err"],
         "ms": gather_timed["ms"], "plain_ms": gather_timed["plain_ms"],
         "bound_ms": gather_timed["bound_ms"], "bound_by": gather_timed["bound_by"],
         "library_ms": gather_timed["library_ms"],
         "launches_eval": {s: r["launches"]["gather_lerp"] for s, r in evals.items()},
         **{f"ho3d_{k}": gather_ho3d[k] for k in gather_ho3d
            if k.startswith(("bf16_", "f32_"))},
         # the nearest mode: dexycb bf16 first, as the bilinear figures above
         "nearest_launches": sampler_steps["nearest"]["launches"]["gather_lerp_nearest"],
         "nearest_launches_sampler": {s: r["launches"]["gather_lerp_nearest"]
                                      for s, r in sampler_steps.items()},
         **{f"nearest_{k[5:]}": nearest["dexycb"][k] for k in (
             "bf16_ms", "bf16_plain_ms", "bf16_bound_ms", "bf16_bound_by", "bf16_library_ms",
             "bf16_max_abs_err")},
         **{f"nearest_{p}_{k}": r[k] for p, r in nearest.items() for k in r
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
    export_launches = exported["programs"]["fixed"]["calls"][str(serve_batch)]["launches"]
    for entry in kernels[:2]:  # launches in one call of the exported serving program
        entry["launches_export"] = export_launches[entry["name"]]
    for entry in kernels:  # launches in each preset's train phase and under each wrapper
        entry["launches_train"] = {s: r["launches"][entry["name"]] for s, r in trains.items()}
        entry["launches_parallel"] = {m: par["world1"][m]["launches"][entry["name"]]
                                      for m in PARALLEL_MODES}
    guard = {"phase": "plain_guard", "port_calls_on_card": plain_calls[:20],
             "ok": not plain_calls}
    emit(guard)
    if not guard["ok"]:
        raise AssertionError("the port ran a kernel's plain version on a CUDA tensor")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
