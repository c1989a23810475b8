"""Drive the PyTorch port (hoisdf_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   - nvcc builds the CUDA kernels from hoisdf_torch/csrc into
             hoisdf_torch/_build (sm_90a); seconds, card name, power limit.
2. kernel  - each kernel against its plain PyTorch version on the card, f32
             and bf16, at the serving shapes, with its time, the plain
             version's time, one stock PyTorch call's time and its bound.
             The SDF MLP is checked at ragged row counts around its tile
             size, smallest first, and timed in bf16 at each of the eight
             row counts of a serving step (their sum is step_ms).  Its biases
             are drawn, and each must move the output by more than the
             tolerance.  The gather is also timed on its fine levels (0-2)
             and its coarse levels (3-4) alone.
3. forward - the full-width dexycb eval forward, batch 2, f32 with TF32 off:
             card (through the kernels) against CPU (plain versions), with
             drawn SDF decoder biases.
4. serve   - the main path: a dexycb Predictor at bf16, batch 22, answers
             40 requests on each of the u8 and the f32 wire, in turn; p50
             and p90 latency, frames/s, peak memory, kernel launches per step
             (from the wrappers' counters, zeroed just before the requests).
5. kernels - one line listing both kernels with the numbers this run took.

Any failed check raises, and the script exits non-zero.  The last line is
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints no result.
Weights are random, made from a seed; MANO is the synthetic stand-in.
"""

from __future__ import annotations

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
RAGGED_ROWS = (1, 63, 64, 65, 127, 128, 129, 255, 257)
GATHER_TPU = "hoisdf_tpu/ops/pallas/gather_lerp.py:89"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
            if latent == 256 and dtype == torch.bfloat16:
                xs = x[:rows_big].contiguous()
                wb = weights.plain

                def library():  # the stock bf16 matmul chain (cuBLAS)
                    h = F.relu(F.linear(xs, wb[0].t(), wb[1]))
                    h = F.relu(F.linear(h, wb[2].t(), wb[3]))
                    h = F.relu(F.linear(torch.cat([h, xs], -1), wb[4].t(), wb[5]))
                    h = F.relu(F.linear(h, wb[6].t(), wb[7]))
                    return torch.tanh(F.linear(h, wb[8].t(), wb[9]))

                macs = sum(w.numel() for w in wb[0::2])
                w_bytes = sum(w.numel() * 2 for w in wb)

                def bound_for(rows):
                    return bound(2.0 * rows * macs, H100_BF16_FLOPS,
                                 rows * (xs.shape[1] * 2 + 4) + w_bytes)

                b_ms, b_by = bound_for(rows_big)
                timed = {"ms": time_ms(lambda: sdf_mlp(xs, weights)),
                         "plain_ms": time_ms(lambda: sdf_mlp_plain(xs, wb)),
                         "library_ms": time_ms(library), "bound_ms": b_ms,
                         "bound_by": b_by, "max_abs_err": err, "rows": rows_big,
                         "dtype": "bfloat16"}
                # one serving step: the eight launches of the two cascades
                by_rows = {}
                for rows in sorted(set(step_rows)):
                    xr = x[:rows].contiguous()
                    by_rows[rows] = time_ms(lambda: sdf_mlp(xr, weights))
                timed["step_rows"] = step_rows
                timed["ms_by_rows"] = by_rows
                timed["step_ms"] = sum(by_rows[r] for r in step_rows)
                timed["step_bound_ms"] = sum(bound_for(r)[0] for r in step_rows)
                res.update({k: timed[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "step_rows",
                    "ms_by_rows", "step_ms", "step_bound_ms")})
            emit(res)
            if not ok:
                raise AssertionError(f"sdf_mlp disagrees with its plain version, or a "
                                     f"bias would go unseen: {res}")
    return timed


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
    in another order.  Errors are scaled by max(1, max |cpu value|)."""
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
    res = {"phase": "forward", "batch": batch_size, "dtype": "float32",
           "overlap_hand": overlap["hand"], "overlap_obj": overlap["obj"],
           "max_scaled_err": worst, "worst_key": max(errs, key=errs.get), "tol": tol,
           "card_repeat_bitwise": repeat_equal, "cpu_seconds": cpu_s,
           "finite": finite, "errors": errs}
    res["ok"] = finite and overlap["hand"] == 1.0 and overlap["obj"] == 1.0 and worst <= tol
    emit(res)
    if not res["ok"]:
        raise AssertionError("card and CPU disagree on the eval forward")
    return res


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


def profile_step(predictor, frames_seed: int = 7):
    """Device time by kernel name over two serving steps (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hoisdf_torch.data.synthetic import synthetic_batch

    fr = synthetic_batch(predictor.cfg, predictor.batch_size, seed=frames_seed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            predictor.predict(fr)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 2e3, ev.count // 2, ev.key[:80]))
    rows.sort(reverse=True)
    groups = {}
    for ms, calls, key in rows:
        name = next((g for g in ("sdf_mlp", "gather_lerp", "Memcpy") if g in key), "other")
        acc = groups.setdefault(name, {"ms": 0.0, "launches": 0})
        acc["ms"] += ms
        acc["launches"] += calls
    out = {"phase": "profile", "steps": 2,
           "device_ms_per_step": sum(r[0] for r in rows),
           "launches_per_step": sum(r[1] for r in rows), "by_group": groups,
           "top": [{"ms": r[0], "calls": r[1], "kernel": r[2]} for r in rows[:15]]}
    emit(out)
    return out


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()

    info = build.build()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": regs})

    serve_batch = 22
    sdf_timed = check_sdf_mlp(device, batch=serve_batch)
    gather_timed = check_gather_lerp(device, batch=serve_batch, points=3584)

    compare_forward(get_config("dexycb", compute_dtype="float32"), 2, device)

    serve_res, predictor = serve(get_config("dexycb", compute_dtype="bfloat16"),
                                 serve_batch, requests=40, device=device)
    profile_step(predictor)

    launches = serve_res["launches"]
    kernels = [
        {"name": "sdf_mlp", "route": "cuda", "source": "hoisdf_torch/csrc/sdf_mlp.cu",
         "replaces": SDF_TPU, "launches": launches["sdf_mlp"],
         "max_abs_err": sdf_timed["max_abs_err"], "ms": sdf_timed["ms"],
         "plain_ms": sdf_timed["plain_ms"], "bound_ms": sdf_timed["bound_ms"],
         "bound_by": sdf_timed["bound_by"], "library_ms": sdf_timed["library_ms"],
         "step_ms": sdf_timed["step_ms"], "step_bound_ms": sdf_timed["step_bound_ms"]},
        {"name": "gather_lerp", "route": "cuda",
         "source": "hoisdf_torch/csrc/gather_lerp.cu", "replaces": GATHER_TPU,
         "launches": launches["gather_lerp"], "max_abs_err": gather_timed["max_abs_err"],
         "ms": gather_timed["ms"], "plain_ms": gather_timed["plain_ms"],
         "bound_ms": gather_timed["bound_ms"], "bound_by": gather_timed["bound_by"],
         "library_ms": gather_timed["library_ms"]},
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
