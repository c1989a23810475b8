"""Benchmark of the port on one card (``hoisdf-torch-bench``): the eval
step's throughput, latency, device time and MFU, serving under closed-loop
and Poisson load, the train step, and batch sweeps.  The counterpart of
``hoisdf_tpu/bench.py`` with the repo-root ``bench.py`` and
``bench_components.py``; it imports torch and numpy only.

    hoisdf-torch-bench [--setting dexycb] [--batch 22] [--iters 10]
        [--warmup 2] [--runs 3] [--sdf-infer-mode hier] [--dtype bfloat16]
        [--transfer-dtype uint8] [--hier-levels JSON] [--cfg KEY=VALUE ...]
        [--cpu]
    ... --serve [--serve-seconds 20] [--serve-clients 3 x batch]
    ... --serve-poisson R1,R2,... [--serve-max-wait-ms 5]
    ... --train [--train-setting dexycb] [--train-batch 22]
    ... --batch-sweep B1,B2,... [--record [--root DIR]]

**The headline** (no mode flag) times ``train.make_eval_step`` on the
seeded weights of ``build_model(cfg, 0)`` and the synthetic eval batch,
images on the ``--transfer-dtype`` wire, host inputs pinned.  Each of
``--runs`` runs, after ``--warmup`` steps, takes:

* blocking latency: ``--iters`` steps, each followed by a synchronize; p50
  and p90 (``np.percentile``) per batch and per frame, and the host's time
  in one step call until it returns (``host_ms``, median);
* pipelined frames/s: ``--iters`` steps enqueued with no synchronize (the
  step makes none), then one;
* device ms and kernel launches per step (``utils/profiling.py::
  device_breakdown``, one profiled step), and the per-step launches of the
  SDF MLP and the gather (``ops.kernels.launch_counts`` over the blocking
  steps).

The line reports the median of each number over the runs, with its spread
(min, max) beside it: the host's time moves by a third between runs.  MFU
is ``flops_per_frame x frames/s / peak``: ``flops_per_frame`` from
``FlopCounterMode`` over one step (matrix products, convolutions and
attention; the ops ``hoisdf_torch::sdf_mlp`` and ``gather_lerp`` carry
formulas of their own), ``peak`` the card's dense peak for the step's type
from :data:`PEAK_FLOPS`.  On the CPU, or on a card missing from the table,
``mfu`` is null and ``mfu_note`` says why.  The last line printed is one
JSON object (``"metric": "eval_fps"``).  There is no ``vs_baseline``: the
repository's bench history is of TPU rounds, and no number of the port is
set beside a TPU's.

``--serve`` and ``--serve-poisson`` drive a ``Predictor`` (the same seeded
weights, batch ``--batch``) through a ``BatchingServer``: closed-loop
clients for ``--serve-seconds``, then one open-loop Poisson run per offered
rate.  ``--train`` times the preset's f32 train step (TF32 off, as
training runs) per branch, median of 3 steps.  ``--batch-sweep`` runs the
headline at each batch; ``--record`` writes the rows to
``ROOT/docs/torch_eval_batch_sweep_<setting>.json``.

``--cpu`` runs the JAX bench's ``--cpu`` model (ResNet-18, hidden 64, 2+2
transformer layers, 32 / 16 samples, 64 x 64 input, a 16^3 lattice with
the cascade ((4, 16), (2, 48))) in f32 (``--dtype`` is ignored there, as
in the JAX bench; ``--cfg compute_dtype=bfloat16`` sets it), at most 4
frames a batch, each kernel's plain version.  Without ``--cpu`` the bench
needs a card and exits non-zero without one.

Left out of the JAX bench, and why:

* the batch ladder and the ``--single-attempt`` fresh-process retries: they
  recover from TPU client faults.  On the card a failure fails the run with
  its traceback.
* ``--no-fused``: on the card it would run the plain SDF MLP, a fallback
  that hides the kernel.
* the persistent compile cache: eager PyTorch compiles nothing per shape,
  and the CUDA kernels are built once into ``hoisdf_torch/_build``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hoisdf_torch.config import Config, get_config, parse_cfg_overrides

# The JAX bench's --cpu model (bench.py's CPU branch).
CPU_OVERRIDES = dict(
    resnet_type=18, hidden_dim=64, dim_feedforward=128, enc_layers=2, dec_layers=2,
    num_samp_hand=32, num_samp_obj=16, input_img_shape=(64, 64),
    output_hm_shape=(32, 32, 32), bins_n=16, sdf_infer_chunk=2048)
CPU_HIER_LEVELS = ((4, 16), (2, 48))  # the cascade of a 16^3 lattice
CPU_MAX_BATCH = 4

# Dense peak FLOP/s by card name (a substring of torch.cuda.get_device_name):
# bf16 on the tensor cores, and f32 on the CUDA cores (the port runs f32
# without TF32).  H100 SXM5 and H100 PCIe, from NVIDIA's data sheets.
PEAK_FLOPS = {
    "H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
    "H100 PCIe": {"bfloat16": 756e12, "float32": 51.2e12},
}

SWEEP_FILE = "docs/torch_eval_batch_sweep_{setting}.json"


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentiles(values_ms, qs: Sequence[int] = (50, 95, 99)) -> Dict[str, Optional[float]]:
    """``{"p50_ms": ...}`` for each of ``qs``, by ``np.percentile`` (linear
    interpolation); None where there are no values."""
    v = np.asarray(values_ms, dtype=np.float64)
    return {f"p{q}_ms": float(np.percentile(v, q)) if v.size else None for q in qs}


def peak_flops(device_name: str, dtype: str) -> Optional[float]:
    """The dense peak FLOP/s of the card named ``device_name`` for
    ``dtype``, or None for a card missing from :data:`PEAK_FLOPS`."""
    for key, rates in PEAK_FLOPS.items():
        if key in device_name:
            return rates.get(dtype)
    return None


def smi() -> Tuple[str, float]:
    """(name, power limit in W) of the first card, as ``nvidia-smi`` gives
    them (its line is logged)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    line = res.stdout.strip().splitlines()[0]
    _log(line)
    name, _, limit = line.rpartition(",")
    return name.strip(), float(limit.strip().split()[0])


def build_config(setting: str = "dexycb", *, cpu: bool = False, sdf_infer_mode: str = "hier",
                 dtype: str = "bfloat16", transfer_dtype: str = "uint8",
                 hier_levels: Optional[str] = None, cfg_items: Sequence[str] = ()) -> Config:
    """The bench's config, as the JAX bench builds it: ``hier_levels`` (JSON)
    sets the whole cascade (the object field's too, unless ``cfg_items`` set
    ``hier_levels_obj``); ``cpu`` the tiny model in f32."""
    extra = parse_cfg_overrides(cfg_items)
    if hier_levels:
        extra["hier_levels"] = json.loads(hier_levels)
    if "hier_levels" in extra:
        extra.setdefault("hier_levels_obj", extra["hier_levels"])
    base = dict(sdf_infer_mode=sdf_infer_mode, transfer_dtype=transfer_dtype)
    if cpu:
        if sdf_infer_mode == "hier":
            extra.setdefault("hier_levels", CPU_HIER_LEVELS)
            extra.setdefault("hier_levels_obj", None)
        return get_config(setting, **{**CPU_OVERRIDES, **base, **extra})
    return get_config(setting, **{**base, "compute_dtype": dtype, **extra})


# ---- the eval step -----------------------------------------------------------

def eval_inputs(cfg: Config, batch: int, device: torch.device, seed: int = 0
                ) -> Dict[str, torch.Tensor]:
    """The synthetic eval batch of ``batch`` frames (the JAX bench's), the
    image on ``cfg.transfer_dtype``'s wire (u8 bytes, or the same values
    as f32), as host tensors, pinned on the card."""
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
    from hoisdf_torch.ops import wire

    inputs, _ = split_inputs_targets(synthetic_batch(cfg, batch, seed=seed, train=False))
    img = wire.quantize_image_u8(inputs["img"])
    inputs["img"] = img if cfg.transfer_dtype == "uint8" else img.astype(np.float32) / 255.0
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inputs.items()}
    if device.type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


def make_bench_step(cfg: Config, device: torch.device, seed: int = 0,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> Callable:
    """``train.make_eval_step`` (the preset's own SDF supervision, as the JAX
    bench's) on ``build_model(cfg, seed)``'s weights, or ``state_dict``.
    The parameters take no gradient: the step runs in inference mode
    anyway, and ``FlopCounterMode``'s module tracker would hook the autograd
    graph of a parameter passed as a module's input (the transformers'
    query embeddings), which an inference-mode view of it does not have."""
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.models.hoisdf import build_model
    from hoisdf_torch.train import make_eval_step

    model = build_model(cfg, seed)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.requires_grad_(False)
    return make_eval_step(cfg, model, ManoBuffers.from_model(make_synthetic_mano(0)),
                          device=device)


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one call of ``fn`` by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def measure_eval(step: Callable, inputs: Mapping, batch: int, device: torch.device,
                 iters: int = 10, warmup: int = 2) -> Dict:
    """One run of the headline (see the module's docstring)."""
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts

    for _ in range(warmup):
        step(inputs)
    _sync(device)
    reset_launch_counts()
    lat, host = [], []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        step(inputs)
        t1 = time.perf_counter()
        _sync(device)
        lat.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
    counts = dict(launch_counts)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(inputs)
    _sync(device)
    fps = batch * iters / (time.perf_counter() - t0)
    run = {"fps": fps, **{f"{k}_per_batch": v for k, v in percentiles(lat, (50, 90)).items()},
           "host_ms": float(np.median(host)),
           "launches_sdf_mlp": counts["sdf_mlp"] / iters,
           "launches_gather_lerp": counts["gather_lerp"] / iters,
           "device_ms": None, "launches": None}
    run["p50_ms_per_frame"] = run["p50_ms_per_batch"] / batch
    run["p90_ms_per_frame"] = run["p90_ms_per_batch"] / batch
    if device.type == "cuda":
        from hoisdf_torch.utils.profiling import device_breakdown

        prof = device_breakdown(lambda: step(inputs), 1)
        run.update(device_ms=prof["device_ms_per_step"], launches=prof["launches_per_step"],
                   device_by_group=prof["by_group"])
    return run


RUN_KEYS = ("fps", "p50_ms_per_batch", "p90_ms_per_batch", "p50_ms_per_frame",
            "p90_ms_per_frame", "host_ms", "device_ms", "launches", "launches_sdf_mlp",
            "launches_gather_lerp")


def headline(cfg: Config, step: Callable, inputs: Mapping, batch: int, device: torch.device,
             *, iters: int = 10, warmup: int = 2, runs: int = 3,
             card: Optional[Tuple[str, float]] = None) -> Dict:
    """The headline line of ``runs`` runs of :func:`measure_eval` (medians,
    spreads, FLOPs and MFU); ``card`` is :func:`smi`'s (name, power limit),
    None on the CPU."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    per_run = []
    for i in range(runs):
        per_run.append(measure_eval(step, inputs, batch, device, iters, warmup))
        _log(f"run {i + 1}/{runs}: {per_run[-1]['fps']:.1f} f/s, p50 "
             f"{per_run[-1]['p50_ms_per_batch']:.2f} ms a batch")
    med = {k: (float(np.median([r[k] for r in per_run])) if per_run[0][k] is not None else None)
           for k in RUN_KEYS}
    spread = {k: [min(r[k] for r in per_run), max(r[k] for r in per_run)]
              for k in RUN_KEYS if per_run[0][k] is not None}
    flops_per_frame = count_flops(lambda: step(inputs)) / batch
    peak, note = None, None
    if device.type != "cuda":
        note = "no card: MFU is a card's number"
    else:
        peak = peak_flops(torch.cuda.get_device_name(device), cfg.compute_dtype)
        if peak is None:
            note = (f"no {cfg.compute_dtype} peak for {torch.cuda.get_device_name(device)!r} "
                    "in hoisdf_torch.bench.PEAK_FLOPS")
    mfu = flops_per_frame * med["fps"] / peak if peak else None
    if mfu is not None:
        spread["mfu"] = [flops_per_frame * f / peak for f in spread["fps"]]
        note = f"flops_per_frame x frames/s / the {cfg.compute_dtype} dense peak"
    return {"metric": "eval_fps", "value": med["fps"], "unit": "frames/s",
            **{k: med[k] for k in RUN_KEYS if k != "fps"},
            "flops_per_frame": flops_per_frame, "mfu": mfu, "mfu_note": note,
            "peak_flops": peak,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
            "setting": cfg.setting, "batch": batch, "dtype": cfg.compute_dtype,
            "sampler": cfg.sdf_infer_mode, "wire": cfg.transfer_dtype, "runs": runs,
            "iters": iters, "spread": spread,
            "device_by_group": per_run[-1].get("device_by_group"),
            "device": card[0] if card else None, "power_limit_w": card[1] if card else None}


# ---- serving -----------------------------------------------------------------

def serving_pool(predictor, seed: int = 5) -> List[Dict[str, np.ndarray]]:
    """One synthetic batch of the predictor's size as single frames, the
    image as u8 bytes (a camera's) on the u8 wire, as f32 on the other."""
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
    from hoisdf_torch.ops import wire
    from hoisdf_torch.predictor import INPUT_KEYS

    inputs, _ = split_inputs_targets(synthetic_batch(predictor.cfg, predictor.batch_size,
                                                     seed=seed, train=False))
    img = wire.quantize_image_u8(inputs["img"])
    inputs["img"] = img if predictor.transfer_dtype == "uint8" else img.astype(np.float32) / 255
    return [{k: inputs[k][i] for k in INPUT_KEYS} for i in range(predictor.batch_size)]


def serve_closed(predictor, pool: Sequence[Mapping], clients: int, seconds: float,
                 max_wait_ms: float = 5.0) -> Dict:
    """``clients`` closed-loop clients, each submitting one frame of
    ``pool`` at a time to a ``BatchingServer`` for ``seconds``: frames/s,
    mean batch fill, request p50/p95/p99, the responses that lacked an
    output's shape or were not finite, the errors, and the kernel launches
    (counts zeroed just before, read just after)."""
    from hoisdf_torch.ops.kernels import launch_counts, reset_launch_counts
    from hoisdf_torch.predictor import BatchingServer

    shapes = predictor.output_shapes
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
                    latencies.append(dt * 1e3)
                    bad[0] += not good
        except Exception as exc:  # recorded; the caller judges the run
            with lock:
                errors.append(repr(exc)[:200])

    _sync(predictor.device)
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
    _sync(predictor.device)
    counts = dict(launch_counts)
    return {"clients": clients, "seconds": elapsed, "max_wait_ms": max_wait_ms,
            "frames_per_s": served / elapsed, "frames_served": served, "batches": batches,
            "mean_batch_fill": served / max(batches, 1), **percentiles(latencies),
            "responses": len(latencies), "bad_responses": bad[0], "errors": errors[:5],
            "threads_alive": sum(t.is_alive() for t in threads), "launches": counts,
            "launches_per_batch": {k: v / max(batches, 1) for k, v in counts.items()}}


def serve_poisson(predictor, pool: Sequence[Mapping], rates_hz: Sequence[float],
                  seconds: float, max_wait_ms: float = 5.0, seed: int = 7) -> List[Dict]:
    """``predictor.run_poisson_load`` at each offered rate, one
    ``BatchingServer`` a rate: goodput, submitted, completed and dropped
    (submitted and not completed), mean batch fill, p50/p95/p99."""
    from hoisdf_torch.predictor import BatchingServer, run_poisson_load

    out = []
    for rate in rates_hz:
        with BatchingServer(predictor, max_wait_ms=max_wait_ms) as srv:
            rep = run_poisson_load(srv, list(pool), rate, seconds, seed=seed)
            batches = srv.batches_dispatched
        out.append({"offered_hz": rep["offered_hz"], "goodput_hz": rep["goodput_hz"],
                    "submitted": rep["submitted"], "completed": rep["completed"],
                    "dropped": rep["submitted"] - rep["completed"],
                    "elapsed_s": rep["elapsed_s"], "batches": batches,
                    "mean_batch_fill": rep["completed"] / max(batches, 1),
                    **percentiles(np.asarray(rep["latencies_s"]) * 1e3)})
    return out


# ---- the train step ------------------------------------------------------------

def train_bench(cfg: Config, batch: int, device: torch.device, steps: int = 3,
                seed: int = 0, dist_range: float = 0.03) -> List[Dict]:
    """Per branch (presampled, field-guided): one warmup step, then the
    median of ``steps`` host-clock ms (each step ends in a synchronize), on
    a train state of ``build_model(cfg, seed)``; the last losses must be
    finite."""
    from hoisdf_torch.data.synthetic import split_inputs_targets, synthetic_batch
    from hoisdf_torch.mano.layer import ManoBuffers
    from hoisdf_torch.mano.model import make_synthetic_mano
    from hoisdf_torch.models.hoisdf import build_model
    from hoisdf_torch.train import create_train_state, make_train_step

    state = create_train_state(cfg, build_model(cfg, seed), steps_per_epoch=1000,
                               device=device)
    step = make_train_step(cfg, ManoBuffers.from_model(make_synthetic_mano(0)), device=device)
    inputs, targets = split_inputs_targets(synthetic_batch(cfg, batch, seed=seed, train=True))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = []
    for branch, pre in (("presampled", True), ("field_guided", False)):
        step(state, inputs, targets, gen, dist_range, use_presampled=pre)
        times = []
        for _ in range(steps):
            _sync(device)
            t0 = time.perf_counter()
            _, losses = step(state, inputs, targets, gen, dist_range, use_presampled=pre)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append({"metric": "train_ms", "value": float(np.median(times)), "unit": "ms/step",
                    "branch": branch, "ms": times, "setting": cfg.setting, "batch": batch,
                    "dtype": cfg.compute_dtype,
                    "finite": all(bool(torch.isfinite(v).all()) for v in losses.values())})
    return out


# ---- the command line --------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    from hoisdf_torch.config import SETTINGS

    p = argparse.ArgumentParser(prog="hoisdf-torch-bench", description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="the tiny model on the CPU (the kernels' plain versions)")
    p.add_argument("--setting", default="dexycb", choices=SETTINGS)
    p.add_argument("--batch", type=int, default=22)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--runs", type=int, default=3,
                   help="runs of the headline; each number is their median")
    p.add_argument("--sdf-infer-mode", default="hier", choices=("full", "coarse2fine", "hier"))
    p.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"),
                   help="compute dtype of the eval step (on the card)")
    p.add_argument("--transfer-dtype", default="uint8", choices=("float32", "uint8"),
                   help="the image wire: u8 bytes decoded on the card, or f32")
    p.add_argument("--hier-levels", default=None, metavar="JSON",
                   help='the cascade, e.g. "[[4,512],[2,896]]" (the object field\'s too)')
    p.add_argument("--cfg", action="append", default=[], metavar="KEY=VALUE",
                   help="config overrides (JSON values; repeatable)")
    p.add_argument("--serve", action="store_true",
                   help="closed-loop clients through a BatchingServer")
    p.add_argument("--serve-seconds", type=float, default=20.0)
    p.add_argument("--serve-clients", type=int, default=None, help="default 3 x batch")
    p.add_argument("--serve-poisson", default=None, metavar="R1,R2,...",
                   help="one open-loop Poisson run per offered rate (frames/s)")
    p.add_argument("--serve-max-wait-ms", type=float, default=5.0,
                   help="the BatchingServer's coalescing window")
    p.add_argument("--train", action="store_true", help="the train step per branch")
    p.add_argument("--train-setting", default="dexycb", choices=SETTINGS)
    p.add_argument("--train-batch", type=int, default=None,
                   help="default the preset's train batch (2 under --cpu)")
    p.add_argument("--batch-sweep", default=None, metavar="B1,B2,...",
                   help="the headline at each batch: f/s, p50 and MFU per batch")
    p.add_argument("--record", action="store_true",
                   help=f"with --batch-sweep, write ROOT/{SWEEP_FILE}")
    p.add_argument("--root", default=".", help="where --record writes (default: here)")
    return p


def _emit(obj: Dict) -> None:
    print(json.dumps(obj), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
        card = None
    else:
        if not torch.cuda.is_available():
            raise SystemExit("hoisdf-torch-bench: CUDA is not available; this bench runs on "
                             "an NVIDIA card (--cpu runs the tiny model on the CPU)")
        device = torch.device("cuda", 0)
        card = smi()
    build = dict(cpu=args.cpu, sdf_infer_mode=args.sdf_infer_mode, dtype=args.dtype,
                 transfer_dtype=args.transfer_dtype, hier_levels=args.hier_levels,
                 cfg_items=args.cfg)
    batch = min(args.batch, CPU_MAX_BATCH) if args.cpu else args.batch
    modes = args.serve or args.serve_poisson or args.train or args.batch_sweep

    if args.serve or args.serve_poisson:
        from hoisdf_torch.predictor import Predictor

        cfg = build_config(args.setting, **build)
        pred = Predictor(cfg, batch, args.transfer_dtype, device=device)
        pred.warmup()
        pool = serving_pool(pred)
        common = {"setting": cfg.setting, "batch": batch, "dtype": cfg.compute_dtype,
                  "wire": args.transfer_dtype, "max_wait_ms": args.serve_max_wait_ms,
                  "device": card[0] if card else None,
                  "power_limit_w": card[1] if card else None}
        if args.serve:
            res = serve_closed(pred, pool, args.serve_clients or 3 * batch,
                               args.serve_seconds, args.serve_max_wait_ms)
            _emit({"metric": "serve_fps", "value": res["frames_per_s"], "unit": "frames/s",
                   **common, **res})
        if args.serve_poisson:
            rates = [float(r) for r in args.serve_poisson.split(",") if r.strip()]
            for res in serve_poisson(pred, pool, rates, args.serve_seconds,
                                     args.serve_max_wait_ms):
                _emit({"metric": "serve_poisson_goodput", "value": res["goodput_hz"],
                       "unit": "frames/s", **common, **res})
    if args.train:
        tcfg = build_config(args.train_setting, **dict(build, dtype="float32"))
        tbatch = args.train_batch or (2 if args.cpu else tcfg.train_batch_size)
        for res in train_bench(tcfg, tbatch, device):
            _emit(res)
    if args.batch_sweep:
        cfg = build_config(args.setting, **build)
        step = make_bench_step(cfg, device)
        batches = [int(b) for b in args.batch_sweep.split(",") if b.strip()]
        if args.cpu:
            batches = list(dict.fromkeys(min(b, CPU_MAX_BATCH) for b in batches))
        rows = []
        for b in batches:
            r = headline(cfg, step, eval_inputs(cfg, b, device), b, device, iters=args.iters,
                         warmup=args.warmup, runs=args.runs, card=card)
            rows.append({"batch": b, "fps": r["value"], "p50_ms_per_frame": r["p50_ms_per_frame"],
                         "flops_per_frame": r["flops_per_frame"], "mfu": r["mfu"],
                         "spread": r["spread"]})
        best = max(rows, key=lambda r: r["fps"])
        doc = {"setting": cfg.setting, "sampler": cfg.sdf_infer_mode, "dtype": cfg.compute_dtype,
               "wire": cfg.transfer_dtype, "mode": "pipelined", "runs": args.runs,
               "device": card[0] if card else "cpu",
               "power_limit_w": card[1] if card else None, "rows": rows,
               "batch_opt": best["batch"], "batch_opt_fps": best["fps"]}
        if args.record:
            path = os.path.join(args.root, SWEEP_FILE.format(setting=cfg.setting))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
            _log(f"recorded {path}")
        _emit({"metric": "eval_batch_sweep", "value": best["fps"], "unit": "frames/s", **doc})
    if modes:
        return 0

    cfg = build_config(args.setting, **build)
    step = make_bench_step(cfg, device)
    res = headline(cfg, step, eval_inputs(cfg, batch, device), batch, device, iters=args.iters,
                   warmup=args.warmup, runs=args.runs, card=card)
    _emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
