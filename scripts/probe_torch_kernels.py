"""Probe the PyTorch port's two CUDA kernels on one NVIDIA card.

    python3 scripts/probe_torch_kernels.py        (from the repository root)

For work on a kernel: builds the kernels and prints ptxas's register counts
and warnings, runs chip_smoke.py's kernel phase (each kernel against its plain
version, the SDF MLP at ragged row counts and at the row counts of a serving
step), then two sweeps that chip_smoke.py does not make: the SDF MLP by tiles
in flight and the gather by points per image.  One JSON line per result; exits
non-zero on a mismatch.
"""

import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hoisdf_torch.models.hoisdf import init_weights  # noqa: E402
from hoisdf_torch.models.sdf_decoder import SDFDecoder  # noqa: E402
from hoisdf_torch.ops.kernels import build  # noqa: E402
from hoisdf_torch.ops.kernels.gather_lerp import gather_lerp  # noqa: E402
from hoisdf_torch.ops.kernels.sdf_mlp import fold_weight_norm, prepare_weights, sdf_mlp  # noqa: E402


def sweep_sdf_mlp_tiles(dev):
    """Time against tiles of 64 rows in flight: flat up to one tile per SM
    means a tile's own latency, not L2's rate, sets the time."""
    dec = init_weights(SDFDecoder(256, 33), 0)
    weights = prepare_weights([w.to(dev) for w in fold_weight_norm(dec)], torch.bfloat16)
    x = (torch.randn(64 * 1232, 289, generator=torch.Generator().manual_seed(0)) * 0.5)
    x = x.to(dev).bfloat16()
    us = {}
    for tiles in (2, 8, 33, 66, 132, 264, 528, 1232):
        xr = x[:64 * tiles]
        us[tiles] = cs.time_ms(lambda: sdf_mlp(xr, weights), iters=20) * 1e3
    cs.emit({"kernel": "sdf_mlp", "us_by_tiles_of_64_rows": us})


def host_ms(fn, iters=20):
    """Host time of one call of ``fn``, the queue drained before and not after:
    where it is no less than the device time of a back-to-back loop, that loop
    timed the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def sweep_gather_points(dev, batch=22):
    g = torch.Generator().manual_seed(1)
    maps = [torch.randn(batch, s, s, c, generator=g).to(dev).bfloat16() for _, s, c in cs.PYRAMID]
    ms, host = {}, {}
    for pts in (512, 832, 1024, 1472, 1792, 2944, 3584):
        grid = (torch.rand(batch, pts, 2, generator=g) * 2.2 - 1.1).to(dev)
        ms[pts] = cs.time_ms(lambda: gather_lerp(grid, maps), iters=20)
        host[pts] = host_ms(lambda: gather_lerp(grid, maps))
    cs.emit({"kernel": "gather_lerp", "batch": batch, "ms_by_points_per_image": ms,
             "host_ms_per_call": host})


def main():
    if not torch.cuda.is_available():
        print("probe_torch_kernels: CUDA is not available", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    info = build.build()
    notes = sorted({re.sub(r"around line \d+ ", "", ln.strip())[:200]
                    for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln or "arning" in ln
                    or ("(C75" in ln and "C7519" not in ln)})
    cs.emit({"build_seconds": info["seconds"], "ptxas": notes})
    dev = torch.device("cuda", 0)
    cs.check_sdf_mlp(dev, batch=22)
    cs.check_gather_lerp(dev, batch=22, points=3584)
    sweep_sdf_mlp_tiles(dev)
    sweep_gather_points(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
