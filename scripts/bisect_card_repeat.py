"""Find the first operation whose result differs between two identical f32
eval forwards of the full-width model on one NVIDIA card.

    python3 scripts/bisect_card_repeat.py [--settings dexycb,ho3d,ho3d_render]

Two modes, each in a child process of its own: ``default`` (the port as it
runs) and ``deterministic`` (``torch.use_deterministic_algorithms(True,
warn_only=True)`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which also makes
cuDNN pick deterministic algorithms and makes torch warn at every operation
that has no deterministic form).  For each preset the child builds the
kernels, runs chip_smoke's seeded model (the SDF decoders' biases drawn) at
batch 2 twice on the same inputs, and logs every ATen operation in call order
(``TorchDispatchMode``) with a bit-level checksum of its inputs and of its
output, taken when the operation returns.  The hand-written kernels are no
ATen operations: they write into buffers that an ``empty`` made, so a
difference that first shows in an operation's inputs, with every earlier
output equal, comes from a kernel.  One JSON line per preset and mode:
whether the two forwards' outputs are bitwise equal, the first operation
whose inputs are equal and whose output differs, the first whose inputs
differ, and the nondeterminism warnings torch gave.  The default mode then
times each preset's deconvolutions (batch 22, f32 and bf16) on cuDNN's
default and on its deterministic algorithm (``deconv_cost`` lines).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORIES = ("aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty")


def _checksums(tensors):
    """Two bit-level sums of each tensor's bytes (its elements reinterpreted
    as integers, plainly and weighted by position), on the device."""
    import torch

    out = []
    for t in tensors:
        flat = t.detach().contiguous().reshape(-1)
        if flat.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[flat.element_size()]
            flat = flat.view(bits)
        flat = flat.to(torch.int64)
        weight = torch.arange(flat.numel(), device=flat.device) % 1009 + 1
        out.append(torch.stack([flat.sum(), (flat * weight).sum()]))
    return torch.stack(out) if out else None


class OpLog:
    """A dispatch mode that logs (name, input checksums, output checksums)."""

    def __init__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        log = self.rows = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = str(func.overloadpacket._qualified_op_name)
                ins = [a for a in tree_flatten((args, kwargs or {}))[0]
                       if isinstance(a, torch.Tensor) and a.is_cuda]
                outs = [] if name in FACTORIES else [
                    o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor) and o.is_cuda]
                log.append((name, _checksums(ins), _checksums(outs),
                            [list(o.shape) for o in outs][:2]))
                return out

        self.mode = Mode


def _same(a, b) -> bool:
    import torch

    return (a is None and b is None) or (a is not None and b is not None
                                         and a.shape == b.shape and bool(torch.equal(a, b)))


def run_child(settings) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hoisdf_torch.config import get_config
    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.ops.kernels import build
    from hoisdf_torch.train import disable_tf32

    mode = os.environ.get("BISECT_MODE", "default")
    if mode == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
    build.build()
    device = torch.device("cuda", 0)
    for setting in settings:
        cfg = get_config(setting, compute_dtype="float32")
        model = cs.build_biased_model(cfg).to(device).eval()
        disable_tf32()
        inputs = synthetic_batch(cfg, 2, seed=0)
        batch = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
        logs, outs, caught = [], [], []
        for _ in range(2):
            log = OpLog()
            with warnings.catch_warnings(record=True) as w, torch.inference_mode():
                warnings.simplefilter("always")
                with log.mode():
                    out = model(batch, supervise_sdf=False)
                torch.cuda.synchronize()
            caught += [str(x.message)[:200] for x in w]
            logs.append(log.rows)
            outs.append(out)
        equal = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
        first_out = first_in = None
        for i, (a, b) in enumerate(zip(*logs)):
            if a[0] != b[0]:
                first_in = first_in or {"index": i, "op": [a[0], b[0]], "note": "op order differs"}
                break
            same_in = _same(a[1], b[1])
            if not same_in and first_in is None:
                first_in = {"index": i, "op": a[0], "shapes": a[3],
                            "previous_ops": [r[0] for r in logs[0][max(0, i - 4):i]]}
            if same_in and not _same(a[2], b[2]) and first_out is None:
                first_out = {"index": i, "op": a[0], "shapes": a[3],
                             "previous_ops": [r[0] for r in logs[0][max(0, i - 4):i]]}
            if first_in and first_out:
                break
        cs.emit({"setting": setting, "mode": mode, "bitwise_equal": equal,
                 "ops": len(logs[0]), "ops_second": len(logs[1]),
                 "first_output_diff_with_equal_inputs": first_out,
                 "first_input_diff": first_in,
                 "warnings": sorted(set(caught))[:20], "card": torch.cuda.get_device_name(0)})
        del model, outs, logs


def time_deconvs(settings, batch: int = 22) -> None:
    """The forward of each preset's deconvolutions at ``batch``, f32 and
    bf16, on cuDNN's default and on its deterministic algorithm: the cost
    of the deterministic form, one JSON line per preset."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hoisdf_torch.config import get_config
    from hoisdf_torch.models.hoisdf import HOISDF
    from hoisdf_torch.models.layers import ConvTranspose2d
    from hoisdf_torch.train import disable_tf32

    disable_tf32()  # f32 as the port runs it
    cudnn = torch.backends.cudnn
    for setting in settings:
        cfg = get_config(setting)
        deconvs = [m for m in HOISDF(cfg).decoder_net.modules() if isinstance(m, ConvTranspose2d)]
        side = cfg.input_img_shape[0] // 32
        res = {"phase": "deconv_cost", "setting": setting, "batch": batch}
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(0)
            xs, size = [], side
            for m in deconvs:
                xs.append(torch.randn(batch, m.in_channels, size, size, generator=g,
                                      device="cuda", dtype=dtype)
                          .contiguous(memory_format=torch.channels_last))
                size *= 2
            ws = [m.weight.to("cuda", dtype) for m in deconvs]

            def run():
                for x, w in zip(xs, ws):
                    F.conv_transpose2d(x, w, None, 2, 1)

            for det in (False, True):
                cudnn.deterministic = det
                res[f"{str(dtype)[6:]}_{'deterministic' if det else 'default'}_ms"] = \
                    cs.time_ms(run, iters=20)
            cudnn.deterministic = False
        res["card"] = torch.cuda.get_device_name(0)
        cs.emit(res)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--settings", default="dexycb,ho3d,ho3d_render")
    p.add_argument("--child", action="store_true")
    args = p.parse_args()
    settings = args.settings.split(",")
    if args.child:
        run_child(settings)
        if os.environ.get("BISECT_MODE") == "default":
            time_deconvs(settings)
        return 0
    rc = 0
    for mode in ("default", "deterministic"):
        env = dict(os.environ, BISECT_MODE=mode)
        if mode == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              "--settings", args.settings], env=env, check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
