"""The IK kernel (``hoisdf_torch::ik_solve``) in the eval step: the
benchmark's bound of the profiled steps' launches (``counts/ik.py``: the
larger of the operations at the f32 peak and the bytes at the bandwidth)
over the kernel's device time there, in %."""


def read(ctx):
    if ctx.phase != "eval" or ctx.trace is None or not ctx.bounds.get("ik_solve"):
        return None
    t = ctx.trace.kernel_seconds(lambda name: "ik_solve_kernel" in name)
    return 100.0 * ctx.bounds["ik_solve"] / t if t > 0 else None
