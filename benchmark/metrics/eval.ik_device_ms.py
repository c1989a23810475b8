"""Device ms a step of the operations launched inside the program's
``eval.ik`` spans in the profiled sub-window (the two MANO forwards and the
IK kernel), matched to their launches by the profiler's correlation ids.
Nothing from a program without the span, or where no operation ran on a
device."""


def read(ctx):
    seconds = (getattr(ctx, "range_device_s", None) or {}).get("eval.ik")
    if ctx.phase != "eval" or not seconds or not ctx.profiled_steps:
        return None
    return seconds * 1e3 / ctx.profiled_steps
