"""Median host ms of the program's ``eval.ik`` span a step (the IK head's
enqueue: the template's MANO forward, the solve's launch and the second
MANO forward), read from the profiled sub-window, where the span is a
``record_function`` range of the profiled thread.  Nothing from a program
without the span."""

import statistics


def read(ctx):
    if ctx.phase != "eval" or ctx.trace is None:
        return None
    ms = [(end - start) * 1e3 for name, start, end in ctx.trace.host if name == "eval.ik"]
    return statistics.median(ms) if ms else None
