"""Constants made once per device, never inside a trace.

The eval step reads a few small tensors built from host data (the u8 table,
the grid normalizer, the cascade's offsets, the SDF kernel's stage index).
Built on every call they would copy from the host and hold it until the card
reached the copy, so each is cached per argument tuple.  Under
``torch.export`` or ``torch.compile`` the function runs uncached instead: the
trace's fake tensors never enter the cache, and the trace records the
constant itself.
"""

from __future__ import annotations

import functools

import torch


def device_cache(maxsize: int = 16):
    """``functools.lru_cache`` that the tracers bypass."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            return cached(*args)

        get.cache_info, get.cache_clear = cached.cache_info, cached.cache_clear
        return get

    return wrap
