"""Constants made once per device, never inside a trace.

The eval step reads a few small tensors built from host data (the u8 table,
the grid normalizer, the cascade's offsets, the SDF kernel's stage index).
Built on every call they would copy from the host and hold it until the card
reached the copy, so each is cached per argument tuple.  Under
``torch.export`` or ``torch.compile`` the function runs uncached instead: the
trace's fake tensors never enter the cache, and the trace records the
constant itself.  A CUDA graph captured meanwhile reads the constants at
their addresses: within :func:`held`, each constant the caches return on
the calling thread is also kept in a list, which the graph holds.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, List

import torch

_local = threading.local()


@contextlib.contextmanager
def held(into: List) -> Iterator[None]:
    """Within it, every value the caches return on this thread is appended
    to ``into``, so that an eviction cannot free it while ``into`` lives."""
    outer = getattr(_local, "into", None)
    _local.into = into
    try:
        yield
    finally:
        _local.into = outer


def device_cache(maxsize: int = 16):
    """``functools.lru_cache`` that the tracers bypass."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            value = cached(*args)
            into = getattr(_local, "into", None)
            if into is not None:
                into.append(value)
            return value

        get.cache_info, get.cache_clear = cached.cache_info, cached.cache_clear
        return get

    return wrap
