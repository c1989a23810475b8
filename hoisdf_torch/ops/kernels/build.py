"""Build ``csrc/*.cu`` into one shared library with plain ``nvcc`` and load it
with ``ctypes``.

Every source compiles to an object in its own ``nvcc`` process, all started
together, and one ``nvcc -shared`` links them into
``hoisdf_torch/_build/libhoisdf_kernels.so``.  The build runs at first use and
again only when a source, the flags or the compiler change (a content stamp);
a file lock keeps concurrent processes from building over each other.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("sdf_mlp.cu", "gather_lerp.cu")
HEADERS = ("hopper.cuh",)  # included by the sources; part of the stamp
LIB = os.path.join(BUILD_DIR, "libhoisdf_kernels.so")
# The shared memory that a shared-route block of the gather's backward gives
# to its private copies of a map slice: the wrapper's plan sizes the copies to
# it, and the kernel, built with it as a macro, checks at compile time that the
# copies and its staging fit a block.
BWD_COPIES_BYTES = 48 * 1024
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         f"-DHOISDF_BWD_COPIES_BYTES={BWD_COPIES_BYTES}")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stamp(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def build(force: bool = False) -> dict:
    """Compile and link if stale.  Returns ``{"seconds", "built", "log"}``
    where ``log`` holds ptxas's register and shared-memory report."""
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    stamp = _stamp(nvcc)
    stamp_file = os.path.join(BUILD_DIR, "stamp.txt")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not force and os.path.exists(LIB) and os.path.exists(stamp_file):
                with open(stamp_file) as f:
                    if f.read() == stamp:
                        return {"seconds": time.perf_counter() - t0, "built": False, "log": ""}
            procs = []
            for name in SOURCES:
                obj = os.path.join(BUILD_DIR, name + ".o")
                cmd = [nvcc, *FLAGS, "-c", os.path.join(CSRC, name), "-o", obj]
                procs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            log, objs, failed = [], [], []
            for name, obj, proc in procs:
                text, _ = proc.communicate(timeout=600)
                log.append(f"== {name}\n{text}")
                objs.append(obj)
                if proc.returncode != 0:
                    failed.append(name)
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
            tmp = f"{LIB}.tmp.{os.getpid()}"
            res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
            os.replace(tmp, LIB)
            with open(stamp_file, "w") as f:
                f.write(stamp)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return {"seconds": time.perf_counter() - t0, "built": True, "log": "\n".join(log)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.sdf_mlp_launch.argtypes = [vp, i, i, i, vp, vp, i, vp, vp]
            lib.sdf_mlp_launch.restype = i
            lib.gather_lerp_launch.argtypes = [vp, i, i, i, vp, vp, i, vp, vp]
            lib.gather_lerp_launch.restype = i
            lib.gather_lerp_bwd_launch.argtypes = [vp, vp, i, i, i, vp, i, vp, vp, vp, i, vp]
            lib.gather_lerp_bwd_launch.restype = i
            _lib = lib
        return _lib
