"""Build ``native/src/pipeline.cc`` into ``hoisdf_torch/_build/
libhoisdf_pipeline.so`` with plain ``g++`` (bound with ``ctypes`` in
``hoisdf_torch/native/__init__.py``).

The build runs at first use, and again only when the source, the flags, the
compiler or the codec decision change (a content stamp).  A file lock keeps
processes that load the library at once (test workers, spawned loader
workers) from building over each other, and the library appears by an atomic
rename, so no process loads a half-written file.

The codec decision is taken here, at build time: where g++ finds
``jpeglib.h`` and ``png.h`` the library links libjpeg, libpng and zlib and
decodes JPEG and PNG itself (``decode: "libjpeg"``); elsewhere the build
defines ``HN_NO_CODECS``, the decoders are compiled out, and the bindings
decode with PIL before the fused call (``decode: "pil"``).  :func:`build`
reports which, and a failed build raises with g++'s messages.

    python -m hoisdf_torch.native.build   # build and print the report
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "src", "pipeline.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libhoisdf_pipeline.so"
CXX = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fno-math-errno")
CODEC_LIBS = ("-ljpeg", "-lpng", "-lz")
CODEC_HEADERS = ("jpeglib.h", "png.h")


class BuildError(RuntimeError):
    """g++ is missing or failed; the message holds its output."""


def compiler() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise BuildError(f"{CXX} not found on PATH: the native image pipeline cannot build")
    return path


def compiler_version(cxx: str) -> str:
    res = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    return res.stdout.splitlines()[0] if res.stdout else ""


def codec_headers_found(cxx: str) -> bool:
    """Whether ``cxx`` preprocesses a file that includes the codec headers."""
    text = "".join(f"#include <{h}>\n" for h in CODEC_HEADERS)
    res = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull], input=text,
                         capture_output=True, text=True, timeout=60)
    return res.returncode == 0


def _stamp(src: str, cxx: str, version: str, cmd_flags) -> str:
    h = hashlib.sha256("\0".join((cxx, version, *cmd_flags)).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build(force: bool = False, src: str = SRC, build_dir: str = BUILD_DIR,
          codecs: "bool | None" = None) -> dict:
    """Compile ``src`` into ``build_dir`` if its stamp is stale.  ``codecs``
    None takes the codecs where their headers are found; True or False forces
    the choice.  Returns ``{"path", "built", "seconds", "cxx", "headers",
    "codecs", "decode"}``; raises :class:`BuildError` when g++ fails."""
    t0 = time.perf_counter()
    cxx = compiler()
    version = compiler_version(cxx)
    headers = codec_headers_found(cxx)
    use_codecs = headers if codecs is None else codecs
    defines, libs = ((), CODEC_LIBS) if use_codecs else (("-DHN_NO_CODECS",), ())
    stamp = _stamp(src, cxx, version, FLAGS + defines + libs)
    lib = os.path.join(build_dir, LIB_NAME)
    stamp_file = os.path.join(build_dir, "pipeline.stamp")

    def fresh() -> bool:
        if force or not (os.path.exists(lib) and os.path.exists(stamp_file)):
            return False
        with open(stamp_file) as f:
            return f.read() == stamp

    report = {"path": lib, "cxx": version, "headers": headers, "codecs": use_codecs,
              "decode": "libjpeg" if use_codecs else "pil"}
    built = False
    if not fresh():
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, ".pipeline.lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if not fresh():
                    tmp = f"{lib}.tmp.{os.getpid()}"
                    res = subprocess.run([cxx, *FLAGS, *defines, src, "-o", tmp, *libs],
                                         capture_output=True, text=True, timeout=300)
                    if res.returncode != 0:
                        if os.path.exists(tmp):
                            os.remove(tmp)
                        raise BuildError(f"{cxx} failed on {src}:\n{res.stdout}{res.stderr}")
                    os.replace(tmp, lib)
                    with open(stamp_file, "w") as f:
                        f.write(stamp)
                    built = True
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
    return dict(report, built=built, seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    print(json.dumps(build()))
