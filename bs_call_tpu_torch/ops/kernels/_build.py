"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` of this package (with the `csrc/*.cuh` headers they
include) is compiled with `nvcc` for sm_90a, one
`nvcc -c` per source, all started together, and linked into one shared
library with a plain C interface, on first use, and loaded with
`ctypes`. The library lands in `bs_call_tpu_torch/build/<hash>/`,
keyed by a hash of the sources and the compile command, so an edit
rebuilds and an unchanged tree reuses the previous build. A failed build
raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB_NAME = "libbsct_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process ran, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of bs_call_tpu_torch cannot be built"
    )


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in [*srcs, *headers()]:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source tree has no build yet; returns
    the library path."""
    global build_log
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = os.path.join(BUILD, _key(srcs))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target and rename: a concurrent process either
    # sees no library or a complete one
    tmp = tempfile.mkdtemp(dir=out_dir)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, p]
                for p, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        so = os.path.join(tmp, LIB_NAME)
        link = [nvcc, *LINK_FLAGS, "-o", so, *objs]
        for cmd, proc, out in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): "
                    f"{' '.join(cmd)}\n" + out
                )
        res = subprocess.run(link, capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {res.returncode}): "
                f"{' '.join(link)}\n" + res.stdout + res.stderr
            )
        os.replace(so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib
