"""Build and load the native code of ``groomed_nms_torch/csrc``, and the
repository's backend-free C++ NMS oracle ``eval/cpu_nms.cpp``.

Each source becomes a shared library with a plain C interface under
``build/groomed_nms_torch/`` at the checkout's root, at first use; ``ctypes``
loads it.  ``nvcc`` compiles the CUDA kernels (``*.cu``), the host C++
compiler the host routines (``*.cpp``: the PNG unfilter).  The library's
file name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
EVAL_DIR = Path(__file__).resolve().parents[2] / "eval"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "groomed_nms_torch"
# -fmad=false and no fast math: no fused multiply-add, IEEE division, so a
# kernel's float arithmetic rounds op by op as its plain PyTorch version's
# separate ops do (csrc/greedy_nms.cu relies on it for exact keep masks,
# csrc/iou_prune.cu for IoUs that meet the GrooMeD threshold exactly as the
# plain version's do)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (on PATH or under /usr/local/cuda)")


def _host_cxx():
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the PNG "
                       "unfilter and the C++ NMS oracle need one")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (or the absolute path ``source``) into a
    shared library; return its path.

    A ``.cu`` source goes to ``nvcc`` with ``FLAGS``, a ``.cpp`` source to
    the host compiler with ``HOST_FLAGS``.  The hash covers the source, the
    CUDA headers (``*.cuh``) beside it and the flags.  The compiler's output
    (for nvcc, ``-Xptxas -v``: registers, shared memory and spills of every
    kernel) is kept beside the library as ``<name>.log``.
    """
    src = CSRC / source
    if src.suffix == ".cu":
        compiler, flags = _nvcc(), FLAGS
    else:
        compiler, flags = _host_cxx(), HOST_FLAGS
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed on {src}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)           # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def greedy_nms_lib():
    """The greedy-NMS library with its C entry's signature declared."""
    lib = ctypes.CDLL(str(build("greedy_nms.cu")))
    p = ctypes.c_void_p
    lib.greedy_nms.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_float, p]
    lib.greedy_nms.restype = ctypes.c_int
    return lib


@functools.cache
def iou_prune_lib():
    """The IoU/prune (K3) library with its C entry's signature declared."""
    lib = ctypes.CDLL(str(build("iou_prune.cu")))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.iou_prune.argtypes = [p, p, p, p, i, i, i, f, f, f, p]
    lib.iou_prune.restype = ctypes.c_int
    return lib


@functools.cache
def group_leaders_lib():
    """The GrooMeD grouping library with its C entry's signature declared."""
    lib = ctypes.CDLL(str(build("group_leaders.cu")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.group_leaders.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, p]
    lib.group_leaders.restype = ctypes.c_int
    return lib


@functools.cache
def dense_block_lib():
    """The dense-block (K4) library with its C entry's signature declared."""
    lib = ctypes.CDLL(str(build("dense_block.cu")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_block_eval.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.dense_block_eval.restype = ctypes.c_int
    return lib


@functools.cache
def png_unfilter_lib():
    """The host PNG unfilter library with its C entry's signature declared."""
    lib = ctypes.CDLL(str(build("png_unfilter.cpp")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.png_unfilter.argtypes = [p, p, i, i, i]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


@functools.cache
def cpu_nms_lib():
    """The C++ greedy-NMS oracle (``eval/cpu_nms.cpp``, shared with the JAX
    package) with its C entry's signature declared."""
    lib = ctypes.CDLL(str(build(EVAL_DIR / "cpu_nms.cpp")))
    fp, i32 = ctypes.POINTER(ctypes.c_float), ctypes.c_int32
    lib.greedy_nms.argtypes = [fp, i32, ctypes.c_float, ctypes.c_float,
                               ctypes.POINTER(i32)]
    lib.greedy_nms.restype = i32
    return lib
