"""Build and load the port's CUDA kernels.

Every `flatmatch_tpu_torch/csrc/*.cu` file is compiled by `nvcc` into one
shared library with a plain C interface, loaded through ctypes. The library
goes to `flatmatch_tpu_torch/_build/` under a name keyed by a hash of the
sources and the flags, so an edit of either rebuilds it on first use and a
fresh checkout builds it without a separate step. Nothing here runs when a
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None
build_info = {}   # "seconds", "log" (ptxas register and spill report), "path"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "flatmatch_tpu_torch are built from source on first use"
    )


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libflatmatch_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        from .progress import info

        info(f"building the CUDA kernels into {out.name} (first use)")
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    elif out.with_suffix(".log").exists():
        log = out.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.fm_trace_splat_wide_rng_i8
    fn.argtypes = [ptr, ptr, ptr] + [i32] * 8 + [f32] * 10 + [ptr]
    fn.restype = i32
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(out))
    _lib = lib
    return lib
