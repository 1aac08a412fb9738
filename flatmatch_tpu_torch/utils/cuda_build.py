"""Build, load and launch the port's CUDA kernels.

Every `flatmatch_tpu_torch/csrc/*.cu` file is compiled by its own `nvcc`
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded through ctypes. The library goes to
`flatmatch_tpu_torch/_build/` under a name keyed by a hash of the sources,
the headers and the flags, so an edit of any rebuilds it on first use and a
fresh checkout builds it without a separate step. Nothing here runs when a
module is imported. `launch` calls an entry point on PyTorch's current
stream and raises on a CUDA error.
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

COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# C entry points: their argument types (pointers, ints, floats; the threefry
# keys as uint32 and its element count as int64); each ends with the stream
# pointer and returns the CUDA error code, but for the plan queries
# (fm_*_plan), which launch nothing and take no stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32, _I64 = ctypes.c_uint32, ctypes.c_longlong
ENTRY_POINTS = {
    "fm_trace_splat_wide_rng_i8": [_P] * 3 + [_I] * 8 + [_F] * 10 + [_P],
    "fm_trace_splat_wide_rng_f32": [_P] * 4 + [_I] * 8 + [_F] * 11 + [_P],
    "fm_trace_splat_wide_i8": [_P] * 4 + [_I] * 9 + [_F] * 10 + [_P],
    "fm_trace_splat_wide_f32": [_P] * 5 + [_I] * 9 + [_F] * 11 + [_P],
    "fm_trace_splat_wide_diff_rng_i8": [_P] * 5 + [_I] * 8 + [_F] * 9 + [_P],
    "fm_trace_splat_wide_diff_rng_f32": [_P] * 6 + [_I] * 8 + [_F] * 9 + [_P],
    "fm_trace_splat_wide_diff_i8": [_P] * 6 + [_I] * 9 + [_F] * 9 + [_P],
    "fm_trace_splat_wide_diff_f32": [_P] * 7 + [_I] * 9 + [_F] * 9 + [_P],
    "fm_trace_fold_wide_rng": [_P] * 6 + [_I] * 8 + [_F] * 9 + [_P],
    "fm_trace_fold_wide": [_P] * 7 + [_I] * 9 + [_F] * 9 + [_P],
    "fm_aa_nearest": [_P] * 5 + [_I] * 5 + [_P],
    "fm_nearest_distances": [_P] * 4 + [_I] * 5 + [_F] + [_P],
    "fm_ao_fused": [_P] * 6 + [_I] * 6 + [_F] + [_P],
    "fm_trace_deposits_wide_rng": [_P] * 4 + [_I] * 10 + [_F] * 9 + [_P],
    "fm_trace_deposits_wide": [_P] * 5 + [_I] * 10 + [_F] * 9 + [_P],
    "fm_trace_deposits_wide_diff": [_P] * 7 + [_I] * 10 + [_F] * 9 + [_P],
    "fm_fused_splat_i8": [_P] * 4 + [_I] * 2 + [_F] * 2 + [_P],
    "fm_fused_splat_i8_add": [_P] * 4 + [_I] * 2 + [_F] * 2 + [_P],
    "fm_fused_splat": [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P],
    "fm_fused_splat_add": [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P],
    "fm_fused_splat_plan": [_I, _P, _P],
    "fm_fused_splat_i8_plan": [_I, _P, _P],
    "fm_trace_deposits_narrow": [_P] * 5 + [_I] * 4 + [_F] * 9 + [_P],
    "fm_trace_deposits_narrow_plan": [_I, _I, _P, _P],
    "fm_nearest_plan": [_I, _I, _P, _P, _P, _P],
    "fm_ao_fused_plan": [_I, _P, _P, _P, _P],
    "fm_threefry_uniform": [_U32, _U32, _I64, _P, _P],
    "fm_threefry_uniform_t": [_U32, _U32, _I, _I, _P, _P],
    "fm_general_nearest": [_P] * 5 + [_I] * 2 + [_P],
    "fm_general_nearest_plan": [_I, _P, _P, _P, _P],
}
SMEM_LIMIT = 232448   # dynamic shared memory of a block on sm_90

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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libflatmatch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; (output of each, first failure or None)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], None
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (c, p.returncode, out)
    return logs, failed


def _build(out: pathlib.Path) -> str:
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, cmds = [], []
    for src in _sources():
        obj = BUILD / f"{tag}.{src.stem}.o"
        objs.append(obj)
        cmds.append([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)])
    logs, failed = _run_all(cmds)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if failed is None:
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed = (link, res.returncode, res.stdout + res.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed is not None:
        cmd, rc, log = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    log = "".join(logs)
    out.with_suffix(".log").write_text(log)
    return log


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    t0 = time.perf_counter()
    if not out.exists():
        from .progress import info

        info(f"building the CUDA kernels into {out.name} (first use)")
        log = _build(out)
    elif out.with_suffix(".log").exists():
        log = out.with_suffix(".log").read_text()
    else:
        log = ""
    lib = ctypes.CDLL(str(out))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(out))
    _lib = lib
    return lib


def table_plan(name: str, dev, *args) -> dict:
    """What a kernel that keeps the scene table in shared memory or device
    memory (csrc/trace_wide.cuh launch_table) launches on CUDA device
    `dev`, from its C query `name` with the int arguments `args`:
    instance ("shared" or "device"), shared_bytes (dynamic and static),
    registers and blocks_per_sm (the occupancy calculator). No launch;
    raises on a non-zero CUDA error."""
    import torch

    outs = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(dev):
        err = getattr(load_library(), name)(
            *(int(a) for a in args), *(ctypes.byref(o) for o in outs))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    in_smem, smem, regs, blocks = (o.value for o in outs)
    return dict(instance="shared" if in_smem else "device",
                shared_bytes=smem, registers=regs, blocks_per_sm=blocks)


def launch(name: str, dev, *args):
    """Call C entry point `name` on the current stream of CUDA device
    `dev`; raise on a non-zero CUDA error."""
    import torch

    fn = getattr(load_library(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
