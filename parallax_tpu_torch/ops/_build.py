"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, each ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by
its own ``nvcc``, all started together, and the objects are linked into
one shared library with a plain C interface,
``<checkout>/build/kernels/libparallax_kernels.so``.  A stamp beside it
holds the hash of the sources (``*.cu`` and the ``*.cuh`` they include)
and flags; a changed hash rebuilds.  The library is loaded with
``ctypes``; every pointer and the CUDA stream are passed as ``c_void_p``.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libparallax_kernels.so"

# No --use_fast_math, and --fmad=false: the kernels round each product and
# sum on its own, as the plain torch versions they are checked against do.
# -Xptxas -v reports each kernel's registers, stack and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_seconds = None  # wall time of the last build in this process, or None
ptxas_report = None  # {source name: ptxas -v lines} of that build, or None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source "
        "with the CUDA toolkit on the machine that has the GPU"
    )


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _run_all(cmds) -> list:
    """Run the commands at once; raise with nvcc's output if any failed,
    else return their outputs."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outputs


def build() -> Path:
    """Compile the kernels unless the stamped build matches the sources."""
    global build_seconds, ptxas_report
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = {str(src): str(BUILD_DIR / f"{src.stem}.{tag}.o") for src in _sources()}
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        outs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in objs.items()])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs.values()]])
        os.replace(tmp, lib)
    finally:
        for f in (*objs.values(), tmp):
            Path(f).unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    ptxas_report = {
        Path(src).name: [
            line.strip() for line in out.splitlines()
            if any(k in line for k in ("entry function", "registers", "stack frame"))
        ]
        for src, out in zip(objs, outs)
    }
    stamp.write_text(digest)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint
_D = ctypes.c_double

_SIGNATURES = {
    "contact_solve_fwd": (
        [_P] * 5  # pen_x, pen_y, pt_x, pt_y, active
        + [_P] * 6  # px, py, vx, vy, angle, omega
        + [_P] * 6  # outputs
        + [_P] * 9  # body_a, body_b, partner, lane_const, movable,
        #             body_im, body_ii, joint_body, joint_f
        + [_P] * 2  # body_lanes, scratch
        + [_I] * 6  # B, C, n, J, iterations, position_iterations
        + [_F] * 5  # dt, baumgarte, slop, baumgarte_dt, max_bias
        + [_I] * 3  # has_max_bias, fields_in_smem, worlds_per_block
        + [_P]  # stream
    ),
    "contact_solve_bwd": (
        [_P] * 5  # pen_x, pen_y, pt_x, pt_y, active
        + [_P] * 6  # px, py, vx, vy, angle, omega
        + [_P] * 6  # cotangents of the six outputs
        + [_P] * 6  # cotangents of the six body planes (out)
        + [_P] * 4  # cotangents of pen_x, pen_y, pt_x, pt_y (out)
        + [_P] * 9  # the operands, as for contact_solve_fwd
        + [_P] * 2  # body_lanes, scratch
        + [_I] * 6  # B, C, n, J, iterations, position_iterations
        + [_F] * 5  # dt, baumgarte, slop, baumgarte_dt, max_bias
        + [_I, _I, _P]  # has_max_bias, worlds_per_block, stream
    ),
    "fused_step_fwd": (
        [_P] * 6  # px, py, vx, vy, angle, omega
        + [_P] * 2  # terrain x, y
        + [_P] * 6  # outputs
        + [_P]  # active (out)
        + [_P] * 4  # part_i, part_lv, pair_i, pair_f
        + [_P] * 9  # the solver operands, as for contact_solve_fwd
        + [_P] * 2  # body_lanes, scratch
        + [_I] * 5  # P, pairs, lanes, V, symplectic
        + [_F] * 2  # gravity x and y times dt
        + [_I] * 6  # B, C, n, J, iterations, position_iterations
        + [_F] * 5  # dt, baumgarte, slop, baumgarte_dt, max_bias
        + [_I] * 3  # has_max_bias, fields_in_smem, worlds_per_block
        + [_P]  # stream
    ),
    "fused_step_bwd": (
        [_P] * 6  # px, py, vx, vy, angle, omega
        + [_P] * 2  # terrain x, y
        + [_P] * 6  # cotangents of the six outputs
        + [_P] * 6  # cotangents of the six body planes (out)
        + [_P] * 2  # cotangents of the terrain planes (out)
        + [_P] * 4  # part_i, part_lv, pair_i, pair_f
        + [_P] * 9  # the solver operands, as for contact_solve_fwd
        + [_P] * 2  # body_lanes, scratch
        + [_I] * 5  # P, pairs, lanes, V, symplectic
        + [_F] * 2  # gravity x and y times dt
        + [_I] * 6  # B, C, n, J, iterations, position_iterations
        + [_F] * 5  # dt, baumgarte, slop, baumgarte_dt, max_bias
        + [_I] * 3  # has_max_bias, pair_rows, worlds_per_block
        + [_P]  # stream
    ),
    # keys, row stride, N, num, first, out, stream
    "threefry_split": [_P, _L, _L, _I, _U, _P, _P],
    # keys, row stride, N, n, lo, span, raw, out, stream
    "threefry_uniform": [_P, _L, _L, _L, _D, _D, _I, _P, _P],
    # keys, row stride, B, split_first, V, tox, toy, stream
    "lander_terrain": [_P, _L, _I, _I, _I, _P, _P, _P],
    "contact_solver_num_fields": [],
    "contact_solver_fwd_smem_bytes": [_I] * 3,  # C, n, fields_in_smem
    "fused_step_fwd_smem_bytes": [_I] * 4,  # C, n, P, fields_in_smem
    "contact_solver_bwd_scratch_rows": [_I] * 4,  # C, n, iterations, position_iterations
    "contact_solver_bwd_smem_bytes": [_I] * 2,  # C, n
    "fused_step_bwd_scratch_rows": [_I] * 4,  # C, n, iterations, position_iterations
    "fused_step_bwd_smem_bytes": [_I] * 5,  # C, n, P, pairs, pair_rows
}


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
