#!/usr/bin/env python3
"""Run the port's CUDA kernels as host C++ on the CPU, against their plain versions.

    python3 tools/torch_host_kernels.py [--double] [--batch 256]

The sources in ``parallax_tpu_torch/csrc`` compile with ``g++`` once a
small shim header defines the CUDA keywords away (``__device__``,
``__global__``, ``__launch_bounds__``, ``threadIdx``, ``rsqrtf``,
``__popc``) and each ``<<<...>>>`` launch becomes a loop over the worlds.
The library goes to ``build/host_kernels/`` and is loaded in place of
``ops/_build.load()``; the wrappers then run the kernels on CPU tensors.
This checks a kernel's arithmetic before it reaches a GPU: it is not a
GPU result, and it times nothing.

Without ``--double`` it compares, on the scenarios of
``tests/torch_scenarios.py``, the fused step kernel with
``fused_step_plain`` (flags and body planes) and the fused reverse-pass
kernel with ``fused_step_bwd_plain`` (its largest share of the bar
``1e-5 + 2e-4 |plain|``).  With ``--double`` the shim also defines
``float`` as ``double``, so the reverse pass runs in float64 and is held
to the plain version in float64 (share of ``1e-10 + 1e-8 |plain|``):
that checks the adjoint's formulas free of float32 rounding.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

SHIM = """#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct HostDim { unsigned x; };
static HostDim threadIdx = {0}, blockIdx = {0}, blockDim = {1};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
#define __popc __builtin_popcount
"""
FLOAT_MATH = "static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }\n"
DOUBLE_MATH = """#define float double
#define rsqrtf(x) (1.0 / sqrt(x))
#define fabsf(x) fabs(x)
#define cosf(x) cos(x)
#define sinf(x) sin(x)
#define sqrtf(x) sqrt(x)
"""


def build(double: bool) -> Path:
    """Compile every ``csrc/*.cu`` with g++ into one shared library."""
    out = ROOT / "build" / "host_kernels" / ("double" if double else "float")
    src = out / "src"
    src.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(SHIM + (DOUBLE_MATH if double else FLOAT_MATH))
    objs = []
    for f in sorted((ROOT / "parallax_tpu_torch" / "csrc").iterdir()):
        text = f.read_text()
        if f.suffix == ".cu":
            text = re.sub(r"(\w+)<<<[^>]*>>>\(",
                          r"for (unsigned _t = 0; _t < (unsigned)B; ++_t) threadIdx.x = _t, \1(",
                          text)
        (src / f.name).write_text(text)
    for f in sorted(src.glob("*.cu")):
        obj = f.with_suffix(".o")
        subprocess.run(["g++", "-O2", "-ffp-contract=off", "-fPIC", "-std=c++17", f"-I{out}",
                        "-x", "c++", "-c", str(f), "-o", str(obj)], check=True)
        objs.append(str(obj))
    lib = out / "libhost_kernels.so"
    subprocess.run(["g++", "-shared", "-o", str(lib), *objs], check=True)
    return lib


def load(lib: Path, double: bool) -> None:
    """Make the wrappers launch the host library on CPU tensors."""
    from parallax_tpu_torch.ops import _build, contact_solver, fused_step

    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = [ctypes.c_double if double and a is ctypes.c_float else a
                       for a in argtypes]
        fn.restype = ctypes.c_int
    _build.load = lambda: cdll
    torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
    if double:  # float64 planes, operands and scratch
        contact_solver._check = lambda *a, **k: None
        proxy = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                         if not k.startswith("__")})
        proxy.float32 = torch.float64
        fused_step.torch = proxy


def to64(world) -> None:
    """The world's kernel operands in float64."""
    from parallax_tpu_torch.ops import contact_solver, fused_step

    ops = (fused_step.fused_operands(world),
           contact_solver.solver_operands(world, world.config.contact))
    for k, v in list(world.cache.items()):
        if any(v is o for o in ops):
            world.cache[k] = type(v)(*(x.double() if x.dtype == torch.float32 else x for x in v))


def scenarios(B: int):
    """``(label, world, state, cotangents)`` of the scenarios checked."""
    from torch_scenarios import (area_tie_case, billiards_pairs_state, cb_tie_case, cotangents,
                                 mixed_state, mixed_world, overlap_state, robocup_overlap_state)

    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig

    rc = RoboCup(RoboCupConfig(use_cuda_fused=True), device="cpu")
    bl = Billiards(BilliardsConfig(use_cuda_fused=True), device="cpu")
    mw, ms = mixed_world("cpu")
    out = [("RoboCup overlap", rc.world, robocup_overlap_state(rc, B)),
           ("billiards8 pairs", bl.world, billiards_pairs_state(bl, B)),
           ("billiards8 pile", bl.world, overlap_state(bl, B, 3, 1.0, 0.03, 0.02)),
           ("mixed cc+cb+pp", mw, mixed_state(mw, ms, B))]
    out = [(label, w, s, cotangents(w.n_bodies, B, 5)) for label, w, s in out]
    for env, case in ((bl, cb_tie_case), (rc, area_tie_case)):
        s, cot = case(env)
        out.append((f"{case.__name__} (B=1)", env.world, s, cot))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--double", action="store_true", help="build and compare in float64")
    p.add_argument("--batch", type=int, default=256)
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    load(build(args.double), args.double)
    from parallax_tpu_torch.ops import fused_step

    atol, rtol = (1e-10, 1e-8) if args.double else (1e-5, 2e-4)
    for label, world, s, cot in scenarios(args.batch):
        statics = (world, (), None, None)
        if args.double:
            to64(world)
            s, cot = (type(s)(*(x.double() for x in t)) for t in (s, cot))
        tx, ty = fused_step._terrain_planes({}, (), s.px)
        if not args.double:
            got, act = fused_step._step_cuda(statics, s, tx, ty)
            want, wc = fused_step.fused_step_plain(world, s)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            print(f"{label}: fused step flags equal {torch.equal(act, wc.active)}, "
                  f"{int(wc.active.sum())} active lanes, max |diff| {err:.3e}")
        got = fused_step._fused_bwd_cuda(statics, s, tx, ty, cot)[0]
        want = fused_step.fused_step_bwd_plain(world, s, None, cot)[0]
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        share = max(((a - b).abs() / (atol + rtol * b.abs())).max().item()
                    for a, b in zip(got, want))
        print(f"{label}: reverse pass max |diff| {err:.3e}, {share:.3f} of "
              f"{atol:g} + {rtol:g} |plain| ({'float64' if args.double else 'float32'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
