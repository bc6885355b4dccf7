#!/usr/bin/env python3
"""Run the port's CUDA kernels as host C++ on the CPU, against their plain versions.

    python3 tools/torch_host_kernels.py [--double] [--batch 256]

The sources in ``parallax_tpu_torch/csrc`` compile with ``g++`` once a
small shim header defines the CUDA keywords away (``__device__``,
``__global__``, ``__launch_bounds__``, ``threadIdx``, ``rsqrtf``,
``__popc``, ``__uint_as_float`` and the ``_rn`` intrinsics), makes a
warp one thread (``WARP_LANES`` 1, ``__syncwarp`` and ``__syncthreads``
no-ops, a ballot or vote its one thread's predicate) and each
``<<<...>>>`` launch a loop over its blocks and their threads, in order; the dynamic shared memory of a block becomes a
host buffer, in which each world of the block has its own part.  The library goes to ``build/host_kernels/`` (or ``--out``) and is
loaded in place of ``ops/_build.load()``; the wrappers then run the kernels
on CPU tensors.  This checks a kernel's arithmetic before it reaches a
GPU: it is not a GPU result, and it times nothing.

Without ``--double`` it compares, on the scenarios of
``tests/torch_scenarios.py``, the fused step kernel with
``fused_step_plain`` (flags and body planes), the solve kernel with
``solve_contacts_plain`` on the lanes of the integrated state, and the two
reverse-pass kernels with ``fused_step_bwd_plain`` and
``solve_contacts_bwd_plain`` (their largest share of the bar ``1e-5 + 2e-4
|plain|``).  With ``--double`` the shim also defines ``float`` as
``double``, so the reverse passes run in float64 and are held to the plain
versions in float64 (share of ``1e-10 + 1e-8 |plain|``): that checks the
adjoints' formulas free of float32 rounding.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

SHIM = """#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __syncwarp()
#define __syncthreads()
#define __ballot_sync(mask, p) ((p) ? 1u : 0u)
#define __all_sync(mask, p) (p)
#define WARP_LANES 1
struct HostDim { unsigned x; };
static HostDim threadIdx = {0}, blockIdx = {0}, blockDim = {1};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
static inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
#define __popc __builtin_popcount
#include <string.h>
static inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}
#define __dmul_rn(a, b) ((a) * (b))
#define __dadd_rn(a, b) ((a) + (b))
#define __double2float_rn(x) ((float)(x))
"""
FLOAT_MATH = "static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }\n"
DOUBLE_MATH = """#define float double
#define rsqrtf(x) (1.0 / sqrt(x))
#define fabsf(x) fabs(x)
#define cosf(x) cos(x)
#define sinf(x) sin(x)
#define sqrtf(x) sqrt(x)
"""
# after the math, so that the buffer's type follows `float`
HOST_SMEM = """static float* host_smem = 0;
static inline unsigned host_smem_reserve(size_t bytes) {
  host_smem = (float*)realloc(host_smem, bytes + sizeof(float));
  return 0u;
}
"""
# a launch: its blocks in order, each block's threads in order
LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]*>>>\(")
LOOP = (r"for (unsigned _b = host_smem_reserve(\4); _b < (unsigned)(\2); ++_b) "
        r"for (unsigned _t = 0; _t < (unsigned)(\3); ++_t) "
        r"blockIdx.x = _b, blockDim.x = (\3), threadIdx.x = _t, \1(")
SMEM = re.compile(r"extern __shared__ float (\w+)\[\];")

ATOL, RTOL = 1e-5, 2e-4  # kernel vs plain version (PERF.md section 2)
ATOL64, RTOL64 = 1e-10, 1e-8
PEN_ULPS = 8  # the solver reverse pass's penetration cotangents on RoboCup


def build(double: bool, out: Path | None = None) -> Path:
    """Compile every ``csrc/*.cu`` with g++, all at once, into one shared
    library under ``out`` (default ``build/host_kernels/<float|double>``)."""
    out = out or ROOT / "build" / "host_kernels" / ("double" if double else "float")
    src = out / "src"
    src.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(
        SHIM + (DOUBLE_MATH if double else FLOAT_MATH) + HOST_SMEM)
    for f in sorted((ROOT / "parallax_tpu_torch" / "csrc").iterdir()):
        text = f.read_text()
        if f.suffix == ".cu":
            text = SMEM.sub(r"float* \1 = host_smem;", LAUNCH.sub(LOOP, text))
        (src / f.name).write_text(text)
    objs = [f.with_suffix(".o") for f in sorted(src.glob("*.cu"))]
    procs = [subprocess.Popen(["g++", "-O2", "-ffp-contract=off", "-fPIC", "-std=c++17",
                               f"-I{out}", "-x", "c++", "-c", str(o.with_suffix(".cu")),
                               "-o", str(o)])
             for o in objs]
    if any(p.wait() for p in procs):
        raise RuntimeError("g++ failed on the kernels' host build")
    lib = out / "libhost_kernels.so"
    subprocess.run(["g++", "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return lib


def load(lib: Path, double: bool, mp=None) -> None:
    """Make the wrappers launch the host library on CPU tensors (through
    ``mp.setattr`` where a ``pytest.MonkeyPatch`` is given, so that it is
    undone)."""
    from parallax_tpu_torch.ops import _build, contact_solver, fused_step

    put = setattr if mp is None else mp.setattr
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = [ctypes.c_double if double and a is ctypes.c_float else a
                       for a in argtypes]
        fn.restype = ctypes.c_int
    put(_build, "load", lambda: cdll)
    put(torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    if double:  # float64 planes, operands and scratch
        put(contact_solver, "_check", lambda *a, **k: None)
        proxy = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                         if not k.startswith("__")})
        proxy.float32 = torch.float64
        put(fused_step, "torch", proxy)
        put(contact_solver, "torch", proxy)


def to64(world, tparts=()) -> None:
    """The world's kernel operands in float64, and what the plain version
    reads beside the planes: its gravity mask, and the bodies' masses and
    inertias as float64 tensors whose inverses are the kernel's float32
    ones.  Left in float32, the plain step would round its gravity
    increment and sums such as ``im_a + im_b`` to float32 where the kernel
    works in float64.  The friction and elasticity stay float32: the plain
    step and the kernel's operands both mix them in float32."""
    from parallax_tpu_torch.ops import contact_solver, fused_step

    ops = (fused_step.fused_operands(world, tparts),
           contact_solver.solver_operands(world, world.config.contact))
    for k, v in list(world.cache.items()):
        if any(v is o for o in ops):
            world.cache[k] = type(v)(*(x.double() if x.dtype == torch.float32 else x for x in v))
    p = world.params
    world.params = p._replace(mass=1.0 / p.inv_mass.double(),
                              inertia=1.0 / p.inv_inertia.double())
    world.cache[("gravity_mask",)] = torch.isfinite(world.params.mass).double()[:, None]


SCENARIOS = ("lander contact", "RoboCup overlap", "billiards8 pairs", "billiards8 pile",
             "mixed cc+cb+pp", "crate pile", "cb_tie_case (B=1)", "area_tie_case (B=1)",
             "bb_tie_case (B=1)")
# worlds past the kernels' old 16-part and 64-body limits (float32 only: in
# float64 billiards61's reverse pass needs more than a block's 227 KB):
# billiards48 (48 balls, 52 parts, C=1320: the forward's lane fields in
# scratch), billiards61 (65 bodies) and the override world (its overridden
# part at index 32)
LARGE_SCENARIOS = ("billiards48 pairs", "billiards61 pairs", "override (part 32)")


def scenario(label: str, B: int):
    """``(world, state, override, cotangents)`` of one scenario of
    ``SCENARIOS`` at B worlds (the tie cases at B=1): the world is the
    fused step's, whose lanes the solve kernels take too."""
    import torch_scenarios as ts

    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig

    override = {}
    if label == "lander contact":
        env = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device="cpu")
        world = env.world
        s, override = ts.lander_contact_case(env, B)
    elif label in ("RoboCup overlap", "area_tie_case (B=1)"):
        env = RoboCup(RoboCupConfig(use_cuda_fused=True), device="cpu")
        world = env.world
        if label.startswith("area"):
            s, cot = ts.area_tie_case(env)
            return world, s, override, cot
        s = ts.robocup_overlap_state(env, B)
    elif label.startswith("override"):
        world, slab = ts.override_world("cpu")
        s, override = ts.override_state(world, slab, B)
    elif label in ("billiards48 pairs", "billiards61 pairs"):
        balls = int(label[len("billiards"):label.index(" ")])
        env = Billiards(BilliardsConfig(n_object=balls - 1, use_cuda_fused=True), device="cpu")
        world = env.world
        s = ts.billiards_pairs_state(env, B)
    elif label.startswith("billiards8") or label.startswith("cb_tie"):
        env = Billiards(BilliardsConfig(use_cuda_fused=True), device="cpu")
        world = env.world
        if label.startswith("cb_tie"):
            s, cot = ts.cb_tie_case(env)
            return world, s, override, cot
        s = (ts.billiards_pairs_state(env, B) if label.endswith("pairs")
             else ts.overlap_state(env, B, 3, 1.0, 0.03, 0.02))
    elif label.startswith("mixed"):
        world, ms = ts.mixed_world("cpu")
        s = ts.mixed_state(world, ms, B)
    else:
        world, _ = ts.crate_world("cpu", fused=True)
        if label.startswith("bb_tie"):
            s, cot = ts.bb_tie_case(world)
            return world, s, override, cot
        s = ts.crate_overlap_state(world, B)
    return world, s, override, ts.cotangents(world.n_bodies, B, 5)


def _share(got, want, atol, rtol, ulps=0):
    """The largest ``|got - want| / (atol + rtol |want| + ulps of the plane's
    largest |want|)`` over the planes, and the largest ``|got - want|``."""
    share = err = 0.0
    for a, b in zip(got, want):
        if not b.numel():
            continue
        d = (a - b).abs()
        slack = ulps * torch.finfo(torch.float32).eps * b.abs().max()
        share = max(share, (d / (atol + rtol * b.abs() + slack)).max().item())
        err = max(err, d.max().item())
    return share, err


def check(world, s, override, cot, double=False) -> dict:
    """Every kernel against its plain version on one scenario, through the
    wrappers' launch functions: the fused step and the solve on the
    integrated state's lanes (float32 only: ``flags``, ``fused``,
    ``solve``: max |diff|), and the two reverse passes (``fused_bwd``,
    ``solve_bwd`` and the solver's penetration cotangents ``pen``: share of
    the bar and max |diff|; ``pen_ulps``: the share with PEN_ULPS float32
    ulps of each plane's largest value added to the bar)."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.ops import contact_solver, fused_step

    atol, rtol = (ATOL64, RTOL64) if double else (ATOL, RTOL)
    if double:
        to64(world, tuple(sorted(override)))
        s, cot = (type(s)(*(x.double() for x in t)) for t in (s, cot))
        override = {p: tuple(x.double() for x in xy) for p, xy in override.items()}
    tparts = tuple(sorted(override))
    statics = (world, tparts, None, None)
    tx, ty = fused_step._terrain_planes(override, tparts, s.px)
    out = {}
    if not double:
        got, act = fused_step._step_cuda(statics, s, tx, ty)
        want, wc = fused_step.fused_step_plain(world, s, override)
        out["flags"] = bool(torch.equal(act, wc.active))
        out["active"] = int(wc.active.sum())
        out["fused"] = max((a - b).abs().max().item() for a, b in zip(got, want))
    got = fused_step._fused_bwd_cuda(statics, s, tx, ty, cot)
    want = fused_step.fused_step_bwd_plain(world, s, override, cot)
    out["fused_bwd"] = _share((*got[0], *got[1:]), (*want[0], *want[1:]), atol, rtol)

    cfg = world.config
    args = (cfg.solver_iterations, cfg.position_iterations, cfg.dt, cfg.contact)
    si, _ = integrate_bm(world, s)
    con = collide_batched(world, si, override)
    if double:
        con = con._replace(**{k: getattr(con, k).double()
                              for k in ("pen_x", "pen_y", "pt_x", "pt_y")})
    else:
        got = contact_solver._solve_cuda(world, si, con, *args)
        want = contact_solver.solve_contacts_plain(world, si, con, *args)
        out["solve"] = max((a - b).abs().max().item() for a, b in zip(got, want))
    got = contact_solver._solve_bwd_cuda(world, si, con, cot, *args)
    want = contact_solver.solve_contacts_bwd_plain(world, si, con, cot, *args)
    out["solve_bwd"] = _share((*got[0], *got[3:]), (*want[0], *want[3:]), atol, rtol)
    out["pen"] = _share(got[1:3], want[1:3], atol, rtol)
    out["pen_ulps"] = _share(got[1:3], want[1:3], atol, rtol, 0 if double else PEN_ULPS)[0]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--double", action="store_true", help="build and compare in float64")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--out", type=Path, default=None, help="build directory")
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    load(build(args.double, args.out), args.double)
    atol, rtol = (ATOL64, RTOL64) if args.double else (ATOL, RTOL)
    kind = "float64" if args.double else "float32"
    for label in SCENARIOS + (() if args.double else LARGE_SCENARIOS):
        r = check(*scenario(label, args.batch), double=args.double)
        if not args.double:
            print(f"{label}: fused step flags equal {r['flags']}, {r['active']} active lanes, "
                  f"max |diff| {r['fused']:.3e}; solve max |diff| {r['solve']:.3e}")
        for key in ("fused_bwd", "solve_bwd", "pen"):
            share, err = r[key]
            print(f"{label}: {key} max |diff| {err:.3e}, {share:.3f} of {atol:g} + {rtol:g} "
                  f"|plain| ({kind})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
