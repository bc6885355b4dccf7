"""The port's CUDA kernels built as host C++ and run on the CPU.

``tools/torch_host_kernels.py`` compiles ``parallax_tpu_torch/csrc/*.cu``
with g++ behind a shim: a warp of one thread, ``__syncwarp`` and
``__syncthreads`` as no-ops, a launch as a loop over its blocks and
threads, and a block's dynamic shared memory as a host buffer.  The
wrappers then launch the library on CPU tensors.  This is the CPU's only
check of the kernels' arithmetic: the solve and fused-step kernels and
their reverse passes against their plain versions at B=16, at the bars of
``PERF.md`` section 2 (forward planes within 1e-5 and the fused step's
flags equal; cotangents within 1e-5 + 2e-4 |plain|, the solver reverse
pass's penetration cotangents on RoboCup with 8 float32 ulps of each
plane's largest value added), and the threefry kernels bit-equal to
``utils/prng.py``'s and ``terrain_planes_batch``'s torch bodies.  No jax.
The build is skipped only where g++ is missing.
"""

import importlib.util
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_host_kernels", ROOT / "tools" / "torch_host_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The tool, with the kernels built once and the wrappers launching them
    on CPU tensors until the module's tests are done; then the wrappers and
    their launch counters are as they were."""
    from parallax_tpu_torch.ops import contact_solver, fused_step, threefry

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels as host C++")
    tool = _tool()
    lib = tool.build(False, tmp_path_factory.mktemp("host_kernels"))
    with pytest.MonkeyPatch.context() as mp:
        tool.load(lib, False, mp)
        # the launches here are the host build's: the counters go back
        for mod in (contact_solver, fused_step):
            for name in ("launches", "bwd_launches"):
                mp.setattr(mod, name, getattr(mod, name))
        for name in ("split_launches", "uniform_launches", "terrain_launches"):
            mp.setattr(threefry, name, getattr(threefry, name))
        yield tool


@pytest.mark.parametrize("label", ["lander contact", "RoboCup overlap", "crate pile",
                                   "bb_tie_case (B=1)"])
def test_host_kernels_match_plain_versions(host, label):
    """Every kernel against its plain version on one scenario."""
    r = host.check(*host.scenario(label, 16))
    assert r["flags"] and r["active"] > 0, r
    assert r["fused"] <= host.ATOL and r["solve"] <= host.ATOL, r
    assert r["fused_bwd"][0] <= 1.0 and r["solve_bwd"][0] <= 1.0, r
    pen = r["pen_ulps"] if label.startswith("RoboCup") else r["pen"][0]
    assert pen <= 1.0, r


def test_host_reverse_kernels_on_billiards8_pile_are_read(host, capsys):
    """Billiards8's pile puts lanes near kinks, where two float32 VJPs
    differ (kernel and plain version equally far from float64, as
    ``PERF.md`` records): read and printed, with no bar; finite, and the
    forward kernels still hold theirs."""
    r = host.check(*host.scenario("billiards8 pile", 16))
    with capsys.disabled():
        print(f"\nbilliards8 pile (host build, B=16): fused_bwd {r['fused_bwd'][0]:.3f}, "
              f"solve_bwd {r['solve_bwd'][0]:.3f}, pen {r['pen'][0]:.3f} of the bar")
    assert r["flags"] and r["fused"] <= host.ATOL and r["solve"] <= host.ATOL, r
    assert all(v == v and v < float("inf") for k in ("fused_bwd", "solve_bwd", "pen")
               for v in r[k]), r


def test_host_reverse_kernels_give_the_same_bits_for_any_worlds_per_block(host, monkeypatch):
    """The crate pile at B=7 (ragged for 2, 3 and 4 worlds a block): both
    reverse kernels give the same bits with 1, 2, 3 and 4 worlds a block,
    and on a second launch."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.ops import contact_solver, fused_step

    world, s, _, cot = host.scenario("crate pile", 7)
    c = world.config
    args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
    si, _ = integrate_bm(world, s)
    con = collide_batched(world, si)
    tx, ty = fused_step._terrain_planes({}, (), s.px)

    def both():
        f = fused_step._fused_bwd_cuda((world, (), None, None), s, tx, ty, cot)
        g = contact_solver._solve_bwd_cuda(world, si, con, cot, *args)
        return (*f[0], *g[0], *g[1:])

    first = both()
    for w in (1, 2, 3, 4):
        monkeypatch.setattr(contact_solver, "WORLDS_PER_BLOCK", w)
        assert all(torch.equal(a, b) for a, b in zip(first, both())), w


_TINY = float(np.finfo(np.float32).tiny)
_DRAWS = ([("split", n) for n in (2, 5)] + [("fold_in", 0x501E), ("bits", (47, 2))]
          + [("uniform", shape, lo, hi) for shape in ((), (8,), (47, 2))
             for lo, hi in ((-5.0, 5.0), (-0.002, 0.002), (0.0, 2 * math.pi), (_TINY, 1.0))]
          + [("terrain", False), ("terrain", True)])


@pytest.mark.parametrize("case", _DRAWS, ids=lambda c: "-".join(map(str, c)).replace(" ", ""))
def test_host_threefry_kernels_match_torch_bodies(host, case):
    """``csrc/threefry.cu`` on CPU keys against ``prng``'s torch bodies (and
    ``csrc/lander_terrain.cu`` against ``terrain_planes_batch``'s, on 4,096
    keys), bit for bit: keys 0,
    0xFFFFFFFF in both words or one, and random words, read contiguous and
    through a split's row stride."""
    from parallax_tpu_torch.envs.lunar_lander import MAX_VERTS, terrain_planes_batch
    from parallax_tpu_torch.ops import threefry
    from parallax_tpu_torch.utils import prng

    rng = np.random.default_rng(20)
    words = rng.integers(0, 2**32, (4096 if case[0] == "terrain" else 60, 2), dtype=np.uint64)
    words[:4] = [[0, 0], [2**32 - 1, 2**32 - 1], [0, 2**32 - 1], [2**32 - 1, 0]]
    keys = torch.from_numpy(words.astype(np.int64))
    for k in (keys, prng.split(keys)[:, 1]):  # contiguous, and a row stride of 4
        kind, *args = case
        if kind == "split":
            got, want = threefry.split(k, *args), prng.split(k, *args)
        elif kind == "fold_in":
            got, want = threefry.split(k, 1, *args)[:, 0], prng.fold_in(k, *args)
        elif kind == "bits":
            got, want = threefry.random_bits(k, *args), prng.random_bits(k, *args)
        elif kind == "uniform":
            shape, lo, hi = args
            got = threefry.uniform(k, shape, *prng._bounds(lo, hi))
            want = prng.uniform(k, shape, lo, hi)
        else:
            got = threefry.lander_terrain(k, *args, MAX_VERTS)
            want = terrain_planes_batch(k, *args)
        for g, w in zip(*((got, want) if kind == "terrain" else ((got,), (want,)))):
            assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape)
            assert torch.equal(g, w), case
