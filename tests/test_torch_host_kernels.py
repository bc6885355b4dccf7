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
plane's largest value added).  No jax.  The build is skipped only where
g++ is missing.
"""

import importlib.util
import shutil
from pathlib import Path

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
    from parallax_tpu_torch.ops import contact_solver, fused_step

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
