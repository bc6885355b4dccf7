"""The two forward kernels built as host C++ and run on the CPU.

``tools/torch_host_kernels.py`` builds ``parallax_tpu_torch/csrc/*.cu``
with g++, a warp as one thread (see ``tests/test_torch_host_kernels.py``,
which holds all four kernels against their plain versions on the lander,
RoboCup, the crate pile and ``bb_tie_case``).  Here the solve and
fused-step kernels, one warp per world, W worlds a block: the same bits
for any plan and on a second launch, and a world whose state holds NaN and
inf laid out as the plain versions lay it out.  No jax.  The build is
skipped only where g++ is missing.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The tool, with the kernels built once and the wrappers launching them
    on CPU tensors until the module's tests are done; then the wrappers and
    their launch counters are as they were."""
    from parallax_tpu_torch.ops import contact_solver, fused_step

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels as host C++")
    spec = importlib.util.spec_from_file_location(
        "torch_host_kernels", ROOT / "tools" / "torch_host_kernels.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    lib = tool.build(False, tmp_path_factory.mktemp("host_kernels"))
    with pytest.MonkeyPatch.context() as mp:
        tool.load(lib, False, mp)
        for mod in (contact_solver, fused_step):
            for name in ("launches", "bwd_launches"):
                mp.setattr(mod, name, getattr(mod, name))
        yield tool


def _forwards(world, s, override=None):
    """Both forward kernels on one state, through the wrappers' launch
    functions: the fused step's six body planes and flags, then the solve's
    six planes on the lanes of the integrated state."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.ops import contact_solver, fused_step

    override = override or {}
    tparts = tuple(sorted(override))
    tx, ty = fused_step._terrain_planes(override, tparts, s.px)
    out, active = fused_step._step_cuda((world, tparts, None, None), s, tx, ty)
    c = world.config
    si, _ = integrate_bm(world, s)
    con = collide_batched(world, si, override)
    got = contact_solver._solve_cuda(world, si, con, c.solver_iterations,
                                     c.position_iterations, c.dt, c.contact)
    return (*out, active, *got)


def test_host_forward_kernels_give_the_same_bits_for_any_worlds_per_block(host, monkeypatch):
    """The crate pile at B=7 (ragged for 2, 3 and 4 worlds a block): both
    forward kernels give the same bits with 1, 2, 3 and 4 worlds a block,
    on a second launch, and (the solve) with the lane fields in the
    wrapper's world-major scratch in place of shared memory, as
    billiards48 runs."""
    from parallax_tpu_torch.ops import _build, contact_solver

    world, s, _, _ = host.scenario("crate pile", 7)
    first = _forwards(world, s)
    assert all(torch.equal(a, b) for a, b in zip(first, _forwards(world, s)))
    for w in (1, 2, 3, 4):
        monkeypatch.setattr(contact_solver, "WORLDS_PER_BLOCK", w)
        assert all(torch.equal(a, b) for a, b in zip(first, _forwards(world, s))), w
    monkeypatch.setattr(contact_solver, "FIELDS_MIN_WORLDS", 10**6)
    assert contact_solver.solve_plan(_build.load(), 88, 14)[0] == 0
    assert all(torch.equal(a, b) for a, b in zip(first, _forwards(world, s)))


@pytest.mark.parametrize("kernel", ["fused", "solve"])
def test_host_forward_kernels_place_nan_as_the_plain_versions(host, kernel):
    """The lander's contact scenario at B=8 with world 3's hull x NaN and
    world 5's leg vy inf: the kernel's flags (fused) and the places of its
    NaN are the plain version's, and the finite worlds agree within 1e-5.
    A non-finite world walks every lane, as a serial loop does."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.ops import contact_solver, fused_step

    world, s, override, _ = host.scenario("lander contact", 8)
    px, vy = s.px.clone(), s.vy.clone()
    px[0, 3] = float("nan")
    vy[1, 5] = float("inf")
    s = s._replace(px=px, vy=vy)
    if kernel == "fused":
        tparts = tuple(sorted(override))
        tx, ty = fused_step._terrain_planes(override, tparts, s.px)
        got, active = fused_step._step_cuda((world, tparts, None, None), s, tx, ty)
        want, wc = fused_step.fused_step_plain(world, s, override)
        assert torch.equal(active, wc.active)
    else:
        c = world.config
        args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
        si, _ = integrate_bm(world, s)
        con = collide_batched(world, si, override)
        got = contact_solver._solve_cuda(world, si, con, *args)
        want = contact_solver.solve_contacts_plain(world, si, con, *args)
    finite = torch.ones(s.px.shape[1], dtype=torch.bool)
    finite[[3, 5]] = False
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        torch.testing.assert_close(g[:, finite], w[:, finite], rtol=0, atol=1e-5)
    assert any(torch.isnan(w[:, 3]).any() for w in want)


@pytest.mark.parametrize("label", ["billiards48 pairs", "billiards61 pairs",
                                   "override (part 32)"])
def test_host_kernels_run_worlds_past_the_old_part_and_body_limits(host, label):
    """Worlds the kernels refused before (more than 16 parts or 64 bodies),
    at B=4, against the plain versions at the bars of
    ``test_torch_host_kernels.py``: billiards48 (52 parts, C=1320; the
    fused forward keeps its lane fields in scratch, 3 worlds a block, as
    the solve does), billiards61 (65 bodies, C=2074) with all four kernels,
    and the override world, whose overridden slab is part 32 (rank 0 in
    ``part_i``'s last column), with all four too (its solver reverse
    pass's penetration cotangents, sums that cancel at the crates' face
    contacts, with 8 float32 ulps of each plane's largest value added to
    the bar, as on RoboCup)."""
    from parallax_tpu_torch.ops import _build, fused_step

    world, s, override, cot = host.scenario(label, 4)
    C, n, P = world.table.n_contacts, world.n_bodies, len(world.parts.nverts)
    plan = fused_step._fwd_plan(_build.load(), world, C, n, P, 0)
    if label.startswith("billiards48"):
        assert (P, C, plan) == (52, 1320, (0, 3))
    if label.startswith("override"):
        (slab,) = override
        assert slab == 32
        part_i = fused_step.fused_operands(world, (slab,)).part_i
        assert part_i[:, 3].tolist() == [0 if p == slab else -1 for p in range(P)]
    else:
        assert n > 64 or P > 16
    r = host.check(world, s, override, cot)
    assert r["flags"] and r["active"] > 0, r
    assert r["fused"] <= host.ATOL and r["fused_bwd"][0] <= 1.0, r
    assert r["solve"] <= host.ATOL and r["solve_bwd"][0] <= 1.0, r
    pen = r["pen_ulps"] if label.startswith("override") else r["pen"][0]
    assert pen <= 1.0, r
