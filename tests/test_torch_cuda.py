"""Tests of the port that need an NVIDIA GPU: the CUDA kernel has no CPU mode.

Each skips on a machine without a CUDA device.  This file imports neither
jax nor the JAX package, so on the GPU machine it runs with

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

(``--noconftest``: the suite's conftest sets up jax's CPU platform).
"""

import math

import numpy as np
import pytest
import torch
from torch_scenarios import (
    KIND_WORLDS,
    active_kinds,
    area_tie_case,
    bb_tie_case,
    billiards_pairs_state,
    candidate_contact_case,
    cb_tie_case,
    cotangents,
    crate_kick_loss,
    crate_overlap_state,
    crate_world,
    kinds_state,
    kinds_world,
    mixed_state,
    mixed_world,
    overlap_state,
    pair_world,
    robocup_overlap_state,
    tie_fused_case,
    tie_solve_case,
)

from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs import plane_env
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
from parallax_tpu_torch.envs.lunar_lander import (
    MAX_VERTS,
    LanderConfig,
    LunarLander,
    terrain_planes_batch,
    terrain_planes_plain,
)
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from parallax_tpu_torch.ops import contact_solver, fused_step, threefry
from parallax_tpu_torch.parallel import rollout
from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.pytree import tree_leaves, tree_map

ATOL = 1e-5  # kernel vs plain version: float32 rounding and sum order
RTOL = 2e-4  # the reverse pass: the JAX package's bar for its Pallas backward


@pytest.fixture(scope="module")
def cuda_env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return LunarLander(device="cuda")


@pytest.fixture(scope="module")
def fused_env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device="cuda")


@pytest.fixture(scope="module")
def billiards_env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return Billiards(BilliardsConfig(use_cuda_fused=True), device="cuda")


def _keys(B, seed):
    k = np.random.default_rng(seed).integers(0, 2**32, (B, 2), dtype=np.uint32)
    return torch.from_numpy(k.astype(np.int64)).cuda()


def _zero(_, obs):
    return torch.zeros((obs.shape[0], 2), device=obs.device)


def _contact_scenario(env, B):
    """The lander lowered by 6.2 with vy -= 0.6, after 40 zero-action steps."""
    st = env.reset_fn_batch(_keys(B, 0))
    b = st.bodies
    st = st._replace(bodies=b._replace(
        pos=b.pos - torch.tensor([0.0, 6.2], device="cuda"),
        vel=b.vel - torch.tensor([0.0, 0.6], device="cuda"),
    ))
    st, _ = env.rollout_batch(st, _zero, 40)
    aux = env.plane_pack(st)
    override = {p: (aux.tox[i], aux.toy[i]) for i, p in enumerate(env._ground_parts)}
    s = tb._to_soa(st.bodies)
    con = tb.collide_batched(env.world, s, override)
    assert int(con.active.sum()) > 100
    return st, s, con


@pytest.mark.cuda
@pytest.mark.parametrize("position_iterations", [2, 0])
def test_kernel_matches_plain_version_on_card(cuda_env, position_iterations):
    env = cuda_env
    _, s, con = _contact_scenario(env, 1024)
    cfg = env.world.config.contact
    before = contact_solver.launches
    got = contact_solver.solve_contacts(env.world, s, con, 3, position_iterations, 0.01, cfg)
    assert contact_solver.launches == before + 1
    want = contact_solver.solve_contacts_plain(
        env.world, s, con, 3, position_iterations, 0.01, cfg
    )
    torch.cuda.synchronize()
    for f, x, y in zip(got._fields, got, want):
        err = (x - y).abs().max().item()
        assert err <= ATOL, (f, err)


@pytest.mark.cuda
def test_rollout_on_card_launches_the_kernel_every_step(cuda_env):
    env = cuda_env
    st = env.reset_fn_batch(_keys(256, 3))
    before = contact_solver.launches
    _, traj = env.rollout_batch(st, _zero, 10)
    torch.cuda.synchronize()
    assert contact_solver.launches - before == 10
    assert torch.isfinite(traj.obs).all()


@pytest.mark.cuda
def test_wrapper_refuses_bad_inputs_on_card(cuda_env):
    env = cuda_env
    st = env.reset_fn_batch(_keys(256, 5))
    s = tb._to_soa(st.bodies)
    C = env.world.table.n_contacts
    con = tb.ContactsBM(*(torch.zeros((C, 256), device="cuda") for _ in range(4)),
                        torch.zeros((C, 256), dtype=torch.bool, device="cuda"),
                        torch.ones((C, 256), device="cuda"))
    cfg = env.world.config.contact
    with pytest.raises(ValueError, match="dtype"):
        contact_solver.solve_contacts(
            env.world, s._replace(px=s.px.double()), con, 3, 2, 0.01, cfg
        )
    with pytest.raises(ValueError, match="contiguous"):
        contact_solver.solve_contacts(
            env.world, s._replace(px=s.px.T.contiguous().T), con, 3, 2, 0.01, cfg
        )
    with pytest.raises(ValueError, match="expected cuda"):
        contact_solver.solve_contacts(
            env.world, s, con._replace(pen_x=con.pen_x.cpu()), 3, 2, 0.01, cfg
        )


@pytest.mark.cuda
@pytest.mark.parametrize("position_iterations", [2, 0])
def test_bwd_kernel_matches_plain_vjp_on_card(cuda_env, position_iterations):
    """The reverse-pass kernel against autograd of the plain version.  With
    the lander's position passes every cotangent agrees elementwise (rtol
    2e-4, atol 1e-5).  Without them the velocity solve carries the whole
    Baumgarte bias, and some cotangents are sums of terms thousands of
    times larger than the result, so float32 keeps none of their digits in
    either version.  There both are held against the plain VJP in float64:
    the kernel may be no further from it than twice the plain float32
    version's distance, plus atol."""
    env = cuda_env
    _, s, con = _contact_scenario(env, 1024)
    cfg = env.world.config.contact
    rng = np.random.default_rng(5)
    cot = tb._SoA(*(torch.from_numpy(rng.standard_normal(s.px.shape).astype(np.float32)).cuda()
                    for _ in range(6)))
    before = contact_solver.bwd_launches
    got = contact_solver.solve_contacts_bwd(env.world, s, con, cot, 3, position_iterations,
                                            0.01, cfg)
    assert contact_solver.bwd_launches == before + 1
    want = contact_solver.solve_contacts_bwd_plain(env.world, s, con, cot, 3,
                                                   position_iterations, 0.01, cfg)
    torch.cuda.synchronize()
    if not position_iterations:
        exact = contact_solver.solve_contacts_bwd_plain(
            env.world, tb._SoA(*(x.double() for x in s)),
            con._replace(**{k: getattr(con, k).double() for k in ("pen_x", "pen_y", "pt_x", "pt_y")}),
            tb._SoA(*(x.double() for x in cot)), 3, 0, 0.01, cfg,
        )
    for i, (x, y) in enumerate(zip((*got[0], *got[1:]), (*want[0], *want[1:]))):
        assert torch.isfinite(x).all()
        if position_iterations:
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
        else:
            z = (*exact[0], *exact[1:])[i]
            assert (x - z).abs().max() <= 2 * (y - z).abs().max() + ATOL


@pytest.mark.cuda
def test_train_step_on_card_runs_both_kernels(cuda_env):
    """A train step at small B: the solve carries a grad_fn on the card, the
    backward launches the reverse-pass kernel once a step, and the policy
    gradients are finite and nonzero.  Without autograd nothing of the
    backward is recorded."""
    env = cuda_env
    st, _, _ = _contact_scenario(env, 256)
    rng = np.random.default_rng(0)
    params = {
        "w1": torch.tensor(rng.standard_normal((9, 32)) * 0.3, dtype=torch.float32),
        "b1": torch.zeros(32),
        "w2": torch.tensor(rng.standard_normal((32, 2)) * 0.1, dtype=torch.float32),
        "b2": torch.zeros(2),
    }
    params = {k: v.cuda().requires_grad_(True) for k, v in params.items()}

    def policy(p, obs):
        return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])

    with torch.no_grad():
        before = contact_solver.bwd_launches
        _, traj = env.rollout_batch(st, policy, 2, params)
        assert traj.reward.grad_fn is None and contact_solver.bwd_launches == before

    h = 6
    loss_fn = rollout.make_loss_fn(env, policy, h, checkpoint_segments=2)
    f0, b0 = contact_solver.launches, contact_solver.bwd_launches
    loss, _ = loss_fn(params, st)
    assert loss.grad_fn is not None
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    assert contact_solver.launches - f0 == 2 * h  # forward + checkpoint recompute
    assert contact_solver.bwd_launches - b0 == h
    assert torch.isfinite(loss)
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0


def _override(env, st):
    aux = env.plane_pack(st)
    return {p: (aux.tox[i], aux.toy[i]) for i, p in enumerate(env._ground_parts)}


@pytest.mark.cuda
def test_fused_kernel_matches_plain_version_on_card(cuda_env, fused_env):
    st, s, _ = _contact_scenario(cuda_env, 1024)
    override = _override(fused_env, st)
    before = fused_step.launches
    got_s, got_c = fused_step.physics_core_fused(fused_env.world, s, override)
    assert fused_step.launches == before + 1
    want_s, want_c = fused_step.fused_step_plain(fused_env.world, s, override)
    torch.cuda.synchronize()
    assert int(want_c.active.sum()) > 100
    assert torch.equal(got_c.active, want_c.active)
    for f, x, y in zip(got_s._fields, got_s, want_s):
        err = (x - y).abs().max().item()
        assert err <= ATOL, (f, err)


@pytest.mark.cuda
def test_fused_rollout_launches_the_fused_kernel_every_step(fused_env):
    st = fused_env.reset_fn_batch(_keys(256, 3))
    f0, s0 = fused_step.launches, contact_solver.launches
    _, traj = fused_env.rollout_batch(st, _zero, 10)
    torch.cuda.synchronize()
    assert fused_step.launches - f0 == 10
    assert contact_solver.launches == s0
    assert torch.isfinite(traj.obs).all() and torch.isfinite(traj.reward).all()


@pytest.mark.cuda
def test_nan_world_is_truncated_and_reset_on_the_fused_path(fused_env):
    bad = 5
    st = fused_env.reset_fn_batch(_keys(256, 7))
    vel = st.bodies.vel.clone()
    vel[bad, 0, 0] = float("nan")
    final, traj = fused_env.rollout_batch(st._replace(bodies=st.bodies._replace(vel=vel)),
                                          _zero, 3)
    tr = traj.truncated.cpu()
    assert tr[0, bad] and tr[0].sum() == 1
    assert traj.reward[0, bad] == 0.0 and (traj.obs[0, bad] == 0.0).all()
    assert torch.isfinite(traj.obs).all()
    assert torch.isfinite(final.bodies.pos).all()
    assert int(final.t[bad]) == 2  # reset after the first step


@pytest.mark.cuda
def test_fused_wrapper_refuses_bad_inputs_on_card(cuda_env, fused_env):
    st = fused_env.reset_fn_batch(_keys(256, 5))
    s = tb._to_soa(st.bodies)
    override = _override(fused_env, st)
    world = fused_env.world
    with pytest.raises(ValueError, match="dtype"):
        fused_step.physics_core_fused(world, s._replace(px=s.px.double()), override)
    with pytest.raises(ValueError, match="contiguous"):
        fused_step.physics_core_fused(world, s._replace(px=s.px.T.contiguous().T), override)
    p = fused_env._ground_parts[0]
    with pytest.raises(ValueError, match="expected cuda"):
        fused_step.physics_core_fused(
            world, s, {**override, p: (override[p][0].cpu(), override[p][1])}
        )
    with pytest.raises(ValueError, match="shape"):
        fused_step.physics_core_fused(
            world, s, {**override, p: (override[p][0][:4], override[p][1][:4])}
        )
    # the broadphase-on world is one the kernel does not run: no split path
    with pytest.raises(ValueError, match="broadphase=False"):
        fused_step.physics_core_fused(cuda_env.world, s, override)


@pytest.mark.cuda
def test_fused_step_under_autograd_runs_the_reverse_pass_on_card(fused_env):
    """Under autograd the fused step runs through ``_FusedStep``: one forward
    launch, then one reverse-pass launch on ``backward()``, and ``active``
    carries no gradient.  Under ``no_grad`` nothing of the backward is
    recorded."""
    st = fused_env.reset_fn_batch(_keys(256, 9))
    s = tb._to_soa(st.bodies)
    override = _override(fused_env, st)
    f0, b0 = fused_step.launches, fused_step.bwd_launches
    vy = s.vy.clone().requires_grad_(True)
    out, con = fused_step.physics_core_fused(fused_env.world, s._replace(vy=vy), override)
    assert fused_step.launches == f0 + 1 and fused_step.bwd_launches == b0
    assert out.py.grad_fn is not None and not con.active.requires_grad
    (out.py.sum() + out.vy.sum()).backward()
    torch.cuda.synchronize()
    assert fused_step.bwd_launches == b0 + 1
    assert torch.isfinite(vy.grad).all() and vy.grad.abs().max() > 0
    with torch.no_grad():
        out, _ = fused_step.physics_core_fused(fused_env.world, s._replace(vy=vy), override)
    assert out.py.grad_fn is None
    assert fused_step.launches == f0 + 2 and fused_step.bwd_launches == b0 + 1


@pytest.mark.cuda
def test_fused_bwd_kernel_matches_plain_vjp_on_card(cuda_env, fused_env):
    """The fused step's reverse-pass kernel against autograd of its plain
    version on the same CUDA tensors, at B=1024 on the contact scenario,
    with the terrain tilted by a slope of 0.05 so that its x cotangent is
    not zero (as in tests/test_torch_fused_step.py): every plane within rtol
    2e-4, atol 1e-5, and alive."""
    st, s, _ = _contact_scenario(cuda_env, 1024)
    override = {p: (x, y + 0.05 * x) for p, (x, y) in _override(fused_env, st).items()}
    rng = np.random.default_rng(5)
    cot = tb._SoA(*(torch.from_numpy(rng.standard_normal(s.px.shape).astype(np.float32)).cuda()
                    for _ in range(6)))
    before = fused_step.bwd_launches
    got = fused_step.fused_step_bwd(fused_env.world, s, override, cot)
    assert fused_step.bwd_launches == before + 1
    want = fused_step.fused_step_bwd_plain(fused_env.world, s, override, cot)
    torch.cuda.synchronize()
    for x, y in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert torch.isfinite(x).all() and x.abs().max() > 0
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_fused_train_step_on_card_runs_the_fused_kernels_only(fused_env):
    """A train step through the fused step at small B: per step of the
    horizon one fused launch in the forward and one in the checkpoint
    recompute, one reverse-pass launch, and no launch of the solver's
    kernels; the policy gradients are finite and nonzero."""
    st, _, _ = _contact_scenario(fused_env, 256)
    rng = np.random.default_rng(0)
    params = {
        "w1": torch.tensor(rng.standard_normal((9, 32)) * 0.3, dtype=torch.float32),
        "b1": torch.zeros(32),
        "w2": torch.tensor(rng.standard_normal((32, 2)) * 0.1, dtype=torch.float32),
        "b2": torch.zeros(2),
    }
    params = {k: v.cuda().requires_grad_(True) for k, v in params.items()}

    def policy(p, obs):
        return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])

    h = 6
    loss_fn = rollout.make_loss_fn(fused_env, policy, h, checkpoint_segments=2)
    counts = (fused_step.launches, fused_step.bwd_launches,
              contact_solver.launches, contact_solver.bwd_launches)
    loss, _ = loss_fn(params, st)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    f, b, sf, sb = (x - y for x, y in zip(
        (fused_step.launches, fused_step.bwd_launches,
         contact_solver.launches, contact_solver.bwd_launches), counts))
    assert (f, b, sf, sb) == (2 * h, h, 0, 0)
    assert torch.isfinite(loss)
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["bouncer", "billiards48"])
def test_solver_kernel_on_circle_worlds_matches_plain_version_on_card(cuda_env, label):
    """The solve kernel at the circle worlds' split-path shapes (one lane a
    pair, no manifold partner; billiards48's 52 bodies and 1320 lanes):
    their overlap states at B=1024 through ``collide_batched``, cc and cb
    lanes active, planes within atol 1e-5 of the plain version."""
    from parallax_tpu_torch.envs.bouncer import Bouncer

    env, over = ((Bouncer(device="cuda"), (2.0, 0.25, 0.1)) if label == "bouncer" else
                 (Billiards(BilliardsConfig(n_object=47), device="cuda"), (1.0, 0.03, 0.02)))
    w, c = env.world, env.world.config
    s = overlap_state(env, 1024, 3, *over)
    con = tb.collide_batched(w, s)
    n_cc = w.table.groups[0].size
    assert con.active[:n_cc].any() and con.active[n_cc:].any()
    args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
    before = contact_solver.launches
    got = contact_solver.solve_contacts(w, s, con, *args)
    assert contact_solver.launches == before + 1
    want = contact_solver.solve_contacts_plain(w, s, con, *args)
    for f, x, y in zip(got._fields, got, want):
        err = (x - y).abs().max().item()
        assert err <= ATOL, (f, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["billiards8", "mixed"])
def test_fused_circle_box_lanes_match_plain_version_on_card(billiards_env, case):
    """The fused kernel's cc and cb lanes against its plain version on the
    same CUDA tensors: billiards' overlap state at B=1024, and a world that
    mixes cc, cb and pp groups (its lane offsets); flags equal, planes
    within atol 1e-5, and lanes of every group active."""
    if case == "billiards8":
        world = billiards_env.world
        s = overlap_state(billiards_env, 1024, 3, 1.0, 0.03, 0.02)
    else:
        world, state = mixed_world("cuda")
        s = mixed_state(world, state, 1024)
    before = fused_step.launches
    got_s, got_c = fused_step.physics_core_fused(world, s)
    assert fused_step.launches == before + 1
    want_s, want_c = fused_step.fused_step_plain(world, s)
    torch.cuda.synchronize()
    assert torch.equal(got_c.active, want_c.active)
    lane = 0
    for g in world.table.groups:
        width = g.size * (2 if g.kernel == "pp" else 1)
        assert want_c.active[lane:lane + width].any(), g.kernel
        lane += width
    for f, x, y in zip(got_s._fields, got_s, want_s):
        err = (x - y).abs().max().item()
        assert err <= ATOL, (f, err)


@pytest.mark.cuda
def test_reverse_kernels_at_a_clamp_tie_match_plain_vjps_on_card(cuda_env, fused_env):
    """The clamp-tie cases of ``tests/test_torch_clamp_ties.py`` through the
    solver's and the fused step's reverse-pass kernels against autograd of
    their plain versions on the card: rtol 2e-4, atol 1e-5 (the kernels
    split a tie's cotangent half and half, as torch.maximum and JAX do)."""
    s, con, cot = tie_solve_case(cuda_env, "cuda")
    args = (3, 2, 0.01, cuda_env.world.config.contact)
    got = contact_solver.solve_contacts_bwd(cuda_env.world, s, con, cot, *args)
    want = contact_solver.solve_contacts_bwd_plain(cuda_env.world, s, con, cot, *args)
    s, override, cot = tie_fused_case(fused_env, "cuda")
    fgot = fused_step.fused_step_bwd(fused_env.world, s, override, cot)
    fwant = fused_step.fused_step_bwd_plain(fused_env.world, s, override, cot)
    torch.cuda.synchronize()
    for x, y in zip((*got[0], *got[1:], *fgot[0], *fgot[1:]),
                    (*want[0], *want[1:], *fwant[0], *fwant[1:])):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
    assert got[0].vy.abs().max() > 0.1 and fgot[0].vy.abs().max() > 0.1


@pytest.mark.cuda
def test_fused_step_on_circle_lanes_refuses_autograd_on_card(billiards_env):
    """The reverse-pass kernel walks back every kind the forward runs: under
    autograd the fused step on billiards, and on a box resting on a box
    (bb), launches the forward kernel, and its backward the reverse-pass
    kernel, and no solver kernel.  What the kernels do not run raises
    before any launch, under autograd or not: a world with a kind no fused
    kernel has (a circle on a polygon, cp: ValueError naming the split
    step); it never falls back to the split step.  Billiards48 (52 parts,
    over the 16 the kernels once refused) runs on the fused kernel, its
    lane fields in scratch, held to the plain version (body planes within
    1e-5, flags identical)."""
    world = billiards_env.world
    s = overlap_state(billiards_env, 256, 3, 1.0, 0.03, 0.02)
    vx = s.vx.clone().requires_grad_(True)
    f0, b0, s0 = fused_step.launches, fused_step.bwd_launches, contact_solver.launches
    out, _ = fused_step.physics_core_fused(world, s._replace(vx=vx))
    (g,) = torch.autograd.grad(out.px.sum(), vx)
    assert (fused_step.launches, fused_step.bwd_launches) == (f0 + 1, b0 + 1)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    bb, sb = pair_world("bb", "cuda", broadphase=False, use_cuda_fused=True)
    py = sb.py.clone().requires_grad_(True)
    out, con = tb.physics_core(bb, sb._replace(py=py))
    (g,) = torch.autograd.grad(out.py.sum(), py)
    assert con.active.all() and torch.isfinite(g).all() and g.abs().max() > 0
    assert (fused_step.launches, fused_step.bwd_launches) == (f0 + 2, b0 + 2)
    cp, sc = pair_world("cp", "cuda")
    for grad in (True, False):
        with pytest.raises(ValueError, match="split step"):
            fused_step.physics_core_fused(cp, sc._replace(px=sc.px.clone().requires_grad_(grad)))
    assert (fused_step.launches, fused_step.bwd_launches) == (f0 + 2, b0 + 2)
    big = Billiards(BilliardsConfig(n_object=47, use_cuda_fused=True), device="cuda")
    sb = billiards_pairs_state(big, 128)
    got, gc = fused_step.physics_core_fused(big.world, sb)
    want, wc = fused_step.fused_step_plain(big.world, sb)
    torch.cuda.synchronize()
    assert torch.equal(gc.active, wc.active) and wc.active.any()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=ATOL)
    assert (fused_step.launches, fused_step.bwd_launches) == (f0 + 3, b0 + 2)
    assert contact_solver.launches == s0


@pytest.fixture(scope="module")
def robocup_env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return RoboCup(RoboCupConfig(use_cuda_fused=True), device="cuda")


@pytest.mark.cuda
def test_fused_area_lanes_match_plain_version_on_card(robocup_env):
    """The fused kernel's area_cb lanes, with RoboCup's cc and cb lanes,
    against its plain version on the same CUDA tensors: the overlap state
    at B=1024, flags equal, planes within atol 1e-5, every kind active."""
    world = robocup_env.world
    s = robocup_overlap_state(robocup_env, 1024)
    before = fused_step.launches
    got_s, got_c = fused_step.physics_core_fused(world, s)
    assert fused_step.launches == before + 1
    want_s, want_c = fused_step.fused_step_plain(world, s)
    torch.cuda.synchronize()
    assert torch.equal(got_c.active, want_c.active)
    on = active_kinds(world, want_c.active)
    assert min(on.values()) > 0 and set(on) == {"cc", "cb", "area_cb"}, on
    for f, x, y in zip(got_s._fields, got_s, want_s):
        err = (x - y).abs().max().item()
        assert err <= ATOL, (f, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["robocup", "billiards8", "mixed", "cb_tie", "area_tie"])
def test_fused_reverse_circle_lanes_match_plain_vjp_on_card(robocup_env, billiards_env, case):
    """The reverse-pass kernel's cc, cb and area_cb lanes against autograd
    of the plain version on the card, seeded cotangents: RoboCup's overlap
    state, billiards' pairs state (whose lanes sit near no kink that
    float32 rounding may cross, unlike its pile), the world that mixes cc,
    cb and pp groups (its lane offsets), at B=1024, and the clamp and floor
    tie cases at B=1.  rtol 2e-4, atol 1e-5."""
    B = 1024
    if case == "robocup":
        world, s = robocup_env.world, robocup_overlap_state(robocup_env, B)
    elif case == "billiards8":
        world, s = billiards_env.world, billiards_pairs_state(billiards_env, B)
    elif case == "mixed":
        world, state = mixed_world("cuda")
        s = mixed_state(world, state, B)
    elif case == "cb_tie":
        world = billiards_env.world
        s, cot = cb_tie_case(billiards_env, "cuda")
    else:
        world = robocup_env.world
        s, cot = area_tie_case(robocup_env, "cuda")
    if not case.endswith("tie"):
        cot = tb._SoA(*(torch.randn(x.shape, generator=torch.Generator().manual_seed(k)).cuda()
                        for k, x in enumerate(s)))
    before = fused_step.bwd_launches
    got = fused_step.fused_step_bwd(world, s, None, cot)
    assert fused_step.bwd_launches == before + 1
    want = fused_step.fused_step_bwd_plain(world, s, None, cot)
    torch.cuda.synchronize()
    for f, x, y in zip(s._fields, got[0], want[0]):
        assert torch.isfinite(x).all(), f
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL, msg=f)
    assert all(x.abs().max() > 0 for x in got[0][:4])


@pytest.mark.cuda
def test_robocup_train_on_card_matches_cpu(robocup_env):
    """RoboCup's loss and policy gradients (B=64, h=8, from the overlap
    state) on the card, split and fused, against the CPU: loss 1e-5 and
    each gradient 1e-4 relative in norm.  The fused path launches the
    fused kernels only."""
    B, H = 64, 8
    rng = np.random.default_rng(0)
    arrays = {"w1": rng.standard_normal((28, 32)) * 0.3, "b1": np.zeros(32),
              "w2": rng.standard_normal((32, 18)) * 0.1, "b2": np.zeros(18)}

    def policy(p, obs):
        return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])

    res = {}
    for label, fused, dev in (("cpu", False, "cpu"), ("split", False, "cuda"),
                              ("fused", True, "cuda")):
        env = RoboCup(RoboCupConfig(use_cuda_fused=fused), device=dev)
        k = np.random.default_rng(1).integers(0, 2**32, (B, 2), dtype=np.uint32)
        st = env.reset_fn_batch(torch.from_numpy(k.astype(np.int64)).to(dev))
        st = st._replace(bodies=tb._from_soa(robocup_overlap_state(env, B)))
        p = {n: torch.tensor(a, dtype=torch.float32, device=dev).requires_grad_(True)
             for n, a in arrays.items()}
        counts = (contact_solver.launches, fused_step.launches, fused_step.bwd_launches)
        loss, _ = rollout.make_loss_fn(env, policy, H, checkpoint_segments=2)(p, st)
        grads = [g.cpu() for g in torch.autograd.grad(loss, list(p.values()))]
        counts = tuple(a - b for a, b in zip(
            (contact_solver.launches, fused_step.launches, fused_step.bwd_launches), counts))
        res[label] = (loss.item(), grads, counts)
    loss_c, grads_c, _ = res["cpu"]
    assert res["split"][2][1:] == (0, 0) and res["fused"][2] == (0, 2 * H, H)
    for label in ("split", "fused"):
        loss_g, grads_g, _ = res[label]
        assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), label
        for a, b in zip(grads_g, grads_c):
            assert (a - b).norm() <= 1e-4 * b.norm(), label


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")


@pytest.fixture(scope="module")
def crates(card):
    return crate_world("cuda", fused=True)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["overlap", "tie"])
def test_fused_bb_lanes_match_plain_versions_on_card(crates, case):
    """The fused kernel's bb lane (with the pile's cc and cb lanes) and its
    adjoint against the plain versions on the same CUDA tensors: the crate
    pile's overlap state at B=1024, and the bb lane's exact ties at B=1.
    Forward: flags equal, planes within atol 1e-5; reverse pass: rtol
    2e-4, atol 1e-5."""
    if case == "overlap":
        s, cot = crate_overlap_state(crates, 1024), cotangents(crates.n_bodies, 1024, 5, "cuda")
    else:
        s, cot = bb_tie_case(crates, "cuda")
    f0, b0 = fused_step.launches, fused_step.bwd_launches
    got_s, got_c = fused_step.physics_core_fused(crates, s)
    got = fused_step.fused_step_bwd(crates, s, None, cot)[0]
    assert (fused_step.launches, fused_step.bwd_launches) == (f0 + 1, b0 + 1)
    want_s, want_c = fused_step.fused_step_plain(crates, s)
    want = fused_step.fused_step_bwd_plain(crates, s, None, cot)[0]
    torch.cuda.synchronize()
    assert torch.equal(got_c.active, want_c.active)
    on = active_kinds(crates, want_c.active)
    assert on["bb"] > 0 and (case == "tie" or min(on.values()) > 0), on
    for f, x, y in zip(got_s._fields, got_s, want_s):
        assert (x - y).abs().max().item() <= ATOL, f
    for f, x, y in zip(s._fields, got, want):
        assert torch.isfinite(x).all(), f
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL, msg=f)
    assert all(x.abs().max() > 0 for x in got[:4])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["split", "fused"])
def test_step_batched_on_card_launches_its_kernels(card, path):
    """``step_batched`` on the crate pile on the card: 100 steps launch the
    solver kernel 100 times on the split step and the fused kernel 100
    times (and no solver) on the fused step; the gradient of the crates'
    mean height through 10 of them wrt a kick shared by the fleet
    (``crate_kick_loss``), in 2 checkpointed segments, runs 10 reverse
    passes of that path's kernel and matches the CPU's within 1e-4
    relative in norm.  The mixed and area worlds run on the split step
    there too."""
    fused = path == "fused"
    world, _ = crate_world("cuda", fused=fused)
    state = tb._from_soa(crate_overlap_state(world, 256))
    c0 = (contact_solver.launches, fused_step.launches)
    with torch.no_grad():
        for _ in range(100):
            state, con = tb.step_batched(world, state)
    torch.cuda.synchronize()
    counts = (contact_solver.launches - c0[0], fused_step.launches - c0[1])
    assert counts == ((0, 100) if fused else (100, 0))
    assert torch.isfinite(state.pos).all() and con.active.shape == (88, 256)
    grads = {}
    for dev in ("cpu", "cuda"):
        w, _ = crate_world(dev, fused=fused)
        u = torch.zeros(2, device=dev, requires_grad=True)
        b0 = (contact_solver.bwd_launches, fused_step.bwd_launches)
        loss, _ = crate_kick_loss(w, crate_overlap_state(w, 64), u, 10, 2)
        (grads[dev],) = torch.autograd.grad(loss, u)
        if dev == "cuda":
            bwd = (contact_solver.bwd_launches - b0[0], fused_step.bwd_launches - b0[1])
            assert bwd == ((0, 10) if fused else (10, 0))
    g, c = grads["cuda"].cpu(), grads["cpu"]
    assert (g - c).norm() <= 1e-4 * c.norm() and c.norm() > 0
    if not fused:
        for name in KIND_WORLDS:
            w, st0 = kinds_world(name, "cuda", use_cuda_solver=True)
            n0 = contact_solver.launches
            out, _ = tb.step_batched(w, tb._from_soa(kinds_state(name, w, st0, 64)))
            assert contact_solver.launches == n0 + 1 and torch.isfinite(out.pos).all()


def _reverse(kernel, world, s, cot):
    """One launch of a reverse-pass kernel on the crate pile's planes: the
    solver's on the lanes of the integrated state, or the fused step's.
    Returns every cotangent plane."""
    if kernel == "fused":
        ds, dtx, dty = fused_step.fused_step_bwd(world, s, None, cot)
        return (*ds, dtx, dty)
    c = world.config
    si, _ = tb.integrate_bm(world, s)
    con = tb.collide_batched(world, si)
    ds, *dcon = contact_solver.solve_contacts_bwd(
        world, si, con, cot, c.solver_iterations, c.position_iterations, c.dt, c.contact)
    return (*ds, *dcon)


def _reverse_plain(kernel, world, s, cot):
    if kernel == "fused":
        ds, dtx, dty = fused_step.fused_step_bwd_plain(world, s, None, cot)
        return (*ds, dtx, dty)
    c = world.config
    si, _ = tb.integrate_bm(world, s)
    con = tb.collide_batched(world, si)
    ds, *dcon = contact_solver.solve_contacts_bwd_plain(
        world, si, con, cot, c.solver_iterations, c.position_iterations, c.dt, c.contact)
    return (*ds, *dcon)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["solve", "fused"])
def test_reverse_kernels_are_deterministic_on_card(crates, kernel, monkeypatch):
    """Both reverse-pass kernels, one warp per world with no float atomics,
    on the crate pile at B=1024: two launches on the same inputs agree to
    the bit, and so do launches with 1, 3 and 8 worlds a block (each world
    sums its bodies' terms in lane order, whatever shares its block)."""
    s, cot = crate_overlap_state(crates, 1024), cotangents(crates.n_bodies, 1024, 5, "cuda")
    first = _reverse(kernel, crates, s, cot)
    again = _reverse(kernel, crates, s, cot)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for w in (1, 3, 8):
        monkeypatch.setattr(contact_solver, "WORLDS_PER_BLOCK", w)
        got = _reverse(kernel, crates, s, cot)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, got)), w
    assert all(torch.isfinite(x).all() for x in first)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["solve", "fused"])
def test_reverse_kernels_hold_a_ragged_batch_on_card(crates, kernel):
    """B=1021 worlds, which no plan of 2, 4 or 8 worlds a block divides: the
    last block's idle warps write nothing, and every world's cotangents hold
    the plain VJP's at rtol 2e-4, atol 1e-5."""
    s, cot = crate_overlap_state(crates, 1021), cotangents(crates.n_bodies, 1021, 5, "cuda")
    got = _reverse(kernel, crates, s, cot)
    want = _reverse_plain(kernel, crates, s, cot)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


def _forward(kernel, world, s, plain=False):
    """One launch of a forward kernel (or its plain version) on the crate
    pile's planes: the solver's on the lanes of the integrated state, or
    the fused step's.  Returns the six body planes and, fused, the flags."""
    if kernel == "fused":
        step = fused_step.fused_step_plain if plain else fused_step.physics_core_fused
        out, con = step(world, s)
        return (*out, con.active)
    c = world.config
    si, _ = tb.integrate_bm(world, s)
    con = tb.collide_batched(world, si)
    solve = contact_solver.solve_contacts_plain if plain else contact_solver.solve_contacts
    return tuple(solve(world, si, con, c.solver_iterations, c.position_iterations, c.dt,
                       c.contact))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["solve", "fused"])
def test_forward_kernels_are_deterministic_on_card(crates, kernel, monkeypatch):
    """Both forward kernels, one warp per world with no float atomics, on
    the crate pile at B=1024: two launches agree to the bit, and so do
    launches with 1, 3 and 8 worlds a block and, for the solve, with the
    lane fields in scratch in place of shared memory."""
    s = crate_overlap_state(crates, 1024)
    first, again = _forward(kernel, crates, s), _forward(kernel, crates, s)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for w in (1, 3, 8):
        monkeypatch.setattr(contact_solver, "WORLDS_PER_BLOCK", w)
        got = _forward(kernel, crates, s)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, got)), w
    monkeypatch.setattr(contact_solver, "FIELDS_MIN_WORLDS", 10**6)
    got = _forward(kernel, crates, s)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["solve", "fused"])
def test_forward_kernels_hold_a_ragged_batch_on_card(crates, kernel):
    """B=1021 worlds: every world's body planes hold the plain version's
    within 1e-5 and the fused step's flags are identical."""
    s = crate_overlap_state(crates, 1021)
    got, want = _forward(kernel, crates, s), _forward(kernel, crates, s, plain=True)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        if x.dtype == torch.bool:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_solver_reverse_pass_on_billiards48_on_card(card):
    """The solver reverse pass on billiards48 (52 bodies, more than a warp's
    32 threads, so body work takes two rounds; C=1320 lanes): at B=64 on
    ``billiards_pairs_state`` (24 touching pairs, no lane near a kink) its
    cotangents hold the plain VJP's at rtol 2e-4, atol 1e-5."""
    env = Billiards(BilliardsConfig(n_object=47), device="cuda")
    w, c = env.world, env.world.config
    s = billiards_pairs_state(env, 64)
    con = tb.collide_batched(w, s)
    assert int(con.active.sum()) == 24 * 64
    cot = cotangents(w.n_bodies, 64, 5, "cuda")
    args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
    b0 = contact_solver.bwd_launches
    got = contact_solver.solve_contacts_bwd(w, s, con, cot, *args)
    want = contact_solver.solve_contacts_bwd_plain(w, s, con, cot, *args)
    torch.cuda.synchronize()
    assert contact_solver.bwd_launches == b0 + 1
    for x, y in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
    assert all(x.abs().max() > 0 for x in got[0][:4])


@pytest.mark.cuda
def test_reverse_pass_plan_refuses_a_world_over_the_shared_memory_limit_on_card(card):
    """The kernels' launch plan: every world of the repo fits a block
    (billiards48's 52 bodies and 1320 lanes included: its solve and its
    fused forward keep the lane fields in scratch, 5 and 3 worlds a block,
    and its fused reverse pass takes 2 worlds a block; the crate pile's
    forwards keep theirs in shared memory, 8 worlds a block), and a world
    whose shared memory alone exceeds the H100's 227 KB a block (20,000
    lanes) raises ValueError naming the limit, never a launch."""
    from parallax_tpu_torch.ops import _build

    lib = _build.load()
    assert contact_solver.solve_plan(lib, 1320, 52) == (0, 5)
    assert contact_solver.solve_plan(lib, 88, 14) == (1, 8)
    fwd = contact_solver.fields_plan
    assert fwd(lambda f: lib.fused_step_fwd_smem_bytes(1320, 52, 52, f), "fused_step_fwd") == (0, 3)
    assert fwd(lambda f: lib.fused_step_fwd_smem_bytes(88, 14, 14, f), "fused_step_fwd") == (1, 8)
    assert contact_solver.worlds_per_block(
        lib.fused_step_bwd_smem_bytes(1320, 52, 52, 1320, 2), "fused_step_bwd") == 2
    assert contact_solver.worlds_per_block(
        lib.contact_solver_bwd_smem_bytes(1320, 52), "contact_solve_bwd") >= 1
    assert contact_solver.worlds_per_block(
        lib.fused_step_bwd_smem_bytes(88, 14, 14, 88, 2), "fused_step_bwd") >= 4
    with pytest.raises(ValueError, match="227 KB"):
        contact_solver.worlds_per_block(
            lib.contact_solver_bwd_smem_bytes(20000, 64), "contact_solve_bwd")
    with pytest.raises(ValueError, match="contact_solve_fwd"):
        contact_solver.solve_plan(lib, 20000, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["solve", "solve_bwd", "fused", "fused_bwd"])
def test_candidate_world_kernels_match_plain_versions_on_card(kernel):
    """The four kernels on the lander's terrain-candidate world
    (``LanderConfig(terrain_candidates=True)``: 28 lanes, 14 parts, 11 of
    them gathered windows of the terrain) at B=1024, on the contact
    scenario with the terrain tilted by 0.05: the forwards within 1e-5
    (the fused step's flags identical), the reverse passes within rtol
    2e-4, atol 1e-5 of the plain VJPs, each launched once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    fused = kernel.startswith("fused")
    env = LunarLander(LanderConfig(terrain_candidates=True, broadphase=not fused,
                                   use_cuda_fused=fused), device="cuda")
    w, c = env._bm_world, env.config
    assert w.table.n_contacts == 28
    s, override = candidate_contact_case(env, 1024, "cuda", slope=0.05)
    assert len(override) == 11
    cot = cotangents(w.n_bodies, 1024, 5, "cuda")
    args = (c.solver_iterations, c.position_iterations, c.dt, w.config.contact)
    con = tb.collide_batched(w, s, override)
    assert int(con.active.sum()) > 100
    calls = {
        "solve": (lambda: contact_solver.solve_contacts(w, s, con, *args),
                  lambda: contact_solver.solve_contacts_plain(w, s, con, *args)),
        "solve_bwd": (lambda: contact_solver.solve_contacts_bwd(w, s, con, cot, *args),
                      lambda: contact_solver.solve_contacts_bwd_plain(w, s, con, cot, *args)),
        "fused": (lambda: fused_step.physics_core_fused(w, s, override),
                  lambda: fused_step.fused_step_plain(w, s, override)),
        "fused_bwd": (lambda: fused_step.fused_step_bwd(w, s, override, cot),
                      lambda: fused_step.fused_step_bwd_plain(w, s, override, cot)),
    }
    before = (contact_solver.launches, contact_solver.bwd_launches,
              fused_step.launches, fused_step.bwd_launches)
    got, want = (f() for f in calls[kernel])
    torch.cuda.synchronize()
    after = (contact_solver.launches, contact_solver.bwd_launches,
             fused_step.launches, fused_step.bwd_launches)
    which = ["solve", "solve_bwd", "fused", "fused_bwd"].index(kernel)
    assert [a - b for a, b in zip(after, before)] == [int(i == which) for i in range(4)]
    if kernel == "fused":
        assert torch.equal(got[1].active, want[1].active)
        got, want = got[0], want[0]
    if kernel.endswith("bwd"):
        got, want = (*got[0], *got[1:]), (*want[0], *want[1:])
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=RTOL if kernel.endswith("bwd") else 0, atol=ATOL)


def _edge_keys(B, seed):
    """``_keys`` with the edge words first: 0 and 0xFFFFFFFF, in both words
    and in one."""
    k = _keys(B, seed)
    k[:4] = torch.tensor([[0, 0], [2**32 - 1, 2**32 - 1], [0, 2**32 - 1], [2**32 - 1, 0]])
    return k


_TINY = float(np.finfo(np.float32).tiny)


@pytest.mark.cuda
def test_threefry_kernels_match_torch_bodies_on_card(card):
    """``prng.split``, ``fold_in``, ``random_bits`` and ``uniform`` on CUDA keys
    launch ``csrc/threefry.cu``, one launch a call, and give the bits of
    their torch bodies run on the card, and of the CPU path copied back, at
    B=32,768 (billiards48's jitter, ``uniform(keys, (47, 2))``, included),
    on contiguous keys and on a split's ``[:, 0]`` slice (row stride 4)."""
    def one_launch(counter, draw, *args):
        n0 = getattr(threefry, counter)
        out = draw(*args)
        assert getattr(threefry, counter) == n0 + 1, (draw.__name__, args[1:])
        return out

    keys = _edge_keys(32768, 20)
    bounds = ((-5.0, 5.0), (-0.002, 0.002), (0.0, 2 * math.pi), (_TINY, 1.0))
    for k in (keys, prng.split_plain(keys)[:, 0]):
        assert k.is_cuda and k.stride() == ((2, 1) if k is keys else (4, 1))
        kc = k.cpu()
        for num in (2, 5):
            got = one_launch("split_launches", prng.split, k, num)
            assert torch.equal(got, prng.split_plain(k, num))
            assert torch.equal(got.cpu(), prng.split(kc, num))
        got = one_launch("split_launches", prng.fold_in, k, 0x501E)
        assert torch.equal(got, prng.fold_in_plain(k, 0x501E))
        assert torch.equal(got.cpu(), prng.fold_in(kc, 0x501E))
        for shape in ((), (8,), (47, 2)):
            got = one_launch("uniform_launches", prng.random_bits, k, shape)
            assert torch.equal(got, prng.random_bits_plain(k, shape))
            for lo, hi in bounds:
                got = one_launch("uniform_launches", prng.uniform, k, shape, lo, hi)
                assert got.dtype == torch.float32 and got.shape == (32768, *shape)
                assert torch.equal(got, prng.uniform_plain(k, shape, lo, hi)), (shape, lo)
                assert torch.equal(got.cpu(), prng.uniform(kc, shape, lo, hi)), (shape, lo)


@pytest.mark.cuda
@pytest.mark.parametrize("split_first", [False, True])
def test_lander_terrain_kernel_matches_torch_body_on_card(card, split_first):
    """The terrain kernel (``csrc/lander_terrain.cu``) against
    ``terrain_planes_plain`` run on the card,
    over 2**20 keys, so that a centre summed in another order than torch's
    or a sorting-network tie broken otherwise would show; its first 4,096
    worlds against the CPU path too."""
    keys = _edge_keys(2**20, 21)
    n0 = threefry.terrain_launches
    got = terrain_planes_batch(keys, split_first)
    assert threefry.terrain_launches == n0 + 1
    want = terrain_planes_plain(keys, split_first)
    cpu = terrain_planes_batch(keys[:4096].cpu(), split_first)
    for g, w, c in zip(got, want, cpu):
        assert g.shape == (7, MAX_VERTS, 2**20) and g.is_contiguous()
        assert torch.equal(g, w)
        assert torch.equal(g[..., :4096].cpu(), c)


@pytest.mark.cuda
def test_plane_steps_launch_one_draw_on_card(fused_env):
    """One fleet step's auto-reset draw: the fused lander's launches the split
    kernel once (the plane loop's key split) and the terrain kernel once
    (``plane_fresh``'s split and sampler), billiards48's the split kernel
    twice (the plane loop's, ``plane_fresh``'s) and the uniform kernel once
    (the rack jitter)."""
    def launches():
        return (threefry.split_launches, threefry.uniform_launches, threefry.terrain_launches)

    billiards = Billiards(BilliardsConfig(n_object=47), device="cuda")
    for env, want in ((fused_env, (1, 0, 1)), (billiards, (2, 1, 0))):
        st = env.reset_fn_batch(_keys(256, 22))
        before = launches()
        env.step_batch(st, torch.zeros((256, env.action_size), device="cuda"))
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(launches(), before)) == want, type(env).__name__


@pytest.mark.cuda
def test_threefry_refuses_bad_keys_on_card(card):
    """A CUDA key tensor the kernels do not take raises, with no launch and
    no torch fallback: int32 words, a key's words apart, leading axes that
    are not rows of one stride, a last axis of 3, and terrain keys that
    are not ``[B, 2]``."""
    keys = _keys(64, 23)
    before = (threefry.split_launches, threefry.uniform_launches, threefry.terrain_launches)
    with pytest.raises(ValueError, match="int64"):
        prng.split(keys.int())
    with pytest.raises(ValueError, match="adjacent"):
        prng.uniform(keys.T.contiguous().T, (8,))
    with pytest.raises(ValueError, match="one stride"):
        prng.random_bits(_keys(48, 23).reshape(4, 12, 2)[:, :6], (3,))
    with pytest.raises(ValueError, match="int64"):
        prng.fold_in(torch.zeros((64, 3), dtype=torch.int64, device="cuda"), 7)
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        terrain_planes_batch(keys.reshape(8, 8, 2))
    assert (threefry.split_launches, threefry.uniform_launches,
            threefry.terrain_launches) == before


# -- the rollout's step replayed from CUDA graphs (envs/plane_env.py) --------

_GRAPH_ENVS = {
    "lander": lambda: LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True),
                                  device="cuda"),
    "robocup": lambda: RoboCup(RoboCupConfig(n_robots_per_team=6, use_cuda_fused=True),
                               device="cuda"),
    "billiards48": lambda: Billiards(BilliardsConfig(n_object=47), device="cuda"),
}


def _mlp_params(env, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"w1": torch.randn((env.observation_size, 32), generator=g, device="cuda") * 0.3,
            "w2": torch.randn((32, env.action_size), generator=g, device="cuda") * 0.1}


def _mlp(p, obs):
    return torch.tanh(torch.tanh(obs @ p["w1"]) @ p["w2"])


def _fragments(env, states, params, graphed, n=3, steps=32):
    """``n`` fragments of ``steps`` steps, each from the last one's final
    states: under ``no_grad`` (the graphs) or under autograd with nothing
    requiring grad (the eager step).  The policy's second layer is negated
    in place before the last fragment.  Returns each fragment's ``(final,
    traj)`` and a copy of each taken as it returned."""
    p = {k: v.clone() for k, v in params.items()}
    out, kept = [], []
    for i in range(n):
        if i == n - 1:
            p["w2"].neg_()
        with torch.set_grad_enabled(not graphed):
            states, traj = env.rollout_batch(states, _mlp, steps, p)
        out.append((states, traj))
        kept.append(tree_map(torch.clone, (states, traj)))
    return out, kept


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_GRAPH_ENVS))
def test_graphed_rollout_equals_the_eager_one_on_card(card, name):
    """Three 32-step fragments at B=4,096 on the fused lander, RoboCup
    Division B (fused) and billiards48 (split): replayed from CUDA graphs
    (the first step eager, the second captured, 95 replayed) they equal the
    eager step's fragments to the bit, the policy's weights changed in
    place between fragments included; and every fragment's returned states
    and trajectory still hold their values after the later fragments ran,
    so none of them lives in the graphs' memory."""
    env = _GRAPH_ENVS[name]()
    states = env.reset_fn_batch(_keys(4096, 31))
    params = _mlp_params(env, 32)
    g0, e0 = plane_env.graph_steps, plane_env.eager_steps
    graphed, kept = _fragments(env, states, params, graphed=True)
    assert (plane_env.graph_steps - g0, plane_env.eager_steps - e0) == (95, 1)
    eager, _ = _fragments(env, states, params, graphed=False)
    assert (plane_env.graph_steps - g0, plane_env.eager_steps - e0) == (95, 97)
    torch.cuda.synchronize()
    for got, want, copy in zip(graphed, eager, kept):
        for x, y, z in zip(tree_leaves(got), tree_leaves(want), tree_leaves(copy)):
            assert torch.equal(x, y) and torch.equal(x, z)


_GRAPH_KERNELS = ("fused_step_kernel", "contact_solve_kernel", "threefry_split_kernel",
                  "lander_terrain_kernel")


def _device_kernels(fn):
    """``fn()`` under ``torch.profiler``: how many device kernels of each of
    ``_GRAPH_KERNELS`` ran, a graph's replays included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return tuple(sum(k in n for n in names) for k in _GRAPH_KERNELS)


@pytest.mark.cuda
def test_graphs_per_wave_shape_and_launch_counts_on_card(card):
    """A new batch gets graphs of its own, and so does a chunked rollout's
    short last wave; the env keeps only the shapes of its last call, and a
    train step keeps none and replays none.  The kernels' launch counters
    count the host's calls (a shape's warm-up step and its capture); ten
    replayed steps run ten of each kernel on the device, by the profiler."""
    env = _GRAPH_ENVS["lander"]()
    params = _mlp_params(env, 33)

    def host():
        return (fused_step.launches, contact_solver.launches, threefry.split_launches,
                threefry.terrain_launches, plane_env.graph_steps, plane_env.eager_steps)

    # (batch, max_chunk, profiled, wave shapes kept, what ten steps count: on
    # the host, and on the device where profiled)
    cases = ((256, None, False, 1, (2, 0, 2, 2, 9, 1), None),
             (256, None, True, 1, (0, 0, 0, 0, 10, 0), (10, 0, 10, 10)),
             (640, 512, False, 2, (4, 0, 4, 4, 18, 2), None),
             (512, None, True, 1, (0, 0, 0, 0, 10, 0), (10, 0, 10, 10)))
    with torch.no_grad():
        for B, chunk, profiled, shapes, want, want_device in cases:
            st = env.reset_fn_batch(_keys(B, 34))
            torch.cuda.synchronize()
            before, got = host(), {}

            def run():
                got["traj"] = env.rollout_batch(st, _mlp, 10, params, max_chunk=chunk)[1]

            device = _device_kernels(run) if profiled else run()
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(host(), before)) == want, B
            assert device == want_device, B
            assert len(env._step_graphs) == shapes and got["traj"].obs.shape[:2] == (10, B)

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss_fn = rollout.make_loss_fn(env, _mlp, 4, checkpoint_segments=2)
    g0 = plane_env.graph_steps
    loss, _ = loss_fn(p, env.reset_fn_batch(_keys(256, 35)))
    torch.autograd.grad(loss, list(p.values()))
    assert plane_env.graph_steps == g0 and not env._step_graphs


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises_on_card(card):
    """A hook that reads a value back to the host runs in the eager warm-up
    step and cannot run inside a capture: the rollout raises, naming the
    step and the span, and does not fall back to the eager step."""
    env = _GRAPH_ENVS["lander"]()
    post = env.plane_post

    def reading_post(*args):
        out = post(*args)
        float(out[2].sum())  # a host read of the reward
        return out

    env.plane_post = reading_post
    e0 = plane_env.eager_steps
    with torch.no_grad(), pytest.raises(RuntimeError, match=r"rollout step.*inside px\.post"):
        env.rollout_batch(env.reset_fn_batch(_keys(256, 36)), _mlp, 3, _mlp_params(env, 37))
    assert plane_env.eager_steps == e0 + 1
    torch.cuda.synchronize()
