"""RoboCup SSL Division B (six robots a team) on the port's plane-space
path, held against the benchmark's plain reference
(``portbench/reference/robocup.py``, plain torch written from the JAX
package's semantics; it imports nothing of the port) on the CPU, at B=64
on seeded keys and a seeded tanh policy.

* the reset states: equal to the bit (the same threefry draw, and torch's
  CPU cosine and sine on both sides);
* one 32-step fragment from a scene built so that every lane kind is
  active at its first step in every world (two robots touching: cc; the
  ball against a goal's side wall: cb; a robot past the field's edge:
  area_cb), on the split path and on the fused step's plain version: the
  first step's active lanes equal; obs and reward within 1e-5 of max(1,
  |reference|), since the reference sums a body's lane impulses in its own
  order and rounding may differ in the last bits, which 32 steps grow by
  far less than 1e-5; terminated and truncated equal, since no world of
  the scene comes near a goal or the step limit;
* a reference whose containment lane ignores the circle's radius, or
  whose ball is not damped, fails that same comparison.
"""

import pytest
import torch

from parallax_tpu_torch.engine.batched import physics_core
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from portbench.reference import physics, plain
from portbench.reference import robocup as ref_robocup

torch.set_num_threads(2)

B, STEPS, TOL = 64, 32, 1e-5
POLICY = {"hidden": 32, "w1_scale": 0.3, "w2_scale": 0.1}


def _keys(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**32, (B, 2), generator=g, dtype=torch.int64)


def _params(env, seed=2**31 + 5):
    g = torch.Generator().manual_seed(seed)
    h = POLICY["hidden"]
    return {"w1": torch.randn((env.observation_size, h), generator=g) * POLICY["w1_scale"],
            "b1": torch.zeros(h),
            "w2": torch.randn((h, env.action_size), generator=g) * POLICY["w2_scale"],
            "b2": torch.zeros(env.action_size)}


def _scene(env, seed=2**31 + 77):
    """Reset states with, in every world (each jittered by up to 0.01): blue
    robots 1 and 2 overlapping by 0.03, the ball 0.05 above the yellow
    goal's top wall and falling onto it, and blue robot 3 poking 0.04 past
    the field's top edge."""
    st = env.reset_fn_batch(_keys(seed))
    g = torch.Generator().manual_seed(seed)
    jit = (torch.rand((B, 4, 2), generator=g) - 0.5) * 0.02
    pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
    b, r1, r2, r3 = env.ball_idx, *env.robot_idx[1:4].tolist()
    pos[:, r1] = torch.tensor([0.5, 0.0]) + jit[:, 0]
    pos[:, r2] = pos[:, r1] + torch.tensor([0.15, 0.0])
    pos[:, b] = torch.tensor([-4.6, 0.55]) + jit[:, 1] * torch.tensor([1.0, 0.0])
    vel[:, b] = torch.tensor([0.0, -0.5]) + jit[:, 2]
    pos[:, r3] = torch.tensor([2.0, 3.7 - 0.05]) + jit[:, 3] * torch.tensor([1.0, 0.0])
    return st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))


def _program_fragment(env, start, params):
    with torch.no_grad():
        return env.rollout_batch(start, plain.mlp, STEPS, params)[1]


def _gap(traj, r_traj):
    """The widest gap of obs and reward over max(1, |reference|), or inf
    where a flag differs."""
    if not (torch.equal(traj.terminated, r_traj.terminated)
            and torch.equal(traj.truncated, r_traj.truncated)):
        return float("inf")
    gaps = [((a - b).abs() / b.abs().clamp_min(1.0)).max()
            for a, b in ((traj.obs, r_traj.obs), (traj.reward, r_traj.reward))]
    return float(max(gaps))


@pytest.fixture(scope="module")
def case():
    env = RoboCup(RoboCupConfig(n_robots_per_team=6, use_cuda_fused=True), device="cpu")
    ref = plain.reference_env({"reference": "robocup:RoboCup",
                               "config": {"n_robots_per_team": 6, "use_cuda_fused": True}}, "cpu")
    start = _scene(env)
    params = _params(env)
    return env, ref, start, params, _program_fragment(env, start, params)


def test_reset_states_equal_the_reference_to_the_bit(case):
    env, ref, *_ = case
    keys = _keys(2**31 + 3)
    prog, mine = ref.program_fields(env.reset_fn_batch(keys)), ref.fields(ref.reset(keys))
    assert prog.keys() == mine.keys()
    for k in mine:
        assert torch.equal(prog[k].to(mine[k].dtype), mine[k]), k


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_fragment_with_every_lane_kind_active_follows_the_reference(case, fused):
    env, ref, start, params, traj = case
    if not fused:
        env = RoboCup(RoboCupConfig(n_robots_per_team=6), device="cpu")
        traj = _program_fragment(env, start, params)
    r_start = ref.from_program(start)
    actions = plain.mlp(params, ref.obs(r_start))
    lanes = ref.collide(physics.integrate(ref.world, ref.track(r_start.s, actions)))
    ps = env._to_planes(start)
    _, con = physics_core(env.world, env.plane_pre(ps.s, ps.aux, actions))
    assert torch.equal(con.active.T, lanes.active)
    ends = torch.tensor([len(ref.kinds[k]) for k in ("cc", "cb", "area_cb")]).cumsum(0).tolist()
    for kind, lo, hi in zip(("cc", "cb", "area_cb"), [0] + ends[:-1], ends):
        assert bool(lanes.active[:, lo:hi].any(1).all()), kind
    _, r_traj = plain.rollout(ref, r_start, params, STEPS)
    assert _gap(traj, r_traj) <= TOL


_AREA_CB = ref_robocup.area_cb


def _area_cb_without_radius(cx, cy, r, lx, ly, ux, uy):
    return _AREA_CB(cx, cy, 0.0 * r, lx, ly, ux, uy)


@pytest.mark.parametrize("fault", ["containment", "damping"])
def test_an_altered_reference_fails_the_comparison(case, fault, monkeypatch):
    env, ref, start, params, traj = case
    if fault == "containment":
        monkeypatch.setattr(ref_robocup, "area_cb", _area_cb_without_radius)
    else:
        monkeypatch.setattr(ref, "ball_damping", 1.0)
    _, r_traj = plain.rollout(ref, ref.from_program(start), params, STEPS)
    assert _gap(traj, r_traj) > 100 * TOL
