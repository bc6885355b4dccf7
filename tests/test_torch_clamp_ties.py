"""Gradients at an exact clamp tie: the port against ``jax.vjp`` on the CPU.

JAX writes its clamps against a constant as ``jnp.maximum``,
``jnp.minimum`` and ``jnp.clip``, whose gradient at a tie splits half and
half; ``torch.clamp`` would pass all of it.  The port writes them as
``torch.maximum``/``torch.minimum`` against a constant
(``engine.batched._max_c``/``_min_c``), and its reverse-pass kernels follow
the same rule.  A body at rest on a contact under the Baumgarte slop ties
the solve's ``max(jn + rhs * inv_kn, 0)`` exactly, and a saturated tanh
policy ties the lander's action clip.  The scenarios come from
``tests/torch_scenarios.py`` (numpy-seeded).  Tolerance: rtol 2e-4, atol
1e-5, the bar the JAX package sets between its Pallas backward and its XLA
VJP; with ``torch.clamp``'s rule the solve case's hull vy cotangent was off
by 0.55 and the fused case's by 0.26.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import tie_fused_case, tie_solve_case

from parallax_tpu.engine import batched as jb
from parallax_tpu.envs.lunar_lander import LanderConfig as JaxLanderConfig
from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.ops import contact_solver, fused_step

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 2e-4
PLANES = ("pen_x", "pen_y", "pt_x", "pt_y")


def _jax_soa(s):
    return jb._SoA(*(jnp.asarray(x.numpy()) for x in s))


def _close(got, want, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=name)


def _clamp_rule(monkeypatch):
    """The port's constant clamps back on ``torch.clamp``'s rule (the whole
    cotangent at a tie): what the port did before, kept to show that a
    case exercises the tie."""
    monkeypatch.setattr(tb, "_max_c", lambda x, c: torch.clamp(x, min=c))


def test_solver_vjp_at_a_tie_matches_jax(monkeypatch):
    """The VJP of the plain solve (3 + 2 iterations, dt 0.01) on the
    single-lane tie case against ``jax.vjp`` of the JAX solve."""
    env = LunarLander(device="cpu")
    jworld = JaxLander().world
    s, con, cot = tie_solve_case(env)
    cfg = env.world.config.contact
    ds, *dcon = contact_solver.solve_contacts_bwd_plain(
        env.world, s, con, cot, 3, 2, 0.01, cfg)
    con_j = jb.ContactsBM(*(jnp.asarray(x.numpy()) for x in con))

    def solve(ss, planes):
        out = jb.solve_contacts_bm(jworld, ss, con_j._replace(**dict(zip(PLANES, planes))),
                                   3, 2, 0.01, jworld.config.contact)
        return jb.apply_joints_bm(jworld, out)

    _, vjp = jax.vjp(solve, _jax_soa(s), tuple(getattr(con_j, k) for k in PLANES))
    ds_j, dplanes_j = vjp(_jax_soa(cot))
    for f in s._fields:
        _close(getattr(ds, f), getattr(ds_j, f), f)
    for name, got, want in zip(PLANES, dcon, dplanes_j):
        _close(got, want, name)
    # the case turns on the tie: torch.clamp's rule is far off
    _clamp_rule(monkeypatch)
    old = contact_solver.solve_contacts_bwd_plain(env.world, s, con, cot, 3, 2, 0.01, cfg)[0]
    assert abs(old.vy[0, 0].item() - float(ds_j.vy[0, 0])) > 0.1


def test_fused_plain_vjp_at_a_tie_matches_jax(monkeypatch):
    """The VJP of the fused step's plain version on the fused tie case (the
    hull on one corner, at rest, under the slop) against ``jax.vjp`` of the
    JAX split step, body and terrain cotangents both."""
    env = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device="cpu")
    jworld = JaxLander(JaxLanderConfig(broadphase=False)).world
    s, override, cot = tie_fused_case(env)
    _, con = fused_step.fused_step_plain(env.world, s, override)
    lanes = torch.nonzero(con.active[:, 0]).flatten().tolist()
    assert len(lanes) == 1 and env.world.table.partner[lanes[0]] >= 0
    ds, dtx, dty = fused_step.fused_step_bwd_plain(env.world, s, override, cot)

    parts = sorted(override)
    tx = jnp.asarray(np.stack([override[p][0].numpy() for p in parts]))
    ty = jnp.asarray(np.stack([override[p][1].numpy() for p in parts]))

    def step(ss, tx, ty):
        ov = {p: (tx[i], ty[i]) for i, p in enumerate(parts)}
        return jb.physics_core(jworld, ss, terrain_override=ov)[0]

    _, vjp = jax.vjp(step, _jax_soa(s), tx, ty)
    ds_j, dtx_j, dty_j = vjp(_jax_soa(cot))
    for f in s._fields:
        _close(getattr(ds, f), getattr(ds_j, f), f)
    V = fused_step.MAX_VERTS
    _close(dtx, np.asarray(dtx_j).reshape(len(parts) * V, 1), "dtx")
    _close(dty, np.asarray(dty_j).reshape(len(parts) * V, 1), "dty")
    _clamp_rule(monkeypatch)
    old = fused_step.fused_step_bwd_plain(env.world, s, override, cot)[0]
    assert abs(old.vy[0, 0].item() - float(ds_j.vy[0, 0])) > 0.1


@pytest.mark.parametrize("hook", ["plane_pre", "plane_post"])
def test_lander_action_clip_at_the_bounds_matches_jax(hook):
    """Actions at exactly 0, +1 and -1 (a saturated tanh policy): the
    gradients of the thrust and the reward through the lander's action
    clip are ``jax.vjp``'s, half the cotangent at a bound."""
    env = LunarLander(device="cpu")
    jenv = JaxLander()
    B = 4
    rng = np.random.default_rng(1)
    s = tb._SoA(*(torch.from_numpy(rng.standard_normal((4, B)).astype(np.float32) * 0.1)
                  for _ in range(6)))
    actions = np.array([[1.0, -1.0], [0.0, 1.0], [1.0, 0.5], [0.3, -1.0]], np.float32)
    aux = env.plane_pack(env.reset_fn_batch(torch.zeros((B, 2), dtype=torch.int64)))
    jaux = jenv.plane_pack(jenv.reset_fn_batch(jnp.zeros((B, 2), jnp.uint32)))
    con = tb.ContactsBM(*(torch.zeros((48, B)) for _ in range(4)),
                        torch.zeros((48, B), dtype=torch.bool), torch.ones((48, B)))
    jcon = jb.ContactsBM(*(jnp.asarray(x.numpy()) for x in con))
    t = torch.ones(B, dtype=torch.int32)

    def port(a):
        if hook == "plane_pre":  # the thrust moves the hull's velocities
            out = env.plane_pre(s, aux, a)
            return out.vx, out.vy, out.omega
        return (env.plane_post(s, aux, con, a, t)[2],)

    def ref(a):
        if hook == "plane_pre":
            out = jenv.plane_pre(_jax_soa(s), jaux, a)
            return out.vx, out.vy, out.omega
        return (jenv.plane_post(_jax_soa(s), jaux, jcon, a, jnp.asarray(t.numpy()))[2],)

    a = torch.from_numpy(actions).requires_grad_(True)
    out = port(a)
    gout = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
            for o in out]
    (got,) = torch.autograd.grad(out, a, gout)
    _, vjp = jax.vjp(ref, jnp.asarray(actions))
    (want,) = vjp(tuple(jnp.asarray(g.numpy()) for g in gout))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert np.abs(got.numpy()).max() > 0
