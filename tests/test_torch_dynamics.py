"""The per-world dynamics, module by module, against the JAX package's.

The port's ``dynamics/{integrator,impulses,joints,block_solver,solver}.py``
take tensors with leading batch axes; the JAX functions run one world and
are ``jax.vmap``ped (or broadcast, where they are elementwise).  Inputs
are numpy-seeded: a batch of B=8 worlds of the config matrix's topology
(``tests/torch_scenarios.py:matrix_world``: cc, cb, cp, bp and pp lanes,
two-lane manifolds among them) with synthetic contacts every one of which
is at least 0.01 deep, and a chain of three bodies held by three joints.
The bars: 1e-6 for the integrator, 1e-5 for impulses, joints and solvers
(the block solve's omega 1e-4: sums in another order meet an inertia of
0.04), and the JAX package's rtol 2e-4, atol 1e-5 for the joints' VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import matrix_world

from parallax_tpu.dynamics import block_solver as jblock
from parallax_tpu.dynamics import impulses as jimp
from parallax_tpu.dynamics import integrator as jint
from parallax_tpu.dynamics import joints as jjoints
from parallax_tpu.dynamics import solver as jsolver
from parallax_tpu.dynamics.bodies import BodyParams as JParams
from parallax_tpu.dynamics.bodies import BodyState as JState
from parallax_tpu.geometry.contacts import Contact as JContact
from parallax_tpu_torch.dynamics import block_solver, impulses, integrator, joints, solver
from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.geometry.contacts import Contact

torch.set_num_threads(2)
B = 8


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _state(rng, n):
    """A numpy-seeded batch ``{pos, vel, angle, omega}`` of n bodies."""
    return {"pos": rng.normal(0.0, 0.5, (B, n, 2)).astype(np.float32),
            "vel": rng.normal(0.0, 1.0, (B, n, 2)).astype(np.float32),
            "angle": rng.uniform(-0.5, 0.5, (B, n)).astype(np.float32),
            "omega": rng.normal(0.0, 1.0, (B, n)).astype(np.float32)}


def _port_state(d):
    return BodyState(*(_t(d[f]) for f in BodyState._fields))


def _jax_state(d):
    return JState(*(jnp.asarray(d[f]) for f in BodyState._fields))


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


def test_integrator_matches_jax():
    """Explicit Euler, the masked gravity kick and symplectic Euler on a
    batch with a static body, at 1e-6; the movable mask equal."""
    rng = np.random.default_rng(0)
    d = _state(rng, 4)
    mass = np.float32([1.0, 2.0, np.inf, 0.5])
    mov = integrator.movable_mask(BodyParams.make(mass, mass))
    jmov = jint.movable_mask(JParams.make(mass, mass))
    np.testing.assert_array_equal(mov.numpy(), np.asarray(jmov))
    accel = np.float32([0.3, -9.8])
    for dt in (0.01, 0.05):
        cases = (
            (integrator.integrate_explicit_euler(_port_state(d), dt),
             jint.integrate_explicit_euler(_jax_state(d), dt)),
            (integrator.apply_acceleration(_port_state(d), accel, dt, mov),
             jint.apply_acceleration(_jax_state(d), accel, dt, jmov)),
            (integrator.integrate_symplectic_euler(_port_state(d), dt, accel, mov),
             jint.integrate_symplectic_euler(_jax_state(d), dt, accel, jmov)),
        )
        for got, want in cases:
            for f in BodyState._fields:
                _close(getattr(got, f), getattr(want, f), 1e-6, f"{f} dt={dt}")


VARIANTS = [dict(friction_mode=f, restitution_mode=r, lever_mode=lv)
            for f in ("tangent", "reference") for r in ("min", "mean")
            for lv in ("textbook", "reference")] + [dict(baumgarte_max_bias=None)]


def test_contact_impulse_matches_jax():
    """``contact_impulse`` and ``resolve_contact_deltas`` on 512 random
    lanes, under each of the 2 x 2 x 2 friction, restitution and lever
    modes and with no bias clamp: impulses and deltas within 1e-5, the
    applied flags equal.  The lanes' approach (``pen . v_rel``) is kept
    clear of 0, where the separating test switches."""
    rng = np.random.default_rng(1)
    N = 512
    f = lambda *s: rng.normal(0.0, 1.0, s).astype(np.float32)  # noqa: E731
    depth = rng.uniform(0.01, 0.2, N).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, N)
    pen = (depth[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(np.float32)
    lanes = dict(point=f(N, 2), pos_a=f(N, 2), vel_a=f(N, 2), omega_a=f(N),
                 pos_b=f(N, 2), vel_b=f(N, 2), omega_b=f(N))
    params = [rng.uniform(0.2, 2.0, N).astype(np.float32) for _ in range(2)]
    params = dict(inv_mass_a=params[0], inv_inertia_a=params[1],
                  elasticity_a=rng.uniform(0, 1, N).astype(np.float32),
                  friction_a=rng.uniform(0, 1, N).astype(np.float32),
                  inv_mass_b=np.where(rng.random(N) < 0.3, 0.0, rng.uniform(0.2, 2, N)).astype(np.float32),
                  inv_inertia_b=rng.uniform(0.2, 2.0, N).astype(np.float32),
                  elasticity_b=rng.uniform(0, 1, N).astype(np.float32),
                  friction_b=rng.uniform(0, 1, N).astype(np.float32))
    active = rng.random(N) < 0.8
    # the approach speed at the point, pen . v_rel, clear of 0
    perp = lambda r: np.stack([-r[:, 1], r[:, 0]], -1)  # noqa: E731
    v_rel = (lanes["vel_b"] + perp(lanes["point"] - lanes["pos_b"]) * lanes["omega_b"][:, None]
             - lanes["vel_a"] - perp(lanes["point"] - lanes["pos_a"]) * lanes["omega_a"][:, None])
    active &= np.abs(np.sum(pen * v_rel, -1)) > 1e-2
    args = dict(pen=pen, active=active, **lanes, **params)
    targs = {k: _t(v) for k, v in args.items()}
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    order = ("pen", "point", "active", "pos_a", "vel_a", "omega_a", "pos_b", "vel_b", "omega_b")
    pkeys = ("inv_mass", "inv_inertia", "elasticity", "friction")
    n_applied = 0
    for v in VARIANTS:
        cfg, jcfg = impulses.ContactSolverConfig(**v), jimp.ContactSolverConfig(**v)
        J, applied = impulses.contact_impulse(**targs, config=cfg)
        jJ, japplied = jax.jit(lambda a: jimp.contact_impulse(**a, config=jcfg))(jargs)
        assert np.array_equal(applied.numpy(), np.asarray(japplied)), v
        _close(J, jJ, 1e-5, f"impulse {v}")
        got = impulses.resolve_contact_deltas(
            *(targs[k] for k in order), tuple(targs[k + "_a"] for k in pkeys),
            tuple(targs[k + "_b"] for k in pkeys), cfg)
        want = jax.jit(lambda a: jimp.resolve_contact_deltas(
            *(a[k] for k in order), tuple(a[k + "_a"] for k in pkeys),
            tuple(a[k + "_b"] for k in pkeys), jcfg))(jargs)
        for g, w in zip(jax.tree_util.tree_leaves(got[:2]), jax.tree_util.tree_leaves(want[:2])):
            _close(g, w, 1e-5, f"deltas {v}")
        n_applied += int(applied.sum())
    assert n_applied > 1000


def _joint_case():
    """Three bodies (the last static) held by three joints, B worlds."""
    rng = np.random.default_rng(2)
    d = _state(rng, 3)
    d["vel"][:, 2] = 0.0
    d["omega"][:, 2] = 0.0
    mass = np.float32([1.0, 1.5, np.inf])
    inertia = np.float32([0.2, 0.3, np.inf])
    tab = dict(body_a=[0, 1, 0], body_b=[1, 2, 2],
               anchor_a=rng.normal(0, 0.3, (3, 2)).astype(np.float32),
               anchor_b=rng.normal(0, 0.3, (3, 2)).astype(np.float32),
               kp=rng.uniform(0.5, 1.5, 3).astype(np.float32),
               kd=rng.uniform(0.02, 0.1, 3).astype(np.float32),
               v0=rng.uniform(0.05, 0.2, 3).astype(np.float32))
    return (d, BodyParams.make(mass, inertia), joints.Joints.make(**tab),
            JParams.make(mass, inertia), jjoints.Joints.make(**tab))


@pytest.mark.parametrize("mode", ["gauss_seidel", "jacobi"])
def test_apply_joints_matches_jax(mode):
    """``apply_joints`` in sequence and all at once, 1 and 3 iterations:
    velocities within 1e-5; then its VJP wrt the state and the joint gains
    against ``jax.vjp`` at rtol 2e-4, atol 1e-5."""
    d, params, jt, jparams, jjt = _joint_case()
    for it in (1, 3):
        got = joints.apply_joints(_port_state(d), params, jt, mode, it)
        want = jax.jit(jax.vmap(lambda s: jjoints.apply_joints(s, jparams, jjt, mode, it)))(
            _jax_state(d))
        for f in BodyState._fields:
            _close(getattr(got, f), getattr(want, f), 1e-5, f"{mode} x{it} {f}")

    rng = np.random.default_rng(3)
    cot = (rng.normal(size=(B, 3, 2)).astype(np.float32), rng.normal(size=(B, 3)).astype(np.float32))
    st = BodyState(*(x.clone().requires_grad_() for x in _port_state(d)))
    gains = [x.clone().requires_grad_() for x in (jt.kp, jt.kd, jt.v0)]
    out = joints.apply_joints(st, params, jt._replace(kp=gains[0], kd=gains[1], v0=gains[2]),
                              mode, 3)
    loss = (out.vel * _t(cot[0])).sum() + (out.omega * _t(cot[1])).sum()
    grads = torch.autograd.grad(loss, list(st) + gains, allow_unused=True)

    def f(s, kp, kd, v0):
        o = jax.vmap(lambda x: jjoints.apply_joints(
            x, jparams, jjt.replace(kp=kp, kd=kd, v0=v0), mode, 3))(s)
        return o.vel, o.omega

    _, vjp = jax.vjp(f, _jax_state(d), jjt.kp, jjt.kd, jjt.v0)
    js, *jg = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    jleaves = [getattr(js, f) for f in BodyState._fields] + jg
    for name, g, w in zip(list(BodyState._fields) + ["kp", "kd", "v0"], grads, jleaves):
        g = torch.zeros(w.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=1e-5,
                                   err_msg=f"{mode} d/d{name}")


def _contact_case(seed=4):
    """The matrix world's lane table with synthetic contacts: every lane's
    depth in [0.01, 0.1], a manifold's two lanes sharing their normal,
    points between the lane's bodies, about 80 % of lanes active; the
    bodies' velocities random.  Returns the port's and JAX's inputs."""
    world, st0 = matrix_world("sat", "block", "cpu")
    tab = world.table
    C, n = tab.n_contacts, world.n_bodies
    partner = np.asarray(tab.partner)
    rng = np.random.default_rng(seed)
    d = {"pos": np.broadcast_to(st0.pos.numpy(), (B, n, 2)).copy(),
         "vel": rng.normal(0, 0.5, (B, n, 2)).astype(np.float32),
         "angle": np.broadcast_to(st0.angle.numpy(), (B, n)).copy(),
         "omega": rng.normal(0, 0.5, (B, n)).astype(np.float32)}
    static = np.asarray(world.static_bodies)
    d["vel"][:, static] = 0.0
    d["omega"][:, static] = 0.0
    ang = rng.uniform(0, 2 * np.pi, (B, C))
    lead = np.where(partner >= 0, np.minimum(np.arange(C), partner), np.arange(C))
    ang = ang[:, lead]  # a manifold's lanes share their normal
    depth = rng.uniform(0.01, 0.1, (B, C))
    pen = (depth[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(np.float32)
    pa, pb = d["pos"][:, list(tab.body_a)], d["pos"][:, list(tab.body_b)]
    w = rng.uniform(0.3, 0.7, (B, C, 1))
    point = (w * pa + (1 - w) * pb + rng.normal(0, 0.05, (B, C, 2))).astype(np.float32)
    active = rng.random((B, C)) < 0.8
    weight = np.where(partner >= 0, 0.5, 1.0).astype(np.float32)[None].repeat(B, 0)
    con = Contact(_t(pen), _t(point), _t(active), _t(weight))
    jcon = JContact(jnp.asarray(pen), jnp.asarray(point), jnp.asarray(active), jnp.asarray(weight))
    jparams = JParams(*(jnp.asarray(x.numpy()) for x in world.params))
    return world, d, con, jcon, jparams


def test_block_solver_matches_jax():
    """``solve_contacts`` (the 2x2 manifold block solve, the friction pass,
    two split-impulse position passes) on the synthetic contacts, under the
    default and the reference impulse configs and a restitution threshold:
    pos and vel within 1e-5, omega within 1e-4; manifold lanes block-solve
    in most worlds."""
    world, d, con, jcon, jparams = _contact_case()
    tab = world.table
    args = (np.asarray(tab.body_a), np.asarray(tab.body_b), np.asarray(tab.partner))
    partner = np.asarray(tab.partner)
    both = con.active & con.active[:, np.where(partner >= 0, partner, np.arange(len(partner)))]
    assert int((both & torch.from_numpy(partner >= 0)).sum()) > B
    for v, thr in ((dict(), 0.0), (dict(friction_mode="reference", lever_mode="reference"), 0.1)):
        cfg, jcfg = impulses.ContactSolverConfig(**v), jimp.ContactSolverConfig(**v)
        got = block_solver.solve_contacts(_port_state(d), world.params, con, *args, iterations=4,
                                          position_iterations=2, restitution_threshold=thr,
                                          config=cfg)
        want = jax.jit(jax.vmap(lambda s, c: jblock.solve_contacts(
            s, jparams, c, *args, iterations=4, position_iterations=2,
            restitution_threshold=thr, config=jcfg)))(_jax_state(d), jcon)
        for f, bar in (("pos", 1e-5), ("vel", 1e-5), ("angle", 1e-5), ("omega", 1e-4)):
            _close(getattr(got, f), getattr(want, f), bar, f"{v} {f}")
        assert (got.vel - _t(d["vel"])).abs().max() > 0.01


def test_resolve_contacts_matches_jax():
    """``resolve_contacts`` in ``jacobi`` (relaxation 0.7, the lanes'
    manifold weights) and ``gauss_seidel`` (the lanes in buffer order), 3
    iterations, under the default and the reference configs: velocities
    within 1e-5."""
    world, d, con, jcon, jparams = _contact_case(seed=5)
    tab = world.table
    args = (np.asarray(tab.body_a), np.asarray(tab.body_b))
    for mode in ("jacobi", "gauss_seidel"):
        for cfg_kw in (dict(), dict(friction_mode="reference", lever_mode="reference",
                                    baumgarte_max_bias=None)):
            cfg, jcfg = impulses.ContactSolverConfig(**cfg_kw), jimp.ContactSolverConfig(**cfg_kw)
            got = solver.resolve_contacts(_port_state(d), world.params, con, *args, mode=mode,
                                          iterations=3, relaxation=0.7, config=cfg)
            want = jax.jit(jax.vmap(lambda s, c: jsolver.resolve_contacts(
                s, jparams, c, *args, mode=mode, iterations=3, relaxation=0.7,
                config=jcfg)))(_jax_state(d), jcon)
            for f in ("vel", "omega"):
                _close(getattr(got, f), getattr(want, f), 1e-5, f"{mode} {cfg_kw} {f}")
            assert (got.vel - _t(d["vel"])).abs().max() > 0.01
