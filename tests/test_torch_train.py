"""The port's train path against the JAX package's, on the CPU.

Inputs come from numpy seeds and cross between the frameworks through
numpy.  The contact scenario is ``tests/test_pallas_solver.py``'s: the
lander lowered by 6.2 with ``vy -= 0.6``, then 40 zero-action steps, so
that the legs and the hull rest on the terrain and the differentiated
window is full of contacts.  Every JAX reference is compiled once.

Tolerances, each with its reason:

* solver VJP: rtol 2e-4, atol 1e-5, the bar the JAX package sets between
  its Pallas backward and its XLA VJP (the frameworks round and sum in
  another order, so they agree to float32 rounding, not bit for bit);
* loss and policy gradients of the train step: 1e-5 relative on the loss
  and 1e-4 relative (in norm) on each gradient: rounding differences of
  the forward (about 1e-6 relative per step) pass through 12 contact steps
  and their backward, where the 2x2 block solves amplify them;
* the FD oracle: rtol 2e-2, atol 2e-4 as in ``tests/test_grad_fd_oracle.py``
  (central differences in float32 with a step of 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parallax_tpu.dynamics.bodies import BodyState as JaxBodyState
from parallax_tpu.engine import batched as jb
from parallax_tpu.envs.lunar_lander import LanderState as JaxLanderState
from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu.parallel.rollout import make_train_step as jax_make_train_step
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.ops import contact_solver
from parallax_tpu_torch.parallel import rollout
from parallax_tpu_torch.utils import convert
from parallax_tpu_torch.utils.pytree import tree_map

torch.set_num_threads(2)

SOLVER_B = 32  # about 4 active lanes a world: > 100 in all
TRAIN_B, HORIZON = 8, 12
FIELDS = ("px", "py", "vx", "vy", "angle", "omega")
PLANES = ("pen_x", "pen_y", "pt_x", "pt_y")


def contact_states(env, B):
    """Lowered start, 40 zero-action steps: the contact scenario's states."""
    keys = np.random.default_rng(0).integers(0, 2**32, (B, 2), dtype=np.uint32)
    st = env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)))
    b = st.bodies
    st = st._replace(bodies=b._replace(
        pos=b.pos - torch.tensor([0.0, 6.2]), vel=b.vel - torch.tensor([0.0, 0.6])
    ))

    def zero(_, obs):
        return torch.zeros((obs.shape[0], 2))

    st, _ = env.rollout_batch(st, zero, 40)
    return st


def to_jax(st):
    d = convert.lander_state_to_numpy(st)
    return JaxLanderState(
        bodies=JaxBodyState(
            pos=jnp.asarray(d["bodies.pos"]), vel=jnp.asarray(d["bodies.vel"]),
            angle=jnp.asarray(d["bodies.angle"]), omega=jnp.asarray(d["bodies.omega"]),
        ),
        terrain=jnp.asarray(d["terrain"]),
        t=jnp.asarray(d["t"]),
        key=jnp.asarray(d["key"]),
        prev_shaping=jnp.asarray(d["prev_shaping"]),
        leg_contacts=jnp.asarray(d["leg_contacts"]),
    )


def policy_arrays():
    rng = np.random.default_rng(0)
    return {
        "w1": (rng.standard_normal((9, 32)) * 0.3).astype(np.float32),
        "b1": np.zeros(32, np.float32),
        "w2": (rng.standard_normal((32, 2)) * 0.1).astype(np.float32),
        "b2": np.zeros(2, np.float32),
    }


def torch_params():
    return {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in policy_arrays().items()}


def torch_policy(p, obs):
    return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


def jax_policy(p, obs):
    return jnp.tanh(jnp.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


@pytest.fixture(scope="module")
def env():
    return LunarLander(device="cpu")


@pytest.fixture(scope="module")
def jenv():
    return JaxLander()


@pytest.fixture(scope="module")
def scenario(env):
    return contact_states(env, SOLVER_B)


# ---------------------------------------------------------------------------
# (a), (b): the solver's VJP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solver_vjps(env, jenv, scenario):
    """The scenario, random cotangents, and jax.vjp of the JAX solve with
    and without the joints (one compile)."""
    st = scenario
    aux = env.plane_pack(st)
    override = {p: (aux.tox[i], aux.toy[i]) for i, p in enumerate(env._ground_parts)}
    s = tb._to_soa(st.bodies)
    con = tb.collide_batched(env.world, s, override)
    assert int(con.active.sum()) > 100, "scenario must have real contacts"
    rng = np.random.default_rng(5)
    cot = [rng.standard_normal(s.px.shape).astype(np.float32) for _ in FIELDS]

    jworld = jenv.world
    cfg = jworld.config.contact
    s_j = jb._SoA(*(jnp.asarray(x) for x in convert.to_numpy(s)))
    con_j = jb.ContactsBM(*(jnp.asarray(x) for x in convert.to_numpy(con)))

    @jax.jit
    def both(s_j, planes, g):
        def f(joints):
            def solve(ss, pp):
                out = jb.solve_contacts_bm(
                    jworld, ss, con_j._replace(**dict(zip(PLANES, pp))), 3, 2, 0.01, cfg
                )
                return jb.apply_joints_bm(jworld, out) if joints else out

            _, vjp = jax.vjp(solve, s_j, planes)
            return vjp(jb._SoA(*g))

        return f(True), f(False)

    planes_j = tuple(getattr(con_j, k) for k in PLANES)
    want = both(s_j, planes_j, tuple(jnp.asarray(c) for c in cot))
    return s, con, tb._SoA(*(torch.from_numpy(c) for c in cot)), dict(zip((True, False), want))


def _port_vjp(env, s, con, cot, joints):
    if joints:
        return contact_solver.solve_contacts_bwd_plain(
            env.world, s, con, cot, 3, 2, 0.01, env.world.config.contact
        )
    s_in = tb._SoA(*(x.clone().requires_grad_(True) for x in s))
    planes = {k: getattr(con, k).clone().requires_grad_(True) for k in PLANES}
    out = tb.solve_contacts_bm(
        env.world, s_in, con._replace(**planes), 3, 2, 0.01, env.world.config.contact
    )
    got = torch.autograd.grad(tuple(out), (*s_in, *planes.values()), tuple(cot))
    return (tb._SoA(*got[:6]), *got[6:])


@pytest.mark.parametrize("joints", [True, False])
def test_plain_solver_vjp_matches_jax_vjp(env, solver_vjps, joints):
    s, con, cot, want = solver_vjps
    ds, *dcon = _port_vjp(env, s, con, cot, joints)
    ds_j, dplanes_j = want[joints]
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(ds, f).numpy(), np.asarray(getattr(ds_j, f)),
            rtol=2e-4, atol=1e-5, err_msg=f,
        )
    for name, got, ref in zip(PLANES, dcon, dplanes_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-5,
                                   err_msg=name)
    assert np.abs(ds.vy.numpy()).max() > 1e-3, "the VJP must be alive"


def test_autograd_function_cotangent_structure(env, solver_vjps, monkeypatch):
    """``_ContactSolve`` (the card's autograd path), with its two launches
    swapped for the plain versions: it returns one cotangent per input,
    none for the bool ``active`` mask and the static arguments, and its
    cotangents are the plain VJP's (``pen_y`` against jax.vjp's as in
    ``test_pallas_bwd_cotangent_structure``)."""
    s, con, cot, want = solver_vjps
    cfg = env.world.config.contact
    statics = (env.world, 3, 2, 0.01, cfg)
    monkeypatch.setattr(contact_solver, "_solve_cuda", contact_solver.solve_contacts_plain)
    monkeypatch.setattr(
        contact_solver, "_solve_bwd_cuda", contact_solver.solve_contacts_bwd_plain
    )
    planes = [getattr(con, k).clone().requires_grad_(True) for k in PLANES]
    body = [x.clone().requires_grad_(True) for x in s]
    out = contact_solver._ContactSolve.apply(statics, *planes, con.active, *body)
    assert all(o.grad_fn is not None for o in out), "the solve must carry a grad_fn"
    got = torch.autograd.grad(out, (*planes, *body), tuple(cot))

    ctx = type("Ctx", (), {})()
    ctx.statics = statics
    ctx.saved_tensors = (*(getattr(con, k) for k in PLANES), con.active, *s)
    grads = contact_solver._ContactSolve.backward(ctx, *cot)
    assert len(grads) == 1 + 5 + 6
    assert grads[0] is None and grads[5] is None  # statics, active
    ref_s, *ref_planes = contact_solver.solve_contacts_bwd_plain(
        env.world, s, con, cot, 3, 2, 0.01, cfg
    )
    for a, b, c in zip(got, (*ref_planes, *ref_s), (*grads[1:5], *grads[6:])):
        assert torch.equal(a, b) and torch.equal(b, c)
    np.testing.assert_allclose(
        got[1].numpy(), np.asarray(want[True][1][1]), rtol=2e-4, atol=1e-5
    )


# ---------------------------------------------------------------------------
# (c): autograd against finite differences through 20 env steps
# ---------------------------------------------------------------------------


def test_lander_thrust_grad_fd(env):
    """d(final hull height)/d(thrust) through 20 full env steps (thrust
    kick, physics, joints, reward plumbing): the port's
    ``test_lander_thrust_grad_fd[default]``."""
    B, T, H = 2, 20, 1e-2
    keys = np.random.default_rng(3).integers(0, 2**32, (B, 2), dtype=np.uint32)
    states = env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)))

    def loss(theta):
        def policy(_, obs):
            return torch.stack([theta, 0.0 * theta]).expand(obs.shape[0], 2)

        final, _ = env.rollout_batch(states, policy, T)
        return final.bodies.pos[:, 0, 1].mean()

    theta = torch.tensor(0.6, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)
    with torch.no_grad():
        fd = (loss(torch.tensor(0.6 + H)) - loss(torch.tensor(0.6 - H))) / (2 * H)
    assert abs(g.item()) > 1e-4, "thrust gradient must be alive (not a clipped zero)"
    np.testing.assert_allclose(g.item(), fd.item(), rtol=2e-2, atol=2e-4)


# ---------------------------------------------------------------------------
# (d), (e), (f): the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_ref(jenv, scenario):
    """JAX make_train_step's loss and gradients at the contact state (one
    compile).  The optimizer is a transformation that returns zero updates
    and keeps the gradients as its state, so they come out unrounded."""
    st = tree_map(lambda x: x[:TRAIN_B], scenario)
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )
    params = {k: jnp.asarray(v) for k, v in policy_arrays().items()}
    step = jax.jit(jax_make_train_step(jenv, jax_policy, keep, HORIZON))
    _, grads, _, metrics = step(params, keep.init(params), to_jax(st))
    return st, float(metrics["loss"]), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("remat_steps", [False, True])
@pytest.mark.parametrize("segments", [0, 2])
def test_train_loss_and_grads_match_jax(env, train_ref, segments, remat_steps):
    st, loss_j, grads_j = train_ref
    params = torch_params()
    loss_fn = rollout.make_loss_fn(
        env, torch_policy, HORIZON, segments, remat_steps=remat_steps
    )
    loss, (final, mean_ret) = loss_fn(params, st)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    assert mean_ret.item() == -loss.item()
    assert final.t.shape == (TRAIN_B,)
    for k, g in zip(params, grads):
        ref = grads_j[k]
        assert np.linalg.norm(ref) > 1e-3, f"{k}: gradient must be alive"
        rel = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert rel < 1e-4, (k, rel)


def test_adam_step_matches_optax(env, train_ref):
    """One port train step (torch Adam at lr 3e-3) against optax.adam(3e-3)
    applied to the JAX gradients."""
    st, _, grads_j = train_ref
    arrays = policy_arrays()
    opt = optax.adam(3e-3)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    updates, _ = opt.update({k: jnp.asarray(v) for k, v in grads_j.items()},
                            opt.init(jparams), jparams)
    params = torch_params()
    step = rollout.make_train_step(env, torch_policy, rollout.adam(params, 3e-3), HORIZON)
    new, final, metrics = step(params, st)
    assert new is params and not final.bodies.pos.requires_grad
    assert set(metrics) == {"loss", "mean_return"}
    for k, v in arrays.items():
        moved = new[k].detach().numpy() - v
        # the first Adam update is lr * g / (|g| + eps): 3e-3 wherever |g| >> eps
        np.testing.assert_allclose(moved, np.asarray(updates[k]), rtol=1e-3, atol=1e-7,
                                   err_msg=k)
        assert np.abs(moved).max() > 1e-3


def test_segments_must_divide_the_horizon(env, scenario):
    st = tree_map(lambda x: x[:2], scenario)
    with pytest.raises(ValueError, match="must divide"):
        rollout.batched_rollout(env, st, torch_policy, torch_params(), 12, 5)
    with pytest.raises(TypeError, match="DeviceMesh"):
        rollout.make_train_step(env, torch_policy, None, 12, mesh=object())
    # a world mesh is taken (a one-rank gloo mesh here); its step is
    # tests/test_torch_mesh.py's and tests/test_torch_fleet*.py's
    from parallax_tpu_torch.parallel.mesh import make_world_mesh

    mesh = make_world_mesh("cpu")
    try:
        assert callable(rollout.make_train_step(env, torch_policy, None, 12, mesh=mesh))
    finally:
        torch.distributed.destroy_process_group()


def test_trainer_entry_point_runs_on_cpu(capsys):
    from parallax_tpu_torch.examples import train_lander

    params, metrics = train_lander.main(
        ["--steps", "1", "--batch", "4", "--horizon", "4", "--device", "cpu"]
    )
    out = capsys.readouterr().out
    assert "device=cpu" in out and out.count("step ") == 1
    assert np.isfinite(metrics["loss"].item())
    assert all(torch.isfinite(p).all() for p in params.values())


def test_robocup_trainer_entry_point_runs_on_cpu(capsys):
    from parallax_tpu_torch.examples import train_robocup

    params, metrics = train_robocup.main(
        ["--steps", "1", "--batch", "4", "--horizon", "4", "--fused", "--device", "cpu"]
    )
    out = capsys.readouterr().out
    assert "device=cpu" in out and "fused=True" in out and out.count("step ") == 1
    assert np.isfinite(metrics["loss"].item())
    assert all(torch.isfinite(p).all() for p in params.values())


def test_reward_without_a_gradient_path_gives_zero_grads():
    """Billiards' reward counts pots and a living cost, so the train loss
    does not depend on the policy: the train step gives zero gradients, as
    ``jax.value_and_grad`` does for the JAX package's ``bench.py --train
    --all`` line, and Adam steps with them, leaving the policy as it was."""
    from parallax_tpu_torch.envs.billiards import Billiards

    env = Billiards(device="cpu")
    rng = np.random.default_rng(0)
    arrays = {"w": (rng.standard_normal((env.observation_size, 2)) * 0.3).astype(np.float32)}
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in arrays.items()}
    opt = rollout.adam(params, 3e-3)
    step = rollout.make_train_step(env, lambda p, obs: torch.tanh(obs @ p["w"]), opt, 4)
    keys = rng.integers(0, 2**32, (4, 2), dtype=np.uint32)
    st = env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)))
    new, final, metrics = step(params, st)
    assert np.isfinite(metrics["loss"].item()) and final.t.tolist() == [4, 4, 4, 4]
    assert (new["w"].grad == 0).all()
    np.testing.assert_array_equal(new["w"].detach().numpy(), arrays["w"])
    assert opt.state[new["w"]]["step"].item() == 1
