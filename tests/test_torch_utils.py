"""The port's utils (``parallax_tpu_torch/utils/{dbc,metrics,checkpoint,
profiling}.py`` and ``viz.py``) on the CPU, the models being
``tests/test_dbc.py``, ``test_metrics.py``, ``test_checkpoint_viz.py`` and
``test_profiling.py``.

* ``contact_metrics`` (per-world contacts, reduced over every axis) and
  ``contact_metrics_bm`` (the batched planes) against JAX's on the same
  B=8 overlap states: counts exact, depths within 1e-5;
* ``checkpoint``: a lander fleet round trip bit for bit, onto the target's
  types; a resume (policy, Adam state, fleet) whose next train step equals
  the unbroken run's bit for bit;
* ``Renderer.render_env`` of the lander, RoboCup and Billiards against the
  JAX package's ``Renderer`` on the same state: the differing pixels are
  counted and held to at most 16 of 76,800 (a vertex a float32 rounding
  apart would land a boundary pixel on the other side; a CPU run found
  none); the rasterizer's bbox and clamping cases;
* ``trace`` (a Chrome trace with a ``named`` region and the program's own
  spans in it; ``named`` is a no-op outside it);
* ``dbc``: raising checks, pre/post conditions and invariants, free when
  off; in fleet mode one poisoned world of B=8 is truncated and reset by
  the env's watchdog while the others step on, and the violation is
  counted;
* ``log_metrics`` prints only when switched on; ``timestep_metrics``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import keys_np, port_keys

from parallax_tpu.engine import batched as jbatched
from parallax_tpu.engine.world import BodyDef as JBodyDef
from parallax_tpu.engine.world import World as JWorld
from parallax_tpu.engine.world import WorldConfig as JConfig
from parallax_tpu.envs.billiards import Billiards as JBilliards
from parallax_tpu.envs.lunar_lander import LunarLander as JLander
from parallax_tpu.envs.robocup import RoboCup as JRoboCup
from parallax_tpu.geometry import shapes as js
from parallax_tpu.utils import metrics as jmetrics
from parallax_tpu.viz import Renderer as JRenderer
from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine.batched import _to_soa, collide_batched
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.envs.billiards import Billiards
from parallax_tpu_torch.envs.bouncer import Bouncer
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.envs.robocup import RoboCup
from parallax_tpu_torch.geometry import shapes as ps
from parallax_tpu_torch.parallel.rollout import adam, make_train_step
from parallax_tpu_torch.utils import checkpoint, dbc, metrics, profiling
from parallax_tpu_torch.viz import Renderer

torch.set_num_threads(2)
B = 8


def _overlap_bodies(BD, box, circle):
    ball = BD(shapes=[circle(0.5)], mass=1.0, inertia=0.1, position=(0.0, 0.3),
              elasticity=0.0, friction=0.5)
    ground = BD(shapes=[box((-5.0, -2.0), (5.0, 0.0))], mass=np.inf, inertia=np.inf,
                elasticity=0.0, friction=0.5)
    return [ball, ground]


def test_contact_metrics_match_jax():
    world, st0 = World.build(_overlap_bodies(BodyDef, ps.box, ps.circle), WorldConfig(dt=0.01),
                             device="cpu")
    jworld, jst0 = JWorld.build(_overlap_bodies(JBodyDef, js.box, js.circle), JConfig(dt=0.01))
    pos = np.broadcast_to(st0.pos.numpy(), (B, 2, 2)).copy()
    pos[:, 0, 1] += np.linspace(0.0, 1.0, B, dtype=np.float32)  # 0.2 deep to apart
    st = BodyState(*(x.expand((B,) + x.shape).contiguous() for x in st0))._replace(
        pos=torch.from_numpy(pos))
    jst = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jst0).replace(
        pos=jnp.asarray(pos))
    pairs = ((metrics.contact_metrics(world.detect_contacts(st)),
              jmetrics.contact_metrics(jax.vmap(jworld.detect_contacts)(jst))),
             (metrics.contact_metrics_bm(collide_batched(world, _to_soa(st))),
              jmetrics.contact_metrics_bm(jbatched.collide_batched(jworld, jbatched._to_soa(jst)))))
    for got, want in pairs:
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=k)
    m = pairs[0][0]
    assert int(m["n_active"]) >= 1 and 0.15 < float(m["max_depth"]) < 0.25


def test_checkpoint_round_trip_and_bitwise_resume(tmp_path):
    env = LunarLander(device="cpu")
    states = env.reset_fn_batch(port_keys(keys_np(4, 0)))
    path = str(tmp_path / "fleet.pt")
    checkpoint.save(path, states)
    with pytest.raises(FileExistsError):
        checkpoint.save(path, states, force=False)
    back = checkpoint.restore(path, states)
    assert type(back) is type(states) and type(back.bodies) is type(states.bodies)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(states)), jax.tree_util.tree_leaves(tuple(back))):
        assert a.dtype == b.dtype and a.device == b.device
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert checkpoint.restore(path)["terrain"].shape == states.terrain.shape

    def policy(p, obs):
        return torch.tanh(obs @ p["w"] + p["b"])

    rng = np.random.default_rng(0)
    params = {"w": torch.tensor(rng.standard_normal((9, 2)) * 0.1, dtype=torch.float32,
                                requires_grad=True),
              "b": torch.zeros(2, requires_grad=True)}
    opt = adam(params)
    step = make_train_step(env, policy, opt, 6)
    params, states, _ = step(params, states)
    checkpoint.save(path, {"params": params, "opt": opt.state_dict(), "states": states})
    target = {"params": {k: v.detach().clone() for k, v in params.items()},
              "opt": opt.state_dict(), "states": states}
    pa, sa, ma = step(params, states)
    r = checkpoint.restore(path, target)
    pb = {k: v.requires_grad_(True) for k, v in r["params"].items()}
    opt_b = adam(pb)
    opt_b.load_state_dict(r["opt"])
    pb, sb, mb = make_train_step(env, policy, opt_b, 6)(pb, r["states"])
    assert ma["mean_return"].item() == mb["mean_return"].item()
    for k in pa:
        np.testing.assert_array_equal(pa[k].detach().numpy(), pb[k].detach().numpy())
    np.testing.assert_array_equal(sa.bodies.pos.numpy(), sb.bodies.pos.numpy())


def test_renderer_matches_jax_renderer():
    for cls, jcls, extent in (
        (LunarLander, JLander, (-8.0, 8.0, -6.0, 6.0)),
        (RoboCup, JRoboCup, (-5.5, 5.5, -4.0, 4.0)),
        (Billiards, JBilliards, (-1.3, 1.3, -0.8, 0.8)),
    ):
        env, jenv = cls(device="cpu"), jcls()
        k = keys_np(1, 4)[0]
        jst = jenv.reset_fn(jnp.asarray(k))
        st = env.reset(port_keys(k))
        np.testing.assert_array_equal(st.bodies.pos.numpy(), np.asarray(jst.bodies.pos))
        got = Renderer(320, 240, extent).render_env(env, st)
        want = JRenderer(320, 240, extent).render_env(jenv, jst)
        assert got.shape == want.shape == (240, 320, 3) and got.max() > 0
        differ = int((got != want).any(-1).sum())
        assert differ <= 16, (cls.__name__, differ)

    r = Renderer(width=100, height=80, extent=(-1.0, 1.0, -0.8, 0.8))
    f = r.blank()
    r.draw_circle(f, (0.0, 0.0), 0.1, color=(255, 0, 0))
    assert 0 < (f[..., 0] > 0).sum() < 200
    g = r.blank()
    r.draw_circle(g, (5.0, 5.0), 0.2)
    r.draw_polygon(g, [(3.0, 3.0), (4.0, 3.0), (3.5, 4.0)])
    assert g.max() == 0


def test_trace_writes_the_named_spans(tmp_path):
    x = torch.ones(128)
    env = Bouncer(device="cpu")
    states = env.reset_fn_batch(port_keys(keys_np(2, 5)))
    d = str(tmp_path / "prof")
    with profiling.trace(d) as prof:
        with profiling.named("hot_section"):
            torch.sin(x) * 2.0
        env.step_batch(states, torch.zeros((2, env.action_size)))
    assert not isinstance(profiling.named("hot_section"), torch.profiler.record_function)
    with open(os.path.join(d, "trace.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"hot_section", "px.step", "px.physics", "px.watchdog", "px.reset"} <= names
    assert any(e.key == "hot_section" for e in prof.key_averages())


def test_dbc_checks_and_fleet_poisoning():
    dbc.clear_violations()
    assert not dbc.checks_enabled()

    @dbc.pre_condition(lambda x: (x > 0).all(), "x must be positive")
    def f(x):
        return torch.sqrt(x)

    assert f(torch.tensor(-1.0)).isnan()  # off: no check
    dbc.set_debug_checks(True)
    try:
        assert float(f(torch.tensor(4.0))) == 2.0
        with pytest.raises(AssertionError, match="x must be positive"):
            f(torch.tensor(-1.0))

        @dbc.post_condition(lambda out: torch.isfinite(out).all(), "finite output")
        def g(x):
            return 1.0 / x

        with pytest.raises(AssertionError, match="finite output"):
            g(torch.tensor(0.0))

        @dbc.class_invariant
        class Counter:
            def __init__(self, v):
                self.v = v

            def __invariant__(self):
                return torch.as_tensor(self.v) >= 0

            def bump(self):
                self.v = self.v + 1
                return self.v

        c = Counter(1)
        assert c.bump() == 2
        c.v = -5
        with pytest.raises(AssertionError):
            c.bump()

        # fleet mode: poison, no raise; the watchdog resets just that world
        dbc.set_raise_on_violation(False)
        env = Bouncer(device="cpu")
        st = env.reset_fn_batch(port_keys(keys_np(B, 2)))
        ok = torch.arange(B) != 3
        pos, n = dbc.check(ok, "world in bounds", st.bodies.pos, st.t)
        assert torch.isnan(pos[3]).all() and not torch.isnan(pos[ok]).any()
        assert torch.equal(n, st.t)
        out, ts = env.step(st._replace(bodies=st.bodies._replace(pos=pos)), torch.zeros(B, 2))
        clean, _ = env.step(st, torch.zeros(B, 2))
        assert ts.truncated.tolist() == [i == 3 for i in range(B)]
        assert torch.isfinite(out.bodies.pos).all()
        assert torch.equal(out.bodies.pos[ok], clean.bodies.pos[ok])
        dbc.check(torch.tensor(True), "never violated")
        assert dbc.violation_counts()["world in bounds"] == 1
        assert "never violated" not in dbc.violations()
    finally:
        dbc.set_raise_on_violation(True)
        dbc.set_debug_checks(False)
        dbc.clear_violations()


def test_log_metrics_gated_and_timestep_metrics(capsys):
    env = LunarLander(device="cpu")
    states = env.reset_fn_batch(port_keys(keys_np(4, 0)))
    _, ts = env.step_batch(states, torch.zeros(4, 2))
    m = metrics.merge_metrics(metrics.timestep_metrics(ts), {"extra": torch.tensor(1.0)})
    assert set(m) >= {"mean_reward", "n_done", "reset_rate", "extra"}
    assert 0.0 <= float(m["reset_rate"]) <= 1.0
    metrics.log_metrics(m, step=0)
    assert "[metrics" not in capsys.readouterr().out
    metrics.set_debug_logging(True)
    try:
        metrics.log_metrics(m, step=3, every=2)
        assert "[metrics" not in capsys.readouterr().out
        metrics.log_metrics(m, step=4, every=2)
        out = capsys.readouterr().out
        assert "[metrics step=4]" in out and "mean_reward=" in out
    finally:
        metrics.set_debug_logging(False)
