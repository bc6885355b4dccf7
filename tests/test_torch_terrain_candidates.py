"""The lander's terrain-candidate windows (``LanderConfig(terrain_candidates=True)``) on the CPU.

The candidate world pairs each dynamic body with its own window of K
consecutive terrain segments (the lander 5, each leg 3: 28 contact lanes
where the full table has 48), gathered per world and step.  It is held
against the JAX package's candidate lander and against the port's own
full-table lander.  The scene is the JAX test's
(``tests/test_batched_engine.py:231``): the fleet scattered across the
whole terrain, down into the ground (``torch_scenarios.
lander_scatter_state``), numpy-seeded.  Tolerances:

* the candidate world's tables and the gathered windows: equal, to the
  bit (a selection is exact), NaN positions included; the windows' VJP
  within float32 rounding of ``jax.vjp`` (the cotangent of a segment
  chosen by two windows is a sum of two);
* 60 resynced steps: pos 1e-5, vel 1e-4 and the done flags equal against
  JAX's candidate lander; pos 1e-5 and vel 1e-4 against the port's full
  table with the leg flags equal (the JAX test's bars);
* the fused step's plain version on the candidate world against JAX's
  interpret-mode fused kernel: atol 1e-5, flags equal
  (``tests/test_torch_fused_step.py``'s bar);
* ``PARALLAX_REMAT_COLLIDE``: the split train step's loss and gradients
  equal to the bit with and without the switch.

The train steps against JAX's ``make_train_step`` are in
``tests/test_torch_terrain_candidates_train.py`` (one JAX compile of
about a minute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import jax_state, np_tree
from torch_scenarios import candidate_contact_case, lander_scatter_state

from parallax_tpu.engine import batched as jb
from parallax_tpu.envs.lunar_lander import LanderConfig as JaxLanderConfig
from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu.ops import pallas_step
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.ops import fused_step
from parallax_tpu_torch.parallel import rollout
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)

B, STEPS = 64, 60
CAND = LanderConfig(terrain_candidates=True)


@pytest.fixture(scope="module")
def envs():
    return (LunarLander(CAND, device="cpu"), LunarLander(device="cpu"),
            JaxLander(JaxLanderConfig(terrain_candidates=True)))


def test_candidate_world_matches_jax(envs):
    env, full, jenv = envs
    world, jworld = env._bm_world, jenv._bm_world
    assert world.table.n_contacts == jworld.table.n_contacts == 28
    assert full._bm_world.table.n_contacts == env.world.table.n_contacts == 48
    assert env._cand_parts == jenv._cand_parts == [(3, 5, 2), (8, 3, 1), (11, 3, 1)]
    assert len(world.parts.body) == len(jworld.parts.body) == 14
    for f in ("body_a", "body_b", "partner"):
        np.testing.assert_array_equal(np.asarray(getattr(world.table, f)),
                                      np.asarray(getattr(jworld.table, f)), err_msg=f)
    for g, jg in zip(world.table.groups, jworld.table.groups, strict=True):
        assert (g.kernel, g.size) == (jg.kernel, jg.size)
        assert tuple(g.part_a) == tuple(jg.part_a)
        assert tuple(g.part_b) == tuple(jg.part_b)
    for f in ("left_leg", "right_leg", "lander_ground"):
        np.testing.assert_array_equal(getattr(env, f"_bm_{f}_lanes").numpy(),
                                      getattr(jenv, f"_bm_{f}_lanes"), err_msg=f)
        # the per-world path keeps the full world's lanes
        np.testing.assert_array_equal(getattr(env, f"_{f}_lanes").numpy(),
                                      getattr(jenv, f"_{f}_lanes"), err_msg=f)


def test_candidate_windows_match_jax_to_the_bit(envs):
    """``_candidate_override`` against JAX's select chains: every x from
    the scattered fleet, each segment's left edge exactly, and a NaN (its
    window starts at segment 0 in both); then its VJP."""
    env, _, jenv = envs
    st = lander_scatter_state(env, B)
    aux = env.plane_pack(st)
    px = st.bodies.pos[:, :3, 0].T.contiguous()  # [3, B]
    edges = aux.tox.amin(dim=1)  # [7, B]
    k = torch.arange(7)
    px[0, k] = edges[k, k]  # world k's lander on its segment k's left edge
    px[1, 7 + k] = edges[k, 7 + k]
    px[:, 20] = float("nan")
    px[2, 21] = float("inf")
    got = env._candidate_override(px, aux.tox, aux.toy)
    want = jenv._candidate_override(*(jnp.asarray(x.numpy()) for x in (px, aux.tox, aux.toy)))
    assert sorted(got) == sorted(want) == list(range(3, 14))
    for p in want:
        for g, w in zip(got[p], want[p]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"part {p}")

    # the cotangent reaches each window's chosen segment only
    rng = np.random.default_rng(2)
    cot = {p: [rng.standard_normal(tuple(got[p][0].shape)).astype(np.float32)
               for _ in range(2)] for p in got}
    tox, toy = (x.clone().requires_grad_(True) for x in (aux.tox, aux.toy))
    out = env._candidate_override(px, tox, toy)
    loss = sum((out[p][i] * torch.from_numpy(cot[p][i])).sum() for p in out for i in range(2))
    g_tox, g_toy = torch.autograd.grad(loss, (tox, toy))
    _, vjp = jax.vjp(lambda x, y: jenv._candidate_override(jnp.asarray(px.numpy()), x, y),
                     jnp.asarray(aux.tox.numpy()), jnp.asarray(aux.toy.numpy()))
    w_tox, w_toy = vjp({p: tuple(jnp.asarray(c) for c in cot[p]) for p in cot})
    for g, w in ((g_tox, w_tox), (g_toy, w_toy)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        assert ((g.numpy() == 0) == (np.asarray(w) == 0)).all()


def test_candidate_steps_match_jax_and_full_table(envs):
    """60 steps from the scattered fleet, each from the same state (the
    port's candidate trajectory), through the port's candidate lander,
    JAX's candidate lander and the port's full table."""
    env, full, jenv = envs
    st = lander_scatter_state(env, B)
    acts = torch.zeros((B, 2))
    jacts = jnp.zeros((B, 2))
    jlike = jenv.reset_fn_batch(jnp.zeros((B, 2), jnp.uint32))
    jstep = jax.jit(jenv.step_batch)
    contacts = 0
    for _ in range(STEPS):
        sc, tc = env.step_batch(st, acts)
        sf, tf = full.step_batch(st, acts)
        sj, tj = jstep(jax_state(jlike, convert.lander_state_to_numpy(st)), jacts)
        got, want = convert.lander_state_to_numpy(sc), np_tree(sj)
        np.testing.assert_allclose(got["bodies.pos"], want["bodies.pos"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["bodies.vel"], want["bodies.vel"], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got["leg_contacts"], want["leg_contacts"])
        for f in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(tj, f)))
        np.testing.assert_allclose(sc.bodies.pos.numpy(), sf.bodies.pos.numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(sc.bodies.vel.numpy(), sf.bodies.vel.numpy(), atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(sc.leg_contacts.numpy(), sf.leg_contacts.numpy())
        contacts += int(sc.leg_contacts.sum())
        st = sc
    assert contacts > 0, "no leg ever touched the ground"


def test_fused_candidate_plain_matches_jax_kernel():
    """The fused step's plain version on the candidate world (11 override
    parts) against JAX's fused kernel in interpret mode, on the lander's
    contact scenario."""
    env = LunarLander(LanderConfig(terrain_candidates=True, broadphase=False,
                                   use_cuda_fused=True), device="cpu")
    jenv = JaxLander(JaxLanderConfig(terrain_candidates=True, broadphase=False))
    s, override = candidate_contact_case(env, 128)
    assert len(override) == 11
    got_s, got_c = fused_step.fused_step_plain(env._bm_world, s, override)
    ov_j = {p: (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())) for p, (x, y) in override.items()}
    want_s, want_c = jax.jit(lambda x: pallas_step.physics_core_pallas(
        jenv._bm_world, x, terrain_override=ov_j, interpret=True))(
        jb._SoA(*(jnp.asarray(x.numpy()) for x in s)))
    assert int(got_c.active.sum()) > 100, "the scenario must have real contacts"
    np.testing.assert_array_equal(got_c.active.numpy(), np.asarray(want_c.active))
    for f, g, w in zip(got_s._fields, got_s, want_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=f)
    # and the env's fused step takes it: the same planes as the split step
    split = LunarLander(LanderConfig(terrain_candidates=True, broadphase=False), device="cpu")
    ref_s, _ = tb.physics_core(split._bm_world, s, terrain_override=override)
    for g, w in zip(got_s, ref_s):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


def test_remat_collide_keeps_loss_and_gradients(monkeypatch):
    """``PARALLAX_REMAT_COLLIDE`` (``engine/batched.py:_REMAT_COLLIDE``)
    recomputes the collide in the backward pass: the split train step's
    loss and policy gradients equal those without it to the bit, on the
    candidate lander (a terrain override) and through ``step_batched`` on
    billiards (no override); the collide runs once more per step."""
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig

    env = LunarLander(CAND, device="cpu")
    st = lander_scatter_state(env, 8, seed=3)
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((9, 2)).astype(np.float32) * 0.3,
              "b": np.zeros(2, np.float32)}

    def policy(p, obs):
        return torch.tanh(obs @ p["w"] + p["b"])

    table = Billiards(BilliardsConfig(n_object=3), device="cpu")
    b0 = tb._to_soa(table.reset_fn_batch(torch.zeros((4, 2), dtype=torch.int64)).bodies)
    b0 = b0._replace(vx=b0.vx + torch.linspace(-1.0, 2.0, b0.vx.numel()).reshape(b0.vx.shape))

    calls = {"n": 0}
    collide = tb.collide_batched

    def counted(*args, **kwargs):
        calls["n"] += 1
        return collide(*args, **kwargs)

    monkeypatch.setattr(tb, "collide_batched", counted)

    def run(remat):
        monkeypatch.setattr(tb, "_REMAT_COLLIDE", remat)
        calls["n"] = 0
        params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in arrays.items()}
        loss, _ = rollout.make_loss_fn(env, policy, 4, checkpoint_segments=2)(params, st)
        grads = torch.autograd.grad(loss, list(params.values()))
        kick = torch.zeros(1, requires_grad=True)
        s = b0._replace(vx=b0.vx + kick)
        for _ in range(3):
            s, _ = tb.physics_core(table.world, s)
        (g_kick,) = torch.autograd.grad(s.px.sum(), kick)
        return loss.detach(), grads, g_kick, calls["n"]

    loss0, grads0, kick0, n0 = run(False)
    loss1, grads1, kick1, n1 = run(True)
    assert torch.equal(loss0, loss1)
    for a, b in zip(grads0, grads1):
        assert torch.equal(a, b)
    assert torch.equal(kick0, kick1) and kick0.abs().item() > 0
    # lander: forward 4 + the segments' recompute 4 (+ 4 recomputes of the
    # collide under remat); billiards: 3 (+ 3)
    assert (n0, n1) == (8 + 3, 12 + 6), (n0, n1)
