"""The fused step's reverse pass (``ops/fused_step.py``) on the CPU.

The scenario is ``tests/test_torch_fused_step.py``'s (its module-scoped
``fused`` fixture: B=128, the lowered lander after 40 zero-action steps,
world ``BAD`` poisoned by a NaN velocity), with the terrain tilted by a
slope of ``TILT``: on the flat pad the contact faces are axis-aligned and
the terrain's x cotangent is exactly zero, in JAX as in the port.

* The reverse pass's plain version (autograd of ``fused_step_plain``)
  against ``jax.vjp`` of the JAX split step: rtol 2e-4, atol 1e-5, the bar
  the JAX package sets between its fused reverse kernel and its XLA VJP
  (the frameworks sum in another order).
* ``_FusedStep``, the card's autograd path, with its launches swapped for
  the plain versions: its cotangents equal the plain VJP's exactly.
* The train path through the fused step equals the split one to the bit.

These tests sit in a file of their own, not in ``test_torch_fused_step.py``,
so that the suite's ``--dist loadfile`` runs, which hand out files with more
tests first, start them after ``tests/test_grad_fd_oracle.py``, the longest
file, rather than before it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_contact_solver import lowered_start
from test_torch_fused_step import BAD, B, fused  # noqa: F401 (the fixture)

from parallax_tpu.engine import batched as jb
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.ops import contact_solver, fused_step
from parallax_tpu_torch.parallel import rollout

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 2e-4
TILT = 0.05



def _tilted(override):
    return {p: (x, y + TILT * x) for p, (x, y) in override.items()}


def _cotangents(s, seed=5):
    rng = np.random.default_rng(seed)
    return tb._SoA(*(torch.from_numpy(rng.standard_normal(s.px.shape).astype(np.float32))
                     for _ in s))


def test_fused_bwd_plain_matches_jax_vjp(fused):
    """``fused_step_bwd_plain`` against ``jax.vjp`` of the JAX split step
    (``engine.batched.physics_core``, broadphase off), the plain reference
    the JAX package holds ``_step_bwd_kernel`` to
    (``tests/test_pallas_solver.py::test_fused_step_bwd_kernel_matches_xla_vjp``,
    rtol 2e-4, atol 1e-5).  The interpret-mode kernel itself is not the
    reference here: ``jax.grad`` through it takes about 77 s cold on a CPU
    against 34 s for ``jax.jit(jax.grad)`` of the split step (this eager
    ``jax.vjp`` about 23 s), and that JAX test already links the two.  The
    NaN world is left out: there the split path and the fused step differ
    by design (ROADMAP Queue 3)."""
    env, jenv, s, override, _ = fused
    override = _tilted(override)
    cot = _cotangents(s)
    ds, dtx, dty = fused_step.fused_step_bwd_plain(env.world, s, override, cot)

    parts = list(env._ground_parts)
    s_j = jb._SoA(*(jnp.asarray(x.numpy()) for x in s))
    tox = jnp.asarray(np.stack([override[p][0].numpy() for p in parts]))
    toy = jnp.asarray(np.stack([override[p][1].numpy() for p in parts]))

    def step(s_j, tox, toy):
        ov = {p: (tox[i], toy[i]) for i, p in enumerate(parts)}
        return jb.physics_core(jenv.world, s_j, terrain_override=ov)[0]

    _, vjp = jax.vjp(step, s_j, tox, toy)
    ds_j, dtox_j, dtoy_j = vjp(jb._SoA(*(jnp.asarray(c.numpy()) for c in cot)))

    finite = np.arange(B) != BAD
    V = fused_step.MAX_VERTS
    want = {f: np.asarray(getattr(ds_j, f)) for f in s._fields}
    got = {f: getattr(ds, f).numpy() for f in s._fields}
    for k, p in enumerate(sorted(parts)):
        i = parts.index(p)
        for name, plane, ref in (("dtx", dtx, dtox_j), ("dty", dty, dtoy_j)):
            got[f"{name}[{p}]"] = plane[k * V:(k + 1) * V].numpy()
            want[f"{name}[{p}]"] = np.asarray(ref[i])
    for key in got:
        np.testing.assert_allclose(got[key][:, finite], want[key][:, finite],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for name, plane in (*zip(s._fields, ds), ("dtx", dtx), ("dty", dty)):
        assert np.abs(plane.numpy()[:, finite]).max() > 0, f"{name}: the VJP must be alive"
    assert dtx.shape == dty.shape == (len(parts) * V, B)


def _plain_launches(monkeypatch):
    """Swap the two kernel launches for the plain versions (the CPU has no
    card): the forward returns ``(s, active)``, the backward ``(ds, dtx,
    dty)``, as the launches do."""

    def step(statics, s, tx, ty):
        world, tparts, dt, accel = statics
        out, con = fused_step.fused_step_plain(
            world, s, fused_step._split(tparts, tx, ty), dt, accel
        )
        return out, con.active

    def bwd(statics, s, tx, ty, grads):
        world, tparts, dt, accel = statics
        return fused_step.fused_step_bwd_plain(
            world, s, fused_step._split(tparts, tx, ty), grads, dt, accel
        )

    monkeypatch.setattr(fused_step, "_step_cuda", step)
    monkeypatch.setattr(fused_step, "_fused_bwd_cuda", bwd)


def test_fused_step_function_cotangent_structure(fused, monkeypatch):
    """``_FusedStep`` (the card's autograd path) with its two launches
    swapped for the plain versions, as ``tests/test_torch_train.py`` does
    for ``_ContactSolve``: one cotangent per input, ``None`` for the
    statics, none into ``active``; ``torch.cat``'s backward routes the
    terrain cotangents to each part; the cotangents are
    ``fused_step_bwd_plain``'s."""
    env, _, s, override, _ = fused
    override = _tilted(override)
    _plain_launches(monkeypatch)
    tparts = tuple(sorted(override))
    statics = (env.world, tparts, None, None)
    parts = {p: tuple(x.clone().requires_grad_(True) for x in xy) for p, xy in override.items()}
    body = [x.clone().requires_grad_(True) for x in s]
    tx, ty = fused_step._terrain_planes(parts, tparts, s.px)
    *out, active = fused_step._FusedStep.apply(statics, tx, ty, *body)
    assert all(o.grad_fn is not None for o in out), "the step must carry a grad_fn"
    assert not active.requires_grad and active.dtype == torch.bool
    cot = _cotangents(s)
    leaves = [x for p in tparts for x in parts[p]]
    got = torch.autograd.grad(out, (*leaves, *body), tuple(cot))

    ctx = type("Ctx", (), {})()
    ctx.statics = statics
    ctx.saved_tensors = (*fused_step._terrain_planes(override, tparts, s.px), *s)
    grads = fused_step._FusedStep.backward(ctx, *cot, torch.zeros_like(active))
    assert len(grads) == 1 + 2 + 6 and grads[0] is None
    ref_s, ref_tx, ref_ty = fused_step.fused_step_bwd_plain(env.world, s, override, cot)
    V = fused_step.MAX_VERTS
    for k, p in enumerate(tparts):
        assert _same(got[2 * k], ref_tx[k * V:(k + 1) * V])
        assert _same(got[2 * k + 1], ref_ty[k * V:(k + 1) * V])
    for a, b, c in zip((*got[len(leaves):], grads[1], grads[2]), (*ref_s, ref_tx, ref_ty),
                       (*grads[3:], ref_tx, ref_ty)):
        assert _same(a, b) and _same(b, c)


def _same(a, b):
    """Equal, with NaN where the other is NaN (the poisoned world)."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _mlp_params():
    rng = np.random.default_rng(0)
    arrays = {
        "w1": rng.standard_normal((9, 32)) * 0.3, "b1": np.zeros(32),
        "w2": rng.standard_normal((32, 2)) * 0.1, "b2": np.zeros(2),
    }
    return {k: torch.tensor(v, dtype=torch.float32, requires_grad=True) for k, v in arrays.items()}


def _mlp(p, obs):
    return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


@pytest.mark.parametrize("remat_steps", [False, True])
def test_fused_train_step_on_cpu_equals_split(fused, remat_steps):
    """The train path through the fused step on the CPU (autograd of its
    plain version) equals the split broadphase-off train path to the bit:
    B=16, h=8, 2 checkpoint segments, from a contact start.  Nothing is
    launched."""
    env = fused[0]
    split_env = LunarLander(LanderConfig(broadphase=False), device="cpu")
    st = lowered_start(env, 16, seed=4)
    counts = (fused_step.launches, fused_step.bwd_launches,
              contact_solver.launches, contact_solver.bwd_launches)
    res = []
    for e in (env, split_env):
        params = _mlp_params()
        loss_fn = rollout.make_loss_fn(e, _mlp, 8, 2, remat_steps=remat_steps)
        loss, _ = loss_fn(params, st)
        res.append((loss, torch.autograd.grad(loss, list(params.values()))))
    (loss_f, grads_f), (loss_s, grads_s) = res
    assert torch.equal(loss_f, loss_s)
    for a, b in zip(grads_f, grads_s):
        assert torch.equal(a, b) and a.abs().max() > 0
    assert counts == (fused_step.launches, fused_step.bwd_launches,
                      contact_solver.launches, contact_solver.bwd_launches) == (0, 0, 0, 0)
