"""Collide and the contact solve (+ joints) against the JAX package.

The scenario is ``tests/test_pallas_solver.py``'s at B=128, built with the
port: lander lowered by 6.2 with ``vy -= 0.6``, 40 zero-action steps, then
``collide_batched``.  It reaches JAX through numpy.  Tolerance: atol 1e-5,
the bar the JAX package sets between its Pallas kernel and its XLA path;
the two frameworks agree to float32 rounding (XLA fuses multiply-adds and
sums in another order), not bit for bit.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.engine import batched as jb
from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu.ops.pallas_solver import _build_operands, solve_contacts_pallas
from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.ops import contact_solver
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)

B = 128
ATOL = 1e-5


def lowered_start(env, B, seed=0):
    keys = np.random.default_rng(seed).integers(0, 2**32, (B, 2), dtype=np.uint32)
    st = env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)).to(env.device))
    b = st.bodies
    shift = torch.tensor([0.0, 6.2], device=env.device)
    kick = torch.tensor([0.0, 0.6], device=env.device)
    return st._replace(bodies=b._replace(pos=b.pos - shift, vel=b.vel - kick))


def contact_scenario(env, B):
    """Port-side scenario: (s, con, terrain override) after 40 steps."""
    st = lowered_start(env, B)

    def zero(_, obs):
        return torch.zeros((obs.shape[0], 2), device=obs.device)

    st, _ = env.rollout_batch(st, zero, 40)
    aux = env.plane_pack(st)
    override = {p: (aux.tox[i], aux.toy[i]) for i, p in enumerate(env._ground_parts)}
    s = tb._to_soa(st.bodies)
    return s, tb.collide_batched(env.world, s, override), override


@pytest.fixture(scope="module")
def scenario():
    env = LunarLander(device="cpu")
    s, con, override = contact_scenario(env, B)
    jenv = JaxLander()
    s_j = jb._SoA(*(jnp.asarray(x) for x in convert.to_numpy(s)))
    ov_j = {p: (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())) for p, (x, y) in override.items()}
    con_j = jb.ContactsBM(*(jnp.asarray(x) for x in convert.to_numpy(con)))
    return env, jenv, s, con, ov_j, s_j, con_j


def _close(got, want, what):
    for f in got._fields:
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            atol=ATOL, rtol=0, err_msg=f"{what}.{f}",
        )


def test_collide_matches_jax(scenario):
    env, jenv, s, con, ov_j, s_j, _ = scenario
    want = jax.jit(lambda s: jb.collide_batched(jenv.world, s, ov_j))(s_j)
    assert int(con.active.sum()) > 100, "scenario must have real contacts"
    np.testing.assert_array_equal(con.active.numpy(), np.asarray(want.active))
    for f in ("pen_x", "pen_y", "pt_x", "pt_y", "weight"):
        np.testing.assert_allclose(
            getattr(con, f).numpy(), np.asarray(getattr(want, f)),
            atol=ATOL, rtol=0, err_msg=f,
        )


@pytest.mark.parametrize("position_iterations", [2, 0])
def test_plain_solver_with_joints_matches_jax(scenario, position_iterations):
    env, jenv, s, con, _, s_j, con_j = scenario
    assert int(con.active.sum()) > 100
    cfg = jenv.world.config.contact
    got = contact_solver.solve_contacts(
        env.world, s, con, 3, position_iterations, 0.01, env.world.config.contact
    )
    want = jax.jit(
        lambda s, c: jb.apply_joints_bm(
            jenv.world,
            jb.solve_contacts_bm(jenv.world, s, c, 3, position_iterations, 0.01, cfg),
        )
    )(s_j, con_j)
    _close(got, want, "solve_contacts_bm+apply_joints_bm")
    moved = np.abs(got.vy.numpy() - s.vy.numpy()).max()
    assert moved > 1e-3, "the solve must change velocities"


@pytest.mark.parametrize("position_iterations", [2, 0])
def test_plain_solver_with_joints_matches_pallas_interpret(scenario, position_iterations):
    env, jenv, s, con, _, s_j, con_j = scenario
    got = contact_solver.solve_contacts(
        env.world, s, con, 3, position_iterations, 0.01, env.world.config.contact
    )
    want = jax.jit(
        lambda s, c: solve_contacts_pallas(
            jenv.world, s, c, 3, position_iterations, 0.01,
            jenv.world.config.contact, interpret=True, with_joints=True,
        )
    )(s_j, con_j)
    _close(got, want, "solve_contacts_pallas")


def test_restitution_mode_mean_matches_jax(scenario):
    """The plain solver honours restitution_mode like solve_contacts_bm
    (the Pallas kernel always takes the min; ROADMAP Queue 3)."""
    env, jenv, s, con, _, s_j, con_j = scenario
    cfg_t = ContactSolverConfig(restitution_mode="mean")
    cfg_j = dataclasses.replace(jenv.world.config.contact, restitution_mode="mean")
    got = tb.solve_contacts_bm(env.world, s, con, 3, 2, 0.01, cfg_t)
    want = jb.solve_contacts_bm(jenv.world, s_j, con_j, 3, 2, 0.01, cfg_j)
    _close(got, want, "solve_contacts_bm(mean)")


def test_solver_operands_match_jax_lane_constants(scenario):
    env, jenv, *_ = scenario
    ops = contact_solver.solver_operands(env.world, env.world.config.contact)
    ref = _build_operands(jenv.world)
    # rows 0..5 of the JAX lane_const: im_a, im_b, ii_a, ii_b, e(min), mu
    np.testing.assert_array_equal(ops.lane_const.numpy(), ref["lane_const"][:6])
    partner = np.asarray(jenv.world.table.partner)
    C = len(partner)
    np.testing.assert_array_equal(ops.partner.numpy(), partner)
    np.testing.assert_array_equal(
        ref["lane_const"][6], (partner > np.arange(C)).astype(np.float32)
    )
    np.testing.assert_array_equal(ops.movable.numpy(), [1, 1, 1, 0])
    assert ops.joint_f.shape == (4, 7) and ops.body_a.dtype == torch.int32
    mean = contact_solver.solver_operands(
        env.world, ContactSolverConfig(restitution_mode="mean")
    )
    el = env.world.params.elasticity.numpy()
    ia, ib = np.asarray(env.world.table.body_a), np.asarray(env.world.table.body_b)
    np.testing.assert_array_equal(mean.lane_const[4].numpy(), (el[ia] + el[ib]) / 2)


def test_wrapper_runs_plain_version_on_cpu_without_launching(scenario):
    env, _, s, con, *_ = scenario
    before = contact_solver.launches
    got = contact_solver.solve_contacts(env.world, s, con, 3, 2, 0.01, env.world.config.contact)
    want = contact_solver.solve_contacts_plain(
        env.world, s, con, 3, 2, 0.01, env.world.config.contact
    )
    assert contact_solver.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_planes_and_contacts_cross_from_jax_through_numpy(scenario):
    _, _, s, con, _, s_j, con_j = scenario
    for a, b in zip(convert.soa_from_numpy(s_j, device="cpu"), s):
        assert torch.equal(a, b)
    back = convert.contacts_from_numpy(con_j, device="cpu")
    assert back.active.dtype == torch.bool
    for a, b in zip(back, con):
        assert torch.equal(a, b)


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
open(args[args.index("-o") + 1], "w").write("built")
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
sys.exit(1 if {fail!r} and any(a.endswith({fail!r}) for a in args) else 0)
"""


@pytest.mark.parametrize("fail", ["", "contact_solver_bwd.cu"])
def test_kernel_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail):
    """``_build.build`` with a stand-in for nvcc: one compile per ``csrc``
    source, then one link into the library and its stamp; when a compile
    fails it raises with the command and leaves no object, library or
    stamp behind."""
    from parallax_tpu_torch.ops import _build

    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log), fail=fail))
    nvcc.chmod(0o755)
    out = tmp_path / "kernels"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    sources = _build._sources()
    assert {p.name for p in sources} >= {"contact_solver.cu", "contact_solver_bwd.cu"}
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed.*contact_solver_bwd.cu"):
            _build.build()
        assert sorted(p.name for p in out.iterdir()) == []
        return
    lib = _build.build()
    calls = log.read_text().splitlines()
    assert len(calls) == len(sources) + 1
    assert sorted(c.split()[-1] for c in calls[:-1]) == sorted(map(str, sources))
    assert all(" -c " in c and "--fmad=false" in c for c in calls[:-1])
    assert " -shared " in calls[-1]
    assert sorted(p.name for p in out.iterdir()) == [lib.name, lib.name + ".sha256"]
    assert _build.build() == lib and len(log.read_text().splitlines()) == len(calls)
