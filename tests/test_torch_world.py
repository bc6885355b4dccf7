"""The port's static world description against the JAX package's.

The lander's pair table and body parameters must be the JAX World's, lane
for lane; and importing the port must not import jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu_torch.envs.lunar_lander import LunarLander

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds():
    return JaxLander().world, LunarLander(device="cpu").world


@pytest.mark.parametrize("point", ["groups", "body_a", "body_b", "partner", "params"])
def test_lander_world_matches_jax(worlds, point):
    jw, tw = worlds
    if point == "groups":
        assert len(tw.table.groups) == len(jw.table.groups) == 1
        for g_t, g_j in zip(tw.table.groups, jw.table.groups):
            for f in ("kernel", "part_a", "part_b", "body_a", "body_b"):
                assert getattr(g_t, f) == getattr(g_j, f), f
    elif point == "params":
        for f in ("mass", "inertia", "elasticity", "friction"):
            np.testing.assert_array_equal(
                getattr(tw.params, f).numpy(), np.asarray(getattr(jw.params, f)), f
            )
        np.testing.assert_array_equal(tw.params.inv_mass.numpy()[3], 0.0)
        assert tw.static_bodies == jw.static_bodies
    else:
        assert getattr(tw.table, point) == getattr(jw.table, point)
        assert tw.table.n_contacts == 48


def test_lander_parts_and_joints_match_jax(worlds):
    jw, tw = worlds
    np.testing.assert_array_equal(tw.parts.verts.numpy(), np.asarray(jw.parts.verts))
    assert (tw.parts.kind, tw.parts.nverts, tw.parts.body) == (
        jw.parts.kind, jw.parts.nverts, jw.parts.body
    )
    assert (tw.joints.body_a, tw.joints.body_b) == (jw.joints.body_a, jw.joints.body_b)
    for f in ("anchor_a", "anchor_b", "kp", "kd", "v0"):
        np.testing.assert_array_equal(
            getattr(tw.joints, f).numpy(), np.asarray(getattr(jw.joints, f))
        )


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys\n"
        "import parallax_tpu_torch.envs.lunar_lander\n"
        "import parallax_tpu_torch.ops.contact_solver\n"
        "import parallax_tpu_torch.parallel.rollout\n"
        "import parallax_tpu_torch.utils.convert\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'parallax_tpu'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    done = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert done.returncode == 0, done.stderr


def test_unported_kernels_and_modes_raise():
    """Every pair kind of the pair table runs on the batched step, a box on
    a box (bb) among them; what raises is a kind the fused kernels lack,
    as the JAX package's do (a circle on a polygon, cp: ValueError naming
    the split step, under autograd and without), and the per-world solver
    modes, with JAX's ``ValueError`` naming ``World.step``."""
    from torch_scenarios import pair_world

    from parallax_tpu_torch.engine.batched import physics_core
    from parallax_tpu_torch.engine.world import WorldConfig
    from parallax_tpu_torch.ops import fused_step

    for config in ({}, {"use_cuda_fused": True}):
        world, s = pair_world("bb", **config)
        out, con = physics_core(world, s)
        assert con.active.shape == (1, 1) and con.active.all()
        assert torch.isfinite(out.py).all() and out.py[0, 0] > s.py[0, 0]  # pushed up
    world, s = pair_world("cp")
    out, con = physics_core(world, s)
    assert con.active.all() and out.py[0, 0] > s.py[0, 0]
    with pytest.raises(ValueError, match="split step"):
        pair_world("cp", use_cuda_fused=True)
    with pytest.raises(ValueError, match="split step"):
        fused_step.check_fused_step(world)
    for grad in (False, True):
        px = s.px.clone().requires_grad_(grad)
        with pytest.raises(ValueError, match="split step"):
            fused_step.physics_core_fused(world, s._replace(px=px))
    world_gs, _ = pair_world("bb", solver_mode="gauss_seidel")
    with pytest.raises(ValueError, match="block.*World.step.*vmap"):
        physics_core(world_gs, s)
    assert WorldConfig().solver_mode == "block"


@pytest.mark.parametrize("entry", ["LunarLander", "World.build", "convert"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """The entry points run on the GPU unless the caller asks for the CPU:
    without a CUDA device their default raises and never falls back."""
    import inspect

    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import polygon
    from parallax_tpu_torch.utils import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    box = [BodyDef(shapes=[polygon([(0, 0), (1, 0), (1, 1), (0, 1)])])]
    make, fn = {
        "LunarLander": (LunarLander, LunarLander.__init__),
        "World.build": (lambda: World.build(box, WorldConfig()), World.build),
        "convert": (lambda: convert.soa_from_numpy([np.zeros((1, 1))] * 6),
                    convert.soa_from_numpy),
    }[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
