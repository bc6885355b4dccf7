"""The ``robocup`` configuration (RoboCup SSL Division B, six robots a
team): its reference follows the program's plain path on the CPU over
several fragments; its world's shapes are the ones
``configs/robocup.json`` states; the fused step's bound on them is a
positive, finite time; and the hooks' reader sums the three hook spans."""

import math
from types import SimpleNamespace

import torch
from conftest import POLICY

from portbench import common, harness, roofline
from portbench.reference import plain

SPEC = harness.load_spec()
CONFIG = harness.config_of(SPEC, "robocup")


def test_reference_follows_the_program_over_fragments_on_cpu():
    dev = torch.device("cpu")
    env, ref = common.program_env(CONFIG, dev), plain.reference_env(CONFIG, dev)
    g = common.generator(2**31 + 23, dev)
    keys = common.keys(g, 24, dev)
    params = common.mlp_params(g, env.observation_size, env.action_size, POLICY, dev)
    state = env.reset_fn_batch(keys)
    assert common.reset_gap(ref.program_fields(state), ref.fields(ref.reset(keys))) == 0.0
    for _ in range(3):
        with torch.no_grad():
            final, traj = env.rollout_batch(state, common.mlp, 16, params, max_chunk=0)
        _, r_traj = plain.rollout(ref, ref.from_program(state), params, 16)
        assert float(common.step_gaps(traj, r_traj).max()) <= 1e-5
        state = final


def test_world_shapes_are_division_b():
    world = common.program_env(CONFIG, "cpu").world
    sh = roofline.world_shapes(world, harness.per_world_parts(world, CONFIG))
    assert sh["n_bodies"] == 17 and sh["n_contacts"] == 169 and sh["per_world_parts"] == []
    assert [(g["kernel"], len(g["part_a"])) for g in sh["groups"]] == [
        ("cc", 78), ("cb", 78), ("area_cb", 13)]
    for n_active in (0, 169 * 32768):
        b = roofline.fused_bound(sh, n_active, 32768)
        assert b["ms"] > 0 and math.isfinite(b["ms"])


def test_hook_kernels_reads_the_three_hook_spans():
    read = harness.reader("hook_kernels.rollout").read
    rec = SimpleNamespace(host_s={"px.pre": 1.0, "px.post": 1.0, "px.obs": 1.0, "px.step": 1.0},
                          kernels={"px.pre": 64, "px.post": 96, "px.obs": 32, "px.step": 500},
                          steps=32)
    assert read(SimpleNamespace(spans=rec)) == 6.0
    rec.host_s = {"px.step": 1.0}  # a program without the hook spans
    assert read(SimpleNamespace(spans=rec)) is None
    assert read(SimpleNamespace(spans=None)) is None
