"""The plain reference's PRNG against known answers: Threefry-2x32's own
test vector (Salmon et al. 2011) and JAX's split and uniform draws for two
keys, as JAX 0.9 gives them."""

import torch

from portbench.reference import threefry

KEYS = torch.tensor([[0x12345678, 0x9ABCDEF0], [0, 42]], dtype=torch.int64)


def test_threefry_matches_its_published_test_vector():
    zero = torch.zeros(1, dtype=torch.int64)
    x0, x1 = threefry.threefry2x32(zero, zero, zero, zero)
    assert (int(x0), int(x1)) == (0x6B200159, 0x99BA4EFE)


def test_split_matches_jax():
    assert threefry.split(KEYS, 3).tolist() == [
        [[3978822521, 2696639427], [2085429205, 1499321931], [1630462717, 2825784901]],
        [[1832780943, 270669613], [64467757, 2916123636], [2465931498, 255383827]],
    ]


def test_uniform_matches_jax_bit_for_bit():
    bits = threefry.uniform(KEYS, 3, -5.0, 5.0).view(torch.int32).tolist()
    assert [[b % 2**32 for b in row] for row in bits] == [
        [3220971216, 3227735564, 1077355086], [3186047584, 1072047088, 1066718168]]


def _contact_case(name, batch, seed):
    from conftest import POLICY
    from portbench import common, harness
    from portbench.reference import plain

    spec = harness.load_spec()
    cfg = harness.config_of(spec, name)
    dev = torch.device("cpu")
    env, ref = common.program_env(cfg, dev), plain.reference_env(cfg, dev)
    g = common.generator(seed, dev)
    params = common.mlp_params(g, env.observation_size, env.action_size, POLICY, dev)
    ps = env.reset_fn_batch(common.keys(g, batch, dev))
    b = ps.bodies
    pos, vel = b.pos.clone(), b.vel.clone()
    if name == "lunarlander":  # the craft a little above the pad, falling
        pos[..., 0] += ((torch.rand(batch, generator=g) - 0.5) * 8)[:, None]
        pos[:, :3, 1] += -6.0 + 0.3 * torch.rand(batch, generator=g)[:, None]
        vel[:, :3, 1] = -0.5 * torch.rand(batch, generator=g)[:, None]
    else:  # every ball moving
        vel[:, :-4] = (torch.rand(vel[:, :-4].shape, generator=g) - 0.5) * 4
    ps = ps._replace(bodies=b._replace(pos=pos, vel=vel))
    with torch.no_grad():
        _, traj = env.rollout_batch(ps, common.mlp, 8, params, max_chunk=0)
    _, r_traj = plain.rollout(ref, ref.from_program(ps), params, 8)
    return traj, r_traj


def test_reference_follows_the_program_through_contacts_on_cpu():
    """Landers dropped onto the terrain and billiards with every ball moving:
    8 steps of the program's plain path and of the reference agree (the
    reference is written independently; only rounding may differ)."""
    from portbench import common

    for name, batch in (("lunarlander", 32), ("billiards48", 4)):
        traj, r_traj = _contact_case(name, batch, 2**31 + 21)
        assert float(common.step_gaps(traj, r_traj).max()) <= 1e-5, name
        if name == "lunarlander":
            assert bool(traj.terminated.any()), "no lander reached the ground"
