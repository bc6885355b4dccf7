"""The keyed replay of the reference collider on the lander's world
against the JAX package's.

``engine/ref_replay.py:resolve_reference_keyed`` on the lander's world
(its hull, legs and seven ground squares: buckets ``('Polygon4',
'Polygon6')`` and ``('Polygon4', 'Polygon4')``, 25 cells of GJK and EPA)
touching its ground (``tests/torch_scenarios.py:lander_touch_state``),
B=8 worlds with numpy-made keys, under the reference impulse config:
velocities within 1e-5 of JAX's under ``jax.vmap``.  A file of its own:
the JAX reference is one compile of some 35 s.
"""

from test_torch_random_solvers import B, hold_keyed, keyed_worlds  # noqa: F401
from torch_scenarios import world_keys


def test_lander_keyed_resolve_matches_jax(keyed_worlds):  # noqa: F811
    hold_keyed(*keyed_worlds["lander"], world_keys(B, 51), "lander")
