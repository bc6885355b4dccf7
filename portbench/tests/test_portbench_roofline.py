"""The frozen roofline counts reproduce the anchors that the repository's
earlier chip runs read, from the configurations' own shapes."""

import ast
from pathlib import Path

import pytest

from portbench import common, harness, roofline

B = 8192


def shapes(name):
    spec = harness.load_spec()
    config = harness.config_of(spec, name)
    world = common.program_env(config, "cpu").world
    return roofline.world_shapes(world, harness.per_world_parts(world, config))


def test_solve_bound_billiards48_is_bytes_0_0610_ms():
    b = roofline.solve_bound(shapes("billiards48"), n_active=5000, B=B)
    assert b["by"] == "bytes"
    assert round(b["ms"], 4) == 0.0610


def test_fused_bound_lander_contact_scenario_is_159_3m_operations():
    sh = shapes("lunarlander")
    assert sh["per_world_parts"] == [3, 4, 5, 6, 7, 8, 9]
    b = roofline.fused_bound(sh, n_active=32768, B=B)
    assert b["by"] == "operations"
    assert round(b["ops"] / 1e6, 1) == 159.3
    assert round(b["ms"], 5) == 0.00238


@pytest.mark.parametrize("n_active", [0, 1000, 32768])
def test_bounds_grow_with_active_lanes_and_reverse_pass_exceeds_forward(n_active):
    sh = shapes("lunarlander")
    touched = [n_active // 24] * 24
    fwd = roofline.fused_bound(sh, n_active, B)
    bwd = roofline.fused_bwd_bound(sh, n_active, touched, B)
    assert bwd["ops"] > fwd["ops"]
    assert roofline.fused_bound(sh, n_active + 1, B)["ops"] > fwd["ops"]


def test_roofline_imports_nothing_of_the_program():
    tree = ast.parse(Path(roofline.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.split(".")[0].startswith("parallax_tpu")]
