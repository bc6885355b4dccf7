"""The batched collide's area kinds against the JAX package.

The box-area and hexagon-area worlds of ``tests/test_area_containment.py:103``
and ``:145`` (``tests/torch_scenarios.py:KIND_WORLDS``) hold a triangle, a
box and a circle inside an area box or an area hexagon: the kinds
``area_pb``, ``area_bb`` and ``area_cb``, or ``area_cp``, ``area_pp`` and
``area_bp``, with ``bp``, ``cp`` and ``cb`` between the contained bodies.
The lanes and their VJP are held to the JAX package's as in
``test_torch_collide_kinds.py`` (whose helpers this file uses), with the
same tolerances.  The area lanes' extents are ``amax``/``amin``, which
split a tie's cotangent evenly over the tied vertices as JAX's ``max`` and
``min`` do; the triangle's base and the box's sides are axis-aligned (the
perturbations leave the angles alone), so in the box area every extent
of the box ties, and so does the triangle's lowest.
"""

import pytest
from test_torch_collide_kinds import check_lanes, check_vjp, collide_scene

KINDS = {
    "box_area": {"area_pb", "area_bb", "area_cb", "bp", "cp", "cb"},
    "hex_area": {"area_cp", "area_pp", "area_bp", "bp", "cp", "cb"},
}


@pytest.fixture(scope="module", params=list(KINDS))
def scene(request):
    return request.param, collide_scene(request.param)


def test_collide_matches_jax(scene):
    name, sc = scene
    check_lanes(sc, KINDS[name])


def test_collide_vjp_matches_jax(scene):
    name, sc = scene
    check_vjp(sc)
    if name == "box_area":
        # the triangle (body 0) is pushed back up through its tied base,
        # and the box (body 1) back in through its tied sides
        act = sc["got"].active
        tri_below = sc["got"].pen_y.detach()[3] > 0  # area_pb lanes pushing up
        assert (tri_below & act[3]).any()
        assert (sc["got_vjp"][1][0] != 0).any() and (sc["got_vjp"][0][1] != 0).any()
