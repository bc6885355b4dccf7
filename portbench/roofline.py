"""The yardstick's roofline arithmetic: the least time the card could take
for one call of a kernel, counted from the configuration's own shapes and
the run's active lanes, never from the program's own kernel operands.

The shapes are read once at set-up from the world's public tables
(:func:`world_shapes`) and written into the run's output; the counts below
are a frozen copy of the arithmetic the repository's ``chip_smoke.py`` used
(``solver_bound_ms``, ``fused_bound_ms``, ``fused_bwd_bound_ms``), rewritten
over those shapes.  Peaks are NVIDIA's data sheet for the H100 SXM part at
its 700 W limit: HBM 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
F32_FLOPS = 67e12
MAX_VERTS = 8  # vertex rows a part holds (geometry/shapes.py of the port)

# float32 operations of one lane of each analytic pair kind, counted from
# csrc/fused_step.cuh (CcLane, CbLane, AreaCbLane, BbLane), and of their
# adjoints in csrc/fused_step_bwd.cu
LANE_OPS = {"cc": 45, "cb": 60, "area_cb": 35, "bb": 30}
LANE_BWD_OPS = {"cc": 45, "cb": 50, "area_cb": 20, "bb": 50}
_ANALYTIC = ("cc", "cb", "bb", "area_cb")


def world_shapes(world, per_world_parts=()) -> dict:
    """The shapes the counts read, from the world's public tables: bodies,
    contact lanes, joints, iterations, each part's body and vertex count,
    each pair group's kind and parts, and the parts whose vertices each
    world holds itself (the lander's terrain: read from the state, not
    rotated)."""
    cfg = world.config
    return {
        "n_bodies": int(world.n_bodies),
        "n_contacts": int(world.table.n_contacts),
        "n_joints": int(world.joints.n_joints),
        "iterations": int(cfg.solver_iterations),
        "position_iterations": int(cfg.position_iterations),
        "part_nverts": [int(v) for v in world.parts.nverts],
        "groups": [
            {"kernel": g.kernel, "part_a": [int(p) for p in g.part_a],
             "part_b": [int(p) for p in g.part_b]}
            for g in world.table.groups
        ],
        "per_world_parts": sorted(int(p) for p in per_world_parts),
    }


def _group_rows(shapes, g):
    """Vertex rows each side of a group reads: a polygon's rows padded to
    the group's largest vertex count, two for an analytic lane's side."""
    nv = shapes["part_nverts"]
    va = max(nv[p] for p in g["part_a"])
    vb = max(nv[p] for p in g["part_b"])
    if g["kernel"] in _ANALYTIC:
        va, vb = min(va, 2), min(vb, 2)
    return va, vb


def pairs(shapes):
    """``[(kernel, part_a, part_b, va, vb, lanes)]`` in lane order."""
    out = []
    for g in shapes["groups"]:
        va, vb = _group_rows(shapes, g)
        for a, b in zip(g["part_a"], g["part_b"]):
            out.append((g["kernel"], a, b, va, vb, 2 if g["kernel"] == "pp" else 1))
    return out


def pair_ops(kernel, va, vb):
    """float32 operations of one pair's lanes: a polygon pair's SAT over its
    edge axes (9 each; per axis 3 a vertex and 2 a min/max for both
    polygons, then 4 to compare), 4 a vertex for the reference edges and
    about 85 for the clip and the lanes; an analytic pair's lane."""
    if kernel != "pp":
        return LANE_OPS[kernel]
    a = va + vb
    return 9 * a + a * (3 * a + 2 * (a - 2) + 4) + 4 * a + 85


def solve_ops(shapes, n_active, B):
    """The solve's and joints' operations: about 80 an active lane for the
    setup, 45 for each normal or friction pass, 38 for each position pass,
    60 for each joint of a world."""
    return (n_active * (80 + 90 * shapes["iterations"] + 38 * shapes["position_iterations"])
            + 60 * shapes["n_joints"] * B)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BPS, ops / F32_FLOPS
    return {"ms": 1e3 * max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def solve_bound(shapes, n_active, B, bwd=False):
    """One solve (or its reverse pass): each input byte read once (four
    float32 contact planes and the active flags, the six body planes and
    six outputs), the reverse pass reading six cotangents and writing four
    contact cotangents more; its operations three times the forward's."""
    C, n = shapes["n_contacts"], shapes["n_bodies"]
    body = n * B * 4
    nbytes = C * B * (4 * 4 + 1) + 12 * body + (6 * body + 4 * C * B * 4 if bwd else 0)
    ops = solve_ops(shapes, n_active, B) * (3 if bwd else 1)
    return _bound(nbytes, ops)


def _vertex_rows(shapes):
    rows = {}
    for _, a, b, va, vb, _ in pairs(shapes):
        rows[a] = max(rows.get(a, 0), va)
        rows[b] = max(rows.get(b, 0), vb)
    return rows


def fused_ops(shapes, n_active, B):
    """The fused step's operations: every pair's lanes whether or not they
    touch, 8 for every rotated vertex row (parts each world holds itself
    are not rotated), 8 to integrate and about 40 for the cosine and sine
    of every body, then the solve and joints for the active lanes."""
    own = set(shapes["per_world_parts"])
    per_world = sum(pair_ops(k, va, vb) for k, _, _, va, vb, _ in pairs(shapes))
    per_world += sum(8 * r for p, r in _vertex_rows(shapes).items() if p not in own)
    per_world += 48 * shapes["n_bodies"]
    return per_world * B + solve_ops(shapes, n_active, B)


def fused_bound(shapes, n_active, B):
    """One fused step: six body planes and the per-world parts' vertex
    rows read once, six body planes and one byte of active flag a lane
    written once."""
    rows = _vertex_rows(shapes)
    own = sum(rows.get(p, 0) for p in shapes["per_world_parts"])
    nbytes = (12 * shapes["n_bodies"] + 2 * own) * B * 4 + shapes["n_contacts"] * B
    return _bound(nbytes, fused_ops(shapes, n_active, B))


def fused_bwd_bound(shapes, n_active, touched, B):
    """One reverse pass of the fused step: the recompute is the forward
    step, the solver's reverse pass about twice the solve again, and each
    pair with an active lane (``touched``: per pair in lane order, the
    worlds where one of its lanes is active) its lanes again and their
    adjoint (a polygon pair about 17 a vertex of both polygons and 160 for
    the clips, tangent and edge normal).  Bytes: six body planes, their six
    cotangents and the per-world vertex rows read once; six body-plane
    cotangents and the per-world rows' cotangents written once."""
    ops = fused_ops(shapes, n_active, B) + 2 * solve_ops(shapes, n_active, B)
    for t, (k, _, _, va, vb, _) in zip(touched, pairs(shapes)):
        ops += t * (pair_ops(k, va, vb) + (LANE_BWD_OPS[k] if k != "pp" else 17 * (va + vb) + 160))
    rows = _vertex_rows(shapes)
    own = sum(rows.get(p, 0) for p in shapes["per_world_parts"])
    n_own = len(shapes["per_world_parts"])
    nbytes = (18 * shapes["n_bodies"] + 2 * own + 2 * MAX_VERTS * n_own) * B * 4
    return _bound(nbytes, ops)


def share(bound_ms, kernel_ms):
    """A kernel's share of its roofline, in percent, or None where the
    kernel did not run."""
    if not kernel_ms or kernel_ms <= 0:
        return None
    return 100.0 * bound_ms / kernel_ms
