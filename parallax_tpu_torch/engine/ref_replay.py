"""Key-for-key replay of the reference's RandomizedCollider (the torch port
of ``engine/ref_replay.py``).

The reference's collider consumes PRNG keys along a tree whose shape is
fixed by its Python-level bucketing of part pairs.  That bucketing is a
deterministic function of the static body and part list
(:func:`build_replay_plan`, host side), so the key tree is rebuilt
exactly:

    skey = split(rkey)[0]
    per type-pair bucket, in dict insertion order:
        skey = split(skey)[0]
        scatter keys = split(skey, N2)
          per ind2: split(key, N1)
            per ind1: key1, key2 = split(key)
                      bernoulli(key1, 0.5)
                      bernoulli(key2, 0.5)   # discarded
    choice keys = split(skey_final, n_bodies)
      per body i: choice(key_i, arange(n), p=row_probs)

``solver_mode="random_one_per_body_keyed"`` replays this order bit for
bit, keeping the reference's structural quirks:

* each bucket's sides are deduplicated independently, breaking the
  original pairing, and the scatter walks the full N1 x N2 cross product
  (ind2-major), self-cells and re-derived pairs included;
* cells with i < j write nothing, but their keys are consumed in place;
* a cell's contact function is dispatched on the cell's actual part types
  with the reference's swap rule, and a swapped call's result is stored
  without reorientation;
* a cell writes ``all_contacts[i, j]`` with probability 0.5 when its
  contact is valid; later writes overwrite earlier ones;
* per body i, one uniformly random valid entry of row i is chosen, and the
  chosen contacts are resolved in body order, skipping i == j.

Where the reference iterates a set, the replay takes first-occurrence
order; a chosen contact between two infinite masses is skipped (k == 0).

Every world of a batch (leading axes of the state, one key ``[.., 2]`` a
world) replays its own tree.  The cells' contact functions run grouped by
function, one call a group over the group's cells.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.dynamics.impulses import (
    DEFAULT_SOLVER,
    ContactSolverConfig,
    resolve_contact_deltas,
)
from parallax_tpu_torch.dynamics.solver import _take1, _take2
from parallax_tpu_torch.geometry.contacts import (
    contact_box_box,
    contact_box_polygon_gjk_epa,
    contact_circle_box,
    contact_circle_circle,
    contact_circle_polygon_gjk_epa,
    contact_polygon_polygon_gjk_epa,
)
from parallax_tpu_torch.geometry.shapes import BOX, CIRCLE, Parts, edge_mask_for
from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.device import static_tensor

# the reference's _contact_funcs dict keys, in definition order; membership
# drives the bucket-key swap rule
REF_CONTACT_KEYS = (
    ("AABB", "AABB"),
    ("Circle", "Circle"),
    ("Circle", "AABB"),
    ("Polygon", "Polygon"),
    ("AABB", "Polygon"),
    ("Circle", "Polygon"),
    ("Circle", "Polygon4"),
    ("Circle", "Polygon6"),
    ("AABB", "Polygon4"),
    ("AABB", "Polygon6"),
    ("Polygon4", "Polygon4"),
    ("Polygon4", "Polygon6"),
    ("Polygon6", "Polygon6"),
)


def _ref_type(kind: int, nverts: int) -> str:
    """The reference shape class of a part (4 and 6 are the arities of its
    fixed-arity polygon classes)."""
    if kind == CIRCLE:
        return "Circle"
    if kind == BOX:
        return "AABB"
    return {4: "Polygon4", 6: "Polygon6"}.get(nverts, "Polygon")


@dataclasses.dataclass(frozen=True)
class ReplayBucket:
    """One (type1, type2) bucket: independently deduplicated sides."""

    key_types: tuple  # the _contact_funcs dict key (canonical order)
    side0: tuple  # ((body, part), ...) first-occurrence order
    side1: tuple


@dataclasses.dataclass(frozen=True)
class ReplayPlan:
    n_bodies: int
    buckets: tuple  # tuple[ReplayBucket], dict insertion order


@functools.lru_cache(maxsize=None)
def build_replay_plan(kind: tuple, nverts: tuple, body: tuple, n_bodies: int) -> ReplayPlan:
    """Host-side reconstruction of the reference's bucketing: pairs (i, j)
    with i > j in loop order (1,0),(2,0),(2,1),(3,0)...; per pair, parts
    crossed in body part order; the bucket key by the swap rule; sides
    deduplicated independently.  Cached per topology."""
    parts_of = [[] for _ in range(n_bodies)]
    for p, b in enumerate(body):
        parts_of[b].append(p)
    sides: dict = {}
    order = []
    for i in range(n_bodies):
        for j in range(n_bodies):
            if i <= j:
                continue
            for pa in parts_of[i]:
                for pb in parts_of[j]:
                    t1 = _ref_type(kind[pa], nverts[pa])
                    t2 = _ref_type(kind[pb], nverts[pb])
                    if (t1, t2) in REF_CONTACT_KEYS:
                        k = (t1, t2)
                    elif (t2, t1) in REF_CONTACT_KEYS:
                        k = (t2, t1)
                    else:
                        # the reference raises RuntimeError here
                        raise ValueError(
                            f"illegal shape pair for reference replay: "
                            f"{(t1, t2)} (parts {pa}, {pb})"
                        )
                    if k not in sides:
                        sides[k] = ([], [])
                        order.append(k)
                    sides[k][0].append((i, pa))
                    sides[k][1].append((j, pb))
    buckets = tuple(
        ReplayBucket(
            key_types=k,
            side0=tuple(dict.fromkeys(sides[k][0])),
            side1=tuple(dict.fromkeys(sides[k][1])),
        )
        for k in order
    )
    return ReplayPlan(n_bodies=n_bodies, buckets=buckets)


def replay_key_schedule(rkey, plan: ReplayPlan):
    """The whole key tree (module docstring), as the reference consumes
    it, for keys ``[.., 2]``.  Returns ``(bernoulli_keys, choice_keys)``:
    ``bernoulli_keys[b]`` is ``[.., N2, N1, 2]``, the ``key1`` of each
    cell's write draw in bucket b, and ``choice_keys`` ``[.., n_bodies,
    2]``."""
    skey = prng.split(rkey)[..., 0, :]
    bern = []
    for bucket in plan.buckets:
        skey = prng.split(skey)[..., 0, :]
        keys2 = prng.split(skey, len(bucket.side1))  # [.., N2, 2]
        keys1 = prng.split(keys2, len(bucket.side0))  # [.., N2, N1, 2]
        bern.append(prng.split(keys1)[..., 0, :])  # key1 of (key1, key2)
    return bern, prng.split(skey, plan.n_bodies)


def _cell_call(kind: tuple, nverts: tuple, pa: int, pb: int):
    """A cell's contact call after the reference's swap rule (a swapped
    result is not reoriented): ``(function tag, pa, pb, EPA steps)``."""
    ta = _ref_type(kind[pa], nverts[pa])
    tb = _ref_type(kind[pb], nverts[pb])
    if (ta, tb) not in REF_CONTACT_KEYS:
        pa, pb = pb, pa
        ta, tb = tb, ta
    fa = "c" if ta == "Circle" else ("b" if ta == "AABB" else "p")
    fb = "c" if tb == "Circle" else ("b" if tb == "AABB" else "p")
    if (fa, fb) == ("c", "p"):
        iters = 128
    elif (fa, fb) == ("b", "p"):
        iters = min(48, 4 + nverts[pb] + 1)
    elif (fa, fb) == ("p", "p"):
        iters = min(48, nverts[pa] + nverts[pb] + 1)
    else:
        iters = 0
    return fa + fb, pa, pb, iters


@functools.lru_cache(maxsize=None)
def _cell_groups(plan: ReplayPlan, kind: tuple, nverts: tuple):
    """The scatter's cells in order, ``(bucket, ind2, ind1, i, j, group,
    slot)``, and the groups of cells sharing a contact call: ``{(tag,
    iters): ([pa], [pb])}``, ``slot`` a cell's place in its group.  Cells
    with i < j write nothing and are left out."""
    cells, groups = [], {}
    for b, bucket in enumerate(plan.buckets):
        for ind2, (j, pb) in enumerate(bucket.side1):
            for ind1, (i, pa) in enumerate(bucket.side0):
                if i < j:
                    continue
                tag, qa, qb, iters = _cell_call(kind, nverts, pa, pb)
                g = groups.setdefault((tag, iters), ([], []))
                cells.append((b, ind2, ind1, i, j, (tag, iters), len(g[0])))
                g[0].append(qa)
                g[1].append(qb)
    return tuple(cells), {k: (tuple(a), tuple(b)) for k, (a, b) in groups.items()}


def _group_contacts(wp: Parts, tag: str, iters: int, pa: tuple, pb: tuple):
    """One group's contacts, the cells on the last batch axis: ``(pen
    [.., K, 2], point [.., K, 2], valid [.., K])``."""
    dev = wp.verts.device
    V = wp.verts.shape[-2]
    pa_t = static_tensor(pa, dev)
    pb_t = static_tensor(pb, dev)

    def circ(p, t):
        return wp.verts[..., t, 0, :], wp.radius[t]

    def box(p, t):
        return wp.verts[..., t, 0, :], wp.verts[..., t, 1, :]

    def poly(p, t):
        mask = np.stack([edge_mask_for(wp.nverts[q], V) for q in p])
        return wp.verts[..., t, :, :], static_tensor(mask, dev)

    if tag == "cc":
        out = contact_circle_circle(*circ(pa, pa_t), *circ(pb, pb_t))
    elif tag == "bb":
        out = contact_box_box(*box(pa, pa_t), *box(pb, pb_t))
    elif tag == "cb":
        out = contact_circle_box(*circ(pa, pa_t), *box(pb, pb_t))
    elif tag == "cp":
        out = contact_circle_polygon_gjk_epa(*circ(pa, pa_t), *poly(pb, pb_t), iters)
    elif tag == "bp":
        out = contact_box_polygon_gjk_epa(*box(pa, pa_t), *poly(pb, pb_t), iters)
    else:
        out = contact_polygon_polygon_gjk_epa(*poly(pa, pa_t), *poly(pb, pb_t), iters)
    return out.penetration, out.point, out.active


def keyed_choice(world_parts: Parts, plan: ReplayPlan, key):
    """The scatter and the per-row choice of every world of a batch:
    ``(pen_t, pt_t, chosen)``, the ``all_contacts`` table ``[.., n, n, 2]``
    (penetration 0 and point NaN where nothing was written) and each
    body's chosen entry ``[.., n]`` (the body itself where its row is
    empty).  ``key`` is ``[.., 2]``."""
    n = plan.n_bodies
    dtype, dev = world_parts.verts.dtype, world_parts.verts.device
    batch = key.shape[:-1]
    cells, groups = _cell_groups(plan, world_parts.kind, world_parts.nverts)
    out = {g: _group_contacts(world_parts, g[0], g[1], *groups[g]) for g in groups}

    bern_keys, choice_keys = replay_key_schedule(key, plan)
    cond = [prng.bernoulli(k, 0.5) for k in bern_keys]  # [.., N2, N1] a bucket
    # all_contacts starts as pen 0, point NaN; each cell overwrites its
    # (i, j) entry where it draws a write and its contact is valid
    zero = torch.zeros(batch + (2,), dtype=dtype, device=dev)
    nan = torch.full(batch + (2,), float("nan"), dtype=dtype, device=dev)
    pen_t, pt_t = {}, {}
    for b, ind2, ind1, i, j, g, slot in cells:
        pen, pt, valid = out[g]
        pen, pt, valid = pen[..., slot, :], pt[..., slot, :], valid[..., slot]
        write = (cond[b][..., ind2, ind1] & valid)[..., None]
        pen_t[i, j] = torch.where(write, pen, pen_t.get((i, j), zero))
        pt_t[i, j] = torch.where(write, pt, pt_t.get((i, j), nan))

    def table(d, init):
        rows = [torch.stack([d.get((i, j), init) for j in range(n)], -2) for i in range(n)]
        return torch.stack(rows, -3)  # [.., n, n, 2]

    pen_t, pt_t = table(pen_t, zero), table(pt_t, nan)

    # per body, a uniform choice over its row's valid entries
    good = ~torch.any(torch.isnan(pt_t), dim=-1)  # [.., n, n]
    nn_count = good.sum(-1)  # [.., n]
    probs = good.to(torch.float32) / nn_count[..., None].to(torch.float32)
    rows = static_tensor(np.arange(n), dev)
    return pen_t, pt_t, torch.where(nn_count == 0, rows, prng.choice(choice_keys, probs))


def resolve_reference_keyed(
    world_parts: Parts,
    state: BodyState,
    params: BodyParams,
    plan: ReplayPlan,
    key,
    config: ContactSolverConfig = DEFAULT_SOLVER,
) -> BodyState:
    """One keyed-replay contact resolve of every world of a batch: the
    scatter and the per-row choice (:func:`keyed_choice`), then the
    resolution in body order, consuming keys as
    :func:`replay_key_schedule` lays them out.  ``key`` is ``[.., 2]``
    (None: ``PRNGKey(0)`` in every world)."""
    n = plan.n_bodies
    dtype, dev = state.pos.dtype, state.pos.device
    if key is None:
        key = torch.zeros(state.pos.shape[:-2] + (2,), dtype=torch.int64, device=dev)
    pen_t, pt_t, chosen = keyed_choice(world_parts, plan, key)
    rows = static_tensor(np.arange(n), dev)

    # sequential resolution in body order; velocities only
    ptup = (params.inv_mass, params.inv_inertia, params.elasticity, params.friction)
    eye = static_tensor(np.eye(n, dtype=np.float32), dev).to(dtype)
    vel, omega = state.vel, state.omega
    for i in range(n):
        j = chosen[..., i]
        pen = _take2(pen_t[..., i, :, :], j)
        pt = _take2(pt_t[..., i, :, :], j)
        valid = ~torch.any(torch.isnan(pt), dim=-1) & (j != i)
        (dva, dwa), (dvb, dwb), applied = resolve_contact_deltas(
            pen, pt, valid,
            state.pos[..., i, :], vel[..., i, :], omega[..., i],
            _take2(state.pos, j), _take2(vel, j), _take1(omega, j),
            tuple(x[i] for x in ptup), tuple(x[j] for x in ptup),
            config,
        )
        onej = eye[j]
        new_vel = vel.index_add(-2, rows[i:i + 1], dva[..., None, :]) + onej[..., None] * dvb[..., None, :]
        new_omega = omega.index_add(-1, rows[i:i + 1], dwa[..., None]) + onej * dwb[..., None]
        vel = torch.where(applied[..., None, None], new_vel, vel)
        omega = torch.where(applied[..., None], new_omega, omega)
    return state._replace(vel=vel, omega=omega)
