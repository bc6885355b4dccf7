"""Uniform convex-part tables (the torch port of ``geometry/shapes.py``).

Every convex part is one row of a fixed-shape table:

* ``kind``   -- CIRCLE / BOX / POLYGON (static tuple)
* ``verts``  -- ``[P, MAX_VERTS, 2]`` local-frame vertices.  A polygon's
  vertices are ordered clockwise and padded by repeating the last one; a
  box stores its lower and upper corner; a circle its centre offset.
* ``radius`` -- ``[P]`` circle radius (0 otherwise)
* ``nverts``, ``body`` -- static topology (owning body index)

``verts`` and ``radius`` are float32 tensors; ``Parts.to`` moves them to a
device once, when the world is built.  ``Parts.to_world`` gives the
world-frame table (leading batch axes allowed), on which the supports,
containment tests and edges below, GJK/EPA (``geometry/gjk.py``,
``geometry/epa.py``) and the contact functions (``geometry/contacts.py``)
work.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from parallax_tpu_torch.geometry.math import order_clockwise, safe_normalize

CIRCLE = 0
BOX = 1  # axis-aligned box
POLYGON = 2

KIND_NAMES = {CIRCLE: "circle", BOX: "box", POLYGON: "polygon"}

MAX_VERTS = 8


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """Host-side description of one convex part (pre-table construction)."""

    kind: int
    verts: np.ndarray  # [nverts, 2]
    radius: float = 0.0

    @property
    def nverts(self) -> int:
        return int(self.verts.shape[0])


def circle(radius, position=(0.0, 0.0)) -> ShapeSpec:
    """Circle of ``radius`` centred at ``position`` in the body frame."""
    return ShapeSpec(
        kind=CIRCLE,
        verts=np.asarray([position], dtype=np.float32),
        radius=float(radius),
    )


def box(lower, upper) -> ShapeSpec:
    """Axis-aligned box with min/max corners."""
    lower = np.asarray(lower, dtype=np.float32)
    upper = np.asarray(upper, dtype=np.float32)
    if not np.all(upper > lower):
        raise ValueError(f"box is invalid: lower={lower} upper={upper}")
    return ShapeSpec(kind=BOX, verts=np.stack([lower, upper]), radius=0.0)


aabb = box


def polygon(vertices) -> ShapeSpec:
    """Convex polygon, vertices ordered by ascending atan2 angle."""
    v = np.asarray(vertices, dtype=np.float32)
    if v.ndim != 2 or v.shape[-1] != 2 or v.shape[0] < 3:
        raise ValueError(f"polygon needs [n>=3, 2] vertices, got {v.shape}")
    if v.shape[0] > MAX_VERTS:
        raise ValueError(f"polygon exceeds MAX_VERTS={MAX_VERTS}")
    return ShapeSpec(kind=POLYGON, verts=order_clockwise(v), radius=0.0)


def regular_polygon(n: int, radius: float, position=(0.0, 0.0)) -> ShapeSpec:
    """Regular ``n``-gon of circumradius ``radius`` centred at ``position``."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    v = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * radius + np.asarray(position)
    return polygon(v)


@dataclasses.dataclass(frozen=True)
class Parts:
    """SoA table of convex parts (local frame)."""

    verts: torch.Tensor  # [P, V, 2] float32
    radius: torch.Tensor  # [P] float32
    kind: tuple
    nverts: tuple
    body: tuple

    @property
    def n_parts(self) -> int:
        return len(self.kind)

    @staticmethod
    def from_specs(
        specs: Sequence[ShapeSpec],
        body_index: Sequence[int],
        max_verts: int = MAX_VERTS,
    ) -> "Parts":
        if len(specs) != len(body_index):
            raise ValueError("one owning body per shape spec")
        P = len(specs)
        verts = np.zeros((P, max_verts, 2), dtype=np.float32)
        radius = np.zeros((P,), dtype=np.float32)
        for i, s in enumerate(specs):
            n = s.nverts
            verts[i, :n] = s.verts
            # pad by repeating the last valid vertex: supports and extents
            # stay exact with no masking
            verts[i, n:] = s.verts[n - 1]
            radius[i] = s.radius
        return Parts(
            verts=torch.from_numpy(verts),
            radius=torch.from_numpy(radius),
            kind=tuple(int(s.kind) for s in specs),
            nverts=tuple(int(s.nverts) for s in specs),
            body=tuple(int(b) for b in body_index),
        )

    @property
    def max_verts(self) -> int:
        return self.verts.shape[-2]

    def to(self, device) -> "Parts":
        return dataclasses.replace(
            self, verts=self.verts.to(device), radius=self.radius.to(device)
        )

    def replace(self, **kw) -> "Parts":
        return dataclasses.replace(self, **kw)

    def to_world(self, pos, cos, sin, rotate_circles: bool = True) -> "Parts":
        """All parts in the world frame from per-body poses: ``pos``
        ``[..., n_bodies, 2]``, ``cos``/``sin`` ``[..., n_bodies]``.  A
        polygon takes the full rigid transform, a box only the translation
        (boxes live on bodies that do not rotate), a circle's centre offset
        is rotated then translated (``rotate_circles=False``: translated
        only, as the reference does)."""
        body = list(self.body)
        pb = pos[..., body, :]  # [..., P, 2]
        c = cos[..., body][..., None]  # [..., P, 1]
        s = sin[..., body][..., None]
        v = self.verts
        rotated = torch.stack([c * v[..., 0] - s * v[..., 1],
                               s * v[..., 0] + c * v[..., 1]], dim=-1)
        rot = [k == POLYGON or (rotate_circles and k == CIRCLE) for k in self.kind]
        sel = torch.tensor(rot, device=v.device)[:, None, None]
        return self.replace(verts=torch.where(sel, rotated, v) + pb[..., None, :])

    def extents(self):
        """Conservative AABB per part: ``(lower, upper)``, each ``[..., P, 2]``."""
        v = self.verts
        dev = v.device
        is_circle = torch.tensor([k == CIRCLE for k in self.kind], device=dev)[:, None]
        is_box = torch.tensor([k == BOX for k in self.kind], device=dev)[:, None]
        poly_lo = torch.amin(v, dim=-2)
        poly_hi = torch.amax(v, dim=-2)
        circ_lo = v[..., 0, :] - self.radius[..., None]
        circ_hi = v[..., 0, :] + self.radius[..., None]
        lo = torch.where(is_circle, circ_lo, torch.where(is_box, v[..., 0, :], poly_lo))
        hi = torch.where(is_circle, circ_hi, torch.where(is_box, v[..., 1, :], poly_hi))
        return lo, hi

    def centers(self):
        """AABB midpoint per part ``[..., P, 2]``."""
        lo, hi = self.extents()
        return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# supports, containment and edges over one part's gathered geometry:
# ``verts`` [..., V, 2] (and ``radius`` [...]), the kind chosen by the
# caller; the innermost primitive of GJK and EPA
# ---------------------------------------------------------------------------


def support_polygon(verts, direction):
    """Farthest vertex along ``direction`` (``[..., 2]``); repeat-padding
    keeps an unmasked argmax exact.  The first of tied vertices wins."""
    dots = torch.sum(verts * direction[..., None, :], dim=-1)
    idx = torch.argmax(dots, dim=-1)
    vb = verts.expand(*dots.shape, 2)
    return torch.take_along_dim(vb, idx[..., None, None], dim=-2)[..., 0, :]


def support_circle(center, radius, direction):
    """``center + r * dir / |dir|``."""
    return center + radius[..., None] * safe_normalize(direction)


def support_box(lower, upper, direction):
    """The corner on ``direction``'s side, per coordinate."""
    return torch.where(direction >= 0, upper, lower)


def support_any(kind: int, verts, radius, direction):
    """The support of a part of static ``kind``."""
    if kind == CIRCLE:
        return support_circle(verts[..., 0, :], radius, direction)
    if kind == BOX:
        return support_box(verts[..., 0, :], verts[..., 1, :], direction)
    return support_polygon(verts, direction)


def contains_circle(center, radius, point, eps=1e-6):
    return torch.sum((point - center) ** 2, dim=-1) <= (radius + eps) ** 2


def contains_box(lower, upper, point, eps=1e-6):
    return torch.all((point >= lower - eps) & (point <= upper + eps), dim=-1)


def contains_polygon(verts, edge_mask, point):
    """All real edges (``edge_mask`` ``[..., V]``) see ``point`` on one
    side; a zero sign matches either side."""
    nxt = torch.roll(verts, shifts=-1, dims=-2)
    e = verts - nxt
    n = torch.stack([-e[..., 1], e[..., 0]], dim=-1)
    d = torch.sum(n * (point[..., None, :] - verts), dim=-1)
    sgn = torch.sign(d)
    pos_ok = torch.all(torch.where(edge_mask, sgn >= 0, True), dim=-1)
    neg_ok = torch.all(torch.where(edge_mask, sgn <= 0, True), dim=-1)
    return pos_ok | neg_ok


def polygon_edges(verts):
    """Edges as ``(start, end)``, each ``[..., V, 2]``, padded ones too."""
    return verts, torch.roll(verts, shifts=-1, dims=-2)


def box_corners(lower, upper):
    """The 4 corners ``[..., 4, 2]``: upper, (ux, ly), lower, (lx, uy)."""
    ux, uy = upper[..., 0], upper[..., 1]
    lx, ly = lower[..., 0], lower[..., 1]
    return torch.stack([torch.stack([ux, uy], dim=-1), torch.stack([ux, ly], dim=-1),
                        torch.stack([lx, ly], dim=-1), torch.stack([lx, uy], dim=-1)],
                       dim=-2)


def edge_mask_for(nverts: int, max_verts: int) -> np.ndarray:
    """Static mask of real edges for an ``nverts``-gon padded to max_verts.

    With repeat-padding, vertices [0..nverts-1] are distinct and vertex
    nverts-1 repeats to the end; real edges are (0..nverts-2 -> +1) plus the
    closing edge (max_verts-1 -> 0).
    """
    m = np.zeros((max_verts,), dtype=bool)
    m[: nverts - 1] = True
    m[max_verts - 1] = True
    return m
