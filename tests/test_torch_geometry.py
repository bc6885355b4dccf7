"""The port's geometry helpers, shapes and composite queries against JAX's.

``parallax_tpu_torch/geometry/{math,shapes,composite}.py`` against
``parallax_tpu/geometry``'s on the same numpy inputs from a seed.  The JAX
functions run one item and are ``vmap``ped; the port's take leading batch
dimensions.  Elementwise formulas agree to float32 rounding (atol 1e-6
unless stated); selections (supports, containment, collision flags) are
equal.  The model is the JAX package's own ``tests/test_geometry_math.py``
and ``tests/test_composite.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from parallax_tpu.geometry import composite as jcomp
from parallax_tpu.geometry import math as jm
from parallax_tpu.geometry import shapes as js
from parallax_tpu_torch.geometry import composite as tcomp
from parallax_tpu_torch.geometry import math as tm
from parallax_tpu_torch.geometry import shapes as tsh
from parallax_tpu_torch.utils import prng

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_math_matches_jax():
    """fast_normal, perpendicular_vector, cross2, rotate, safe_norm and
    safe_normalize (zero rows included, with and without a fallback, and
    their gradients there: finite, JAX's), is_point_in_triangle,
    angle_between, order_clockwise and Transform2 on a seeded batch."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 2)).astype(np.float32)
    b = rng.standard_normal((64, 2)).astype(np.float32)
    a[:4] = 0.0
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    for name in ("fast_normal", "perpendicular_vector"):
        _close(getattr(tm, name)(_t(a)), getattr(jm, name)(jnp.asarray(a)))
    _close(tm.cross2(_t(a), _t(b)), jm.cross2(jnp.asarray(a), jnp.asarray(b)))
    _close(tm.rotate(_t(a), _t(ang)), jm.rotate(jnp.asarray(a), jnp.asarray(ang)))
    _close(tm.safe_norm(_t(a)), jm.safe_norm(jnp.asarray(a)))
    _close(tm.safe_norm(_t(a), keepdim=True), jm.safe_norm(jnp.asarray(a), keepdims=True))
    fb = np.float32([0.0, 1.0])
    _close(tm.safe_normalize(_t(a)), jm.safe_normalize(jnp.asarray(a)))
    _close(tm.safe_normalize(_t(a), fallback=_t(fb)),
           jm.safe_normalize(jnp.asarray(a), fallback=jnp.asarray(fb)))
    x = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(tm.safe_normalize(x).sum() + tm.safe_norm(x).sum(), x)
    want = jax.grad(lambda v: jm.safe_normalize(v).sum() + jm.safe_norm(v).sum())(jnp.asarray(a))
    _close(g, want, 1e-5)
    assert torch.isfinite(g).all()
    tri = rng.uniform(-1, 1, (3, 64, 2)).astype(np.float32)
    pts = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    assert np.array_equal(
        tm.is_point_in_triangle(*map(_t, (pts, *tri))).numpy(),
        np.asarray(jm.is_point_in_triangle(*map(jnp.asarray, (pts, *tri)))))
    _close(tm.angle_between(_t(a[4:]), _t(b[4:])),
           jm.angle_between(jnp.asarray(a[4:]), jnp.asarray(b[4:])), 1e-5)
    verts = rng.standard_normal((16, 6, 2)).astype(np.float32)
    assert np.array_equal(tm.order_clockwise(verts),
                          np.asarray(jm.order_clockwise(jnp.asarray(verts))))
    pos = rng.standard_normal((64, 2)).astype(np.float32)
    for tf, jf in ((tm.Transform2.make(_t(pos), _t(ang)),
                    jm.Transform2.make(jnp.asarray(pos), jnp.asarray(ang))),
                   (tm.Transform2.identity((64,)), jm.Transform2.identity((64,)))):
        for name in ("forward_direction", "inverse_direction", "forward_vector",
                     "inverse_vector"):
            _close(getattr(tf, name)(_t(b)), getattr(jf, name)(jnp.asarray(b)), 1e-5)
        _close(tf.angle, jf.angle)
        _close(tf.shift(), jf.shift())
        _close(tf.inverse_vector(tf.forward_vector(_t(b))), b, 1e-5)


def test_random_direction_and_normal_match_jax_draws():
    """``utils.prng.normal`` against ``jax.random.normal`` on 4,096 seeded
    threefry keys x 2 draws: at least 98% of the draws are JAX's to the
    bit (98.9% here) and none is more than 3 float32 ulps off.  The port computes XLA's
    own erf_inv polynomial (``torch.erfinv``, another approximation, is up
    to 61 ulps away), but XLA on the CPU rounds its ``log1p`` and ``sqrt``
    to within 1-2 ulps, not correctly, so a few draws differ in their last
    bits.  ``random_direction`` is then JAX's unit vector within 1e-6,
    and without a key ``(1, 0)``."""
    keys = np.random.default_rng(1).integers(0, 2**32, (4096, 2), dtype=np.uint32)
    jkeys = jax.vmap(lambda k: jax.random.wrap_key_data(k, impl="threefry2x32"))(
        jnp.asarray(keys))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2,)))(jkeys))
    got = prng.normal(_t(keys.astype(np.int64)), (2,)).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3 and (ulps == 0).mean() >= 0.98, (ulps.max(), (ulps == 0).mean())
    d = tm.random_direction(_t(keys.astype(np.int64)))
    _close(d, jax.vmap(jm.random_direction)(jkeys))
    _close(tm.random_direction(None), jm.random_direction(None))


def _mixed_specs(mod):
    return [mod.polygon([(0.0, 0.0), (1.0, 0.0), (0.5, 1.0)]),
            mod.box((-2.0, -1.0), (-1.0, 1.0)),
            mod.circle(0.3, (0.0, 2.0)),
            mod.regular_polygon(6, 0.5, (1.5, -0.5))]


def test_shapes_match_jax():
    """regular_polygon, Parts.from_specs, max_verts, to_world (batched poses,
    with and without rotated circles), extents and centers; the supports
    (and support_any per kind), the containment tests, polygon_edges and
    box_corners on a seeded batch."""
    rng = np.random.default_rng(2)
    for n in (3, 5, 8):
        assert np.array_equal(tsh.regular_polygon(n, 0.7, (0.1, 0.2)).verts,
                              js.regular_polygon(n, 0.7, (0.1, 0.2)).verts)
    tp = tsh.Parts.from_specs(_mixed_specs(tsh), [0, 1, 1, 2])
    jp = js.Parts.from_specs(_mixed_specs(js), [0, 1, 1, 2])
    assert tp.max_verts == jp.max_verts == 8
    pos = rng.standard_normal((32, 3, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (32, 3)).astype(np.float32)
    for rc in (True, False):
        tw = tp.to_world(_t(pos), torch.cos(_t(ang)), torch.sin(_t(ang)), rotate_circles=rc)
        jw = jp.to_world(jnp.asarray(pos), jnp.cos(jnp.asarray(ang)),
                         jnp.sin(jnp.asarray(ang)), rotate_circles=rc)
        _close(tw.verts, jw.verts, 1e-5)
        for x, y in zip(tw.extents(), jw.extents()):
            _close(x, y, 1e-5)
        _close(tw.centers(), jw.centers(), 1e-5)
    d = rng.standard_normal((32, 2)).astype(np.float32)
    d[0] = 0.0
    v = np.asarray(jw.verts)
    r = np.asarray(jw.radius)
    for k in range(4):
        _close(tsh.support_any(tp.kind[k], _t(v[:, k]), _t(r[k]).expand(32), _t(d)),
               jax.vmap(lambda v_, d_: js.support_any(jp.kind[k], v_, jnp.asarray(r[k]), d_))(
                   jnp.asarray(v[:, k]), jnp.asarray(d)), 1e-5)
    em = js.edge_mask_for(6, 8)
    pts = rng.uniform(-2.5, 2.5, (32, 2)).astype(np.float32)
    checks = (
        (tsh.contains_circle(_t(v[:, 2, 0]), _t(r[2]), _t(pts)),
         js.contains_circle(jnp.asarray(v[:, 2, 0]), r[2], jnp.asarray(pts))),
        (tsh.contains_box(_t(v[:, 1, 0]), _t(v[:, 1, 1]), _t(pts)),
         js.contains_box(jnp.asarray(v[:, 1, 0]), jnp.asarray(v[:, 1, 1]), jnp.asarray(pts))),
        (tsh.contains_polygon(_t(v[:, 3]), _t(em), _t(pts)),
         jax.vmap(lambda v_, p_: js.contains_polygon(v_, jnp.asarray(em), p_))(
             jnp.asarray(v[:, 3]), jnp.asarray(pts))),
    )
    for got, want in checks:
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert any(g.any() and not g.all() for g, _ in checks)
    for x, y in zip(tsh.polygon_edges(_t(v[:, 3])), js.polygon_edges(jnp.asarray(v[:, 3]))):
        _close(x, y, 0)
    _close(tsh.box_corners(_t(v[:, 1, 0]), _t(v[:, 1, 1])),
           js.box_corners(jnp.asarray(v[:, 1, 0]), jnp.asarray(v[:, 1, 1])), 0)


def _composites(mod, off):
    a = mod.Parts.from_specs([mod.polygon([(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)]),
                              mod.circle(0.4, (0.9, 0.0))], [0, 0])
    b = mod.Parts.from_specs([mod.box((-0.3, -0.3), (0.3, 0.3)),
                              mod.polygon([(0.0, 0.0), (0.8, 0.1), (0.3, 0.7)])], [0, 0])
    return a, b


def test_composite_matches_jax():
    """support over a mixed composite (batched directions), and
    collides_with (its details: the first colliding pair's simplex and part
    indices), penetrates_with and possibly_collides_with between two
    composites moved by 48 seeded poses of B, against JAX's vmapped."""
    rng = np.random.default_rng(3)
    tp = tsh.Parts.from_specs(_mixed_specs(tsh), [0, 0, 0, 0])
    jp = js.Parts.from_specs(_mixed_specs(js), [0, 0, 0, 0])
    d = rng.standard_normal((64, 2)).astype(np.float32)
    _close(tcomp.support(tp, _t(d)), jax.vmap(lambda d_: jcomp.support(jp, d_))(jnp.asarray(d)),
           1e-5)
    _close(tcomp.support(tp, _t(d), part_indices=[1, 3]),
           jax.vmap(lambda d_: jcomp.support(jp, d_, part_indices=[1, 3]))(jnp.asarray(d)), 1e-5)
    (ta, tb), (ja, jb) = _composites(tsh, 0), _composites(js, 0)
    pos = rng.uniform(-1.6, 1.6, (48, 1, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (48, 1)).astype(np.float32)
    zero_p, zero_a = np.zeros((48, 1, 2), np.float32), np.zeros((48, 1), np.float32)

    def world(parts, p, a, torch_side):
        if torch_side:
            return parts.to_world(_t(p), torch.cos(_t(a)), torch.sin(_t(a)))
        return parts.to_world(p, jnp.cos(a), jnp.sin(a))

    twa, twb = world(ta, pos, ang, True), world(tb, zero_p, zero_a, True)

    def jax_queries(p, a, zp, za):
        wa, wb = world(ja, p, a, False), world(jb, zp, za, False)
        hit, det = jcomp.collides_with(wa, wb, details=True)
        return (hit, det, jcomp.penetrates_with(wa, wb, 24),
                jcomp.possibly_collides_with(wa, wb, 0.05))

    jhit, jdet, jpen, jposs = jax.jit(jax.vmap(jax_queries))(*map(jnp.asarray,
                                                             (pos, ang, zero_p, zero_a)))
    hit, det = tcomp.collides_with(twa, twb, key=None, details=True)
    assert tcomp.collides_with(twa, twb).equal(hit)
    assert np.array_equal(hit.numpy(), np.asarray(jhit)) and 0 < int(hit.sum()) < 48
    for x, y in zip(det[1:], jdet[1:]):
        assert np.array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_allclose(det[0].numpy()[hit.numpy()], np.asarray(jdet[0])[np.asarray(jhit)],
                               rtol=0, atol=1e-5)
    phit, pen = tcomp.penetrates_with(twa, twb, 24)
    assert np.array_equal(phit.numpy(), np.asarray(jpen[0]))
    _close(pen, jpen[1], 1e-5)
    assert np.array_equal(tcomp.possibly_collides_with(twa, twb, 0.05).numpy(),
                          np.asarray(jposs))
