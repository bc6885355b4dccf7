// Reverse pass of the fused physics step, one warp per world.
//
// Replaces parallax_tpu/ops/pallas_step.py:_step_bwd_kernel (l.495) on
// NVIDIA Hopper (sm_90a), for worlds whose pair groups are polygon-polygon
// ("pp"), circle-circle ("cc"), circle-box ("cb"), box-box ("bb") and
// circle-in-area-box ("area_cb"), the kinds of the forward kernel
// (fused_step.cu).  For a world whose lane count is not a
// multiple of 8 (RoboCup, C=70; billiards8, C=60) the JAX package takes
// jax.vjp of its split step instead of its kernel (pallas_step.py:660-673,
// a Mosaic limit): that is the same VJP, and this kernel computes it for
// every world.  Given the step's primal inputs (the six [n, B] body planes before the step and the
// terrain-override planes) and the cotangents of its six output body
// planes, it returns the cotangents of the six input body planes and of the
// terrain planes (dtx, dty [k * V, B]): the VJP of fused_step_fwd, which is
// the VJP of ops/fused_step.py:fused_step_plain.  The [C, B] active flags
// take no cotangent (pallas_step.py:507).
//
// The Pallas kernel took this VJP from jax.vjp of the recomputed step
// inside the kernel.  CUDA has no autodiff, so it is written out by hand,
// and it follows torch's autograd of the plain version rule for rule:
// torch.minimum/maximum split the cotangent half and half at a tie (the
// projection chains are replayed in order, so a three-way tie splits 1/4,
// 1/4, 1/2), and so do the depth's and the lane depths' floors, which are
// torch.maximum against a constant (jnp.maximum and jnp.clip in the JAX
// package); a `where` passes nothing into the branch it did not take, and
// of a running selection
// (best axis, best edge) only the last element taken receives a
// cotangent.  Per world, in order:
//
//   1. Recompute: integration and gravity, the world-frame vertices and
//      every pair's SAT and clip, with fused_step.cuh's
//      integrate_and_collide, the forward kernel's own first phase, so
//      every decision is the forward's to the bit.  The integrated state
//      stays in shared memory; the contact planes and the flags go to the
//      world's tape.
//   2. The solver's reverse pass: the warp walk (Walk<true>) of
//      solver_walk.cuh, the solver reverse kernel's own code, on those
//      planes.  It yields the cotangents of the integrated state and
//      of each lane's pen_x, pen_y, pt_x, pt_y.
//   3. The lanes' adjoint, by each pair's kind.  A pair with a nonzero
//      lane cotangent is run forward again in registers and walked back.
//      A polygon pair (PairSat, its two lanes): through the lanes' depths
//      and the MTV normal, the reference-face clips and the reference
//      tangent, into the endpoints of the reference and incident edges;
//      through the best axis into its edge's two vertices and, by the
//      projection chains, into every vertex of both polygons.  A circle
//      or box pair (CcLane, CbLane, BbLane, AreaCbLane; its one lane, whose
//      four cotangents it alone reads) into the rows it read: a circle's
//      centre, a box's lb and ub (cb_lane_bwd, bb_lane_bwd,
//      area_cb_lane_bwd: the clip of the centre into the box, the floors,
//      the box-box lane's nested minimum and its contact point's min and
//      max split a tie's cotangent half and half; the face and wall
//      selections take none; a box-box lane sends nothing to an angle,
//      its rows translating without rotation).  Every term
//      of a pair's adjoint is a product with one of its lane cotangents, so
//      a pair whose cotangents are all zero (its lanes inactive, in a world
//      without NaN) is skipped.  Each pair writes its parts' vertex
//      cotangents to a slot of its own; each part then sums its pairs'
//      slots in pair order.
//   4. Vertex adjoint: an overridden part writes its cotangents to its rows
//      of dtx, dty (rows past the vertices it reads are 0); a body part adds
//      them to its body's x and y and, when it rotates (a polygon or a
//      circle; a box translates only, P_ROTATE = 0, as at
//      pallas_step.py:172-185), to its angle through the cosine and sine.
//      Static bodies receive their cotangents too, as from jax.vjp.
//   5. Integration adjoint: gravity is a constant, so in either order
//      dv += dq * dt and domega += dangle * dt.
//
// What bounds it: at the crate pile's shapes (88 one-lane pairs, C=88,
// n=14, B=8192) a call reads 12 [n,B] planes (the primal state and the
// output cotangents) and writes 6, about 8 MB, 2.5 us at 3.35 TB/s; its
// float32 operations, the forward step again, the solver reverse pass's
// (about twice the solve) and the touching pairs' adjoints, are about 385
// M, 5.7 us at 67 TFLOP/s.  Its tape (the solver's, 4,888 floats a world
// at these shapes, plus the contact planes, their cotangents and the
// flags, 5,614 in all: 184 MB at B=8192) is written once and read about
// twice.  As in the solver's reverse pass, latency bounds it, and the
// design is the same: one warp walks one world, W worlds a block (the
// wrapper's plan), the warp's threads taking the world's bodies, parts and
// pairs in turn and, in the solve, its lanes; sums over a body's lanes or
// parts and over a part's pairs are taken in the serial kernel's order, so
// every launch gives the same bits, with no float atomics.  The
// integrated state, the vertices, their cotangents and the pairs' slots
// sit in dynamic shared memory beside the solver walk's (BwdSmem, sized
// by n, C, the parts and the pairs); a pair's SAT, clip and adjoint run in
// one thread's registers and stack.  Built, like the other sources,
// without fast math and with --fmad=false.

#include "fused_step.cuh"

namespace {

struct StepGrads {
  float *dpx, *dpy, *dvx, *dvy, *dang, *dom;  // [n, B]
  float *dtx, *dty;  // [k * V, B]
};

// adjoint of edge v's unit normal in edge_axes: its cotangent (g_nx, g_ny)
// into the edge's two vertices (rsqrt's backward is -g r^3 / 2)
__device__ void edge_axis_bwd(const float* wx, const float* wy, int V, int v,
                              float g_nx, float g_ny, float* gx, float* gy) {
  const int j = v + 1 < V ? v + 1 : 0;
  const float ex = wx[j] - wx[v];
  const float ey = wy[j] - wy[v];
  const float nx = ey, ny = -ex;
  const float ln2 = nx * nx + ny * ny;
  const float inv = rsqrtf(ln2 <= 0.0f ? 1.0f : ln2);
  float g_rx = g_nx * inv, g_ry = g_ny * inv;
  if (ln2 > 0.0f) {
    const float g_inv = g_nx * nx + g_ny * ny;
    const float g_ln2 = -0.5f * g_inv * (inv * inv * inv);
    g_rx += 2.0f * nx * g_ln2;
    g_ry += 2.0f * ny * g_ln2;
  }
  // (nx, ny) = (ey, -ex)
  gx[j] -= g_ry;
  gx[v] += g_ry;
  gy[j] += g_rx;
  gy[v] -= g_rx;
}

// adjoint of project: the cotangents of the min and the max of the
// projections on (nx, ny), replayed through both chains in order, into the
// vertices (gx, gy) and the axis (g_nx, g_ny)
__device__ void project_bwd(float nx, float ny, const float* wx,
                            const float* wy, int V, float g_mn, float g_mx,
                            float* gx, float* gy, float& g_nx, float& g_ny) {
  float p[MAX_V], mn[MAX_V], mx[MAX_V];
  p[0] = mn[0] = mx[0] = nx * wx[0] + ny * wy[0];
  for (int v = 1; v < V; ++v) {
    p[v] = nx * wx[v] + ny * wy[v];
    mn[v] = minp(mn[v - 1], p[v]);
    mx[v] = maxp(mx[v - 1], p[v]);
  }
  for (int v = V - 1; v >= 0; --v) {
    float g_p = g_mn + g_mx;  // vertex 0 starts both chains
    if (v > 0) {
      float g_a, g_b, g_c, g_d;
      min_bwd(mn[v - 1], p[v], g_mn, g_a, g_b);
      max_bwd(mx[v - 1], p[v], g_mx, g_c, g_d);
      g_mn = g_a;
      g_mx = g_c;
      g_p = g_b + g_d;
    }
    gx[v] += g_p * nx;
    gy[v] += g_p * ny;
    g_nx += g_p * wx[v];
    g_ny += g_p * wy[v];
  }
}

// adjoint of Clip::run: the cotangents of the clipped points (q0, q1) into
// those of the segment (p0, p1), the anchor an and the direction d
__device__ void clip_bwd(const Clip& k, float g_q0x, float g_q0y, float g_q1x,
                         float g_q1y, float& g_p0x, float& g_p0y, float& g_p1x,
                         float& g_p1y, float& g_anx, float& g_any, float& g_dx,
                         float& g_dy) {
  const float g_inx = (k.cut0 ? g_q0x : 0.0f) + (k.cut1 ? g_q1x : 0.0f);
  const float g_iny = (k.cut0 ? g_q0y : 0.0f) + (k.cut1 ? g_q1y : 0.0f);
  g_p0x = k.cut0 ? 0.0f : g_q0x;
  g_p0y = k.cut0 ? 0.0f : g_q0y;
  g_p1x = k.cut1 ? 0.0f : g_q1x;
  g_p1y = k.cut1 ? 0.0f : g_q1y;
  // in = p0 + frac * (p1 - p0)
  const float g_frac = g_inx * (k.p1x - k.p0x) + g_iny * (k.p1y - k.p0y);
  g_p0x += g_inx - g_inx * k.frac;
  g_p0y += g_iny - g_iny * k.frac;
  g_p1x += g_inx * k.frac;
  g_p1y += g_iny * k.frac;
  // frac = d0 / where(den == 0, 1, den)
  float g_d0 = g_frac / k.sden, g_d1 = 0.0f;
  if (k.den != 0.0f) {
    const float g_den = -g_frac * (k.frac / k.sden);
    g_d0 += g_den;
    g_d1 -= g_den;
  }
  // d = (p - an) . dir
  g_p0x += g_d0 * k.dx;
  g_p0y += g_d0 * k.dy;
  g_p1x += g_d1 * k.dx;
  g_p1y += g_d1 * k.dy;
  g_anx = -(g_d0 * k.dx) - g_d1 * k.dx;
  g_any = -(g_d0 * k.dy) - g_d1 * k.dy;
  g_dx = g_d0 * (k.p0x - k.anx) + g_d1 * (k.p1x - k.anx);
  g_dy = g_d0 * (k.p0y - k.any) + g_d1 * (k.p1y - k.any);
}

// add the cotangents of an edge's endpoints (edge e of a polygon of V
// vertices; -1: no edge was taken, the endpoints were constants)
__device__ void edge_points_bwd(int e, int V, float g0x, float g0y, float g1x,
                                float g1y, float* gx, float* gy) {
  if (e < 0) return;
  const int j = e + 1 < V ? e + 1 : 0;
  gx[e] += g0x;
  gy[e] += g0y;
  gx[j] += g1x;
  gy[j] += g1y;
}

// adjoint of one pair (s, recomputed by PairSat::run): g holds the
// cotangents of its lanes' pen_x, pen_y, pt_x, pt_y (lane 0, lane 1 each);
// they go into the vertex cotangents of A (gax, gay) and B (gbx, gby)
__device__ void pair_bwd(const PairSat& s, const float* ax, const float* ay,
                         int Va, const float* bx, const float* by, int Vb,
                         const float* g, float* gax, float* gay, float* gbx,
                         float* gby) {
  // pen = n * ld * a (a the lane's flag), pt = c
  const float m0 = s.a0 ? 1.0f : 0.0f, m1 = s.a1 ? 1.0f : 0.0f;
  const float gl0x = g[0] * m0, gl1x = g[1] * m1;
  const float gl0y = g[2] * m0, gl1y = g[3] * m1;
  float g_nx = gl0x * s.ld0 + gl1x * s.ld1;
  float g_ny = gl0y * s.ld0 + gl1y * s.ld1;
  const float g_ld0 = gl0x * s.n_x + gl0y * s.n_y;
  const float g_ld1 = gl1x * s.n_x + gl1y * s.n_y;
  // ld = where(none_kept, depth, max(d, 1e-6))
  float g_depth = 0.0f, g_d0 = 0.0f, g_d1 = 0.0f, g_floor;
  if (s.none_kept) {
    g_depth = g_ld0 + g_ld1;
  } else {
    max_bwd(s.d0, 1e-6f, g_ld0, g_d0, g_floor);
    max_bwd(s.d1, 1e-6f, g_ld1, g_d1, g_floor);
  }
  // d = -((c - r0) . nref)
  const float h0 = -g_d0, h1 = -g_d1;
  const float g_c0x = g[4] + h0 * s.nrefx, g_c0y = g[6] + h0 * s.nrefy;
  const float g_c1x = g[5] + h1 * s.nrefx, g_c1y = g[7] + h1 * s.nrefy;
  float g_r0x = -(h0 * s.nrefx) - h1 * s.nrefx;
  float g_r0y = -(h0 * s.nrefy) - h1 * s.nrefy;
  const float g_nrefx = h0 * (s.c0x - s.r0x) + h1 * (s.c1x - s.r0x);
  const float g_nrefy = h0 * (s.c0y - s.r0y) + h1 * (s.c1y - s.r0y);
  g_nx += s.ref_is_a ? -g_nrefx : g_nrefx;
  g_ny += s.ref_is_a ? -g_nrefy : g_nrefy;
  // the second clip, against -t at r1
  float g_p0x, g_p0y, g_p1x, g_p1y, g_anx, g_any, g_dx, g_dy;
  clip_bwd(s.clip1, g_c0x, g_c0y, g_c1x, g_c1y, g_p0x, g_p0y, g_p1x, g_p1y,
           g_anx, g_any, g_dx, g_dy);
  float g_r1x = g_anx, g_r1y = g_any;
  float g_tx = -g_dx, g_ty = -g_dy;
  // the first clip: the incident edge against t at r0
  float g_i0x, g_i0y, g_i1x, g_i1y;
  clip_bwd(s.clip0, g_p0x, g_p0y, g_p1x, g_p1y, g_i0x, g_i0y, g_i1x, g_i1y,
           g_anx, g_any, g_dx, g_dy);
  g_r0x += g_anx;
  g_r0y += g_any;
  g_tx += g_dx;
  g_ty += g_dy;
  // t = (r1 - r0) * rsqrt(|r1 - r0|^2)
  float g_t0x = g_tx * s.tl, g_t0y = g_ty * s.tl;
  const float tl2 = s.tx0 * s.tx0 + s.ty0 * s.ty0;
  if (tl2 > 0.0f) {
    const float g_tl = g_tx * s.tx0 + g_ty * s.ty0;
    const float g_tl2 = -0.5f * g_tl * (s.tl * s.tl * s.tl);
    g_t0x += 2.0f * s.tx0 * g_tl2;
    g_t0y += 2.0f * s.ty0 * g_tl2;
  }
  g_r1x += g_t0x;
  g_r1y += g_t0y;
  g_r0x -= g_t0x;
  g_r0y -= g_t0y;
  // the reference edge is one polygon's candidate, the incident the other's
  if (s.ref_is_a) {
    edge_points_bwd(s.ea, Va, g_r0x, g_r0y, g_r1x, g_r1y, gax, gay);
    edge_points_bwd(s.eb, Vb, g_i0x, g_i0y, g_i1x, g_i1y, gbx, gby);
  } else {
    edge_points_bwd(s.eb, Vb, g_r0x, g_r0y, g_r1x, g_r1y, gbx, gby);
    edge_points_bwd(s.ea, Va, g_i0x, g_i0y, g_i1x, g_i1y, gax, gay);
  }
  if (s.axis < 0) return;  // no axis taken: n and depth were constants
  // n = N[axis] * sign; depth = max(best, 0), best = ovl[axis]
  float g_Nx = g_nx * s.bsign, g_Ny = g_ny * s.bsign;
  float g_best;
  max_bwd(s.best, 0.0f, g_depth, g_best, g_floor);
  float g_op, g_on;
  min_bwd(s.o_pos, s.o_neg, g_best, g_op, g_on);
  // o_pos = max_B - min_A, o_neg = max_A - min_B
  const float nx = s.NX[s.axis], ny = s.NY[s.axis];
  project_bwd(nx, ny, ax, ay, Va, -g_op, g_on, gax, gay, g_Nx, g_Ny);
  project_bwd(nx, ny, bx, by, Vb, -g_on, g_op, gbx, gby, g_Nx, g_Ny);
  if (s.axis < Va) {
    edge_axis_bwd(ax, ay, Va, s.axis, g_Nx, g_Ny, gax, gay);
  } else {
    edge_axis_bwd(bx, by, Vb, s.axis - Va, g_Nx, g_Ny, gbx, gby);
  }
}

// adjoint of CcLane::run (l, recomputed): g holds the cotangents of its
// lane's pen_x, pen_y, pt_x, pt_y; they go into the centre rows of A (ga)
// and B (gb)
__device__ void cc_lane_bwd(const CcLane& l, const float* g, float* gax,
                            float* gay, float* gbx, float* gby) {
  // pen = u * depth * active
  const float m = l.out.active ? 1.0f : 0.0f;
  const float gpx = g[0] * m, gpy = g[1] * m;
  float g_ux = gpx * maxp(l.over, 0.0f), g_uy = gpy * maxp(l.over, 0.0f);
  const float g_depth = gpx * l.ux + gpy * l.uy;
  // pt = where(same_side, where(b_in_a, cb, ca), (cb + u * k + ca) / 2)
  if (l.same_side) {
    if (l.b_in_a) {
      gbx[0] += g[2];
      gby[0] += g[3];
    } else {
      gax[0] += g[2];
      gay[0] += g[3];
    }
  } else {
    const float hx = g[2] / 2.0f, hy = g[3] / 2.0f;
    gax[0] += hx;
    gay[0] += hy;
    gbx[0] += hx;
    gby[0] += hy;
    g_ux += hx * l.k;
    g_uy += hy * l.k;
  }
  // depth = max(rsum - dist, 0)
  float g_over, g_floor;
  max_bwd(l.over, 0.0f, g_depth, g_over, g_floor);
  const float g_dist = -g_over;
  // u = where(d2 == 0, (1, 0), d * inv); dist = d2 * inv; inv = rsqrt(d2)
  float g_dx = 0.0f, g_dy = 0.0f, g_inv = g_dist * l.d2;
  if (l.d2 != 0.0f) {
    g_dx += g_ux * l.inv;
    g_dy += g_uy * l.inv;
    g_inv += g_ux * l.dx + g_uy * l.dy;
  }
  float g_d2 = g_dist * l.inv;
  if (l.d2 > 0.0f) g_d2 += -0.5f * g_inv * (l.inv * l.inv * l.inv);
  g_dx += 2.0f * l.dx * g_d2;
  g_dy += 2.0f * l.dy * g_d2;
  // d = ca - cb
  gax[0] += g_dx;
  gay[0] += g_dy;
  gbx[0] -= g_dx;
  gby[0] -= g_dy;
}

// adjoint of the clamp cc = min(max(c, lo), hi): g added into c, lo and hi
__device__ void clamp_bwd(float c, float lo, float hi, float g, float& g_c,
                         float& g_lo, float& g_hi) {
  float g_m, g_hi_, g_lo_, g_c_;
  min_bwd(maxp(c, lo), hi, g, g_m, g_hi_);
  max_bwd(c, lo, g_m, g_c_, g_lo_);
  g_c += g_c_;
  g_lo += g_lo_;
  g_hi += g_hi_;
}

// adjoint of CbLane::run (l, recomputed, at the circle's centre c and
// radius r and the box's lb, ub): g as for cc_lane_bwd; into the circle's
// centre row (gc) and the box's rows 0 and 1 (gb)
__device__ void cb_lane_bwd(const CbLane& l, float cx, float cy, float r,
                            float lbx, float lby, float ubx, float uby,
                            const float* g, float* gcx, float* gcy,
                            float* gbx, float* gby) {
  const float m = l.out.active ? 1.0f : 0.0f;
  const float gpx = g[0] * m, gpy = g[1] * m;
  float g_cx = 0.0f, g_cy = 0.0f, g_ccx = g[2], g_ccy = g[3];
  float g_lbx = 0.0f, g_lby = 0.0f, g_ubx = 0.0f, g_uby = 0.0f;
  if (l.perfect_vertex) {
    // pv = -(c + r * uv - cc)
    g_cx -= gpx;
    g_cy -= gpy;
    g_ccx += gpx;
    g_ccy += gpy;
    const float g_uvx = -gpx * r, g_uvy = -gpy * r;
    // uv = where(dd == 0, (1, 0), dv * inv), inv = rsqrt(dd)
    float g_dvx = 0.0f, g_dvy = 0.0f, g_inv = 0.0f;
    if (l.dd != 0.0f) {
      g_dvx += g_uvx * l.inv;
      g_dvy += g_uvy * l.inv;
      g_inv += g_uvx * l.dvx + g_uvy * l.dvy;
    }
    if (l.dd > 0.0f) {
      const float g_dd = -0.5f * g_inv * (l.inv * l.inv * l.inv);
      g_dvx += 2.0f * l.dvx * g_dd;
      g_dvy += 2.0f * l.dvy * g_dd;
    }
    // dv = cc - c
    g_ccx += g_dvx;
    g_ccy += g_dvy;
    g_cx -= g_dvx;
    g_cy -= g_dvy;
  } else {
    // pf = (where(is2, -s2, where(is3, s3, 0)), where(is0, -s0, where(is1,
    // s1, 0))); s0 = cy + r - lby, s1 = uby - (cy - r), s2 = cx + r - lbx,
    // s3 = ubx - (cx - r)
    if (l.is2) {
      g_cx -= gpx;
      g_lbx += gpx;
    } else if (l.is3) {
      g_ubx += gpx;
      g_cx -= gpx;
    }
    if (l.is0) {
      g_cy -= gpy;
      g_lby += gpy;
    } else if (l.is1) {
      g_uby += gpy;
      g_cy -= gpy;
    }
  }
  clamp_bwd(cx, lbx, ubx, g_ccx, g_cx, g_lbx, g_ubx);
  clamp_bwd(cy, lby, uby, g_ccy, g_cy, g_lby, g_uby);
  gcx[0] += g_cx;
  gcy[0] += g_cy;
  gbx[0] += g_lbx;
  gby[0] += g_lby;
  gbx[1] += g_ubx;
  gby[1] += g_uby;
}

// adjoint of AreaCbLane::run (l, recomputed): g as for cc_lane_bwd; into
// the contained circle's centre row (gc) and the area box's rows 0 and 1
// (gb).  pen = (-max(hx, 0) + max(lx, 0), -max(hy, 0) + max(ly, 0)) *
// active with hx = cx + r - ubx, lx = lbx - (cx - r) and so on; each
// branch of the contact point is the centre plus a constant.
__device__ void area_cb_lane_bwd(const AreaCbLane& l, const float* g,
                                 float* gcx, float* gcy, float* gbx,
                                 float* gby) {
  const float m = l.out.active ? 1.0f : 0.0f;
  const float gpx = g[0] * m, gpy = g[1] * m;
  float g_hx, g_hy, g_lx, g_ly, g_floor;
  max_bwd(l.hx, 0.0f, -gpx, g_hx, g_floor);
  max_bwd(l.hy, 0.0f, -gpy, g_hy, g_floor);
  max_bwd(l.lx, 0.0f, gpx, g_lx, g_floor);
  max_bwd(l.ly, 0.0f, gpy, g_ly, g_floor);
  gcx[0] += g[2] + g_hx - g_lx;
  gcy[0] += g[3] + g_hy - g_ly;
  gbx[0] += g_lx;
  gby[0] += g_ly;
  gbx[1] -= g_hx;
  gby[1] -= g_hy;
}

// adjoint of BbLane::run (l, recomputed, at the boxes' rows la, ua of A and
// lb, ub of B): g as for cc_lane_bwd; into A's rows 0 and 1 (ga) and B's
// (gb).  pen = (where(is2, -m, where(is3, m, 0)), where(is0, -m, where(is1,
// m, 0))) * active with m = max(best, 0), best the nested minimum of the
// floored overlaps d = max(e, -eps); pt = (min(ua, ub) + max(la, lb)) / 2.
// Every min and max splits a tie's cotangent half and half.
__device__ void bb_lane_bwd(const BbLane& l, float lax, float lay, float uax,
                            float uay, float lbx, float lby, float ubx,
                            float uby, const float* g, float* gax, float* gay,
                            float* gbx, float* gby) {
  const float a = l.out.active ? 1.0f : 0.0f;
  const float gpx = g[0] * a, gpy = g[1] * a;
  const float g_m = (l.is2 ? -gpx : (l.is3 ? gpx : 0.0f)) +
                    (l.is0 ? -gpy : (l.is1 ? gpy : 0.0f));
  float g_best, g_floor, g01, g23, gd[4], ge[4];
  max_bwd(l.best, 0.0f, g_m, g_best, g_floor);
  min_bwd(minp(l.d[0], l.d[1]), minp(l.d[2], l.d[3]), g_best, g01, g23);
  min_bwd(l.d[0], l.d[1], g01, gd[0], gd[1]);
  min_bwd(l.d[2], l.d[3], g23, gd[2], gd[3]);
  for (int k = 0; k < 4; ++k) max_bwd(l.e[k], -1e-8f, gd[k], ge[k], g_floor);
  // e0 = uay - lby, e1 = uby - lay, e2 = uax - lbx, e3 = ubx - lax
  float g_uax = ge[2], g_uay = ge[0], g_lax = -ge[3], g_lay = -ge[1];
  float g_ubx = ge[3], g_uby = ge[1], g_lbx = -ge[2], g_lby = -ge[0];
  float ga_, gb_;
  const float hx = g[2] / 2.0f, hy = g[3] / 2.0f;
  min_bwd(uax, ubx, hx, ga_, gb_);
  g_uax += ga_;
  g_ubx += gb_;
  max_bwd(lax, lbx, hx, ga_, gb_);
  g_lax += ga_;
  g_lbx += gb_;
  min_bwd(uay, uby, hy, ga_, gb_);
  g_uay += ga_;
  g_uby += gb_;
  max_bwd(lay, lby, hy, ga_, gb_);
  g_lay += ga_;
  g_lby += gb_;
  gax[0] += g_lax;
  gay[0] += g_lay;
  gax[1] += g_uax;
  gay[1] += g_uay;
  gbx[0] += g_lbx;
  gby[0] += g_lby;
  gbx[1] += g_ubx;
  gby[1] += g_uby;
}

// whether any of the k cotangents g is nonzero
__device__ bool any_nonzero(const float* g, int k) {
  for (int i = 0; i < k; ++i) {
    if (g[i] != 0.0f) return true;
  }
  return false;
}

// Offsets in one world's tape, in floats: the solver's tape, then the
// recomputed contact planes and their cotangents.
struct StepTape {
  int geo, dgeo, flags, rows;
  __host__ __device__ StepTape(int C, int n, int I, int P) {
    int r = Tape(C, n, I, P).rows;
    geo = r;  // pen_x, pen_y, pt_x, pt_y [4, C]
    r += 4 * C;
    dgeo = r;  // their cotangents [4, C]
    r += 4 * C;
    flags = r;  // the active flags, uint8 [C]
    r += byte_words(C);
    rows = r;
  }
};

// Offsets in one world's shared memory, in words of sizeof(float): the
// state both fused kernels keep (StepSmem), then the reverse pass's own.
// R is the most vertex rows a pair reads of one of its parts.
struct BwdSmem {
  int state, qc, qs, wx, wy, gwx, gwy, slot, words;
  __host__ __device__ BwdSmem(int C, int n, int P, int npairs, int R) {
    const StepSmem m(C, n, P);
    state = m.state;
    qc = m.qc;
    qs = m.qs;
    wx = m.wx;
    wy = m.wy;
    int r = m.words;
    gwx = r;  // the vertices' cotangents [P, MAX_V]
    r += P * MAX_V;
    gwy = r;
    r += P * MAX_V;
    slot = r;  // each pair's: x and y of its part A's rows, then B's
    r += npairs * 4 * R;  // [npairs, 4, R]
    words = r;
  }
};

// the cotangents of the step's six output body planes [n, B]
struct StepCots {
  const float *gpx, *gpy, *gvx, *gvy, *gang, *gom;
};

// adjoint of pair q's lanes, whose pen_x, pen_y, pt_x, pt_y cotangents are
// at dgeo [4, C], into its slot sl: the cotangents of part A's vertex rows
// (x, then y) and of part B's, each [R] (a pair reads at most R rows of a
// part)
__device__ void pair_adjoint(const StepArgs& st, int q, const float* wx,
                             const float* wy, const float* dgeo, int C, int R,
                             float* sl) {
  for (int k = 0; k < 4 * R; ++k) sl[k] = 0.0f;
  float* gax = sl;
  float* gay = sl + R;
  float* gbx = sl + 2 * R;
  float* gby = sl + 3 * R;
  const int32_t* qi = st.pair_i + q * PAIR_COLS;
  const int pa = qi[Q_A] * MAX_V, pb = qi[Q_B] * MAX_V;
  const int c = qi[Q_LANE];
  const float ra = st.pair_f[2 * q], rb = st.pair_f[2 * q + 1];
  if (qi[Q_KIND] == K_PP) {
    const float g[8] = {dgeo[c], dgeo[c + 1], dgeo[C + c], dgeo[C + c + 1],
                        dgeo[2 * C + c], dgeo[2 * C + c + 1],
                        dgeo[3 * C + c], dgeo[3 * C + c + 1]};
    if (!any_nonzero(g, 8)) return;
    PairSat s;
    s.run(wx + pa, wy + pa, qi[Q_VA], qi[Q_MASK_A], wx + pb, wy + pb,
          qi[Q_VB], qi[Q_MASK_B]);
    pair_bwd(s, wx + pa, wy + pa, qi[Q_VA], wx + pb, wy + pb, qi[Q_VB], g,
             gax, gay, gbx, gby);
    return;
  }
  // a one-lane pair reads its own lane's cotangents only
  const float g[4] = {dgeo[c], dgeo[C + c], dgeo[2 * C + c], dgeo[3 * C + c]};
  if (!any_nonzero(g, 4)) return;
  switch (qi[Q_KIND]) {
    case K_CC: {
      CcLane l;
      l.run(wx[pa], wy[pa], ra, wx[pb], wy[pb], rb);
      cc_lane_bwd(l, g, gax, gay, gbx, gby);
      break;
    }
    case K_CB: {
      CbLane l;
      l.run(wx[pa], wy[pa], ra, wx[pb], wy[pb], wx[pb + 1], wy[pb + 1]);
      cb_lane_bwd(l, wx[pa], wy[pa], ra, wx[pb], wy[pb], wx[pb + 1],
                  wy[pb + 1], g, gax, gay, gbx, gby);
      break;
    }
    case K_AREA_CB: {
      AreaCbLane l;
      l.run(wx[pa], wy[pa], ra, wx[pb], wy[pb], wx[pb + 1], wy[pb + 1]);
      area_cb_lane_bwd(l, g, gax, gay, gbx, gby);
      break;
    }
    case K_BB: {
      BbLane l;
      l.run(wx[pa], wy[pa], wx[pa + 1], wy[pa + 1], wx[pb], wy[pb],
            wx[pb + 1], wy[pb + 1]);
      bb_lane_bwd(l, wx[pa], wy[pa], wx[pa + 1], wy[pa + 1], wx[pb], wy[pb],
                  wx[pb + 1], wy[pb + 1], g, gax, gay, gbx, gby);
      break;
    }
    default:
      break;
  }
}

// at least 2 blocks an SM: at most 128 registers a thread.  Left free, ptxas
// takes 188 with no spill, one block an SM runs, and the pass is 1.3-1.4x
// slower (NVIDIA H100 80GB HBM3, tools/bench_kernels.py)
__global__ void __launch_bounds__(LANES * MAX_WORLDS_PER_BLOCK, 2)
fused_step_bwd_kernel(const SolveOps o, const StepArgs st, const StepCots cot,
                      const StepGrads out, float* scratch, int rows, int R,
                      int B, int W) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int b = blockIdx.x * W + warp;
  if (b >= B) return;
  const size_t Bs = B;
  const int C = o.C, n = o.n;
  const BwdSmem M(C, n, st.P, st.npairs, R);
  const StepTape L(C, n, o.iterations, o.position_iterations);
  float* s = smem + warp * M.words;
  float* t = scratch + (size_t)b * rows;
  float* state = s + M.state;
  float *qc = s + M.qc, *qs = s + M.qs;
  float *wx = s + M.wx, *wy = s + M.wy;
  float *gwx = s + M.gwx, *gwy = s + M.gwy;
  float* geo = t + L.geo;
  float* dgeo = t + L.dgeo;
  uint8_t* flags = reinterpret_cast<uint8_t*>(t + L.flags);

  // 1. the recompute, the forward kernel's first phase
  integrate_and_collide(st, o.movable, o.dt, n, C, Bs, b, lane, state, qc, qs,
                        wx, wy, geo, flags);

  // 2. the solver's reverse walk on those planes and the integrated state
  const WorldIO io{
      Rows{geo, 1}, Rows{geo + C, 1}, Rows{geo + 2 * C, 1},
      Rows{geo + 3 * C, 1},
      flags, 1,
      Rows{state, 1}, Rows{state + n, 1}, Rows{state + 2 * n, 1},
      Rows{state + 3 * n, 1}, Rows{state + 4 * n, 1}, Rows{state + 5 * n, 1},
      Rows{cot.gpx + b, Bs}, Rows{cot.gpy + b, Bs}, Rows{cot.gvx + b, Bs},
      Rows{cot.gvy + b, Bs}, Rows{cot.gang + b, Bs}, Rows{cot.gom + b, Bs},
      dgeo, dgeo + C, dgeo + 2 * C, dgeo + 3 * C, 1};
  Walk<true> w(o, io, t, s, lane);
  w.run();

  // 3. the lanes' adjoint by pair, into its slot; then each part's vertex
  // cotangents, its pairs' slots summed in pair order
  for (int q = lane; q < st.npairs; q += LANES) {
    pair_adjoint(st, q, wx, wy, dgeo, C, R, s + M.slot + q * 4 * R);
  }
  __syncwarp();
  for (int p = lane; p < st.P; p += LANES) {
    float* px = gwx + p * MAX_V;
    float* py = gwy + p * MAX_V;
    for (int v = 0; v < MAX_V; ++v) px[v] = py[v] = 0.0f;
    for (int q = 0; q < st.npairs; ++q) {
      const int32_t* qi = st.pair_i + q * PAIR_COLS;
      const float* sl = s + M.slot + q * 4 * R;
      if (qi[Q_A] == p) {
        for (int v = 0; v < R; ++v) {
          px[v] += sl[v];
          py[v] += sl[R + v];
        }
      } else if (qi[Q_B] == p) {
        for (int v = 0; v < R; ++v) {
          px[v] += sl[2 * R + v];
          py[v] += sl[3 * R + v];
        }
      }
    }
    // an overridden part's into its rows of dtx, dty (rows past the
    // vertices it reads are 0)
    const int32_t* pi = st.part_i + p * PART_COLS;
    if (pi[P_OVR] >= 0) {
      const int nv = pi[P_NV];
      const size_t row = (size_t)pi[P_OVR] * st.V;
      for (int v = 0; v < st.V; ++v) {
        out.dtx[(row + v) * Bs + b] = v < nv ? px[v] : 0.0f;
        out.dty[(row + v) * Bs + b] = v < nv ? py[v] : 0.0f;
      }
    }
  }
  __syncwarp();

  // 4. the vertices of each body's parts, in part order, into its pose:
  // px = c lx - s ly + x, py = s lx + c ly + y (a box: lx + x, ly + y);
  // 5. the integration: q = p + v dt, and gravity adds a constant to v
  for (int i = lane; i < n; i += LANES) {
    float gx = w.body(S_GQX)[i], gy = w.body(S_GQY)[i], ga = w.body(S_GQA)[i];
    for (int p = 0; p < st.P; ++p) {
      const int32_t* pi = st.part_i + p * PART_COLS;
      if (pi[P_OVR] >= 0 || pi[P_BODY] != i) continue;
      const int nv = pi[P_NV];
      const float* gpx = gwx + p * MAX_V;
      const float* gpy = gwy + p * MAX_V;
      const float* lv = st.part_lv + (size_t)p * st.V * 2;
      float g_c = 0.0f, g_s = 0.0f;
      for (int v = 0; v < nv; ++v) {
        const float lx = lv[2 * v], ly = lv[2 * v + 1];
        gx += gpx[v];
        gy += gpy[v];
        g_c += gpx[v] * lx + gpy[v] * ly;
        g_s += gpy[v] * lx - gpx[v] * ly;
      }
      if (pi[P_ROTATE]) ga += g_s * qc[i] - g_c * qs[i];
    }
    const size_t k = i * Bs + b;
    out.dpx[k] = gx;
    out.dpy[k] = gy;
    out.dang[k] = ga;
    out.dvx[k] = w.body(S_GVX)[i] + gx * o.dt;
    out.dvy[k] = w.body(S_GVY)[i] + gy * o.dt;
    out.dom[k] = w.body(S_GOM)[i] + ga * o.dt;
  }
}

}  // namespace

// Floats of scratch the reverse pass needs per world.
extern "C" int fused_step_bwd_scratch_rows(int C, int n, int iterations,
                                           int position_iterations) {
  return StepTape(C, n, iterations, position_iterations).rows;
}

// Bytes of dynamic shared memory one world of the reverse pass takes; R is
// the most vertex rows a pair reads of one of its parts.
extern "C" int fused_step_bwd_smem_bytes(int C, int n, int P, int npairs,
                                         int R) {
  return BwdSmem(C, n, P, npairs, R).words * (int)sizeof(float);
}

// Launches the reverse pass on `stream` and returns cudaGetLastError().
// Inputs as in fused_step_fwd; g* are the cotangents of its six output
// body planes, d* receive those of its six input body planes and dtx, dty
// those of the terrain planes; body_lanes is the per-body lane list of
// SolveOps; scratch is [B, fused_step_bwd_scratch_rows(...)]; pair_rows is
// the most vertex rows a pair reads of one of its parts; worlds_per_block
// (1 to 8) worlds share a block, one warp each.
extern "C" int fused_step_bwd(
    const float* px, const float* py, const float* vx, const float* vy,
    const float* ang, const float* om, const float* tx, const float* ty,
    const float* gpx, const float* gpy, const float* gvx, const float* gvy,
    const float* gang, const float* gom,
    float* dpx, float* dpy, float* dvx, float* dvy, float* dang, float* dom,
    float* dtx, float* dty,
    const int32_t* part_i, const float* part_lv, const int32_t* pair_i,
    const float* pair_f, const int32_t* body_a, const int32_t* body_b, const int32_t* partner,
    const float* lane_const, const int32_t* movable,
    const float* body_im, const float* body_ii,
    const int32_t* joint_body, const float* joint_f,
    const int32_t* body_lanes, float* scratch,
    int P, int npairs, int lanes, int V, int symplectic,
    float gdx, float gdy,
    int B, int C, int n, int J, int iterations, int position_iterations,
    float dt, float baumgarte, float slop, float baumgarte_dt,
    float max_bias, int has_max_bias, int pair_rows, int worlds_per_block,
    void* stream) {
  const int W = worlds_per_block, R = pair_rows;
  const size_t smem =
      (size_t)W * BwdSmem(C, n, P, npairs, R).words * sizeof(float);
  // lanes: what the pairs' kinds give, two a pp pair and one any other
  if (V > MAX_V || C != lanes || lanes < npairs || lanes > 2 * npairs ||
      B <= 0 || R < 1 || R > MAX_V || W < 1 || W > MAX_WORLDS_PER_BLOCK ||
      smem > SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_step_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const SolveOps ops{body_a, body_b, partner, lane_const, movable,
                     body_im, body_ii, joint_body, joint_f, body_lanes,
                     C, n, J, iterations, position_iterations,
                     dt, baumgarte, slop, baumgarte_dt, max_bias, has_max_bias};
  const StepArgs st{px, py, vx, vy, ang, om, tx, ty, part_i, part_lv, pair_i,
                    pair_f, P, npairs, V, symplectic, gdx, gdy};
  const StepCots cot{gpx, gpy, gvx, gvy, gang, gom};
  const StepGrads out{dpx, dpy, dvx, dvy, dang, dom, dtx, dty};
  const int rows = StepTape(C, n, iterations, position_iterations).rows;
  const int blocks = (B + W - 1) / W, threads = W * LANES;
  fused_step_bwd_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      ops, st, cot, out, scratch, rows, R, B, W);
  return (int)cudaGetLastError();
}
