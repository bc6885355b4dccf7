// Device code shared by the fused step (fused_step.cu) and its reverse pass
// (fused_step_bwd.cu), one CUDA thread per world: integration and gravity,
// the world-frame vertices, each polygon pair's SAT and reference-face clip,
// and each circle-circle, circle-box and circle-in-area-box pair's analytic
// lane.  The reverse pass recomputes the step with exactly this code, so its
// decisions (the SAT's best axis, sign, reference edge, clip cuts and kept
// points; a circle lane's branches) are the forward kernel's to the bit.
// See fused_step.cu for what it computes and the rules it follows.

#pragma once

#include <math.h>

#include "contact_solver.cuh"

namespace {

constexpr int MAX_PARTS = 16;  // ops/fused_step.py MAX_PARTS
constexpr int MAX_V = 8;  // geometry/shapes.py MAX_VERTS
constexpr int MAX_AXES = 2 * MAX_V;

// columns of part_i [P, PART_COLS] and pair_i [npairs, PAIR_COLS]
enum PartCol { P_BODY, P_ROTATE, P_NV, PART_COLS };
enum PairCol { Q_A, Q_B, Q_VA, Q_VB, Q_MASK_A, Q_MASK_B, Q_LANE, Q_KIND, PAIR_COLS };
// pair kinds (pair_i's Q_KIND), in the order of ops/fused_step.py's _KINDS:
// two SAT lanes, or one analytic lane
enum PairKind { K_PP, K_CC, K_CB, K_AREA_CB };

struct StepArgs {
  const float *px, *py, *vx, *vy, *ang, *om;  // [n, B] before the step
  const float *tx, *ty;  // [k * V, B]: the k-th overridden part's rows
  const int32_t* part_i;  // owning body, rotates (0/1), vertices in use
  const float* part_lv;  // [P, V, 2] local vertices, repeat-padded
  const int32_t* pair_i;  // parts a, b; trimmed Va, Vb; edge-mask bits;
                          // first lane; kind
  const float* pair_f;  // [npairs, 2]: radii of parts a and b
  float* geo;  // [4, C, B] scratch: pen_x, pen_y, pt_x, pt_y
  uint8_t* active;  // [C, B]
  int P, npairs, V, override_bits, symplectic;
  float gdx, gdy;  // gravity times dt, per component
};

// unit outward normals of the V edges of one polygon, written at NX[off..]
__device__ void edge_axes(const float* wx, const float* wy, int V, int mask,
                          float* NX, float* NY, bool* OK, int off) {
  for (int v = 0; v < V; ++v) {
    const int j = v + 1 < V ? v + 1 : 0;
    const float ex = wx[j] - wx[v];
    const float ey = wy[j] - wy[v];
    const float nx = ey, ny = -ex;
    const float ln2 = nx * nx + ny * ny;
    const float inv = rsqrtf(ln2 <= 0.0f ? 1.0f : ln2);
    NX[off + v] = nx * inv;
    NY[off + v] = ny * inv;
    OK[off + v] = ((mask >> v) & 1) && ln2 > 0.0f;
  }
}

// min and max over the vertices of their projections on (nx, ny)
__device__ void project(float nx, float ny, const float* wx, const float* wy,
                        int V, float& mn, float& mx) {
  mn = mx = nx * wx[0] + ny * wy[0];
  for (int v = 1; v < V; ++v) {
    const float p = nx * wx[v] + ny * wy[v];
    mn = minp(mn, p);
    mx = maxp(mx, p);
  }
}

// the edge of a polygon whose outward normal best aligns with (dx, dy):
// returns its index (-1 when no edge is valid) and writes its score and
// endpoints
__device__ int best_edge(const float* NX, const float* NY, const bool* OK,
                         const float* wx, const float* wy, int V, float dx,
                         float dy, float& bestv, float& r0x, float& r0y,
                         float& r1x, float& r1y) {
  int e = -1;
  bestv = -INFINITY;
  r0x = r0y = r1x = r1y = 0.0f;
  for (int v = 0; v < V; ++v) {
    const float al = OK[v] ? NX[v] * dx + NY[v] * dy : -INFINITY;
    if (al > bestv) {
      const int j = v + 1 < V ? v + 1 : 0;
      e = v;
      bestv = al;
      r0x = wx[v];
      r0y = wy[v];
      r1x = wx[j];
      r1y = wy[j];
    }
  }
  return e;
}

// one clip of the segment p0-p1 to the side d . (p - an) >= 0, keeping its
// inputs and intermediates for the reverse pass
struct Clip {
  float p0x, p0y, p1x, p1y, anx, any, dx, dy;
  float d0, d1, den, sden, frac;
  bool cut0, cut1;

  // clips (q0, q1) in place
  __device__ void run(float& q0x, float& q0y, float& q1x, float& q1y,
                      float anx_, float any_, float dx_, float dy_) {
    p0x = q0x;
    p0y = q0y;
    p1x = q1x;
    p1y = q1y;
    anx = anx_;
    any = any_;
    dx = dx_;
    dy = dy_;
    d0 = (p0x - anx) * dx + (p0y - any) * dy;
    d1 = (p1x - anx) * dx + (p1y - any) * dy;
    den = d0 - d1;
    sden = den == 0.0f ? 1.0f : den;
    frac = d0 / sden;
    const float inx = p0x + frac * (p1x - p0x);
    const float iny = p0y + frac * (p1y - p0y);
    cut0 = d0 < 0.0f && d1 >= 0.0f;
    cut1 = d1 < 0.0f && d0 >= 0.0f;
    if (cut0) {
      q0x = inx;
      q0y = iny;
    }
    if (cut1) {
      q1x = inx;
      q1y = iny;
    }
  }
};

// SAT + reference-face clip of polygon A against polygon B: its two lanes,
// with what the reverse pass needs to walk it back
struct PairSat {
  float NX[MAX_AXES], NY[MAX_AXES];
  bool OK[MAX_AXES];
  int axis;  // the axis taken last (-1: none)
  float best, o_pos, o_neg, bsign, depth, n_x, n_y;
  bool active;
  int ea, eb;  // the candidate reference edges of A and B (-1: none)
  bool ref_is_a;
  float r0x, r0y, r1x, r1y, nrefx, nrefy;
  float tx0, ty0, tl, tx, ty;  // the reference edge, then its unit tangent
  Clip clip0, clip1;
  float c0x, c0y, c1x, c1y, d0, d1;
  bool none_kept, a0, a1;
  float ld0, ld1;

  __device__ void run(const float* ax, const float* ay, int Va, int ma,
                      const float* bx, const float* by, int Vb, int mb) {
    edge_axes(ax, ay, Va, ma, NX, NY, OK, 0);
    edge_axes(bx, by, Vb, mb, NX, NY, OK, Va);

    best = INFINITY;
    bsign = 1.0f;
    axis = -1;
    o_pos = o_neg = 0.0f;
    float bnx = 0.0f, bny = 0.0f;
    for (int a = 0; a < Va + Vb; ++a) {
      float mna, mxa, mnb, mxb;
      project(NX[a], NY[a], ax, ay, Va, mna, mxa);
      project(NX[a], NY[a], bx, by, Vb, mnb, mxb);
      const float op = mxb - mna;  // push A along +axis
      const float on = mxa - mnb;  // push A along -axis
      const float ovl = OK[a] ? minp(op, on) : INFINITY;
      if (ovl < best) {
        best = ovl;
        bnx = NX[a];
        bny = NY[a];
        bsign = op <= on ? 1.0f : -1.0f;
        axis = a;
        o_pos = op;
        o_neg = on;
      }
    }
    active = best >= 0.0f && best < INFINITY;
    depth = maxp(best, 0.0f);
    n_x = bnx * bsign;  // MTV direction B -> A
    n_y = bny * bsign;

    float al_a, ar0x, ar0y, ar1x, ar1y, al_b, br0x, br0y, br1x, br1y;
    ea = best_edge(NX, NY, OK, ax, ay, Va, -n_x, -n_y, al_a, ar0x, ar0y, ar1x,
                   ar1y);
    eb = best_edge(NX + Va, NY + Va, OK + Va, bx, by, Vb, n_x, n_y, al_b, br0x,
                   br0y, br1x, br1y);
    ref_is_a = al_a >= al_b;
    r0x = ref_is_a ? ar0x : br0x;
    r0y = ref_is_a ? ar0y : br0y;
    r1x = ref_is_a ? ar1x : br1x;
    r1y = ref_is_a ? ar1y : br1y;
    nrefx = ref_is_a ? -n_x : n_x;
    nrefy = ref_is_a ? -n_y : n_y;
    // the incident edge: the other polygon's candidate reference edge
    c0x = ref_is_a ? br0x : ar0x;
    c0y = ref_is_a ? br0y : ar0y;
    c1x = ref_is_a ? br1x : ar1x;
    c1y = ref_is_a ? br1y : ar1y;

    tx0 = r1x - r0x;
    ty0 = r1y - r0y;
    const float tl2 = tx0 * tx0 + ty0 * ty0;
    tl = rsqrtf(tl2 <= 0.0f ? 1.0f : tl2);
    tx = tx0 * tl;
    ty = ty0 * tl;
    clip0.run(c0x, c0y, c1x, c1y, r0x, r0y, tx, ty);
    clip1.run(c0x, c0y, c1x, c1y, r1x, r1y, -tx, -ty);

    d0 = -((c0x - r0x) * nrefx + (c0y - r0y) * nrefy);
    d1 = -((c1x - r0x) * nrefx + (c1y - r0y) * nrefy);
    const float keep_tol = maxp(depth, 1e-4f);
    const bool k0 = d0 >= -keep_tol;
    const bool k1 = d1 >= -keep_tol;
    none_kept = !k0 && !k1;
    a0 = active && (none_kept || k0);
    a1 = active && !none_kept && k1;
    ld0 = none_kept ? depth : maxp(d0, 1e-6f);
    ld1 = none_kept ? depth : maxp(d1, 1e-6f);
  }
};

// one analytic contact lane
struct Lane {
  float pen_x, pen_y, pt_x, pt_y;
  bool active;
};

// circle A against circle B (engine/batched.py:_cc_bm): penetration along
// the centre line, depth max(ra + rb - dist, 0), the contact point midway
// between the surfaces, or at the inner centre when one circle holds the
// other's centre.  Keeps what its adjoint needs.
struct CcLane {
  float dx, dy, d2, inv, dist, ux, uy, over, k;  // over = ra + rb - dist
  bool same_side, b_in_a;
  Lane out;

  __device__ void run(float cax, float cay, float ra, float cbx, float cby,
                      float rb) {
    dx = cax - cbx;
    dy = cay - cby;
    d2 = dx * dx + dy * dy;
    inv = rsqrtf(d2 <= 0.0f ? 1.0f : d2);
    dist = d2 * inv;  // |d| (0 when coincident)
    ux = d2 == 0.0f ? 1.0f : dx * inv;
    uy = d2 == 0.0f ? 0.0f : dy * inv;
    const float rsum = ra + rb;
    over = rsum - dist;
    const float depth = maxp(over, 0.0f);
    const bool active = dist <= rsum;
    k = rb - ra;
    float ptx = (cbx + ux * k + cax) / 2.0f;
    float pty = (cby + uy * k + cay) / 2.0f;
    same_side = (cax - ptx) * (cbx - ptx) + (cay - pty) * (cby - pty) > 0.0f;
    const float ex = cbx - cax, ey = cby - cay;
    const float rin = ra + 1e-6f;
    b_in_a = ex * ex + ey * ey <= rin * rin;
    if (same_side) {
      ptx = b_in_a ? cbx : cax;
      pty = b_in_a ? cby : cay;
    }
    const float m = active ? 1.0f : 0.0f;
    out = {ux * depth * m, uy * depth * m, ptx, pty, active};
  }
};

// circle against the axis-aligned box [lb, ub] (engine/batched.py:_cb_bm):
// the centre clamped into the box; at a corner (within eps on both axes)
// the push runs along the corner's direction, else along the face of least
// shift, the earliest of s0..s3 winning a tie.  Keeps what its adjoint
// needs.
struct CbLane {
  float ccx, ccy, dvx, dvy, dd, inv, uvx, uvy;
  bool perfect_vertex, is0, is1, is2, is3;
  Lane out;

  __device__ void run(float cx, float cy, float r, float lbx, float lby,
                      float ubx, float uby) {
    const float eps = 1e-6f;
    ccx = minp(maxp(cx, lbx), ubx);
    ccy = minp(maxp(cy, lby), uby);
    const bool at_x = fabsf(ccx - lbx) < eps || fabsf(ccx - ubx) < eps;
    const bool at_y = fabsf(ccy - lby) < eps || fabsf(ccy - uby) < eps;
    perfect_vertex = at_x && at_y;
    dvx = ccx - cx;
    dvy = ccy - cy;
    dd = dvx * dvx + dvy * dvy;
    inv = rsqrtf(dd <= 0.0f ? 1.0f : dd);
    uvx = dd == 0.0f ? 1.0f : dvx * inv;
    uvy = dd == 0.0f ? 0.0f : dvy * inv;
    const float pvx = -(cx + r * uvx - ccx);
    const float pvy = -(cy + r * uvy - ccy);
    const float s0 = cy + r - lby;
    const float s1 = uby - (cy - r);
    const float s2 = cx + r - lbx;
    const float s3 = ubx - (cx - r);
    const float best = minp(minp(s0, s1), minp(s2, s3));
    is0 = best == s0;
    is1 = !is0 && best == s1;
    is2 = !is0 && !is1 && best == s2;
    is3 = !is0 && !is1 && !is2;
    const float pfx = is2 ? -s2 : (is3 ? s3 : 0.0f);
    const float pfy = is0 ? -s0 : (is1 ? s1 : 0.0f);
    const float ox = cx - ccx, oy = cy - ccy;
    const float reps = r + eps;
    const bool active = ox * ox + oy * oy <= reps * reps;
    const float m = active ? 1.0f : 0.0f;
    out = {(perfect_vertex ? pvx : pfx) * m, (perfect_vertex ? pvy : pfy) * m,
           ccx, ccy, active};
  }
};

// circle held inside the area box [lb, ub] (engine/batched.py:_area_cb_bm):
// the push back by how far the circle pokes past each side, max(., 0) of
// each, active when any is positive; the contact point on the circle at the
// side it pokes furthest past, the earliest of right, top, left, bottom
// winning a tie.  Keeps what its adjoint needs.
struct AreaCbLane {
  float hx, hy, lx, ly;  // how far the circle pokes past each side
  Lane out;

  __device__ void run(float cx, float cy, float r, float lbx, float lby,
                      float ubx, float uby) {
    hx = cx + r - ubx;
    hy = cy + r - uby;
    lx = lbx - (cx - r);
    ly = lby - (cy - r);
    const float ohx = maxp(hx, 0.0f), ohy = maxp(hy, 0.0f);
    const float olx = maxp(lx, 0.0f), oly = maxp(ly, 0.0f);
    const float pen_x = -ohx + olx;
    const float pen_y = -ohy + oly;
    const float depth = maxp(maxp(ohx, ohy), maxp(olx, oly));
    const bool active = depth > 0.0f;
    const float best = maxp(maxp(hx, hy), maxp(lx, ly));
    const bool is_hx = best == hx;
    const bool is_hy = !is_hx && best == hy;
    const bool is_lx = !is_hx && !is_hy && best == lx;
    const float ptx = is_hx ? cx + r : (is_hy ? cx : (is_lx ? cx - r : cx));
    const float pty = is_hx ? cy : (is_hy ? cy + r : (is_lx ? cy : cy - r));
    const float m = active ? 1.0f : 0.0f;
    out = {pen_x * m, pen_y * m, ptx, pty, active};
  }
};

// integration and gravity of world b's bodies, written to the planes
// args.o*; the poses stay in qx, qy and the cosine and sine of the angle,
// for the vertices
__device__ void integrate_world(const Args& args, const StepArgs& st, int b,
                                float* qx, float* qy, float* qc, float* qs) {
  const size_t B = args.B;
  for (int i = 0; i < args.n; ++i) {
    const size_t k = i * B + b;
    float x = st.px[k], y = st.py[k], a = st.ang[k];
    float vx = st.vx[k], vy = st.vy[k];
    const float w = st.om[k];
    const float mov = args.movable[i] ? 1.0f : 0.0f;
    if (st.symplectic) {
      vx = vx + st.gdx * mov;
      vy = vy + st.gdy * mov;
    }
    x = x + vx * args.dt;
    y = y + vy * args.dt;
    a = a + w * args.dt;
    if (!st.symplectic) {
      vx = vx + st.gdx * mov;
      vy = vy + st.gdy * mov;
    }
    args.opx[k] = x;
    args.opy[k] = y;
    args.ovx[k] = vx;
    args.ovy[k] = vy;
    args.oang[k] = a;
    args.oom[k] = w;
    qx[i] = x;
    qy[i] = y;
    qc[i] = cosf(a);
    qs[i] = sinf(a);
  }
}

// world-frame vertices of every part into wx, wy [MAX_PARTS * MAX_V]
__device__ void world_vertices(const StepArgs& st, size_t B, int b,
                               const float* qx, const float* qy,
                               const float* qc, const float* qs, float* wx,
                               float* wy) {
  for (int p = 0; p < st.P; ++p) {
    const int32_t* pi = st.part_i + p * PART_COLS;
    const int nv = pi[P_NV];
    float* px = wx + p * MAX_V;
    float* py = wy + p * MAX_V;
    if ((st.override_bits >> p) & 1) {
      // the k-th overridden part, k its rank among them (sorted(override))
      const int k = __popc(st.override_bits & ((1u << p) - 1u));
      const size_t row = (size_t)k * st.V;
      for (int v = 0; v < nv; ++v) {
        px[v] = st.tx[(row + v) * B + b];
        py[v] = st.ty[(row + v) * B + b];
      }
      continue;
    }
    const int body = pi[P_BODY];
    const float c = qc[body], s = qs[body], x = qx[body], y = qy[body];
    const float* lv = st.part_lv + (size_t)p * st.V * 2;
    for (int v = 0; v < nv; ++v) {
      const float lx = lv[2 * v], ly = lv[2 * v + 1];
      if (pi[P_ROTATE]) {
        px[v] = c * lx - s * ly + x;
        py[v] = s * lx + c * ly + y;
      } else {
        px[v] = lx + x;
        py[v] = ly + y;
      }
    }
  }
}

// one analytic lane into st.geo and st.active at offset i0
__device__ void write_lane(const StepArgs& st, size_t plane, size_t i0,
                           const Lane& l) {
  st.geo[i0] = l.pen_x;
  st.geo[plane + i0] = l.pen_y;
  st.geo[2 * plane + i0] = l.pt_x;
  st.geo[3 * plane + i0] = l.pt_y;
  st.active[i0] = l.active;
}

// every pair's lanes into st.geo and st.active, from its first lane on, by
// its kind: a polygon pair's two (point-minor), a circle pair's one.  A
// circle's centre is its row 0, a box's lb and ub its rows 0 and 1.  A kind
// this code does not name writes nothing (the host never sends one).
__device__ void pair_geometry(const StepArgs& st, int C, size_t B, int b,
                              const float* wx, const float* wy) {
  const size_t plane = (size_t)C * B;
  for (int q = 0; q < st.npairs; ++q) {
    const int32_t* qi = st.pair_i + q * PAIR_COLS;
    const int pa = qi[Q_A] * MAX_V, pb = qi[Q_B] * MAX_V;
    const size_t i0 = (size_t)qi[Q_LANE] * B + b;
    const float ra = st.pair_f[2 * q], rb = st.pair_f[2 * q + 1];
    switch (qi[Q_KIND]) {
      case K_PP: {
        PairSat s;
        s.run(wx + pa, wy + pa, qi[Q_VA], qi[Q_MASK_A], wx + pb, wy + pb,
              qi[Q_VB], qi[Q_MASK_B]);
        const size_t i1 = i0 + B;
        st.geo[i0] = s.n_x * s.ld0 * (s.a0 ? 1.0f : 0.0f);
        st.geo[i1] = s.n_x * s.ld1 * (s.a1 ? 1.0f : 0.0f);
        st.geo[plane + i0] = s.n_y * s.ld0 * (s.a0 ? 1.0f : 0.0f);
        st.geo[plane + i1] = s.n_y * s.ld1 * (s.a1 ? 1.0f : 0.0f);
        st.geo[2 * plane + i0] = s.c0x;
        st.geo[2 * plane + i1] = s.c1x;
        st.geo[3 * plane + i0] = s.c0y;
        st.geo[3 * plane + i1] = s.c1y;
        st.active[i0] = s.a0;
        st.active[i1] = s.a1;
        break;
      }
      case K_CC: {
        CcLane l;
        l.run(wx[pa], wy[pa], ra, wx[pb], wy[pb], rb);
        write_lane(st, plane, i0, l.out);
        break;
      }
      case K_CB: {
        CbLane l;
        l.run(wx[pa], wy[pa], ra, wx[pb], wy[pb], wx[pb + 1], wy[pb + 1]);
        write_lane(st, plane, i0, l.out);
        break;
      }
      case K_AREA_CB: {
        AreaCbLane l;
        l.run(wx[pa], wy[pa], ra, wx[pb], wy[pb], wx[pb + 1], wy[pb + 1]);
        write_lane(st, plane, i0, l.out);
        break;
      }
      default:
        break;
    }
  }
}

}  // namespace
