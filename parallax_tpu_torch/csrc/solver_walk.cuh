// The solver's warp walk: one world's contact solve and joints, and their
// reverse, walked by the threads of one warp, with the layout of a world's
// shared memory and of its tape.  Both forward kernels run the walk without
// a tape (Walk<false>): the solver kernel (contact_solver.cu) on the
// contact planes it is given, the fused step (fused_step.cu) on those its
// first phase leaves in shared memory.  Both reverse passes run it with a
// tape (Walk<true>): contact_solver_bwd.cu, and fused_step_bwd.cu on the
// contact planes its recompute leaves in the tape.  WorldIO says where one
// world's planes are, so Walk reads them from any memory.  See
// contact_solver.cu for the forward's design and contact_solver_bwd.cu for
// the reverse's.

#pragma once

#include "contact_solver.cuh"

#ifndef WARP_LANES
#define WARP_LANES 32  // the threads a world's walk spreads over
#endif

namespace {

constexpr int LANES = WARP_LANES;
constexpr int MAX_WORLDS_PER_BLOCK = 8;
// dynamic shared memory a block may take on the H100 (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

// per-lane cotangents in the tape, [NUM_G, C]
enum GField {
  G_NX, G_NY, G_RAX, G_RAY, G_RBX, G_RBY,
  G_KN, G_KT, G_KNP, G_KTP, G_TARGET, G_BIAS,
  G_JN, G_JT, G_PJ,
  NUM_G
};

// Offsets in one world's tape, in floats.  The tape is world-major (world
// b's starts at scratch + b * rows), lane index fastest within a field, so
// a warp's lane-strided accesses coalesce.  A walk without a tape keeps
// the first NUM_FIELDS * C floats only, Tape(C, n, 1, 1)'s lane fields and
// one row of each impulse: fields F_NX ... F_PJ, [NUM_FIELDS, C].
struct Tape {
  int jn, jt, pj, g, v, pv, rows;
  __host__ __device__ Tape(int C, int n, int I, int P) {
    int r = F_JN * C;  // the setup's lane fields F_NX ... F_BIAS [12, C]
    jn = r;  // normal impulses after each velocity iteration [I, C]
    r += I * C;
    jt = r;  // friction impulses after each velocity iteration [I, C]
    r += I * C;
    pj = r;  // position impulses after each position pass [P, C]
    r += P * C;
    g = r;  // per-lane cotangents [NUM_G, C]
    r += NUM_G * C;
    v = r;  // velocities before each velocity pass, and after the last
    r += (2 * I + 1) * 3 * n;
    pv = r;  // pseudo-velocities before each position pass
    r += P * 3 * n;
    rows = r;
  }
};

// rows of a world's body arrays in shared memory, [NUM_BODY_ROWS, n]
enum BodyRow {
  S_VX, S_VY, S_OM,     // velocities
  S_GVX, S_GVY, S_GOM,  // their cotangents
  S_GQX, S_GQY, S_GQA,  // cotangents of the corrected poses, then of p
  S_GPX, S_GPY, S_GPW,  // cotangents of the pseudo-velocities
  S_UX, S_UY, S_UW,     // the velocity snapshot a pass read
  S_QX, S_QY, S_QA,     // the corrected poses
  S_PVX, S_PVY, S_POM,  // pseudo-velocities
  NUM_BODY_ROWS
};

// words of sizeof(float) that hold k bytes
__host__ __device__ inline int byte_words(int k) {
  return (k + (int)sizeof(float) - 1) / (int)sizeof(float);
}

// Offsets in one world's shared memory, in words of sizeof(float).
struct WorldSmem {
  int k, list, flags, has, words;
  __host__ __device__ WorldSmem(int C, int n) {
    int r = NUM_BODY_ROWS * n;
    k = r;  // each lane's terms of its two bodies' sums in a pass [6, C]
    r += 6 * C;
    list = r;  // int: the lanes the passes walk, in lane order [C]
    r += C;
    flags = r;  // per lane: bit 0 active, bit 1 solved in a 2x2 block,
                // bit 2 on the list
    r += byte_words(C);
    has = r;  // per lane: whether the setup's adjoint gave it a term
    r += byte_words(C);
    words = r;
  }
};

// the static operands and scalars of the solve
struct SolveOps {
  const int32_t *body_a, *body_b, *partner;
  const float* lane_const;
  const int32_t* movable;
  const float *body_im, *body_ii;
  const int32_t* joint_body;
  const float* joint_f;
  // per body, the lanes touching it in lane order: offsets [n + 1], then
  // entries 2 * lane + side (0: the lane's body A, 1: its body B)
  const int32_t* body_lanes;
  int C, n, J, iterations, position_iterations;
  float dt, baumgarte, slop, baumgarte_dt, max_bias;
  int has_max_bias;
};

// row r of one world's plane at p[r * rs]
struct Rows {
  const float* p;
  size_t rs;
  __device__ float operator[](int r) const { return p[(size_t)r * rs]; }
};

// where one world's planes are: the primal contact and body planes and,
// for a reverse pass, the cotangents of the solve's six outputs and the
// contact planes' cotangents it writes
struct WorldIO {
  Rows pen_x, pen_y, pt_x, pt_y;  // [C]
  const uint8_t* active;
  size_t act_rs;
  Rows px, py, vx, vy, ang, om;  // [n]
  Rows gpx, gpy, gvx, gvy, gang, gom;  // [n]
  float *dpen_x, *dpen_y, *dpt_x, *dpt_y;  // [C], row stride d_rs
  size_t d_rs;
};

// a forward's six output body planes, row-major [n, B]
struct BodyOut {
  float *px, *py, *vx, *vy, *ang, *om;
};

// torch.maximum's and torch.minimum's backward: half to each at a tie
__device__ __forceinline__ void max_bwd(float x, float y, float g, float& gx,
                                        float& gy) {
  if (x == y) {
    gx = g * 0.5f;
    gy = g * 0.5f;
  } else {
    gx = x < y ? 0.0f : g;
    gy = x > y ? 0.0f : g;
  }
}
__device__ __forceinline__ void min_bwd(float x, float y, float g, float& gx,
                                        float& gy) {
  if (x == y) {
    gx = g * 0.5f;
    gy = g * 0.5f;
  } else {
    gx = x > y ? 0.0f : g;
    gy = x < y ? 0.0f : g;
  }
}

// cotangent of k through inv = safe_inv(k), added to acc
__device__ __forceinline__ void inv_bwd(float k, float inv, float g_inv,
                                        float& acc) {
  if (k != 0.0f) acc -= g_inv * (inv * inv);
}

// One world's solve and its reverse, walked by the LANES threads of a warp:
// lane work over the threads by lane, body work by body.  Every per-body
// sum adds its lanes' terms in lane order, the order of a serial loop over
// the lanes (a manifold's two lanes sit side by side in the contact table,
// engine/collider.py, so a 2x2 block's terms come in lane order too).  So a
// world's bits depend neither on how its lanes spread over the warp nor on
// the worlds that share its block, and a reverse pass's recompute is the
// forward kernel's to the bit.
//
// The passes walk a list of lanes.  An inactive lane's impulses are 0 in
// every pass, so its terms in a pass are products of finite values with 0:
// zeros, which leave a sum that starts at +0 as it is (it never becomes
// -0).  So a world whose lane fields are finite lists its active lanes
// only; a world with a non-finite field lists every lane, and a reverse
// pass whose output cotangents hold a non-finite value walks every lane,
// as the serial loop does, so that NaN and inf go where they went there.
//
// TAPE: the reverse passes' walk keeps a tape at t (Tape): the lane fields,
// the impulses after every pass and the velocities before every pass.  The
// forward kernels' walk (TAPE false) keeps the lane fields and one row of
// each impulse at t, which each pass updates in place: a lane's impulse is
// read and written only by the thread that walks it (a 2x2 block's both by
// its lead's), and no pass reads another lane's.
template <bool TAPE>
struct Walk {
  const SolveOps& o;
  const WorldIO& io;
  const Tape T;
  const WorldSmem M;
  float* const t;  // this world's tape
  float* const s;  // this world's shared memory
  const int lane, C, n;
  int listed;  // lanes on the list

  __device__ Walk(const SolveOps& ops, const WorldIO& w, float* tape,
                  float* smem, int thread)
      : o(ops), io(w),
        T(ops.C, ops.n, TAPE ? ops.iterations : 1,
          TAPE ? ops.position_iterations : 1),
        M(ops.C, ops.n), t(tape), s(smem), lane(thread), C(ops.C), n(ops.n) {}

  __device__ float* body(int r) { return s + r * n; }
  __device__ float* K(int r) { return s + M.k + r * C; }
  __device__ uint8_t* flags() {
    return reinterpret_cast<uint8_t*>(s + M.flags);
  }
  __device__ uint8_t* has() { return reinterpret_cast<uint8_t*>(s + M.has); }
  __device__ int* list() { return reinterpret_cast<int*>(s + M.list); }
  __device__ bool act(int c) { return flags()[c] & 1; }
  __device__ bool blk(int c) { return flags()[c] & 2; }

  __device__ float& f(int field, int c) { return t[field * C + c]; }
  __device__ float& g(int field, int c) { return t[T.g + field * C + c]; }
  // the impulses after pass it (k): its row of the tape, or the one row
  __device__ float& jn_t(int it, int c) {
    return t[T.jn + (TAPE ? it : 0) * C + c];
  }
  __device__ float& jt_t(int it, int c) {
    return t[T.jt + (TAPE ? it : 0) * C + c];
  }
  __device__ float& pj_t(int k, int c) {
    return t[T.pj + (TAPE ? k : 0) * C + c];
  }
  __device__ float lc(int row, int c) const {
    return o.lane_const[row * C + c];
  }

  // body threads: snapshot k of rows r, r + 1, r + 2 to the tape at base
  // (with a tape), or back
  __device__ void store(int base, int k, int r) {
    if (!TAPE) return;
    for (int i = lane; i < n; i += LANES) {
      for (int m = 0; m < 3; ++m) {
        t[base + (k * 3 + m) * n + i] = body(r + m)[i];
      }
    }
  }
  __device__ void load(int base, int k, int r) {
    for (int i = lane; i < n; i += LANES) {
      for (int m = 0; m < 3; ++m) {
        body(r + m)[i] = t[base + (k * 3 + m) * n + i];
      }
    }
  }

  // body i's sums of its lanes' terms K, in lane order, from 0: x, y and w
  // of side A's terms K(0..2) or side B's K(3..5), of the listed lanes or,
  // where `every`, of all
  __device__ void gather(int i, bool every, float& x, float& y, float& w) {
    x = y = w = 0.0f;
    const int32_t* ent = o.body_lanes + n + 1;
    for (int e = o.body_lanes[i]; e < o.body_lanes[i + 1]; ++e) {
      const int c = ent[e] >> 1, r = 3 * (ent[e] & 1);
      if (!every && !(flags()[c] & 4)) continue;
      x += K(r)[c];
      y += K(r + 1)[c];
      w += K(r + 2)[c];
    }
  }

  // ---- the forward, lane by lane ----------------------------------------

  // relative velocity of lane c along its normal and tangent, the bodies'
  // velocities in rows r, r + 1, r + 2
  __device__ void rel_vel(int c, int r, float& v_n, float& v_t) {
    const float* ux = body(r);
    const float* uy = body(r + 1);
    const float* uw = body(r + 2);
    int ia = o.body_a[c], ib = o.body_b[c];
    float nx = f(F_NX, c), ny = f(F_NY, c);
    float tx = -ny, ty = nx;
    float rax = f(F_RAX, c), ray = f(F_RAY, c);
    float rbx = f(F_RBX, c), rby = f(F_RBY, c);
    float vax = ux[ia] - ray * uw[ia];
    float vay = uy[ia] + rax * uw[ia];
    float vbx = ux[ib] - rby * uw[ib];
    float vby = uy[ib] + rbx * uw[ib];
    float rx = vbx - vax;
    float ry = vby - vay;
    v_n = rx * nx + ry * ny;
    v_t = rx * tx + ry * ty;
  }

  // lane c's terms of its bodies' velocity deltas for the impulse deltas
  // dj_n, dj_t (a static body's are not gathered)
  __device__ void scatter(int c, float dj_n, float dj_t) {
    float nx = f(F_NX, c), ny = f(F_NY, c);
    float tx = -ny, ty = nx;
    float jx = dj_n * nx + dj_t * tx;
    float jy = dj_n * ny + dj_t * ty;
    float im = lc(R_IM_A, c), ii = lc(R_II_A, c);
    K(0)[c] = jx * im;
    K(1)[c] = jy * im;
    K(2)[c] = (f(F_RAX, c) * jy - f(F_RAY, c) * jx) * ii;
    im = lc(R_IM_B, c);
    ii = lc(R_II_B, c);
    K(3)[c] = -jx * im;
    K(4)[c] = -jy * im;
    K(5)[c] = -(f(F_RBX, c) * jy - f(F_RBY, c) * jx) * ii;
  }

  // body threads: a pass's summed deltas into the movable bodies' rows r..
  __device__ void apply(int r) {
    for (int i = lane; i < n; i += LANES) {
      float dx = 0.0f, dy = 0.0f, dw = 0.0f;
      if (o.movable[i]) gather(i, false, dx, dy, dw);
      body(r)[i] = body(r)[i] + dx;
      body(r + 1)[i] = body(r + 1)[i] + dy;
      body(r + 2)[i] = body(r + 2)[i] + dw;
    }
  }

  // lane c's setup; returns whether its fields and masses are finite
  __device__ bool setup_lane(int c, bool split) {
    int ia = o.body_a[c], ib = o.body_b[c];
    float pen_x = io.pen_x[c], pen_y = io.pen_y[c];
    float pt_x = io.pt_x[c], pt_y = io.pt_y[c];
    float d2 = pen_x * pen_x + pen_y * pen_y;
    float inv_d = rsqrtf(d2 <= 0.0f ? 1.0f : d2);
    float depth = d2 * inv_d;
    float nx = d2 == 0.0f ? 0.0f : pen_x * inv_d;
    float ny = d2 == 0.0f ? 0.0f : pen_y * inv_d;
    float tx = -ny, ty = nx;
    float rax = pt_x - io.px[ia];
    float ray = pt_y - io.py[ia];
    float rbx = pt_x - io.px[ib];
    float rby = pt_y - io.py[ib];
    float ran = rax * ny - ray * nx;
    float rbn = rbx * ny - rby * nx;
    float rat = rax * ty - ray * tx;
    float rbt = rbx * ty - rby * tx;
    float im_a = lc(R_IM_A, c), im_b = lc(R_IM_B, c);
    float ii_a = lc(R_II_A, c), ii_b = lc(R_II_B, c);
    f(F_NX, c) = nx;
    f(F_NY, c) = ny;
    f(F_RAX, c) = rax;
    f(F_RAY, c) = ray;
    f(F_RBX, c) = rbx;
    f(F_RBY, c) = rby;
    f(F_KN, c) = im_a + im_b + ii_a * ran * ran + ii_b * rbn * rbn;
    f(F_KT, c) = im_a + im_b + ii_a * rat * rat + ii_b * rbt * rbt;

    float v_n0, v_t0;
    rel_vel(c, S_VX, v_n0, v_t0);
    float bias = o.baumgarte * maxp(depth - o.slop, 0.0f) / o.baumgarte_dt;
    if (o.has_max_bias) bias = minp(bias, o.max_bias);
    float rest = v_n0 > 0.0f ? lc(R_E, c) * maxp(v_n0, 0.0f) : 0.0f;
    bool on = io.active[c * io.act_rs] != 0;
    f(F_TARGET, c) = on ? (split ? rest : rest + bias) : 0.0f;
    f(F_BIAS, c) = on ? bias : 0.0f;
    int p = o.partner[c];
    bool both = on && p >= 0 && io.active[p * io.act_rs] != 0;
    flags()[c] = (on ? 1 : 0) | (both ? 2 : 0);
    return isfinite(nx) && isfinite(ny) && isfinite(rax) && isfinite(ray) &&
           isfinite(rbx) && isfinite(rby) && isfinite(im_a) && isfinite(im_b) &&
           isfinite(ii_a) && isfinite(ii_b);
  }

  // the list of the lanes the passes walk: the active ones where `finite`,
  // else all, in lane order (a ballot and a prefix count per 32 lanes)
  __device__ void make_list(bool finite) {
    listed = 0;
    for (int base = 0; base < C; base += LANES) {
      const int c = base + lane;
      const bool keep = c < C && (!finite || act(c));
      const unsigned bits = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        list()[listed + __popc(bits & ((1u << lane) - 1u))] = c;
        flags()[c] |= 4;
      }
      listed += __popc(bits);
    }
  }

  // whether rows r, r + 1, r + 2 hold finite values for every body
  __device__ bool rows_finite(int r) {
    bool ok = true;
    for (int i = lane; i < n; i += LANES) {
      ok = ok && isfinite(body(r)[i]) && isfinite(body(r + 1)[i]) &&
           isfinite(body(r + 2)[i]);
    }
    return __all_sync(0xffffffffu, ok);
  }

  // the coupling terms of a manifold lane, from both lanes' lever arms
  __device__ void coupling_lane(int c) {
    int p = o.partner[c];
    if (p < 0) return;
    float nx = f(F_NX, c), ny = f(F_NY, c), tx = -ny, ty = nx;
    float pnx = f(F_NX, p), pny = f(F_NY, p), ptx = -pny, pty = pnx;
    float rax = f(F_RAX, c), ray = f(F_RAY, c);
    float rbx = f(F_RBX, c), rby = f(F_RBY, c);
    float prax = f(F_RAX, p), pray = f(F_RAY, p);
    float prbx = f(F_RBX, p), prby = f(F_RBY, p);
    float ran = rax * ny - ray * nx, rbn = rbx * ny - rby * nx;
    float rat = rax * ty - ray * tx, rbt = rbx * ty - rby * tx;
    float ran_p = prax * pny - pray * pnx, rbn_p = prbx * pny - prby * pnx;
    float rat_p = prax * pty - pray * ptx, rbt_p = prbx * pty - prby * ptx;
    float im_a = lc(R_IM_A, c), im_b = lc(R_IM_B, c);
    float ii_a = lc(R_II_A, c), ii_b = lc(R_II_B, c);
    f(F_KNP, c) = im_a + im_b + ii_a * ran * ran_p + ii_b * rbn * rbn_p;
    f(F_KTP, c) = im_a + im_b + ii_a * rat * rat_p + ii_b * rbt * rbt_p;
  }

  // normal pass `it`, lane c; a 2x2 block at its lead lane
  __device__ void normal_lane(int it, int c) {
    int p = o.partner[c];
    bool bl = blk(c);
    if (bl && p < c) return;  // solved at its lead lane
    float v_n, v_t;
    rel_vel(c, S_VX, v_n, v_t);
    float rhs = v_n + f(F_TARGET, c);
    float jn = it > 0 ? jn_t(it - 1, c) : 0.0f;
    float k_n = f(F_KN, c);
    float inv_kn = safe_inv(k_n);
    if (!bl) {
      float jn_new = act(c) ? maxp(jn + rhs * inv_kn, 0.0f) : 0.0f;
      scatter(c, jn_new - jn, 0.0f);
      jn_t(it, c) = jn_new;
      return;
    }
    float v_n_p, v_t_p;
    rel_vel(p, S_VX, v_n_p, v_t_p);
    float rhs_p = v_n_p + f(F_TARGET, p);
    float jn_p = it > 0 ? jn_t(it - 1, p) : 0.0f;
    float k_p = f(F_KN, p);
    float k_np = f(F_KNP, c);
    float inv_kp = safe_inv(k_p);
    float det = k_n * k_p - k_np * k_np;
    bool ok_det = fabsf(det) >= 1e-12f;
    float safe_det = ok_det ? det : 1.0f;
    float b0 = k_n * jn + k_np * jn_p + rhs;
    float b1 = k_np * jn + k_p * jn_p + rhs_p;
    float x0_full = (k_p * b0 - k_np * b1) / safe_det;
    float x1_full = (k_n * b1 - k_np * b0) / safe_det;
    bool ok_full = (x0_full >= 0.0f) && (x1_full >= 0.0f) && ok_det;
    float x0_c2 = maxp(b0 * inv_kn, 0.0f);
    bool ok_c2 = k_np * x0_c2 - b1 >= -1e-9f;
    float x1_c3 = maxp(b1 * inv_kp, 0.0f);
    bool ok_c3 = k_np * x1_c3 - b0 >= -1e-9f;
    float x0 = ok_full ? x0_full : (ok_c2 ? x0_c2 : 0.0f);
    float x1 = ok_full ? x1_full : (ok_c2 ? 0.0f : (ok_c3 ? x1_c3 : 0.0f));
    scatter(c, x0 - jn, 0.0f);
    scatter(p, x1 - jn_p, 0.0f);
    jn_t(it, c) = x0;
    jn_t(it, p) = x1;
  }

  // friction impulse of a lane outside a solved block, or its split share
  __device__ float clamp_friction(int it, int c, float jt_new) {
    float lim = lc(R_MU, c) * jn_t(it, c);
    jt_new = minp(maxp(jt_new, -lim), lim);
    return act(c) ? jt_new : 0.0f;
  }

  __device__ void friction_lane(int it, int c) {
    int p = o.partner[c];
    bool bl = blk(c);
    if (bl && p < c) return;
    float v_n, v_t;
    rel_vel(c, S_VX, v_n, v_t);
    float jt = it > 0 ? jt_t(it - 1, c) : 0.0f;
    float k_t = f(F_KT, c);
    if (!bl) {
      float jt_new = clamp_friction(it, c, jt + v_t * safe_inv(k_t));
      scatter(c, 0.0f, jt_new - jt);
      jt_t(it, c) = jt_new;
      return;
    }
    float v_n_p, v_t_p;
    rel_vel(p, S_VX, v_n_p, v_t_p);
    float jt_p = it > 0 ? jt_t(it - 1, p) : 0.0f;
    float k_tpd = f(F_KT, p);
    float k_tp = f(F_KTP, c);
    float det_t = k_t * k_tpd - k_tp * k_tp;
    bool ok_det_t = fabsf(det_t) >= 1e-5f * k_t * k_tpd;
    float safe_det_t = ok_det_t ? det_t : 1.0f;
    float bt0 = k_t * jt + k_tp * jt_p + v_t;
    float bt1 = k_tp * jt + k_tpd * jt_p + v_t_p;
    float xt0 = (k_tpd * bt0 - k_tp * bt1) / safe_det_t;
    float xt1 = (k_t * bt1 - k_tp * bt0) / safe_det_t;
    // each lane keeps its own singularity test and split share
    float jt_split = jt + v_t * safe_inv(k_t + k_tp);
    float k_tp_p = f(F_KTP, p);
    float det_t_p = k_tpd * k_t - k_tp_p * k_tp_p;
    bool ok_det_t_p = fabsf(det_t_p) >= 1e-5f * k_tpd * k_t;
    float jt_split_p = jt_p + v_t_p * safe_inv(k_tpd + k_tp_p);
    float jt_new = clamp_friction(it, c, ok_det_t ? xt0 : jt_split);
    float jt_new_p = clamp_friction(it, p, ok_det_t_p ? xt1 : jt_split_p);
    scatter(c, 0.0f, jt_new - jt);
    scatter(p, 0.0f, jt_new_p - jt_p);
    jt_t(it, c) = jt_new;
    jt_t(it, p) = jt_new_p;
  }

  // split-impulse pass k on the pseudo-velocities, lane c
  __device__ void position_lane(int k, int c) {
    float v_n, v_t;
    rel_vel(c, S_PVX, v_n, v_t);
    float rhs = v_n + f(F_BIAS, c);
    float pj = k > 0 ? pj_t(k - 1, c) : 0.0f;
    float pj_new = act(c) ? maxp(pj + rhs * safe_inv(f(F_KN, c)), 0.0f) : 0.0f;
    scatter(c, pj_new - pj, 0.0f);
    pj_t(k, c) = pj_new;
  }

  // joint j on the corrected poses: updates the velocity rows (one thread)
  __device__ void joint(int j) {
    float* vx = body(S_VX);
    float* vy = body(S_VY);
    float* om = body(S_OM);
    const float* qx = body(S_QX);
    const float* qy = body(S_QY);
    const float* qa = body(S_QA);
    int ia = o.joint_body[2 * j], ib = o.joint_body[2 * j + 1];
    const float* gj = o.joint_f + 7 * j;  // ax, ay, bx, by, kp, kd, v0
    float ca = cosf(qa[ia]), sa = sinf(qa[ia]);
    float cb = cosf(qa[ib]), sb = sinf(qa[ib]);
    float pax = qx[ia] + ca * gj[0] - sa * gj[1];
    float pay = qy[ia] + sa * gj[0] + ca * gj[1];
    float pbx = qx[ib] + cb * gj[2] - sb * gj[3];
    float pby = qy[ib] + sb * gj[2] + cb * gj[3];
    float rax = pax - qx[ia], ray = pay - qy[ia];
    float rbx = pbx - qx[ib], rby = pby - qy[ib];
    float vax = vx[ia] - ray * om[ia];
    float vay = vy[ia] + rax * om[ia];
    float vbx = vx[ib] - rby * om[ib];
    float vby = vy[ib] + rbx * om[ib];
    float dpx = pax - pbx, dpy = pay - pby;
    float dvx_ = vax - vbx, dvy_ = vay - vby;
    float dvn = sqrtf(maxp(dvx_ * dvx_ + dvy_ * dvy_, 1e-30f));
    float jx = dpx * gj[4] + dvx_ * (dvn + gj[6]) * gj[5];
    float jy = dpy * gj[4] + dvy_ * (dvn + gj[6]) * gj[5];
    float im_a = o.body_im[ia], im_b = o.body_im[ib];
    float ii_a = o.body_ii[ia], ii_b = o.body_ii[ib];
    vx[ia] = vx[ia] - jx * im_a;
    vx[ib] = vx[ib] + jx * im_b;
    vy[ia] = vy[ia] - jy * im_a;
    vy[ib] = vy[ib] + jy * im_b;
    om[ia] = om[ia] - (rax * jy - ray * jx) * ii_a;
    om[ib] = om[ib] + (rbx * jy - rby * jx) * ii_b;
  }

  // the forward up to the joints: the velocities, the setup, the velocity
  // passes and the position passes integrated into the corrected poses
  // (rows S_Q*); with a tape, (a) of the reverse passes, which replay the
  // joints
  __device__ void forward() {
    for (int i = lane; i < n; i += LANES) {
      body(S_VX)[i] = io.vx[i];
      body(S_VY)[i] = io.vy[i];
      body(S_OM)[i] = io.om[i];
    }
    __syncwarp();
    const bool split = o.position_iterations > 0;
    bool finite = true;
    for (int c = lane; c < C; c += LANES) {
      finite = setup_lane(c, split) && finite;
    }
    finite = __all_sync(0xffffffffu, finite);
    __syncwarp();
    make_list(finite);
    for (int c = lane; c < C; c += LANES) coupling_lane(c);
    store(T.v, 0, S_VX);
    __syncwarp();
    for (int it = 0; it < o.iterations; ++it) {
      for (int k = lane; k < listed; k += LANES) normal_lane(it, list()[k]);
      __syncwarp();
      apply(S_VX);
      store(T.v, 2 * it + 1, S_VX);
      __syncwarp();
      for (int k = lane; k < listed; k += LANES) friction_lane(it, list()[k]);
      __syncwarp();
      apply(S_VX);
      store(T.v, 2 * it + 2, S_VX);
      __syncwarp();
    }
    for (int i = lane; i < n; i += LANES) {
      body(S_QX)[i] = io.px[i];
      body(S_QY)[i] = io.py[i];
      body(S_QA)[i] = io.ang[i];
      body(S_PVX)[i] = body(S_PVY)[i] = body(S_POM)[i] = 0.0f;
    }
    if (split) {
      for (int k = 0; k < o.position_iterations; ++k) {
        store(T.pv, k, S_PVX);
        __syncwarp();
        for (int m = lane; m < listed; m += LANES) position_lane(k, list()[m]);
        __syncwarp();
        apply(S_PVX);
      }
      for (int i = lane; i < n; i += LANES) {
        body(S_QX)[i] = body(S_QX)[i] + body(S_PVX)[i] * o.dt;
        body(S_QY)[i] = body(S_QY)[i] + body(S_PVY)[i] * o.dt;
        body(S_QA)[i] = body(S_QA)[i] + body(S_POM)[i] * o.dt;
      }
    }
    __syncwarp();
  }

  // the whole forward solve: forward(), then the joints on one thread, in
  // joint order (Gauss-Seidel) on the corrected poses
  __device__ void solve() {
    forward();
    if (lane == 0) {
      for (int j = 0; j < o.J; ++j) joint(j);
    }
    __syncwarp();
  }

  // body threads: the solve's six output body planes of world b
  __device__ void write(const BodyOut& out, size_t B, int b) {
    for (int i = lane; i < n; i += LANES) {
      const size_t k = i * B + b;
      out.px[k] = body(S_QX)[i];
      out.py[k] = body(S_QY)[i];
      out.vx[k] = body(S_VX)[i];
      out.vy[k] = body(S_VY)[i];
      out.ang[k] = body(S_QA)[i];
      out.om[k] = body(S_OM)[i];
    }
  }

  // ---- the reverse, lane by lane ---------------------------------------

  // adjoint of scatter(c, dj_n, dj_t) given the cotangents (rows r, r + 1,
  // r + 2) of the pass's output velocities: returns those of dj_n and dj_t
  __device__ void scatter_bwd(int c, float dj_n, float dj_t, int r,
                              float& g_djn, float& g_djt) {
    const float* ox = body(r);
    const float* oy = body(r + 1);
    const float* ow = body(r + 2);
    int ia = o.body_a[c], ib = o.body_b[c];
    float nx = f(F_NX, c), ny = f(F_NY, c);
    float tx = -ny, ty = nx;
    float jx = dj_n * nx + dj_t * tx;
    float jy = dj_n * ny + dj_t * ty;
    float g_jx = 0.0f, g_jy = 0.0f;
    if (o.movable[ia]) {
      float im = lc(R_IM_A, c), ii = lc(R_II_A, c);
      g_jx += ox[ia] * im;
      g_jy += oy[ia] * im;
      float gw = ow[ia] * ii;  // dom += (rax * jy - ray * jx) * ii
      g_jy += gw * f(F_RAX, c);
      g_jx -= gw * f(F_RAY, c);
      g(G_RAX, c) += gw * jy;
      g(G_RAY, c) -= gw * jx;
    }
    if (o.movable[ib]) {
      float im = lc(R_IM_B, c), ii = lc(R_II_B, c);
      g_jx -= ox[ib] * im;
      g_jy -= oy[ib] * im;
      float gw = ow[ib] * ii;  // dom += -(rbx * jy - rby * jx) * ii
      g_jy -= gw * f(F_RBX, c);
      g_jx += gw * f(F_RBY, c);
      g(G_RBX, c) -= gw * jy;
      g(G_RBY, c) += gw * jx;
    }
    g_djn = g_jx * nx + g_jy * ny;
    g_djt = g_jx * tx + g_jy * ty;
    g(G_NX, c) += g_jx * dj_n + g_jy * dj_t;
    g(G_NY, c) += g_jy * dj_n - g_jx * dj_t;
  }

  // adjoint of rel_vel(c, u) given the cotangents of v_n and v_t: the
  // velocity cotangents become lane c's terms K of its bodies' sums
  __device__ void rel_vel_bwd(int c, float g_vn, float g_vt) {
    const float* u_w = body(S_UW);
    int ia = o.body_a[c], ib = o.body_b[c];
    float nx = f(F_NX, c), ny = f(F_NY, c);
    float tx = -ny, ty = nx;
    float rax = f(F_RAX, c), ray = f(F_RAY, c);
    float rbx = f(F_RBX, c), rby = f(F_RBY, c);
    float vax = body(S_UX)[ia] - ray * u_w[ia];
    float vay = body(S_UY)[ia] + rax * u_w[ia];
    float vbx = body(S_UX)[ib] - rby * u_w[ib];
    float vby = body(S_UY)[ib] + rbx * u_w[ib];
    float rx = vbx - vax;
    float ry = vby - vay;
    float g_rx = g_vn * nx + g_vt * tx;
    float g_ry = g_vn * ny + g_vt * ty;
    g(G_NX, c) += g_vn * rx + g_vt * ry;
    g(G_NY, c) += g_vn * ry - g_vt * rx;
    K(3)[c] = g_rx;
    K(4)[c] = g_ry;
    K(5)[c] = rbx * g_ry - rby * g_rx;
    g(G_RBY, c) -= u_w[ib] * g_rx;
    g(G_RBX, c) += u_w[ib] * g_ry;
    K(0)[c] = -g_rx;
    K(1)[c] = -g_ry;
    K(2)[c] = ray * g_rx - rax * g_ry;
    g(G_RAY, c) += u_w[ia] * g_rx;
    g(G_RAX, c) -= u_w[ia] * g_ry;
  }

  // a lane whose rel_vel takes no cotangent in this pass
  __device__ void no_terms(int c) {
    for (int r = 0; r < 6; ++r) K(r)[c] = 0.0f;
  }

  // body threads: a pass's summed velocity cotangents into rows r.. (its
  // lanes' terms start each sum at 0, which a skipped lane's zeros leave
  // as it is)
  __device__ void add_terms(int r, bool every) {
    for (int i = lane; i < n; i += LANES) {
      float hx, hy, hw;
      gather(i, every, hx, hy, hw);
      body(r)[i] += hx;
      body(r + 1)[i] += hy;
      body(r + 2)[i] += hw;
    }
  }

  // adjoint of the lever-arm terms ran, rbn, rat, rbt of lane c
  __device__ void arm_bwd(int c, float g_ran, float g_rbn, float g_rat,
                          float g_rbt) {
    float nx = f(F_NX, c), ny = f(F_NY, c);
    float rax = f(F_RAX, c), ray = f(F_RAY, c);
    float rbx = f(F_RBX, c), rby = f(F_RBY, c);
    // ran = rax ny - ray nx, rat = rax ty - ray tx with (tx, ty) = (-ny, nx)
    g(G_RAX, c) += g_ran * ny + g_rat * nx;
    g(G_RAY, c) += g_rat * ny - g_ran * nx;
    g(G_RBX, c) += g_rbn * ny + g_rbt * nx;
    g(G_RBY, c) += g_rbt * ny - g_rbn * nx;
    g(G_NX, c) += g_rat * rax + g_rbt * rbx - g_ran * ray - g_rbn * rby;
    g(G_NY, c) += g_ran * rax + g_rbn * rbx + g_rat * ray + g_rbt * rby;
  }

  // adjoint of clamp_friction(c, x) for an active lane whose normal impulse
  // was jn: returns the cotangent of x, adds that of jn
  __device__ float clamp_friction_bwd(int c, float x, float jn, float G) {
    float mu = lc(R_MU, c);
    float lim = mu * jn;
    float nlim = -lim;
    float m = maxp(x, nlim);
    float g_m, g_lim, g_x, g_nlim;
    min_bwd(m, lim, G, g_m, g_lim);
    max_bwd(x, nlim, g_m, g_x, g_nlim);
    g_lim -= g_nlim;
    g(G_JN, c) += g_lim * mu;
    return g_x;
  }

  // (b) the joints, last first, on one thread: each replays the joints
  // before it from the velocities after the last pass
  __device__ void joints_bwd() {
    if (lane == 0) {
      float* gvx = body(S_GVX);
      float* gvy = body(S_GVY);
      float* gom = body(S_GOM);
      float* gqx = body(S_GQX);
      float* gqy = body(S_GQY);
      float* gqa = body(S_GQA);
      const float* qx = body(S_QX);
      const float* qy = body(S_QY);
      const float* qa = body(S_QA);
      for (int j = o.J - 1; j >= 0; --j) {
        for (int i = 0; i < n; ++i) {
          for (int m = 0; m < 3; ++m) {
            body(S_VX + m)[i] = t[T.v + (2 * o.iterations * 3 + m) * n + i];
          }
        }
        for (int k = 0; k < j; ++k) joint(k);
        int ia = o.joint_body[2 * j], ib = o.joint_body[2 * j + 1];
        const float* gj = o.joint_f + 7 * j;  // ax, ay, bx, by, kp, kd, v0
        float ca = cosf(qa[ia]), sa = sinf(qa[ia]);
        float cb = cosf(qa[ib]), sb = sinf(qa[ib]);
        float pax = qx[ia] + ca * gj[0] - sa * gj[1];
        float pay = qy[ia] + sa * gj[0] + ca * gj[1];
        float pbx = qx[ib] + cb * gj[2] - sb * gj[3];
        float pby = qy[ib] + sb * gj[2] + cb * gj[3];
        float rax = pax - qx[ia], ray = pay - qy[ia];
        float rbx = pbx - qx[ib], rby = pby - qy[ib];
        float oma = body(S_OM)[ia], omb = body(S_OM)[ib];
        float vax = body(S_VX)[ia] - ray * oma;
        float vay = body(S_VY)[ia] + rax * oma;
        float vbx = body(S_VX)[ib] - rby * omb;
        float vby = body(S_VY)[ib] + rbx * omb;
        float dvx_ = vax - vbx, dvy_ = vay - vby;
        float d = dvx_ * dvx_ + dvy_ * dvy_;
        float dvn = sqrtf(maxp(d, 1e-30f));
        float s_ = dvn + gj[6];
        float kp = gj[4], kd = gj[5];
        float jx = (pax - pbx) * kp + dvx_ * s_ * kd;
        float jy = (pay - pby) * kp + dvy_ * s_ * kd;
        float im_a = o.body_im[ia], im_b = o.body_im[ib];
        float ii_a = o.body_ii[ia], ii_b = o.body_ii[ib];
        // the velocity updates; the velocities themselves pass through
        float g_jx = gvx[ib] * im_b - gvx[ia] * im_a + gom[ia] * ray * ii_a
                     - gom[ib] * rby * ii_b;
        float g_jy = gvy[ib] * im_b - gvy[ia] * im_a - gom[ia] * rax * ii_a
                     + gom[ib] * rbx * ii_b;
        float g_rax = -gom[ia] * jy * ii_a, g_ray = gom[ia] * jx * ii_a;
        float g_rbx = gom[ib] * jy * ii_b, g_rby = -gom[ib] * jx * ii_b;
        // the impulse
        float g_dpx = g_jx * kp, g_dpy = g_jy * kp;
        float g_dvx = g_jx * kd * s_, g_dvy = g_jy * kd * s_;
        float g_s = g_jx * kd * dvx_ + g_jy * kd * dvy_;
        if (!(d < 1e-30f)) {  // dvn = sqrt(max(d, 1e-30))
          float g_d, g_floor;
          max_bwd(d, 1e-30f, g_s / (2.0f * dvn), g_d, g_floor);
          g_dvx += 2.0f * dvx_ * g_d;
          g_dvy += 2.0f * dvy_ * g_d;
        }
        // the anchor velocities
        gvx[ia] += g_dvx;
        gvy[ia] += g_dvy;
        gom[ia] += rax * g_dvy - ray * g_dvx;
        g_ray -= g_dvx * oma;
        g_rax += g_dvy * oma;
        gvx[ib] -= g_dvx;
        gvy[ib] -= g_dvy;
        gom[ib] += rby * g_dvx - rbx * g_dvy;
        g_rby += g_dvx * omb;
        g_rbx -= g_dvy * omb;
        // the anchors
        float g_pax = g_dpx + g_rax, g_pay = g_dpy + g_ray;
        float g_pbx = g_rbx - g_dpx, g_pby = g_rby - g_dpy;
        gqx[ia] += g_pax - g_rax;
        gqy[ia] += g_pay - g_ray;
        gqx[ib] += g_pbx - g_rbx;
        gqy[ib] += g_pby - g_rby;
        float g_ca = g_pax * gj[0] + g_pay * gj[1];
        float g_sa = g_pay * gj[0] - g_pax * gj[1];
        gqa[ia] += g_sa * ca - g_ca * sa;
        float g_cb = g_pbx * gj[2] + g_pby * gj[3];
        float g_sb = g_pby * gj[2] - g_pbx * gj[3];
        gqa[ib] += g_sb * cb - g_cb * sb;
      }
    }
    __syncwarp();
  }

  // position pass k, lane c, given the cotangents of its output (S_GP*)
  __device__ void position_bwd_lane(int k, int c) {
    // an inactive lane's impulses are 0, and off the tape
    float pj = k > 0 && act(c) ? pj_t(k - 1, c) : 0.0f;
    float pj_new = act(c) ? pj_t(k, c) : 0.0f;
    float g_djn, g_djt;
    scatter_bwd(c, pj_new - pj, 0.0f, S_GPX, g_djn, g_djt);
    float G = g(G_PJ, c) + g_djn;
    float g_old = -g_djn;
    bool terms = false;
    if (act(c)) {
      float v_n, v_t;
      rel_vel(c, S_UX, v_n, v_t);
      float rhs = v_n + f(F_BIAS, c);
      float k_n = f(F_KN, c);
      float inv_kn = safe_inv(k_n);
      float x = pj + rhs * inv_kn;
      if (!(x < 0.0f)) {  // pj_new = max(x, 0)
        float gx, g0;
        max_bwd(x, 0.0f, G, gx, g0);
        g_old += gx;
        float g_rhs = gx * inv_kn;
        inv_bwd(k_n, inv_kn, gx * rhs, g(G_KN, c));
        g(G_BIAS, c) += g_rhs;
        rel_vel_bwd(c, g_rhs, 0.0f);
        terms = true;
      }
    }
    if (!terms) no_terms(c);
    g(G_PJ, c) = g_old;
  }

  // friction pass of velocity iteration it, lane c
  __device__ void friction_bwd_lane(int it, int c) {
    int p = o.partner[c];
    bool bl = blk(c);
    if (bl && p < c) return;
    float jt = it > 0 && act(c) ? jt_t(it - 1, c) : 0.0f;
    float jt_new = act(c) ? jt_t(it, c) : 0.0f;
    float g_djn, g_djt;
    scatter_bwd(c, 0.0f, jt_new - jt, S_GVX, g_djn, g_djt);
    float G = g(G_JT, c) + g_djt;
    float g_old = -g_djt;
    float v_n, v_t;
    rel_vel(c, S_UX, v_n, v_t);
    float k_t = f(F_KT, c);
    if (!bl) {
      if (act(c)) {
        float inv_kt = safe_inv(k_t);
        float g_x = clamp_friction_bwd(c, jt + v_t * inv_kt, jn_t(it, c), G);
        g_old += g_x;
        inv_bwd(k_t, inv_kt, g_x * v_t, g(G_KT, c));
        rel_vel_bwd(c, 0.0f, g_x * inv_kt);
      } else {
        no_terms(c);
      }
      g(G_JT, c) = g_old;
      return;
    }
    float jt_p = it > 0 ? jt_t(it - 1, p) : 0.0f;
    float jt_new_p = jt_t(it, p);
    float g_djn_p, g_djt_p;
    scatter_bwd(p, 0.0f, jt_new_p - jt_p, S_GVX, g_djn_p, g_djt_p);
    float G_p = g(G_JT, p) + g_djt_p;
    float g_old_p = -g_djt_p;
    float v_n_p, v_t_p;
    rel_vel(p, S_UX, v_n_p, v_t_p);
    float k_tpd = f(F_KT, p);
    float k_tp = f(F_KTP, c);
    float det_t = k_t * k_tpd - k_tp * k_tp;
    bool ok_det_t = fabsf(det_t) >= 1e-5f * k_t * k_tpd;
    float safe_det_t = ok_det_t ? det_t : 1.0f;
    float bt0 = k_t * jt + k_tp * jt_p + v_t;
    float bt1 = k_tp * jt + k_tpd * jt_p + v_t_p;
    float xt0 = (k_tpd * bt0 - k_tp * bt1) / safe_det_t;
    float xt1 = (k_t * bt1 - k_tp * bt0) / safe_det_t;
    float inv_c = safe_inv(k_t + k_tp);
    float jt_split = jt + v_t * inv_c;
    float k_tp_p = f(F_KTP, p);
    float det_t_p = k_tpd * k_t - k_tp_p * k_tp_p;
    bool ok_det_t_p = fabsf(det_t_p) >= 1e-5f * k_tpd * k_t;
    float inv_c_p = safe_inv(k_tpd + k_tp_p);
    float jt_split_p = jt_p + v_t_p * inv_c_p;
    // both lanes are active in a solved block
    float g_pre = clamp_friction_bwd(c, ok_det_t ? xt0 : jt_split, jn_t(it, c), G);
    float g_pre_p = clamp_friction_bwd(
        p, ok_det_t_p ? xt1 : jt_split_p, jn_t(it, p), G_p);
    float g_vt = 0.0f, g_vt_p = 0.0f;
    float g_kt = 0.0f, g_ktpd = 0.0f, g_ktp = 0.0f, g_ktp_p = 0.0f;
    float g_xt0 = 0.0f, g_xt1 = 0.0f;
    if (ok_det_t) {
      g_xt0 = g_pre;
    } else {
      g_old += g_pre;
      g_vt += g_pre * inv_c;
      float gi = 0.0f;
      inv_bwd(k_t + k_tp, inv_c, g_pre * v_t, gi);
      g_kt += gi;
      g_ktp += gi;
    }
    if (ok_det_t_p) {
      g_xt1 = g_pre_p;
    } else {
      g_old_p += g_pre_p;
      g_vt_p += g_pre_p * inv_c_p;
      float gi = 0.0f;
      inv_bwd(k_tpd + k_tp_p, inv_c_p, g_pre_p * v_t_p, gi);
      g_ktpd += gi;
      g_ktp_p += gi;
    }
    if (ok_det_t || ok_det_t_p) {
      float gN0 = g_xt0 / safe_det_t, gN1 = g_xt1 / safe_det_t;
      if (ok_det_t) {
        float g_det = -(g_xt0 * (xt0 / safe_det_t)) - g_xt1 * (xt1 / safe_det_t);
        g_kt += g_det * k_tpd;
        g_ktpd += g_det * k_t;
        g_ktp -= 2.0f * (g_det * k_tp);
      }
      float g_bt0 = 0.0f, g_bt1 = 0.0f;
      // xt0 = (k_tpd bt0 - k_tp bt1) / det, xt1 = (k_t bt1 - k_tp bt0) / det
      g_ktpd += gN0 * bt0;
      g_bt0 += gN0 * k_tpd;
      g_ktp -= gN0 * bt1;
      g_bt1 -= gN0 * k_tp;
      g_kt += gN1 * bt1;
      g_bt1 += gN1 * k_t;
      g_ktp -= gN1 * bt0;
      g_bt0 -= gN1 * k_tp;
      // bt0 = k_t jt + k_tp jt_p + v_t, bt1 = k_tp jt + k_tpd jt_p + v_t_p
      g_kt += g_bt0 * jt;
      g_old += g_bt0 * k_t + g_bt1 * k_tp;
      g_ktp += g_bt0 * jt_p + g_bt1 * jt;
      g_old_p += g_bt0 * k_tp + g_bt1 * k_tpd;
      g_ktpd += g_bt1 * jt_p;
      g_vt += g_bt0;
      g_vt_p += g_bt1;
    }
    g(G_KT, c) += g_kt;
    g(G_KT, p) += g_ktpd;
    g(G_KTP, c) += g_ktp;
    g(G_KTP, p) += g_ktp_p;
    rel_vel_bwd(c, 0.0f, g_vt);
    rel_vel_bwd(p, 0.0f, g_vt_p);
    g(G_JT, c) = g_old;
    g(G_JT, p) = g_old_p;
  }

  // normal pass of velocity iteration it, lane c
  __device__ void normal_bwd_lane(int it, int c) {
    int p = o.partner[c];
    bool bl = blk(c);
    if (bl && p < c) return;
    float jn = it > 0 && act(c) ? jn_t(it - 1, c) : 0.0f;
    float jn_new = act(c) ? jn_t(it, c) : 0.0f;
    float g_djn, g_djt;
    scatter_bwd(c, jn_new - jn, 0.0f, S_GVX, g_djn, g_djt);
    float G = g(G_JN, c) + g_djn;
    float g_old = -g_djn;
    float v_n, v_t;
    rel_vel(c, S_UX, v_n, v_t);
    float rhs = v_n + f(F_TARGET, c);
    float k_n = f(F_KN, c);
    float inv_kn = safe_inv(k_n);
    if (!bl) {
      float x = jn + rhs * inv_kn;
      if (act(c) && !(x < 0.0f)) {  // jn_new = max(x, 0)
        float gx, g0;
        max_bwd(x, 0.0f, G, gx, g0);
        g_old += gx;
        float g_rhs = gx * inv_kn;
        inv_bwd(k_n, inv_kn, gx * rhs, g(G_KN, c));
        g(G_TARGET, c) += g_rhs;
        rel_vel_bwd(c, g_rhs, 0.0f);
      } else {
        no_terms(c);
      }
      g(G_JN, c) = g_old;
      return;
    }
    float jn_p = it > 0 ? jn_t(it - 1, p) : 0.0f;
    float jn_new_p = jn_t(it, p);
    float g_djn_p, g_djt_p;
    scatter_bwd(p, jn_new_p - jn_p, 0.0f, S_GVX, g_djn_p, g_djt_p);
    float G_p = g(G_JN, p) + g_djn_p;
    float g_old_p = -g_djn_p;
    float v_n_p, v_t_p;
    rel_vel(p, S_UX, v_n_p, v_t_p);
    float rhs_p = v_n_p + f(F_TARGET, p);
    float k_p = f(F_KN, p);
    float k_np = f(F_KNP, c);
    float inv_kp = safe_inv(k_p);
    float det = k_n * k_p - k_np * k_np;
    bool ok_det = fabsf(det) >= 1e-12f;
    float safe_det = ok_det ? det : 1.0f;
    float b0 = k_n * jn + k_np * jn_p + rhs;
    float b1 = k_np * jn + k_p * jn_p + rhs_p;
    float x0_full = (k_p * b0 - k_np * b1) / safe_det;
    float x1_full = (k_n * b1 - k_np * b0) / safe_det;
    bool ok_full = (x0_full >= 0.0f) && (x1_full >= 0.0f) && ok_det;
    float x0_c2 = maxp(b0 * inv_kn, 0.0f);
    bool ok_c2 = k_np * x0_c2 - b1 >= -1e-9f;
    float g_b0 = 0.0f, g_b1 = 0.0f;
    float g_kn = 0.0f, g_kp = 0.0f, g_knp = 0.0f;
    float g_inv_kn = 0.0f, g_inv_kp = 0.0f;
    if (ok_full) {
      float gN0 = G / safe_det, gN1 = G_p / safe_det;
      float g_det = -(G * (x0_full / safe_det)) - G_p * (x1_full / safe_det);
      g_kn += g_det * k_p;
      g_kp += g_det * k_n;
      g_knp -= 2.0f * (g_det * k_np);
      // x0 = (k_p b0 - k_np b1) / det, x1 = (k_n b1 - k_np b0) / det
      g_kp += gN0 * b0;
      g_b0 += gN0 * k_p;
      g_knp -= gN0 * b1;
      g_b1 -= gN0 * k_np;
      g_kn += gN1 * b1;
      g_b1 += gN1 * k_n;
      g_knp -= gN1 * b0;
      g_b0 -= gN1 * k_np;
    } else if (ok_c2) {
      float x = b0 * inv_kn;
      if (!(x < 0.0f)) {  // x0_c2 = max(x, 0)
        float gx, g0;
        max_bwd(x, 0.0f, G, gx, g0);
        g_b0 += gx * inv_kn;
        g_inv_kn += gx * b0;
      }
    } else {
      float x1_c3 = maxp(b1 * inv_kp, 0.0f);
      bool ok_c3 = k_np * x1_c3 - b0 >= -1e-9f;
      float x = b1 * inv_kp;
      if (ok_c3 && !(x < 0.0f)) {  // x1_c3 = max(x, 0)
        float gx, g0;
        max_bwd(x, 0.0f, G_p, gx, g0);
        g_b1 += gx * inv_kp;
        g_inv_kp += gx * b1;
      }
    }
    inv_bwd(k_n, inv_kn, g_inv_kn, g_kn);
    inv_bwd(k_p, inv_kp, g_inv_kp, g_kp);
    // b0 = k_n jn + k_np jn_p + rhs, b1 = k_np jn + k_p jn_p + rhs_p
    g_kn += g_b0 * jn;
    g_knp += g_b0 * jn_p + g_b1 * jn;
    g_kp += g_b1 * jn_p;
    g_old += g_b0 * k_n + g_b1 * k_np;
    g_old_p += g_b0 * k_np + g_b1 * k_p;
    g(G_KN, c) += g_kn;
    g(G_KN, p) += g_kp;
    g(G_KNP, c) += g_knp;
    g(G_TARGET, c) += g_b0;
    g(G_TARGET, p) += g_b1;
    rel_vel_bwd(c, g_b0, 0.0f);
    rel_vel_bwd(p, g_b1, 0.0f);
    g(G_JN, c) = g_old;
    g(G_JN, p) = g_old_p;
  }

  // the lever arms' terms of the coupling k_np, k_tp of lane c (its
  // partner p), as the serial loop over lanes gives them to lane x (c
  // itself, or its partner)
  __device__ void coupling_terms(int x, int c, int p) {
    float gknp = g(G_KNP, c), gktp = g(G_KTP, c);
    float ii_a = lc(R_II_A, c), ii_b = lc(R_II_B, c);
    if (x == c) {
      float pnx = f(F_NX, p), pny = f(F_NY, p);
      float prax = f(F_RAX, p), pray = f(F_RAY, p);
      float prbx = f(F_RBX, p), prby = f(F_RBY, p);
      float ran_p = prax * pny - pray * pnx, rbn_p = prbx * pny - prby * pnx;
      float rat_p = prax * pnx + pray * pny, rbt_p = prbx * pnx + prby * pny;
      arm_bwd(c, gknp * ran_p * ii_a, gknp * rbn_p * ii_b,
              gktp * rat_p * ii_a, gktp * rbt_p * ii_b);
    } else {
      float nx = f(F_NX, c), ny = f(F_NY, c);
      float rax = f(F_RAX, c), ray = f(F_RAY, c);
      float rbx = f(F_RBX, c), rby = f(F_RBY, c);
      float ran = rax * ny - ray * nx, rbn = rbx * ny - rby * nx;
      float rat = rax * nx + ray * ny, rbt = rbx * nx + rby * ny;
      arm_bwd(p, gknp * (ii_a * ran), gknp * (ii_b * rbn),
              gktp * (ii_a * rat), gktp * (ii_b * rbt));
    }
  }

  // the setup of lane c: cotangents into pen and pt, its lever arms' into
  // the tape's G_RA*, G_RB*, and the restitution target's into its terms K
  // (has: whether it has them)
  __device__ void setup_bwd_lane(int c) {
    const bool split = o.position_iterations > 0;
    bool on = act(c);
    float g_target = g(G_TARGET, c);
    float g_bias = on ? g(G_BIAS, c) + (split ? 0.0f : g_target) : 0.0f;
    // restitution target e * max(v_n0, 0) where v_n0 > 0
    bool terms = false;
    if (on) {
      float v_n0, v_t0;
      rel_vel(c, S_UX, v_n0, v_t0);
      if (v_n0 > 0.0f) {
        rel_vel_bwd(c, g_target * lc(R_E, c), 0.0f);
        terms = true;
      }
    }
    has()[c] = terms;
    // effective masses k_n, k_t
    float nx = f(F_NX, c), ny = f(F_NY, c);
    float rax = f(F_RAX, c), ray = f(F_RAY, c);
    float rbx = f(F_RBX, c), rby = f(F_RBY, c);
    float ran = rax * ny - ray * nx, rbn = rbx * ny - rby * nx;
    float rat = rax * nx + ray * ny, rbt = rbx * nx + rby * ny;
    float ii_a = lc(R_II_A, c), ii_b = lc(R_II_B, c);
    float gkn = g(G_KN, c), gkt = g(G_KT, c);
    arm_bwd(c, 2.0f * (gkn * ran * ii_a), 2.0f * (gkn * rbn * ii_b),
            2.0f * (gkt * rat * ii_a), 2.0f * (gkt * rbt * ii_b));
    // lever arms r = pt - p
    float grax = g(G_RAX, c), gray = g(G_RAY, c);
    float grbx = g(G_RBX, c), grby = g(G_RBY, c);
    const size_t k = (size_t)c * io.d_rs;
    io.dpt_x[k] = grax + grbx;
    io.dpt_y[k] = gray + grby;
    // the Baumgarte bias through the depth, and the normal
    float pen_x = io.pen_x[c], pen_y = io.pen_y[c];
    float d2 = pen_x * pen_x + pen_y * pen_y;
    float inv_d = rsqrtf(d2 <= 0.0f ? 1.0f : d2);
    float depth = d2 * inv_d;
    float g_floor;
    if (o.has_max_bias) {  // bias = min(bias, max_bias)
      float bias = o.baumgarte * maxp(depth - o.slop, 0.0f) / o.baumgarte_dt;
      min_bwd(bias, o.max_bias, g_bias, g_bias, g_floor);
    }
    // bias = baumgarte * max(depth - slop, 0) / baumgarte_dt
    float g_depth;
    max_bwd(depth - o.slop, 0.0f, g_bias / o.baumgarte_dt * o.baumgarte,
            g_depth, g_floor);
    float gnx = g(G_NX, c), gny = g(G_NY, c);
    float g_inv_d = g_depth * d2;
    if (d2 != 0.0f) g_inv_d += gnx * pen_x + gny * pen_y;
    float g_d2 = g_depth * inv_d;
    if (d2 > 0.0f) g_d2 -= 0.5f * g_inv_d * (inv_d * inv_d * inv_d);
    float dpen_x = 2.0f * pen_x * g_d2, dpen_y = 2.0f * pen_y * g_d2;
    if (d2 != 0.0f) {
      dpen_x += gnx * inv_d;
      dpen_y += gny * inv_d;
    }
    io.dpen_x[k] = dpen_x;
    io.dpen_y[k] = dpen_y;
  }

  // the setup: cotangents into v (S_GV*), p (S_GQ*), pen and pt
  __device__ void setup_bwd() {
    // the coupling terms k_np, k_tp of manifold pairs: lane x takes its
    // share of the serial loop's iterations x and partner[x], lower first
    for (int x = lane; x < C; x += LANES) {
      int y = o.partner[x];
      if (y < 0) continue;
      coupling_terms(x, x < y ? x : y, x < y ? y : x);
      coupling_terms(x, x < y ? y : x, x < y ? x : y);
    }
    __syncwarp();
    for (int c = lane; c < C; c += LANES) setup_bwd_lane(c);
    __syncwarp();
    // each body's sums in lane order: the restitution terms into v, the
    // lever arms' cotangents out of p
    const int32_t* ent = o.body_lanes + n + 1;
    for (int i = lane; i < n; i += LANES) {
      float* gvx = body(S_GVX);
      float* gvy = body(S_GVY);
      float* gom = body(S_GOM);
      for (int e = o.body_lanes[i]; e < o.body_lanes[i + 1]; ++e) {
        const int c = ent[e] >> 1, side = ent[e] & 1, r = 3 * side;
        if (has()[c]) {
          gvx[i] += K(r)[c];
          gvy[i] += K(r + 1)[c];
          gom[i] += K(r + 2)[c];
        }
        body(S_GQX)[i] -= g(side ? G_RBX : G_RAX, c);
        body(S_GQY)[i] -= g(side ? G_RBY : G_RAY, c);
      }
    }
    __syncwarp();
  }

  // the whole walk: the recompute with its tape, then every pass back.
  // The cotangents of the input body planes are then rows S_GQX, S_GQY,
  // S_GVX, S_GVY, S_GQA, S_GOM; those of the contact planes are in io.d*
  __device__ void run() {
    forward();
    for (int c = lane; c < C; c += LANES) {
      for (int k = 0; k < NUM_G; ++k) g(k, c) = 0.0f;
    }
    for (int i = lane; i < n; i += LANES) {
      body(S_GVX)[i] = io.gvx[i];
      body(S_GVY)[i] = io.gvy[i];
      body(S_GOM)[i] = io.gom[i];
      body(S_GQX)[i] = io.gpx[i];
      body(S_GQY)[i] = io.gpy[i];
      body(S_GQA)[i] = io.gang[i];
    }
    __syncwarp();
    joints_bwd();
    // q = p + pv * dt: gq is now the cotangent of p as well
    if (o.position_iterations > 0) {
      for (int i = lane; i < n; i += LANES) {
        body(S_GPX)[i] = body(S_GQX)[i] * o.dt;
        body(S_GPY)[i] = body(S_GQY)[i] * o.dt;
        body(S_GPW)[i] = body(S_GQA)[i] * o.dt;
      }
      for (int k = o.position_iterations - 1; k >= 0; --k) {
        load(T.pv, k, S_UX);
        __syncwarp();
        const bool every = !rows_finite(S_GPX);
        const int m = every ? C : listed;
        for (int j = lane; j < m; j += LANES) {
          position_bwd_lane(k, every ? j : list()[j]);
        }
        __syncwarp();
        add_terms(S_GPX, every);
        __syncwarp();
      }
    }
    for (int it = o.iterations - 1; it >= 0; --it) {
      load(T.v, 2 * it + 1, S_UX);
      __syncwarp();
      bool every = !rows_finite(S_GVX);
      int m = every ? C : listed;
      for (int j = lane; j < m; j += LANES) {
        friction_bwd_lane(it, every ? j : list()[j]);
      }
      __syncwarp();
      add_terms(S_GVX, every);
      load(T.v, 2 * it, S_UX);
      __syncwarp();
      every = !rows_finite(S_GVX);
      m = every ? C : listed;
      for (int j = lane; j < m; j += LANES) {
        normal_bwd_lane(it, every ? j : list()[j]);
      }
      __syncwarp();
      add_terms(S_GVX, every);
      __syncwarp();
    }
    load(T.v, 0, S_UX);
    __syncwarp();
    setup_bwd();
  }
};

}  // namespace