// Device code shared by the contact solve (contact_solver.cu) and the
// fused step (fused_step.cu): the solver's per-world state and passes, one
// CUDA thread per world.  The reverse passes share its lane fields,
// constants and NaN-propagating helpers; their warp walk
// (contact_solver_bwd.cuh) repeats these passes' arithmetic lane for lane
// on a warp.
//
// Everything here computes what engine/batched.py:solve_contacts_bm
// followed by apply_joints_bm compute, lane for lane, and rounds each
// product and sum on its own (the files are built with --fmad=false and
// without fast math), so the reverse passes' recomputed forward is the
// forward kernel's to the bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BODIES = 64;
constexpr int THREADS = 128;

// per-lane solver state in the scratch buffer, field-major [F, C, B]
enum Field {
  F_NX, F_NY, F_RAX, F_RAY, F_RBX, F_RBY,
  F_KN, F_KT, F_KNP, F_KTP, F_TARGET, F_BIAS,
  F_JN, F_JT, F_PJ,
  NUM_FIELDS
};

// rows of lane_const [6, C]
enum LaneRow { R_IM_A, R_IM_B, R_II_A, R_II_B, R_E, R_MU };

struct Args {
  const float *pen_x, *pen_y, *pt_x, *pt_y;
  const uint8_t* active;
  const float *px, *py, *vx, *vy, *ang, *om;
  float *opx, *opy, *ovx, *ovy, *oang, *oom;
  const int32_t *body_a, *body_b, *partner;
  const float* lane_const;
  const int32_t* movable;
  const float *body_im, *body_ii;
  const int32_t* joint_body;
  const float* joint_f;
  float* scratch;
  int B, C, n, J, iterations, position_iterations;
  float dt, baumgarte, slop, baumgarte_dt, max_bias;
  int has_max_bias;
};

// max/min that propagate a NaN operand, as jnp.maximum/torch.clamp do
__device__ __forceinline__ float maxp(float x, float y) {
  if (x != x) return x;
  if (y != y) return y;
  return x > y ? x : y;
}
__device__ __forceinline__ float minp(float x, float y) {
  if (x != x) return x;
  if (y != y) return y;
  return x < y ? x : y;
}

__device__ __forceinline__ float safe_inv(float k) {
  return 1.0f / (k == 0.0f ? 1.0f : k);
}

struct World {
  const Args& a;
  int b;
  float vx[MAX_BODIES], vy[MAX_BODIES], om[MAX_BODIES];
  float dvx[MAX_BODIES], dvy[MAX_BODIES], dom[MAX_BODIES];

  __device__ World(const Args& args, int world) : a(args), b(world) {}

  __device__ float& f(int field, int c) {
    return a.scratch[((size_t)field * a.C + c) * a.B + b];
  }
  __device__ float lc(int row, int c) const { return a.lane_const[row * a.C + c]; }
  __device__ bool act(int c) const { return a.active[(size_t)c * a.B + b] != 0; }

  __device__ void load_velocities() {
    const size_t B = a.B;
    for (int i = 0; i < a.n; ++i) {
      vx[i] = a.vx[i * B + b];
      vy[i] = a.vy[i * B + b];
      om[i] = a.om[i * B + b];
    }
  }

  __device__ void clear() {
    for (int i = 0; i < a.n; ++i) dvx[i] = dvy[i] = dom[i] = 0.0f;
  }
  __device__ void apply(float* ux, float* uy, float* uw) {
    for (int i = 0; i < a.n; ++i) {
      ux[i] = ux[i] + dvx[i];
      uy[i] = uy[i] + dvy[i];
      uw[i] = uw[i] + dom[i];
    }
  }

  // relative velocity of lane c along its normal and tangent
  __device__ void rel_vel(int c, const float* ux, const float* uy,
                          const float* uw, float& v_n, float& v_t) {
    int ia = a.body_a[c], ib = a.body_b[c];
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

  // add lane c's impulse deltas to its movable bodies' accumulators
  __device__ void scatter(int c, float dj_n, float dj_t) {
    int ia = a.body_a[c], ib = a.body_b[c];
    float nx = f(F_NX, c), ny = f(F_NY, c);
    float tx = -ny, ty = nx;
    float jx = dj_n * nx + dj_t * tx;
    float jy = dj_n * ny + dj_t * ty;
    if (a.movable[ia]) {
      float im = lc(R_IM_A, c), ii = lc(R_II_A, c);
      dvx[ia] += jx * im;
      dvy[ia] += jy * im;
      dom[ia] += (f(F_RAX, c) * jy - f(F_RAY, c) * jx) * ii;
    }
    if (a.movable[ib]) {
      float im = lc(R_IM_B, c), ii = lc(R_II_B, c);
      dvx[ib] += -jx * im;
      dvy[ib] += -jy * im;
      dom[ib] += -(f(F_RBX, c) * jy - f(F_RBY, c) * jx) * ii;
    }
  }

  __device__ void setup(bool split) {
    const size_t B = a.B;
    for (int c = 0; c < a.C; ++c) {
      int ia = a.body_a[c], ib = a.body_b[c];
      float pen_x = a.pen_x[c * B + b], pen_y = a.pen_y[c * B + b];
      float pt_x = a.pt_x[c * B + b], pt_y = a.pt_y[c * B + b];
      float d2 = pen_x * pen_x + pen_y * pen_y;
      float inv_d = rsqrtf(d2 <= 0.0f ? 1.0f : d2);
      float depth = d2 * inv_d;
      float nx = d2 == 0.0f ? 0.0f : pen_x * inv_d;
      float ny = d2 == 0.0f ? 0.0f : pen_y * inv_d;
      float tx = -ny, ty = nx;
      float rax = pt_x - a.px[ia * B + b];
      float ray = pt_y - a.py[ia * B + b];
      float rbx = pt_x - a.px[ib * B + b];
      float rby = pt_y - a.py[ib * B + b];
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
      rel_vel(c, vx, vy, om, v_n0, v_t0);
      float bias = a.baumgarte * maxp(depth - a.slop, 0.0f) / a.baumgarte_dt;
      if (a.has_max_bias) bias = minp(bias, a.max_bias);
      float rest = v_n0 > 0.0f ? lc(R_E, c) * maxp(v_n0, 0.0f) : 0.0f;
      bool on = act(c);
      f(F_TARGET, c) = on ? (split ? rest : rest + bias) : 0.0f;
      f(F_BIAS, c) = on ? bias : 0.0f;
      f(F_JN, c) = 0.0f;
      f(F_JT, c) = 0.0f;
      f(F_PJ, c) = 0.0f;
    }
    // coupling terms of manifold pairs, from both lanes' lever arms
    for (int c = 0; c < a.C; ++c) {
      int p = a.partner[c];
      if (p < 0) continue;
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
  }

  // lanes c and p of a manifold are solved jointly only when both are
  // active; the lead (lower) lane then solves the pair
  __device__ bool blockable(int c, int p) const {
    return p >= 0 && act(c) && act(p);
  }

  __device__ void normal_pass() {
    clear();
    for (int c = 0; c < a.C; ++c) {
      int p = a.partner[c];
      bool blk = blockable(c, p);
      if (blk && p < c) continue;  // solved at its lead lane
      float v_n, v_t;
      rel_vel(c, vx, vy, om, v_n, v_t);
      float rhs = v_n + f(F_TARGET, c);
      float jn = f(F_JN, c);
      float k_n = f(F_KN, c);
      float inv_kn = safe_inv(k_n);
      if (!blk) {
        float jn_new = act(c) ? maxp(jn + rhs * inv_kn, 0.0f) : 0.0f;
        scatter(c, jn_new - jn, 0.0f);
        f(F_JN, c) = jn_new;
        continue;
      }
      float v_n_p, v_t_p;
      rel_vel(p, vx, vy, om, v_n_p, v_t_p);
      float rhs_p = v_n_p + f(F_TARGET, p);
      float jn_p = f(F_JN, p);
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
      f(F_JN, c) = x0;
      f(F_JN, p) = x1;
    }
    apply(vx, vy, om);
  }

  // friction impulse of a lane outside a solved block, or its split share
  __device__ float clamp_friction(int c, float jt_new) {
    float lim = lc(R_MU, c) * f(F_JN, c);
    jt_new = minp(maxp(jt_new, -lim), lim);
    return act(c) ? jt_new : 0.0f;
  }

  __device__ void friction_pass() {
    clear();
    for (int c = 0; c < a.C; ++c) {
      int p = a.partner[c];
      bool blk = blockable(c, p);
      if (blk && p < c) continue;
      float v_n, v_t;
      rel_vel(c, vx, vy, om, v_n, v_t);
      float jt = f(F_JT, c);
      float k_t = f(F_KT, c);
      if (!blk) {
        float jt_new = clamp_friction(c, jt + v_t * safe_inv(k_t));
        scatter(c, 0.0f, jt_new - jt);
        f(F_JT, c) = jt_new;
        continue;
      }
      float v_n_p, v_t_p;
      rel_vel(p, vx, vy, om, v_n_p, v_t_p);
      float jt_p = f(F_JT, p);
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
      float jt_new = clamp_friction(c, ok_det_t ? xt0 : jt_split);
      float jt_new_p = clamp_friction(p, ok_det_t_p ? xt1 : jt_split_p);
      scatter(c, 0.0f, jt_new - jt);
      scatter(p, 0.0f, jt_new_p - jt_p);
      f(F_JT, c) = jt_new;
      f(F_JT, p) = jt_new_p;
    }
    apply(vx, vy, om);
  }

  // one split-impulse pass on the pseudo-velocities pvx, pvy, pom
  __device__ void position_pass(float* pvx, float* pvy, float* pom) {
    clear();
    for (int c = 0; c < a.C; ++c) {
      float v_n, v_t;
      rel_vel(c, pvx, pvy, pom, v_n, v_t);
      float rhs = v_n + f(F_BIAS, c);
      float pj = f(F_PJ, c);
      float pj_new = act(c) ? maxp(pj + rhs * safe_inv(f(F_KN, c)), 0.0f) : 0.0f;
      scatter(c, pj_new - pj, 0.0f);
      f(F_PJ, c) = pj_new;
    }
    apply(pvx, pvy, pom);
  }

  // joint j on the corrected poses qx, qy, qa: updates vx, vy, om
  __device__ void joint(int j, const float* qx, const float* qy, const float* qa) {
    int ia = a.joint_body[2 * j], ib = a.joint_body[2 * j + 1];
    const float* g = a.joint_f + 7 * j;  // ax, ay, bx, by, kp, kd, v0
    float ca = cosf(qa[ia]), sa = sinf(qa[ia]);
    float cb = cosf(qa[ib]), sb = sinf(qa[ib]);
    float pax = qx[ia] + ca * g[0] - sa * g[1];
    float pay = qy[ia] + sa * g[0] + ca * g[1];
    float pbx = qx[ib] + cb * g[2] - sb * g[3];
    float pby = qy[ib] + sb * g[2] + cb * g[3];
    float rax = pax - qx[ia], ray = pay - qy[ia];
    float rbx = pbx - qx[ib], rby = pby - qy[ib];
    float vax = vx[ia] - ray * om[ia];
    float vay = vy[ia] + rax * om[ia];
    float vbx = vx[ib] - rby * om[ib];
    float vby = vy[ib] + rbx * om[ib];
    float dpx = pax - pbx, dpy = pay - pby;
    float dvx_ = vax - vbx, dvy_ = vay - vby;
    float dvn = sqrtf(maxp(dvx_ * dvx_ + dvy_ * dvy_, 1e-30f));
    float jx = dpx * g[4] + dvx_ * (dvn + g[6]) * g[5];
    float jy = dpy * g[4] + dvy_ * (dvn + g[6]) * g[5];
    float im_a = a.body_im[ia], im_b = a.body_im[ib];
    float ii_a = a.body_ii[ia], ii_b = a.body_ii[ib];
    vx[ia] = vx[ia] - jx * im_a;
    vx[ib] = vx[ib] + jx * im_b;
    vy[ia] = vy[ia] - jy * im_a;
    vy[ib] = vy[ib] + jy * im_b;
    om[ia] = om[ia] - (rax * jy - ray * jx) * ii_a;
    om[ib] = om[ib] + (rbx * jy - rby * jx) * ii_b;
  }
};

// The whole solve of world b: load the velocities, set the lanes up, run
// the velocity passes, integrate the position passes into the poses, run
// the joints and write the six body planes.  The solver kernel
// (contact_solver.cu) and the fused step (fused_step.cu) both run it, so
// their solves agree to the bit on the same contact planes.  Every read of
// a body plane comes before the write of the same world's outputs, so the
// input and output planes may be the same memory.
__device__ void solve_world(const Args& args, int b) {
  const size_t B = args.B;
  World w(args, b);
  w.load_velocities();
  const bool split = args.position_iterations > 0;
  w.setup(split);
  for (int it = 0; it < args.iterations; ++it) {
    w.normal_pass();
    w.friction_pass();
  }

  float qx[MAX_BODIES], qy[MAX_BODIES], qa[MAX_BODIES];
  for (int i = 0; i < args.n; ++i) {
    qx[i] = args.px[i * B + b];
    qy[i] = args.py[i * B + b];
    qa[i] = args.ang[i * B + b];
  }
  if (split) {
    float pvx[MAX_BODIES], pvy[MAX_BODIES], pom[MAX_BODIES];
    for (int i = 0; i < args.n; ++i) pvx[i] = pvy[i] = pom[i] = 0.0f;
    for (int it = 0; it < args.position_iterations; ++it) {
      w.position_pass(pvx, pvy, pom);
    }
    for (int i = 0; i < args.n; ++i) {
      qx[i] = qx[i] + pvx[i] * args.dt;
      qy[i] = qy[i] + pvy[i] * args.dt;
      qa[i] = qa[i] + pom[i] * args.dt;
    }
  }
  for (int j = 0; j < args.J; ++j) w.joint(j, qx, qy, qa);

  for (int i = 0; i < args.n; ++i) {
    args.opx[i * B + b] = qx[i];
    args.opy[i * B + b] = qy[i];
    args.ovx[i * B + b] = w.vx[i];
    args.ovy[i * B + b] = w.vy[i];
    args.oang[i * B + b] = qa[i];
    args.oom[i * B + b] = w.om[i];
  }
}

}  // namespace
