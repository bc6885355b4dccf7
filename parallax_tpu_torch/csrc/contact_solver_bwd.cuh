// The solver's reverse pass, one CUDA thread per world: the scratch layout
// of its tape and the Reverse walk.  The reverse-pass kernel
// (contact_solver_bwd.cu) runs it on the contact planes it is given; the
// fused step's reverse pass (fused_step_bwd.cu) runs it on the contact
// planes and integrated state that its recompute leaves in its scratch.
// Args says where the primal planes are, so Reverse reads them from any
// memory.  See contact_solver_bwd.cu for the rules it follows.

#pragma once

#include "contact_solver.cuh"

namespace {

// per-lane cotangents in the scratch, field-major [G, C, B]
enum GField {
  G_NX, G_NY, G_RAX, G_RAY, G_RBX, G_RBY,
  G_KN, G_KT, G_KNP, G_KTP, G_TARGET, G_BIAS,
  G_JN, G_JT, G_PJ,
  NUM_G
};

// Row offsets in the scratch; every row holds B floats.
struct Layout {
  size_t jn, jt, pj, g, v, pv, rows;
  __host__ __device__ Layout(int C, int n, int I, int P) {
    size_t r = (size_t)NUM_FIELDS * C;  // the forward's lane fields
    jn = r;  // normal impulses after each velocity iteration [I, C]
    r += (size_t)I * C;
    jt = r;  // friction impulses after each velocity iteration [I, C]
    r += (size_t)I * C;
    pj = r;  // position impulses after each position pass [P, C]
    r += (size_t)P * C;
    g = r;  // per-lane cotangents [NUM_G, C]
    r += (size_t)NUM_G * C;
    v = r;  // velocities before each velocity pass, and after the last
    r += (size_t)(2 * I + 1) * 3 * n;
    pv = r;  // pseudo-velocities before each position pass
    r += (size_t)P * 3 * n;
    rows = r;
  }
};

struct BwdArgs {
  Args f;  // the forward's operands; f.scratch is the start of the scratch
  const float *gpx, *gpy, *gvx, *gvy, *gang, *gom;  // output cotangents
  float *dpx, *dpy, *dvx, *dvy, *dang, *dom;        // input cotangents
  float *dpen_x, *dpen_y, *dpt_x, *dpt_y;
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

struct Reverse {
  const BwdArgs& A;
  World& w;
  const Layout L;
  const int b;
  // cotangents of the body velocities, poses and pseudo-velocities
  float gvx[MAX_BODIES], gvy[MAX_BODIES], gom[MAX_BODIES];
  float gqx[MAX_BODIES], gqy[MAX_BODIES], gqa[MAX_BODIES];
  float gpx[MAX_BODIES], gpy[MAX_BODIES], gpw[MAX_BODIES];
  // one pass's rel_vel cotangents, and the velocity snapshot it read
  float hx[MAX_BODIES], hy[MAX_BODIES], hw[MAX_BODIES];
  float ux[MAX_BODIES], uy[MAX_BODIES], uw[MAX_BODIES];
  // the corrected poses
  float qx[MAX_BODIES], qy[MAX_BODIES], qa[MAX_BODIES];

  __device__ Reverse(const BwdArgs& args, World& world)
      : A(args), w(world),
        L(args.f.C, args.f.n, args.f.iterations, args.f.position_iterations),
        b(world.b) {}

  __device__ float& row(size_t r) { return A.f.scratch[r * A.f.B + b]; }
  __device__ float& g(int field, int c) { return row(L.g + (size_t)field * A.f.C + c); }
  __device__ float& jn_t(int it, int c) { return row(L.jn + (size_t)it * A.f.C + c); }
  __device__ float& jt_t(int it, int c) { return row(L.jt + (size_t)it * A.f.C + c); }
  __device__ float& pj_t(int k, int c) { return row(L.pj + (size_t)k * A.f.C + c); }
  __device__ float& snap(size_t base, int k, int comp, int i) {
    return row(base + ((size_t)k * 3 + comp) * A.f.n + i);
  }

  __device__ void store(size_t base, int k, const float* x, const float* y,
                        const float* z) {
    for (int i = 0; i < A.f.n; ++i) {
      snap(base, k, 0, i) = x[i];
      snap(base, k, 1, i) = y[i];
      snap(base, k, 2, i) = z[i];
    }
  }
  __device__ void load(size_t base, int k, float* x, float* y, float* z) {
    for (int i = 0; i < A.f.n; ++i) {
      x[i] = snap(base, k, 0, i);
      y[i] = snap(base, k, 1, i);
      z[i] = snap(base, k, 2, i);
    }
  }
  __device__ void clear_h() {
    for (int i = 0; i < A.f.n; ++i) hx[i] = hy[i] = hw[i] = 0.0f;
  }
  __device__ void add_h(float* x, float* y, float* z) {
    for (int i = 0; i < A.f.n; ++i) {
      x[i] += hx[i];
      y[i] += hy[i];
      z[i] += hw[i];
    }
  }

  // (a) the forward, with the tape
  __device__ void forward() {
    const Args& a = A.f;
    const size_t B = a.B;
    w.load_velocities();
    const bool split = a.position_iterations > 0;
    w.setup(split);
    store(L.v, 0, w.vx, w.vy, w.om);
    for (int it = 0; it < a.iterations; ++it) {
      w.normal_pass();
      for (int c = 0; c < a.C; ++c) jn_t(it, c) = w.f(F_JN, c);
      store(L.v, 2 * it + 1, w.vx, w.vy, w.om);
      w.friction_pass();
      for (int c = 0; c < a.C; ++c) jt_t(it, c) = w.f(F_JT, c);
      store(L.v, 2 * it + 2, w.vx, w.vy, w.om);
    }
    for (int i = 0; i < a.n; ++i) {
      qx[i] = a.px[i * B + b];
      qy[i] = a.py[i * B + b];
      qa[i] = a.ang[i * B + b];
    }
    if (split) {
      float pvx[MAX_BODIES], pvy[MAX_BODIES], pom[MAX_BODIES];
      for (int i = 0; i < a.n; ++i) pvx[i] = pvy[i] = pom[i] = 0.0f;
      for (int k = 0; k < a.position_iterations; ++k) {
        store(L.pv, k, pvx, pvy, pom);
        w.position_pass(pvx, pvy, pom);
        for (int c = 0; c < a.C; ++c) pj_t(k, c) = w.f(F_PJ, c);
      }
      for (int i = 0; i < a.n; ++i) {
        qx[i] = qx[i] + pvx[i] * a.dt;
        qy[i] = qy[i] + pvy[i] * a.dt;
        qa[i] = qa[i] + pom[i] * a.dt;
      }
    }
  }

  // adjoint of scatter(c, dj_n, dj_t) given the cotangents (ox, oy, ow) of
  // the pass's output velocities: returns those of dj_n and dj_t
  __device__ void scatter_bwd(int c, float dj_n, float dj_t, const float* ox,
                              const float* oy, const float* ow, float& g_djn,
                              float& g_djt) {
    const Args& a = A.f;
    int ia = a.body_a[c], ib = a.body_b[c];
    float nx = w.f(F_NX, c), ny = w.f(F_NY, c);
    float tx = -ny, ty = nx;
    float jx = dj_n * nx + dj_t * tx;
    float jy = dj_n * ny + dj_t * ty;
    float g_jx = 0.0f, g_jy = 0.0f;
    if (a.movable[ia]) {
      float im = w.lc(R_IM_A, c), ii = w.lc(R_II_A, c);
      g_jx += ox[ia] * im;
      g_jy += oy[ia] * im;
      float gw = ow[ia] * ii;  // dom += (rax * jy - ray * jx) * ii
      g_jy += gw * w.f(F_RAX, c);
      g_jx -= gw * w.f(F_RAY, c);
      g(G_RAX, c) += gw * jy;
      g(G_RAY, c) -= gw * jx;
    }
    if (a.movable[ib]) {
      float im = w.lc(R_IM_B, c), ii = w.lc(R_II_B, c);
      g_jx -= ox[ib] * im;
      g_jy -= oy[ib] * im;
      float gw = ow[ib] * ii;  // dom += -(rbx * jy - rby * jx) * ii
      g_jy -= gw * w.f(F_RBX, c);
      g_jx += gw * w.f(F_RBY, c);
      g(G_RBX, c) -= gw * jy;
      g(G_RBY, c) += gw * jx;
    }
    g_djn = g_jx * nx + g_jy * ny;
    g_djt = g_jx * tx + g_jy * ty;
    g(G_NX, c) += g_jx * dj_n + g_jy * dj_t;
    g(G_NY, c) += g_jy * dj_n - g_jx * dj_t;
  }

  // adjoint of rel_vel(c, u) given the cotangents of v_n and v_t: the
  // velocity cotangents go to (ex, ey, ew)
  __device__ void rel_vel_bwd(int c, const float* u_x, const float* u_y,
                              const float* u_w, float g_vn, float g_vt,
                              float* ex, float* ey, float* ew) {
    const Args& a = A.f;
    int ia = a.body_a[c], ib = a.body_b[c];
    float nx = w.f(F_NX, c), ny = w.f(F_NY, c);
    float tx = -ny, ty = nx;
    float rax = w.f(F_RAX, c), ray = w.f(F_RAY, c);
    float rbx = w.f(F_RBX, c), rby = w.f(F_RBY, c);
    float vax = u_x[ia] - ray * u_w[ia];
    float vay = u_y[ia] + rax * u_w[ia];
    float vbx = u_x[ib] - rby * u_w[ib];
    float vby = u_y[ib] + rbx * u_w[ib];
    float rx = vbx - vax;
    float ry = vby - vay;
    float g_rx = g_vn * nx + g_vt * tx;
    float g_ry = g_vn * ny + g_vt * ty;
    g(G_NX, c) += g_vn * rx + g_vt * ry;
    g(G_NY, c) += g_vn * ry - g_vt * rx;
    ex[ib] += g_rx;
    ey[ib] += g_ry;
    ew[ib] += rbx * g_ry - rby * g_rx;
    g(G_RBY, c) -= u_w[ib] * g_rx;
    g(G_RBX, c) += u_w[ib] * g_ry;
    ex[ia] -= g_rx;
    ey[ia] -= g_ry;
    ew[ia] += ray * g_rx - rax * g_ry;
    g(G_RAY, c) += u_w[ia] * g_rx;
    g(G_RAX, c) -= u_w[ia] * g_ry;
  }

  // adjoint of the lever-arm terms ran, rbn, rat, rbt of lane c
  __device__ void arm_bwd(int c, float g_ran, float g_rbn, float g_rat,
                          float g_rbt) {
    float nx = w.f(F_NX, c), ny = w.f(F_NY, c);
    float rax = w.f(F_RAX, c), ray = w.f(F_RAY, c);
    float rbx = w.f(F_RBX, c), rby = w.f(F_RBY, c);
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
    float mu = w.lc(R_MU, c);
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

  // (b) the joints, last first
  __device__ void joints_bwd() {
    const Args& a = A.f;
    for (int j = a.J - 1; j >= 0; --j) {
      load(L.v, 2 * a.iterations, w.vx, w.vy, w.om);
      for (int k = 0; k < j; ++k) w.joint(k, qx, qy, qa);
      int ia = a.joint_body[2 * j], ib = a.joint_body[2 * j + 1];
      const float* gj = a.joint_f + 7 * j;  // ax, ay, bx, by, kp, kd, v0
      float ca = cosf(qa[ia]), sa = sinf(qa[ia]);
      float cb = cosf(qa[ib]), sb = sinf(qa[ib]);
      float pax = qx[ia] + ca * gj[0] - sa * gj[1];
      float pay = qy[ia] + sa * gj[0] + ca * gj[1];
      float pbx = qx[ib] + cb * gj[2] - sb * gj[3];
      float pby = qy[ib] + sb * gj[2] + cb * gj[3];
      float rax = pax - qx[ia], ray = pay - qy[ia];
      float rbx = pbx - qx[ib], rby = pby - qy[ib];
      float oma = w.om[ia], omb = w.om[ib];
      float vax = w.vx[ia] - ray * oma;
      float vay = w.vy[ia] + rax * oma;
      float vbx = w.vx[ib] - rby * omb;
      float vby = w.vy[ib] + rbx * omb;
      float dvx_ = vax - vbx, dvy_ = vay - vby;
      float d = dvx_ * dvx_ + dvy_ * dvy_;
      float dvn = sqrtf(maxp(d, 1e-30f));
      float s = dvn + gj[6];
      float kp = gj[4], kd = gj[5];
      float jx = (pax - pbx) * kp + dvx_ * s * kd;
      float jy = (pay - pby) * kp + dvy_ * s * kd;
      float im_a = a.body_im[ia], im_b = a.body_im[ib];
      float ii_a = a.body_ii[ia], ii_b = a.body_ii[ib];
      // the velocity updates; the velocities themselves pass through
      float g_jx = gvx[ib] * im_b - gvx[ia] * im_a + gom[ia] * ray * ii_a
                   - gom[ib] * rby * ii_b;
      float g_jy = gvy[ib] * im_b - gvy[ia] * im_a - gom[ia] * rax * ii_a
                   + gom[ib] * rbx * ii_b;
      float g_rax = -gom[ia] * jy * ii_a, g_ray = gom[ia] * jx * ii_a;
      float g_rbx = gom[ib] * jy * ii_b, g_rby = -gom[ib] * jx * ii_b;
      // the impulse
      float g_dpx = g_jx * kp, g_dpy = g_jy * kp;
      float g_dvx = g_jx * kd * s, g_dvy = g_jy * kd * s;
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

  // position pass k, given the cotangents (gpx, gpy, gpw) of its output
  __device__ void position_bwd(int k) {
    const Args& a = A.f;
    load(L.pv, k, ux, uy, uw);
    clear_h();
    for (int c = 0; c < a.C; ++c) {
      float pj = k > 0 ? pj_t(k - 1, c) : 0.0f;
      float pj_new = pj_t(k, c);
      float g_djn, g_djt;
      scatter_bwd(c, pj_new - pj, 0.0f, gpx, gpy, gpw, g_djn, g_djt);
      float G = g(G_PJ, c) + g_djn;
      float g_old = -g_djn;
      if (w.act(c)) {
        float v_n, v_t;
        w.rel_vel(c, ux, uy, uw, v_n, v_t);
        float rhs = v_n + w.f(F_BIAS, c);
        float k_n = w.f(F_KN, c);
        float inv_kn = safe_inv(k_n);
        float x = pj + rhs * inv_kn;
        if (!(x < 0.0f)) {  // pj_new = max(x, 0)
          float gx, g0;
          max_bwd(x, 0.0f, G, gx, g0);
          g_old += gx;
          float g_rhs = gx * inv_kn;
          inv_bwd(k_n, inv_kn, gx * rhs, g(G_KN, c));
          g(G_BIAS, c) += g_rhs;
          rel_vel_bwd(c, ux, uy, uw, g_rhs, 0.0f, hx, hy, hw);
        }
      }
      g(G_PJ, c) = g_old;
    }
    add_h(gpx, gpy, gpw);
  }

  // friction pass of velocity iteration it
  __device__ void friction_bwd(int it) {
    const Args& a = A.f;
    load(L.v, 2 * it + 1, ux, uy, uw);
    clear_h();
    for (int c = 0; c < a.C; ++c) {
      int p = a.partner[c];
      bool blk = w.blockable(c, p);
      if (blk && p < c) continue;
      float jt = it > 0 ? jt_t(it - 1, c) : 0.0f;
      float jt_new = jt_t(it, c);
      float g_djn, g_djt;
      scatter_bwd(c, 0.0f, jt_new - jt, gvx, gvy, gom, g_djn, g_djt);
      float G = g(G_JT, c) + g_djt;
      float g_old = -g_djt;
      float v_n, v_t;
      w.rel_vel(c, ux, uy, uw, v_n, v_t);
      float k_t = w.f(F_KT, c);
      if (!blk) {
        if (w.act(c)) {
          float inv_kt = safe_inv(k_t);
          float g_x = clamp_friction_bwd(c, jt + v_t * inv_kt, jn_t(it, c), G);
          g_old += g_x;
          inv_bwd(k_t, inv_kt, g_x * v_t, g(G_KT, c));
          rel_vel_bwd(c, ux, uy, uw, 0.0f, g_x * inv_kt, hx, hy, hw);
        }
        g(G_JT, c) = g_old;
        continue;
      }
      float jt_p = it > 0 ? jt_t(it - 1, p) : 0.0f;
      float jt_new_p = jt_t(it, p);
      float g_djn_p, g_djt_p;
      scatter_bwd(p, 0.0f, jt_new_p - jt_p, gvx, gvy, gom, g_djn_p, g_djt_p);
      float G_p = g(G_JT, p) + g_djt_p;
      float g_old_p = -g_djt_p;
      float v_n_p, v_t_p;
      w.rel_vel(p, ux, uy, uw, v_n_p, v_t_p);
      float k_tpd = w.f(F_KT, p);
      float k_tp = w.f(F_KTP, c);
      float det_t = k_t * k_tpd - k_tp * k_tp;
      bool ok_det_t = fabsf(det_t) >= 1e-5f * k_t * k_tpd;
      float safe_det_t = ok_det_t ? det_t : 1.0f;
      float bt0 = k_t * jt + k_tp * jt_p + v_t;
      float bt1 = k_tp * jt + k_tpd * jt_p + v_t_p;
      float xt0 = (k_tpd * bt0 - k_tp * bt1) / safe_det_t;
      float xt1 = (k_t * bt1 - k_tp * bt0) / safe_det_t;
      float inv_c = safe_inv(k_t + k_tp);
      float jt_split = jt + v_t * inv_c;
      float k_tp_p = w.f(F_KTP, p);
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
      rel_vel_bwd(c, ux, uy, uw, 0.0f, g_vt, hx, hy, hw);
      rel_vel_bwd(p, ux, uy, uw, 0.0f, g_vt_p, hx, hy, hw);
      g(G_JT, c) = g_old;
      g(G_JT, p) = g_old_p;
    }
    add_h(gvx, gvy, gom);
  }

  // normal pass of velocity iteration it
  __device__ void normal_bwd(int it) {
    const Args& a = A.f;
    load(L.v, 2 * it, ux, uy, uw);
    clear_h();
    for (int c = 0; c < a.C; ++c) {
      int p = a.partner[c];
      bool blk = w.blockable(c, p);
      if (blk && p < c) continue;
      float jn = it > 0 ? jn_t(it - 1, c) : 0.0f;
      float jn_new = jn_t(it, c);
      float g_djn, g_djt;
      scatter_bwd(c, jn_new - jn, 0.0f, gvx, gvy, gom, g_djn, g_djt);
      float G = g(G_JN, c) + g_djn;
      float g_old = -g_djn;
      float v_n, v_t;
      w.rel_vel(c, ux, uy, uw, v_n, v_t);
      float rhs = v_n + w.f(F_TARGET, c);
      float k_n = w.f(F_KN, c);
      float inv_kn = safe_inv(k_n);
      if (!blk) {
        float x = jn + rhs * inv_kn;
        if (w.act(c) && !(x < 0.0f)) {  // jn_new = max(x, 0)
          float gx, g0;
          max_bwd(x, 0.0f, G, gx, g0);
          g_old += gx;
          float g_rhs = gx * inv_kn;
          inv_bwd(k_n, inv_kn, gx * rhs, g(G_KN, c));
          g(G_TARGET, c) += g_rhs;
          rel_vel_bwd(c, ux, uy, uw, g_rhs, 0.0f, hx, hy, hw);
        }
        g(G_JN, c) = g_old;
        continue;
      }
      float jn_p = it > 0 ? jn_t(it - 1, p) : 0.0f;
      float jn_new_p = jn_t(it, p);
      float g_djn_p, g_djt_p;
      scatter_bwd(p, jn_new_p - jn_p, 0.0f, gvx, gvy, gom, g_djn_p, g_djt_p);
      float G_p = g(G_JN, p) + g_djn_p;
      float g_old_p = -g_djn_p;
      float v_n_p, v_t_p;
      w.rel_vel(p, ux, uy, uw, v_n_p, v_t_p);
      float rhs_p = v_n_p + w.f(F_TARGET, p);
      float k_p = w.f(F_KN, p);
      float k_np = w.f(F_KNP, c);
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
      rel_vel_bwd(c, ux, uy, uw, g_b0, 0.0f, hx, hy, hw);
      rel_vel_bwd(p, ux, uy, uw, g_b1, 0.0f, hx, hy, hw);
      g(G_JN, c) = g_old;
      g(G_JN, p) = g_old_p;
    }
    add_h(gvx, gvy, gom);
  }

  // the setup: cotangents into v (gvx, gvy, gom), p (gqx, gqy), pen and pt
  __device__ void setup_bwd() {
    const Args& a = A.f;
    const size_t B = a.B;
    const bool split = a.position_iterations > 0;
    // coupling terms k_np, k_tp of manifold pairs: both lanes' lever arms
    for (int c = 0; c < a.C; ++c) {
      int p = a.partner[c];
      if (p < 0) continue;
      float gknp = g(G_KNP, c), gktp = g(G_KTP, c);
      float nx = w.f(F_NX, c), ny = w.f(F_NY, c);
      float rax = w.f(F_RAX, c), ray = w.f(F_RAY, c);
      float rbx = w.f(F_RBX, c), rby = w.f(F_RBY, c);
      float pnx = w.f(F_NX, p), pny = w.f(F_NY, p);
      float prax = w.f(F_RAX, p), pray = w.f(F_RAY, p);
      float prbx = w.f(F_RBX, p), prby = w.f(F_RBY, p);
      float ran = rax * ny - ray * nx, rbn = rbx * ny - rby * nx;
      float rat = rax * nx + ray * ny, rbt = rbx * nx + rby * ny;
      float ran_p = prax * pny - pray * pnx, rbn_p = prbx * pny - prby * pnx;
      float rat_p = prax * pnx + pray * pny, rbt_p = prbx * pnx + prby * pny;
      float ii_a = w.lc(R_II_A, c), ii_b = w.lc(R_II_B, c);
      arm_bwd(c, gknp * ran_p * ii_a, gknp * rbn_p * ii_b,
              gktp * rat_p * ii_a, gktp * rbt_p * ii_b);
      arm_bwd(p, gknp * (ii_a * ran), gknp * (ii_b * rbn),
              gktp * (ii_a * rat), gktp * (ii_b * rbt));
    }
    for (int c = 0; c < a.C; ++c) {
      int ia = a.body_a[c], ib = a.body_b[c];
      bool on = w.act(c);
      float g_target = g(G_TARGET, c);
      float g_bias = on ? g(G_BIAS, c) + (split ? 0.0f : g_target) : 0.0f;
      // restitution target e * max(v_n0, 0) where v_n0 > 0
      if (on) {
        float v_n0, v_t0;
        w.rel_vel(c, ux, uy, uw, v_n0, v_t0);
        if (v_n0 > 0.0f) {
          rel_vel_bwd(c, ux, uy, uw, g_target * w.lc(R_E, c), 0.0f, gvx, gvy, gom);
        }
      }
      // effective masses k_n, k_t
      float nx = w.f(F_NX, c), ny = w.f(F_NY, c);
      float rax = w.f(F_RAX, c), ray = w.f(F_RAY, c);
      float rbx = w.f(F_RBX, c), rby = w.f(F_RBY, c);
      float ran = rax * ny - ray * nx, rbn = rbx * ny - rby * nx;
      float rat = rax * nx + ray * ny, rbt = rbx * nx + rby * ny;
      float ii_a = w.lc(R_II_A, c), ii_b = w.lc(R_II_B, c);
      float gkn = g(G_KN, c), gkt = g(G_KT, c);
      arm_bwd(c, 2.0f * (gkn * ran * ii_a), 2.0f * (gkn * rbn * ii_b),
              2.0f * (gkt * rat * ii_a), 2.0f * (gkt * rbt * ii_b));
      // lever arms r = pt - p
      float grax = g(G_RAX, c), gray = g(G_RAY, c);
      float grbx = g(G_RBX, c), grby = g(G_RBY, c);
      A.dpt_x[c * B + b] = grax + grbx;
      A.dpt_y[c * B + b] = gray + grby;
      gqx[ia] -= grax;
      gqy[ia] -= gray;
      gqx[ib] -= grbx;
      gqy[ib] -= grby;
      // the Baumgarte bias through the depth, and the normal
      float pen_x = a.pen_x[c * B + b], pen_y = a.pen_y[c * B + b];
      float d2 = pen_x * pen_x + pen_y * pen_y;
      float inv_d = rsqrtf(d2 <= 0.0f ? 1.0f : d2);
      float depth = d2 * inv_d;
      float g_floor;
      if (a.has_max_bias) {  // bias = min(bias, max_bias)
        float bias = a.baumgarte * maxp(depth - a.slop, 0.0f) / a.baumgarte_dt;
        min_bwd(bias, a.max_bias, g_bias, g_bias, g_floor);
      }
      // bias = baumgarte * max(depth - slop, 0) / baumgarte_dt
      float g_depth;
      max_bwd(depth - a.slop, 0.0f, g_bias / a.baumgarte_dt * a.baumgarte,
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
      A.dpen_x[c * B + b] = dpen_x;
      A.dpen_y[c * B + b] = dpen_y;
    }
  }

  // the whole walk: the recompute with its tape, then every pass back.  The
  // cotangents of the input body planes are then gqx, gqy, gvx, gvy, gqa,
  // gom; those of the contact planes are in A.dpen_x ... A.dpt_y
  __device__ void run() {
    const Args& a = A.f;
    const size_t B = a.B;
    forward();
    for (int c = 0; c < a.C; ++c) {
      for (int k = 0; k < NUM_G; ++k) g(k, c) = 0.0f;
    }
    for (int i = 0; i < a.n; ++i) {
      gvx[i] = A.gvx[i * B + b];
      gvy[i] = A.gvy[i * B + b];
      gom[i] = A.gom[i * B + b];
      gqx[i] = A.gpx[i * B + b];
      gqy[i] = A.gpy[i * B + b];
      gqa[i] = A.gang[i * B + b];
    }
    joints_bwd();
    // q = p + pv * dt: gq is now the cotangent of p as well
    if (a.position_iterations > 0) {
      for (int i = 0; i < a.n; ++i) {
        gpx[i] = gqx[i] * a.dt;
        gpy[i] = gqy[i] * a.dt;
        gpw[i] = gqa[i] * a.dt;
      }
      for (int k = a.position_iterations - 1; k >= 0; --k) position_bwd(k);
    }
    for (int it = a.iterations - 1; it >= 0; --it) {
      friction_bwd(it);
      normal_bwd(it);
    }
    load(L.v, 0, ux, uy, uw);
    setup_bwd();
  }

  // the cotangents of the six input body planes, into A.d*
  __device__ void store() {
    const size_t B = A.f.B;
    for (int i = 0; i < A.f.n; ++i) {
      A.dpx[i * B + b] = gqx[i];
      A.dpy[i * B + b] = gqy[i];
      A.dvx[i * B + b] = gvx[i];
      A.dvy[i * B + b] = gvy[i];
      A.dang[i * B + b] = gqa[i];
      A.dom[i * B + b] = gom[i];
    }
  }
};

}  // namespace
