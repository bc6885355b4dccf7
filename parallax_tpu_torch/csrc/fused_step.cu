// The whole physics step of a world of polygon parts, one CUDA thread per
// world.
//
// Replaces parallax_tpu/ops/pallas_step.py:_step_kernel (l.473: the math
// of step_arrays, the SAT of _pp_manifold_arrays and the vertices of
// _world_verts_rows) on NVIDIA Hopper (sm_90a), for worlds whose pair
// groups are all polygon-polygon ("pp"); the JAX kernel's circle and box
// lanes are not ported yet.  Per world it computes what
// ops/fused_step.py:fused_step_plain computes, lane for lane:
//
//   * integration and gravity ("reference": integrate, then gravity;
//     "symplectic": the other order), gravity on movable bodies only;
//   * the world-frame vertices of every part, from its body's pose (boxes
//     translate without rotating), or read from the per-world terrain
//     planes for the parts the caller overrides;
//   * per polygon pair the SAT best axis and the reference-face clip, two
//     contact lanes per pair, pair-major and point-minor in the pair
//     table's order (the solver's partner table depends on it).  A pair
//     with no valid axis (a world with NaN vertices) is inactive, as in
//     the TPU kernel (pallas_step.py:251);
//   * the contact solve and the joints: solve_world of contact_solver.cuh,
//     the solver kernel's own code, so on the same contact planes the two
//     agree to the bit.
//
// It writes the six body planes and the [C, B] active flags.  The contact
// geometry stays inside, as on the TPU (pallas_step.py:760-766): each pair
// writes its two lanes' pen_x, pen_y, pt_x, pt_y into a wrapper-allocated
// scratch [4, C, B] as it is found, and the solve reads them from there.
// The integrated state goes straight into the output planes, which the
// solve then reads as its input (solve_world allows it).
//
// What bounds it: at the lander's shapes (24 pairs, C=48 lanes, n=4
// bodies, B=8192 worlds) a call reads the six [n,B] body planes and 28
// terrain rows of x and y and writes six [n,B] planes and the flags, about
// 3 MB, 1 us at 3.35 TB/s; the SAT does about 750 float32 operations a
// pair whether or not it touches, about 150 M a call, 2.2 us at 67
// TFLOP/s, so operations bound it.  The design is the simple one: one
// thread per world (64 blocks of 128 threads at B=8192, half the SMs), the
// world's vertices in per-thread arrays, each pair's axes in per-thread
// arrays, body planes and lanes addressed [row * B + b] so that
// neighbouring threads touch neighbouring addresses.  Spreading a world's
// pairs over a warp is later work.
//
// Build without --use_fast_math and with --fmad=false, and keep the plain
// version's order of operations: the plain torch ops round every product
// and sum on their own, and call cosf, sinf and rsqrtf as this code does.
// Selections follow the plain version: the first minimum axis wins (o <
// best), a reference edge needs al > best, A is the reference when its
// score is >=; min and max propagate NaN (maxp, minp).

#include <math.h>

#include "contact_solver.cuh"

namespace {

constexpr int MAX_PARTS = 16;
constexpr int MAX_V = 8;  // geometry/shapes.py MAX_VERTS
constexpr int MAX_AXES = 2 * MAX_V;

// columns of part_i [P, PART_COLS] and pair_i [npairs, PAIR_COLS]
enum PartCol { P_BODY, P_ROTATE, P_NV, PART_COLS };
enum PairCol { Q_A, Q_B, Q_VA, Q_VB, Q_MASK_A, Q_MASK_B, PAIR_COLS };

struct StepArgs {
  const float *px, *py, *vx, *vy, *ang, *om;  // [n, B] before the step
  const float *tx, *ty;  // [k * V, B]: the k-th overridden part's rows
  const int32_t* part_i;  // owning body, rotates (0/1), vertices in use
  const float* part_lv;  // [P, V, 2] local vertices, repeat-padded
  const int32_t* pair_i;  // parts a, b; trimmed Va, Vb; edge-mask bits
  float* geo;  // [4, C, B] scratch: pen_x, pen_y, pt_x, pt_y
  uint8_t* active;  // [C, B] output
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

// the edge of a polygon whose outward normal best aligns with (dx, dy)
__device__ void best_edge(const float* NX, const float* NY, const bool* OK,
                          const float* wx, const float* wy, int V, float dx,
                          float dy, float& bestv, float& r0x, float& r0y,
                          float& r1x, float& r1y) {
  bestv = -INFINITY;
  r0x = r0y = r1x = r1y = 0.0f;
  for (int v = 0; v < V; ++v) {
    const float al = OK[v] ? NX[v] * dx + NY[v] * dy : -INFINITY;
    if (al > bestv) {
      const int j = v + 1 < V ? v + 1 : 0;
      bestv = al;
      r0x = wx[v];
      r0y = wy[v];
      r1x = wx[j];
      r1y = wy[j];
    }
  }
}

// clip the segment p0-p1 to the side d . (p - an) >= 0
__device__ void clip(float& p0x, float& p0y, float& p1x, float& p1y,
                     float anx, float any, float dx, float dy) {
  const float d0 = (p0x - anx) * dx + (p0y - any) * dy;
  const float d1 = (p1x - anx) * dx + (p1y - any) * dy;
  const float denom = d0 - d1;
  const float frac = d0 / (denom == 0.0f ? 1.0f : denom);
  const float inx = p0x + frac * (p1x - p0x);
  const float iny = p0y + frac * (p1y - p0y);
  const bool cut0 = d0 < 0.0f && d1 >= 0.0f;
  const bool cut1 = d1 < 0.0f && d0 >= 0.0f;
  if (cut0) {
    p0x = inx;
    p0y = iny;
  }
  if (cut1) {
    p1x = inx;
    p1y = iny;
  }
}

// SAT + reference-face clip of polygon A against polygon B: lanes l, l+1
__device__ void pp_pair(const StepArgs& st, const float* ax, const float* ay,
                        int Va, int ma, const float* bx, const float* by,
                        int Vb, int mb, int l, int C, size_t B, int b) {
  float NX[MAX_AXES], NY[MAX_AXES];
  bool OK[MAX_AXES];
  edge_axes(ax, ay, Va, ma, NX, NY, OK, 0);
  edge_axes(bx, by, Vb, mb, NX, NY, OK, Va);

  float best = INFINITY, bnx = 0.0f, bny = 0.0f, bsign = 1.0f;
  for (int a = 0; a < Va + Vb; ++a) {
    float mna, mxa, mnb, mxb;
    project(NX[a], NY[a], ax, ay, Va, mna, mxa);
    project(NX[a], NY[a], bx, by, Vb, mnb, mxb);
    const float o_pos = mxb - mna;  // push A along +axis
    const float o_neg = mxa - mnb;  // push A along -axis
    const float ovl = OK[a] ? minp(o_pos, o_neg) : INFINITY;
    if (ovl < best) {
      best = ovl;
      bnx = NX[a];
      bny = NY[a];
      bsign = o_pos <= o_neg ? 1.0f : -1.0f;
    }
  }
  const bool active = best >= 0.0f && best < INFINITY;
  const float depth = maxp(best, 0.0f);
  const float n_x = bnx * bsign;  // MTV direction B -> A
  const float n_y = bny * bsign;

  float al_a, ar0x, ar0y, ar1x, ar1y, al_b, br0x, br0y, br1x, br1y;
  best_edge(NX, NY, OK, ax, ay, Va, -n_x, -n_y, al_a, ar0x, ar0y, ar1x, ar1y);
  best_edge(NX + Va, NY + Va, OK + Va, bx, by, Vb, n_x, n_y, al_b, br0x, br0y,
            br1x, br1y);
  const bool ref_is_a = al_a >= al_b;
  const float r0x = ref_is_a ? ar0x : br0x, r0y = ref_is_a ? ar0y : br0y;
  const float r1x = ref_is_a ? ar1x : br1x, r1y = ref_is_a ? ar1y : br1y;
  const float nrefx = ref_is_a ? -n_x : n_x, nrefy = ref_is_a ? -n_y : n_y;
  // the incident edge: the other polygon's candidate reference edge
  float c0x = ref_is_a ? br0x : ar0x, c0y = ref_is_a ? br0y : ar0y;
  float c1x = ref_is_a ? br1x : ar1x, c1y = ref_is_a ? br1y : ar1y;

  float tx = r1x - r0x, ty = r1y - r0y;
  const float tl2 = tx * tx + ty * ty;
  const float tl = rsqrtf(tl2 <= 0.0f ? 1.0f : tl2);
  tx = tx * tl;
  ty = ty * tl;
  clip(c0x, c0y, c1x, c1y, r0x, r0y, tx, ty);
  clip(c0x, c0y, c1x, c1y, r1x, r1y, -tx, -ty);

  const float d0 = -((c0x - r0x) * nrefx + (c0y - r0y) * nrefy);
  const float d1 = -((c1x - r0x) * nrefx + (c1y - r0y) * nrefy);
  const float keep_tol = maxp(depth, 1e-4f);
  const bool k0 = d0 >= -keep_tol;
  const bool k1 = d1 >= -keep_tol;
  const bool none_kept = !k0 && !k1;
  const bool a0 = active && (none_kept || k0);
  const bool a1 = active && !none_kept && k1;
  const float ld0 = none_kept ? depth : maxp(d0, 1e-6f);
  const float ld1 = none_kept ? depth : maxp(d1, 1e-6f);

  const size_t plane = (size_t)C * B;
  const size_t i0 = (size_t)l * B + b, i1 = i0 + B;
  st.geo[i0] = n_x * ld0 * (a0 ? 1.0f : 0.0f);
  st.geo[i1] = n_x * ld1 * (a1 ? 1.0f : 0.0f);
  st.geo[plane + i0] = n_y * ld0 * (a0 ? 1.0f : 0.0f);
  st.geo[plane + i1] = n_y * ld1 * (a1 ? 1.0f : 0.0f);
  st.geo[2 * plane + i0] = c0x;
  st.geo[2 * plane + i1] = c1x;
  st.geo[3 * plane + i0] = c0y;
  st.geo[3 * plane + i1] = c1y;
  st.active[i0] = a0;
  st.active[i1] = a1;
}

__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const Args args, const StepArgs st) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= args.B) return;
  const size_t B = args.B;

  // integration and gravity, into the output planes the solve reads
  float qx[MAX_BODIES], qy[MAX_BODIES], qc[MAX_BODIES], qs[MAX_BODIES];
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

  // world-frame vertices of every part
  float wx[MAX_PARTS * MAX_V], wy[MAX_PARTS * MAX_V];
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

  for (int q = 0; q < st.npairs; ++q) {
    const int32_t* qi = st.pair_i + q * PAIR_COLS;
    const int pa = qi[Q_A] * MAX_V, pb = qi[Q_B] * MAX_V;
    pp_pair(st, wx + pa, wy + pa, qi[Q_VA], qi[Q_MASK_A], wx + pb, wy + pb,
            qi[Q_VB], qi[Q_MASK_B], 2 * q, args.C, B, b);
  }

  solve_world(args, b);
}

}  // namespace

extern "C" int fused_step_max_parts() { return MAX_PARTS; }

// Launches the step on `stream` and returns cudaGetLastError().  Body
// planes are float32 [n, B], the terrain planes [k * V, B], row-major and
// contiguous; active is uint8 [C, B]; geo is [4, C, B] and scratch
// [NUM_FIELDS, C, B].  The solver operands are contact_solve_fwd's.
extern "C" int fused_step_fwd(
    const float* px, const float* py, const float* vx, const float* vy,
    const float* ang, const float* om, const float* tx, const float* ty,
    float* opx, float* opy, float* ovx, float* ovy, float* oang, float* oom,
    uint8_t* active,
    const int32_t* part_i, const float* part_lv, const int32_t* pair_i,
    const int32_t* body_a, const int32_t* body_b, const int32_t* partner,
    const float* lane_const, const int32_t* movable,
    const float* body_im, const float* body_ii,
    const int32_t* joint_body, const float* joint_f,
    float* geo, float* scratch,
    int P, int npairs, int V, int override_bits, int symplectic,
    float gdx, float gdy,
    int B, int C, int n, int J, int iterations, int position_iterations,
    float dt, float baumgarte, float slop, float baumgarte_dt,
    float max_bias, int has_max_bias, void* stream) {
  if (n > MAX_BODIES || P > MAX_PARTS || V > MAX_V || C != 2 * npairs ||
      B <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t plane = (size_t)C * B;
  // the solve reads the integrated state from the output planes
  Args args{geo, geo + plane, geo + 2 * plane, geo + 3 * plane, active,
            opx, opy, ovx, ovy, oang, oom,
            opx, opy, ovx, ovy, oang, oom,
            body_a, body_b, partner, lane_const, movable,
            body_im, body_ii, joint_body, joint_f, scratch,
            B, C, n, J, iterations, position_iterations,
            dt, baumgarte, slop, baumgarte_dt, max_bias, has_max_bias};
  StepArgs st{px, py, vx, vy, ang, om, tx, ty, part_i, part_lv, pair_i,
              geo, active, P, npairs, V, override_bits, symplectic,
              gdx, gdy};
  const int blocks = (B + THREADS - 1) / THREADS;
  fused_step_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(args, st);
  return (int)cudaGetLastError();
}
