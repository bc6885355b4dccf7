// The whole physics step of a world, one warp per world.
//
// Replaces parallax_tpu/ops/pallas_step.py:_step_kernel (l.473: the math
// of step_arrays, the SAT of _pp_manifold_arrays, the circle and box lanes
// of l.415-440 and the vertices of _world_verts_rows) on NVIDIA Hopper
// (sm_90a), for worlds whose pair groups are the JAX kernel's five kinds:
// polygon-polygon ("pp"), circle-circle ("cc"), circle-box ("cb"),
// box-box ("bb") and circle-in-area-box ("area_cb").
// Per world it computes what ops/fused_step.py:fused_step_plain computes,
// lane for lane:
//
//   * integration and gravity ("reference": integrate, then gravity;
//     "symplectic": the other order), gravity on movable bodies only;
//   * the world-frame vertices of every part, from its body's pose (boxes
//     translate without rotating), or read from the per-world terrain
//     planes for the parts the caller overrides; each part computes only
//     the rows its groups read (a circle's centre, a box's lb and ub);
//   * per polygon pair the SAT best axis and the reference-face clip, two
//     contact lanes per pair, point-minor; a pair with no valid axis (a
//     world with NaN vertices) is inactive, as in the TPU kernel
//     (pallas_step.py:251);
//   * per circle or box pair one lane with no partner: _cc_bm's,
//     _cb_bm's, _bb_bm's or _area_cb_bm's arithmetic (CcLane, CbLane,
//     BbLane, AreaCbLane), with the pair's radii, dispatched on the pair's
//     kind;
//   * every pair writes from its first lane on, which the host takes from
//     the pair table (groups concatenate in table order), so the solver's
//     partner table lines up;
//   * the contact solve and the joints: the solver walk of
//     solver_walk.cuh (Walk<false>), the solver kernel's own code, so on
//     the same contact planes the two agree to the bit.
//
// It writes the six body planes and the [C, B] active flags.  The contact
// geometry stays inside, as on the TPU (pallas_step.py:760-766).
//
// What bounds it: at the lander's shapes (24 pairs, C=48 lanes, n=4
// bodies, B=8192 worlds) a call reads the six [n,B] body planes and 28
// terrain rows of x and y and writes six [n,B] planes and the flags, about
// 3 MB, 1 us at 3.35 TB/s; the SAT does about 750 float32 operations a
// pair whether or not it touches, about 150 M a call, 2.2 us at 67
// TFLOP/s, so operations bound it.  An analytic lane costs about 45 (cc),
// 60 (cb), 35 (area_cb) or 30 (bb) float32 operations; billiards (28 cc
// and 32 cb pairs, C=60), RoboCup (21 cc, 42 cb and 7 area_cb pairs, C=70)
// and the crate pile (3 cc, 33 cb and 52 bb pairs, C=88) spend most of
// their time in the solve, a chain of dependent passes that latency
// bounds.  The design spreads both phases over a warp: one warp per world,
// W worlds a block (the wrapper's plan, at most 8).  First
// (integrate_and_collide, fused_step.cuh, which the reverse pass runs too)
// the bodies over the warp's threads, then the parts (their vertices), then
// the pairs (their lanes); the integrated state, the vertices, the lanes'
// pen/pt [4, C] and flags sit in the world's dynamic shared memory.  The
// lane threads write the flags out.  Then the solver walk solves on those
// planes and the integrated state, with the lane fields and impulses in
// shared memory too ([NUM_FIELDS, C]) where at least 4 worlds a block still
// fit with them, else in the wrapper's world-major scratch [B, NUM_FIELDS *
// C], as the solve kernel keeps them (the wrapper decides: billiards48, 52
// parts and C=1320, takes about 150 KB a world with them and 71 KB
// without), and the body threads write the six planes.  Per-body sums are taken in lane order, so every
// launch and every plan gives the same bits.
//
// Build without --use_fast_math and with --fmad=false, and keep the plain
// version's order of operations: the plain torch ops round every product
// and sum on their own, and call cosf, sinf and rsqrtf as this code does.
// Selections follow the plain version: the first minimum axis wins (o <
// best), a reference edge needs al > best, A is the reference when its
// score is >=, a circle-box, box-box or area face tie goes to the
// earliest side; min and max propagate NaN (maxp, minp).

#include "fused_step.cuh"

namespace {

// Offsets in one world's shared memory, in words of sizeof(float): the
// state both fused kernels keep (StepSmem), then the forward's contact
// planes and the solver walk's lane fields.
struct FwdSmem {
  int state, qc, qs, wx, wy, geo, flags, fields, words;
  __host__ __device__ FwdSmem(int C, int n, int P, bool fields_in_smem) {
    const StepSmem m(C, n, P);
    state = m.state;
    qc = m.qc;
    qs = m.qs;
    wx = m.wx;
    wy = m.wy;
    int r = m.words;
    geo = r;  // the lanes' pen_x, pen_y, pt_x, pt_y [4, C]
    r += 4 * C;
    flags = r;  // their active flags, uint8 [C]
    r += byte_words(C);
    fields = r;  // the walk's lane fields and impulses [NUM_FIELDS, C]
    if (fields_in_smem) r += NUM_FIELDS * C;
    words = r;
  }
};

// One instantiation a plan, each with at least 3 blocks an SM (at most 85
// registers): ptxas gives the shared-memory one 80 registers and no spill,
// as before the scratch plan existed, and the scratch one 80 and 16 bytes
// spilled.  One kernel with a run-time choice of pointer took 104
// registers (2 blocks an SM); without the minimum ptxas gave the two
// instantiations 64 and 80 registers with spills, with a minimum of 1 or 2
// 92 and 108 (sm_90a, -Xptxas -v).
template <bool kFieldsInSmem>
__global__ void __launch_bounds__(LANES * MAX_WORLDS_PER_BLOCK, 3)
fused_step_kernel(const SolveOps o, const StepArgs st, const BodyOut out,
                  uint8_t* active, float* scratch, int B, int W) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int b = blockIdx.x * W + warp;
  if (b >= B) return;
  const size_t Bs = B;
  const int C = o.C, n = o.n;
  const FwdSmem M(C, n, st.P, kFieldsInSmem);
  float* s = smem + warp * M.words;
  float* fields = kFieldsInSmem ? s + M.fields
                                : scratch + (size_t)b * NUM_FIELDS * C;
  float* state = s + M.state;
  float* geo = s + M.geo;
  uint8_t* flags = reinterpret_cast<uint8_t*>(s + M.flags);
  integrate_and_collide(st, o.movable, o.dt, n, C, Bs, b, lane, state,
                        s + M.qc, s + M.qs, s + M.wx, s + M.wy, geo, flags);
  for (int c = lane; c < C; c += LANES) active[c * Bs + b] = flags[c];
  const WorldIO io{
      Rows{geo, 1}, Rows{geo + C, 1}, Rows{geo + 2 * C, 1},
      Rows{geo + 3 * C, 1},
      flags, 1,
      Rows{state, 1}, Rows{state + n, 1}, Rows{state + 2 * n, 1},
      Rows{state + 3 * n, 1}, Rows{state + 4 * n, 1}, Rows{state + 5 * n, 1}};
  Walk<false> w(o, io, fields, s, lane);
  w.solve();
  w.write(out, Bs, b);
}

}  // namespace

// Bytes of dynamic shared memory one world of the step takes, with its
// lane fields (fields_in_smem 1) or without (0).
extern "C" int fused_step_fwd_smem_bytes(int C, int n, int P,
                                         int fields_in_smem) {
  return FwdSmem(C, n, P, fields_in_smem != 0).words * (int)sizeof(float);
}

// Launches the step on `stream` and returns cudaGetLastError().  Body
// planes are float32 [n, B], the terrain planes [k * V, B], row-major and
// contiguous; active is uint8 [C, B]; pair_i is int32 [npairs, PAIR_COLS]
// and pair_f float32 [npairs, 2]; lanes is the lanes the pairs' kinds give,
// which must equal C.  The solver operands and body_lanes are
// contact_solve_fwd's; scratch is [B, NUM_FIELDS * C] where fields_in_smem
// is 0, else unused; worlds_per_block (1 to 8) worlds share a block, one
// warp each.
extern "C" int fused_step_fwd(
    const float* px, const float* py, const float* vx, const float* vy,
    const float* ang, const float* om, const float* tx, const float* ty,
    float* opx, float* opy, float* ovx, float* ovy, float* oang, float* oom,
    uint8_t* active,
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
    float max_bias, int has_max_bias, int fields_in_smem,
    int worlds_per_block, void* stream) {
  const int W = worlds_per_block;
  const size_t smem =
      (size_t)W * FwdSmem(C, n, P, fields_in_smem != 0).words * sizeof(float);
  // lanes: what the pairs' kinds give, two a pp pair and one any other
  if (V > MAX_V || C != lanes || lanes < npairs || lanes > 2 * npairs ||
      B <= 0 || W < 1 || W > MAX_WORLDS_PER_BLOCK || smem > SMEM_LIMIT ||
      (!fields_in_smem && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = fields_in_smem ? fused_step_kernel<true>
                                     : fused_step_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const SolveOps ops{body_a, body_b, partner, lane_const, movable,
                     body_im, body_ii, joint_body, joint_f, body_lanes,
                     C, n, J, iterations, position_iterations,
                     dt, baumgarte, slop, baumgarte_dt, max_bias, has_max_bias};
  const StepArgs st{px, py, vx, vy, ang, om, tx, ty, part_i, part_lv, pair_i,
                    pair_f, P, npairs, V, symplectic, gdx, gdy};
  const BodyOut out{opx, opy, ovx, ovy, oang, oom};
  const int blocks = (B + W - 1) / W, threads = W * LANES;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(ops, st, out, active,
                                                         scratch, B, W);
  return (int)cudaGetLastError();
}
