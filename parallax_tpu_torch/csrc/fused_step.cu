// The whole physics step of a world, one CUDA thread per world.
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
//   * the contact solve and the joints: solve_world of contact_solver.cuh,
//     the solver kernel's own code, so on the same contact planes the two
//     agree to the bit.
//
// It writes the six body planes and the [C, B] active flags.  The contact
// geometry stays inside, as on the TPU (pallas_step.py:760-766): each pair
// writes its lanes' pen_x, pen_y, pt_x, pt_y into a wrapper-allocated
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
// neighbouring threads touch neighbouring addresses.  An analytic lane
// costs about 45 (cc), 60 (cb), 35 (area_cb) or 30 (bb) float32
// operations; billiards (28 cc and 32 cb pairs, C=60), RoboCup (21 cc, 42
// cb and 7 area_cb pairs, C=70) and the crate pile (3 cc, 33 cb and 52 bb
// pairs, C=88) spend most of their time in the solve.  Spreading a world's pairs
// over a warp is later work.
//
// Build without --use_fast_math and with --fmad=false, and keep the plain
// version's order of operations: the plain torch ops round every product
// and sum on their own, and call cosf, sinf and rsqrtf as this code does.
// Selections follow the plain version: the first minimum axis wins (o <
// best), a reference edge needs al > best, A is the reference when its
// score is >=, a circle-box, box-box or area face tie goes to the
// earliest side; min and max propagate NaN (maxp, minp).
//
// The integration, the vertices, the SAT and the analytic lanes live in
// fused_step.cuh, which the reverse pass (fused_step_bwd.cu) shares.

#include "fused_step.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const Args args, const StepArgs st) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= args.B) return;
  const size_t B = args.B;
  // integration and gravity, into the output planes the solve reads
  float qx[MAX_BODIES], qy[MAX_BODIES], qc[MAX_BODIES], qs[MAX_BODIES];
  integrate_world(args, st, b, qx, qy, qc, qs);
  float wx[MAX_PARTS * MAX_V], wy[MAX_PARTS * MAX_V];
  world_vertices(st, B, b, qx, qy, qc, qs, wx, wy);
  pair_geometry(st, args.C, B, b, wx, wy);
  solve_world(args, b);
}

}  // namespace

// Launches the step on `stream` and returns cudaGetLastError().  Body
// planes are float32 [n, B], the terrain planes [k * V, B], row-major and
// contiguous; active is uint8 [C, B]; geo is [4, C, B] and scratch
// [NUM_FIELDS, C, B]; pair_i is int32 [npairs, PAIR_COLS] and pair_f
// float32 [npairs, 2]; lanes is the lanes the pairs' kinds give, which must
// equal C.  The solver operands are contact_solve_fwd's.
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
    float* geo, float* scratch,
    int P, int npairs, int lanes, int V, int override_bits, int symplectic,
    float gdx, float gdy,
    int B, int C, int n, int J, int iterations, int position_iterations,
    float dt, float baumgarte, float slop, float baumgarte_dt,
    float max_bias, int has_max_bias, void* stream) {
  // lanes: what the pairs' kinds give, two a pp pair and one any other
  if (n > MAX_BODIES || P > MAX_PARTS || V > MAX_V || C != lanes ||
      lanes < npairs || lanes > 2 * npairs || B <= 0) {
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
  StepArgs st{px, py, vx, vy, ang, om, tx, ty, part_i, part_lv, pair_i, pair_f,
              geo, active, P, npairs, V, override_bits, symplectic,
              gdx, gdy};
  const int blocks = (B + THREADS - 1) / THREADS;
  fused_step_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(args, st);
  return (int)cudaGetLastError();
}
