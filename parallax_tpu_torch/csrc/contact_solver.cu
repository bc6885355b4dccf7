// Contact solve with fused spring-damper joints, one CUDA thread per world.
//
// Replaces parallax_tpu/ops/pallas_solver.py:_solver_kernel (the math of
// solve_arrays plus apply_joint_rows) on NVIDIA Hopper (sm_90a).  It
// computes what engine/batched.py:solve_contacts_bm followed by
// apply_joints_bm compute, lane for lane:
//
//   * contact normals and tangents, effective masses, restitution targets;
//   * `iterations` Jacobi velocity passes: every lane's new impulse comes
//     from one velocity snapshot, then the summed deltas move the bodies.
//     A manifold lane pair whose lanes are both active solves a 2x2 block
//     LCP for its normal impulses (case enumeration with a determinant
//     guard) and a coupled 2x2 system for friction (least-norm split when
//     singular), then the Coulomb clamp;
//   * `position_iterations` split-impulse passes on pseudo-velocities that
//     start at zero, integrated into the positions;
//   * the joints, in joint order (Gauss-Seidel), on the corrected poses.
//
// The TPU kernel reached bodies through one-hot matmuls on the MXU, with
// split bf16 dots to keep them exact.  Here each thread indexes its bodies
// directly through body_a, body_b and partner.
//
// What bounds it: at the lander's shapes (C=48 lanes, n=4 bodies, B=8192
// worlds) a call reads 5 [C,B] contact planes and 6 [n,B] body planes and
// writes 6 [n,B] planes, about 8 MB, plus the per-lane solver state kept
// in a wrapper-allocated scratch [NUM_FIELDS, C, B] (24 MB, read and
// written once per pass, mostly from L2).  The arithmetic is small.  The
// design is the simple one: one thread per world (8192 threads are 64
// blocks of 128, half of the card's 132 SMs with one block each), body
// planes and lanes addressed [row * B + b] so that neighbouring threads
// touch neighbouring addresses, and body velocities in per-thread arrays.
// Spreading a world's lanes over a warp is later work.
//
// C, n and J are runtime values, so the same kernel serves any world with
// at most MAX_BODIES bodies.  Build without --use_fast_math and with
// --fmad=false: the plain torch version rounds every product and sum on
// its own, and so does this kernel.  The passes and the whole
// per-world solve (solve_world) live in contact_solver.cuh, which the
// reverse pass (contact_solver_bwd.cu) and the fused step (fused_step.cu)
// share.

#include "contact_solver.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
contact_solve_kernel(const Args args) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= args.B) return;
  solve_world(args, b);
}

}  // namespace

extern "C" int contact_solver_num_fields() { return NUM_FIELDS; }
extern "C" int contact_solver_max_bodies() { return MAX_BODIES; }

// Launches the solve on `stream` and returns cudaGetLastError().  All
// planes are float32, row-major and contiguous: contact planes [C, B]
// (active as uint8), body planes [n, B]; scratch is [NUM_FIELDS, C, B].
extern "C" int contact_solve_fwd(
    const float* pen_x, const float* pen_y, const float* pt_x,
    const float* pt_y, const uint8_t* active,
    const float* px, const float* py, const float* vx, const float* vy,
    const float* ang, const float* om,
    float* opx, float* opy, float* ovx, float* ovy, float* oang, float* oom,
    const int32_t* body_a, const int32_t* body_b, const int32_t* partner,
    const float* lane_const, const int32_t* movable,
    const float* body_im, const float* body_ii,
    const int32_t* joint_body, const float* joint_f,
    float* scratch,
    int B, int C, int n, int J, int iterations, int position_iterations,
    float dt, float baumgarte, float slop, float baumgarte_dt,
    float max_bias, int has_max_bias, void* stream) {
  if (n > MAX_BODIES || B <= 0) return (int)cudaErrorInvalidValue;
  Args args{pen_x, pen_y, pt_x, pt_y, active,
            px, py, vx, vy, ang, om,
            opx, opy, ovx, ovy, oang, oom,
            body_a, body_b, partner, lane_const, movable,
            body_im, body_ii, joint_body, joint_f, scratch,
            B, C, n, J, iterations, position_iterations,
            dt, baumgarte, slop, baumgarte_dt, max_bias, has_max_bias};
  const int blocks = (B + THREADS - 1) / THREADS;
  contact_solve_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
