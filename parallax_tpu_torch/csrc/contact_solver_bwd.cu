// Reverse pass of the contact solve with fused joints, one CUDA thread per
// world.
//
// Replaces parallax_tpu/ops/pallas_solver.py:_solver_bwd_kernel on NVIDIA
// Hopper (sm_90a).  Given the solve's primal inputs and the cotangents of
// its six output body planes, it returns the cotangents of the six input
// body planes and of the contact planes pen_x, pen_y, pt_x, pt_y: the VJP
// of contact_solve_fwd (contact_solver.cu), which is the VJP of
// engine/batched.py:solve_contacts_bm followed by apply_joints_bm.  The
// contact mask `active` takes no cotangent.
//
// The Pallas kernel took this VJP from jax.vjp inside the kernel.  CUDA has
// no autodiff, so the reverse pass is written out by hand, and it follows
// torch's autograd of the plain version rule for rule: every clamp of the
// plain version is torch.maximum/minimum against a constant (jnp.maximum,
// jnp.minimum and jnp.clip in the JAX package), which splits the cotangent
// half and half at a tie and passes it whole to a NaN operand; a `where`
// passes nothing into the branch it did not take, and a masked (inactive)
// lane takes nothing.
//
// Design: (a) each thread recomputes its world's forward from the primal
// inputs with the forward kernel's own passes (contact_solver.cuh), and
// keeps a tape in the wrapper-allocated scratch: the per-lane setup
// fields, the normal, friction and position impulses after every pass,
// and the body velocities before every pass.  (b) It then walks the passes
// in reverse: the joints, last joint first (each recomputes the
// velocities it saw from the tape); q = p + pv * dt; the position passes;
// for each velocity iteration, last first, the friction pass and then the
// normal pass; and finally the setup, which routes the accumulated
// per-lane cotangents into pen (through rsqrt, the depth and the
// Baumgarte bias), pt and p (through the lever arms and the effective
// masses) and v (through the restitution target).  In a Jacobi pass every
// lane reads one velocity snapshot and the summed impulse deltas move the
// bodies, so the adjoint of the scatter is a gather of the output-velocity
// cotangents per lane, and the adjoint of rel_vel a scatter-add into
// per-thread body arrays that join the identity path after the pass.  A
// 2x2 manifold block is reversed at its lead lane, where the forward
// solved it: the non-lead lane's impulse cotangent flows into the lead's
// block solution, along the branch (full, clamp of one lane, or none) that
// the recomputed forward took.
//
// What bounds it: at the lander's shapes (C=48, n=4, B=8192) a call reads
// 5 [C,B] contact planes and 12 [n,B] body planes (inputs and output
// cotangents) and writes 6 [n,B] and 4 [C,B] planes, about 15 MB; the
// tape, about 1,900 rows of B floats (63 MB), is written once and read
// about twice, mostly from L2.  The arithmetic, the forward's plus about
// twice as much again, is small.  As in the forward, 8192 threads are 64
// blocks of 128; spreading a world's lanes over a warp is later work.
//
// The tape's layout and the walk (Reverse) live in contact_solver_bwd.cuh,
// which the fused step's reverse pass (fused_step_bwd.cu) shares.

#include "contact_solver_bwd.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
contact_solve_bwd_kernel(const BwdArgs args) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= args.f.B) return;
  World w(args.f, b);
  Reverse r(args, w);
  r.run();
  r.store();
}

}  // namespace

// Rows of B floats the reverse pass needs as scratch.
extern "C" int contact_solver_bwd_scratch_rows(int C, int n, int iterations,
                                               int position_iterations) {
  return (int)Layout(C, n, iterations, position_iterations).rows;
}

// Launches the reverse pass on `stream` and returns cudaGetLastError().
// Planes as in contact_solve_fwd; g* are the cotangents of its six
// outputs, d* receive those of its inputs; scratch is
// [contact_solver_bwd_scratch_rows(...), B].
extern "C" int contact_solve_bwd(
    const float* pen_x, const float* pen_y, const float* pt_x,
    const float* pt_y, const uint8_t* active,
    const float* px, const float* py, const float* vx, const float* vy,
    const float* ang, const float* om,
    const float* gpx, const float* gpy, const float* gvx, const float* gvy,
    const float* gang, const float* gom,
    float* dpx, float* dpy, float* dvx, float* dvy, float* dang, float* dom,
    float* dpen_x, float* dpen_y, float* dpt_x, float* dpt_y,
    const int32_t* body_a, const int32_t* body_b, const int32_t* partner,
    const float* lane_const, const int32_t* movable,
    const float* body_im, const float* body_ii,
    const int32_t* joint_body, const float* joint_f,
    float* scratch,
    int B, int C, int n, int J, int iterations, int position_iterations,
    float dt, float baumgarte, float slop, float baumgarte_dt,
    float max_bias, int has_max_bias, void* stream) {
  if (n > MAX_BODIES || B <= 0) return (int)cudaErrorInvalidValue;
  BwdArgs args{
      Args{pen_x, pen_y, pt_x, pt_y, active,
           px, py, vx, vy, ang, om,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           body_a, body_b, partner, lane_const, movable,
           body_im, body_ii, joint_body, joint_f, scratch,
           B, C, n, J, iterations, position_iterations,
           dt, baumgarte, slop, baumgarte_dt, max_bias, has_max_bias},
      gpx, gpy, gvx, gvy, gang, gom,
      dpx, dpy, dvx, dvy, dang, dom,
      dpen_x, dpen_y, dpt_x, dpt_y};
  const int blocks = (B + THREADS - 1) / THREADS;
  contact_solve_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
