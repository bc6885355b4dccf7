// Reverse pass of the contact solve with fused joints, one warp per world.
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
// The walk (Walk<true>, solver_walk.cuh): (a) the warp recomputes its
// world's forward from the primal inputs with the forward kernel's own
// code, and keeps a tape: the per-lane setup fields, the
// normal, friction and position impulses after every pass, and the body
// velocities before every pass.  (b) It then walks the passes in reverse:
// the joints, last joint first (each recomputes the velocities it saw from
// the tape); q = p + pv * dt; the position passes; for each velocity
// iteration, last first, the friction pass and then the normal pass; and
// finally the setup, which routes the accumulated per-lane cotangents into
// pen (through rsqrt, the depth and the Baumgarte bias), pt and p (through
// the lever arms and the effective masses) and v (through the restitution
// target).  In a Jacobi pass every lane reads one velocity snapshot and the
// summed impulse deltas move the bodies, so the adjoint of the scatter is
// a gather of the output-velocity cotangents per lane, and the adjoint of
// rel_vel a sum per body that joins the identity path after the pass.  A
// 2x2 manifold block is reversed at its lead lane, where the forward solved
// it: the non-lead lane's impulse cotangent flows into the lead's block
// solution, along the branch (full, clamp of one lane, or none) that the
// recomputed forward took.
//
// What bounds it: at the crate pile's shapes (C=88, n=14, 8 + 3 passes,
// B=8192) a call reads 5 [C,B] contact planes and 12 [n,B] body planes and
// writes 6 [n,B] and 4 [C,B] planes, about 32 MB, 10 us at 3.35 TB/s; its
// tape, 4,888 floats a world (160 MB), is written once and read about
// twice, 0.14 ms.  Neither bounds it: one world's walk is a chain of
// dependent passes, so latency does, and the design spreads it.  One warp
// walks one world, W worlds a block (the wrapper's plan, at most 8): each
// pass runs its lanes over the warp's threads (a 2x2 block at its lead
// lane; a pass's lanes read one velocity snapshot, so they are
// independent), then its bodies over the threads, each thread summing its
// bodies' lane terms from shared memory in lane order (the forward
// kernel's order, so the recompute is the forward's to the bit and every
// launch gives the same bits; no float atomics); the joints, Gauss-Seidel,
// run on one thread.  A world's body arrays (velocities, their cotangents,
// snapshots, poses) and each lane's terms of a pass live in dynamic
// shared memory sized by n and C (WorldSmem), none in per-thread arrays;
// the tape stays in the wrapper's scratch, world-major [B, rows], lane
// index fastest within a field, so a warp's accesses to it coalesce.
// Built, like the other sources, without fast math and with --fmad=false.

#include "solver_walk.cuh"

namespace {

// the solve's planes, row-major [rows, B]: primal inputs, the cotangents
// of its six outputs, and the cotangents it writes
struct BwdPlanes {
  const float *pen_x, *pen_y, *pt_x, *pt_y;
  const uint8_t* active;
  const float *px, *py, *vx, *vy, *ang, *om;
  const float *gpx, *gpy, *gvx, *gvy, *gang, *gom;
  float *dpx, *dpy, *dvx, *dvy, *dang, *dom;
  float *dpen_x, *dpen_y, *dpt_x, *dpt_y;
};

__global__ void __launch_bounds__(LANES * MAX_WORLDS_PER_BLOCK)
contact_solve_bwd_kernel(const SolveOps o, const BwdPlanes pl, float* scratch,
                         int rows, int B, int W) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / LANES;
  const int b = blockIdx.x * W + warp;
  if (b >= B) return;
  const size_t Bs = B;
  const WorldIO io{
      Rows{pl.pen_x + b, Bs}, Rows{pl.pen_y + b, Bs},
      Rows{pl.pt_x + b, Bs}, Rows{pl.pt_y + b, Bs},
      pl.active + b, Bs,
      Rows{pl.px + b, Bs}, Rows{pl.py + b, Bs}, Rows{pl.vx + b, Bs},
      Rows{pl.vy + b, Bs}, Rows{pl.ang + b, Bs}, Rows{pl.om + b, Bs},
      Rows{pl.gpx + b, Bs}, Rows{pl.gpy + b, Bs}, Rows{pl.gvx + b, Bs},
      Rows{pl.gvy + b, Bs}, Rows{pl.gang + b, Bs}, Rows{pl.gom + b, Bs},
      pl.dpen_x + b, pl.dpen_y + b, pl.dpt_x + b, pl.dpt_y + b, Bs};
  Walk<true> w(o, io, scratch + (size_t)b * rows,
         smem + warp * WorldSmem(o.C, o.n).words, threadIdx.x % LANES);
  w.run();
  // the cotangents of the six input body planes
  for (int i = w.lane; i < o.n; i += LANES) {
    const size_t k = i * Bs + b;
    pl.dpx[k] = w.body(S_GQX)[i];
    pl.dpy[k] = w.body(S_GQY)[i];
    pl.dvx[k] = w.body(S_GVX)[i];
    pl.dvy[k] = w.body(S_GVY)[i];
    pl.dang[k] = w.body(S_GQA)[i];
    pl.dom[k] = w.body(S_GOM)[i];
  }
}

}  // namespace

// Floats of scratch the reverse pass needs per world.
extern "C" int contact_solver_bwd_scratch_rows(int C, int n, int iterations,
                                               int position_iterations) {
  return Tape(C, n, iterations, position_iterations).rows;
}

// Bytes of dynamic shared memory one world of the reverse pass takes.
extern "C" int contact_solver_bwd_smem_bytes(int C, int n) {
  return WorldSmem(C, n).words * (int)sizeof(float);
}

// Launches the reverse pass on `stream` and returns cudaGetLastError().
// Planes as in contact_solve_fwd; g* are the cotangents of its six
// outputs, d* receive those of its inputs; body_lanes is the per-body lane
// list of SolveOps; scratch is [B, contact_solver_bwd_scratch_rows(...)];
// worlds_per_block (1 to 8) worlds share a block, one warp each.
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
    const int32_t* body_lanes, float* scratch,
    int B, int C, int n, int J, int iterations, int position_iterations,
    float dt, float baumgarte, float slop, float baumgarte_dt,
    float max_bias, int has_max_bias, int worlds_per_block, void* stream) {
  const int W = worlds_per_block;
  const size_t smem = (size_t)W * WorldSmem(C, n).words * sizeof(float);
  if (B <= 0 || W < 1 || W > MAX_WORLDS_PER_BLOCK ||
      smem > SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        contact_solve_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const SolveOps ops{body_a, body_b, partner, lane_const, movable,
                     body_im, body_ii, joint_body, joint_f, body_lanes,
                     C, n, J, iterations, position_iterations,
                     dt, baumgarte, slop, baumgarte_dt, max_bias, has_max_bias};
  const BwdPlanes planes{pen_x, pen_y, pt_x, pt_y, active,
                         px, py, vx, vy, ang, om,
                         gpx, gpy, gvx, gvy, gang, gom,
                         dpx, dpy, dvx, dvy, dang, dom,
                         dpen_x, dpen_y, dpt_x, dpt_y};
  const int rows = Tape(C, n, iterations, position_iterations).rows;
  const int blocks = (B + W - 1) / W, threads = W * LANES;
  contact_solve_bwd_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      ops, planes, scratch, rows, B, W);
  return (int)cudaGetLastError();
}
