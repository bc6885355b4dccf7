// Contact solve with fused spring-damper joints, one warp per world.
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
// split bf16 dots to keep them exact.  Here a world's lanes index their
// bodies directly through body_a, body_b and partner.
//
// What bounds it: at the crate pile's shapes (C=88 lanes, n=14 bodies, 8 +
// 3 passes, B=8192 worlds) a call reads 5 [C,B] contact planes and 6 [n,B]
// body planes and writes 6 [n,B] planes, about 18 MB, 5 us at 3.35 TB/s;
// its float32 operations, about 900 a touching lane, take less still.
// Neither bounds it: a world's solve is a chain of dependent passes, so
// latency does, and the design spreads each pass.  One warp walks one
// world, W worlds a block (the wrapper's plan, at most 8): the solver walk
// of solver_walk.cuh without a tape (Walk<false>), the reverse passes' own
// code.  Each pass runs its listed lanes over the warp's threads (a 2x2
// block at its lead lane; a pass's lanes read one velocity snapshot, so
// they are independent), then its bodies over the threads, each thread
// summing its bodies' lane terms from shared memory in lane order (so every
// launch and every plan gives the same bits; no float atomics); the
// joints, Gauss-Seidel, run on one thread.  A world's body rows, each
// lane's terms of a pass and its lane list sit in dynamic shared memory
// (WorldSmem); so do its lane fields and impulses, [NUM_FIELDS, C], where
// at least 4 worlds a block still fit with them (the wrapper decides),
// else they go to the wrapper's scratch, world-major [B, NUM_FIELDS * C],
// lane index fastest within a field (billiards48: 52 bodies, C=1320).
//
// C, n and J are runtime values, so the same kernel serves any world whose
// plan fits a block's shared memory.  Build without --use_fast_math and with
// --fmad=false: the plain torch version rounds every product and sum on
// its own, and so does this kernel.

#include "solver_walk.cuh"

namespace {

// the solve's planes, row-major: contact planes [C, B], body planes [n, B]
struct FwdPlanes {
  const float *pen_x, *pen_y, *pt_x, *pt_y;
  const uint8_t* active;
  const float *px, *py, *vx, *vy, *ang, *om;
};

// the words of shared memory a world takes, with or without its lane fields
__host__ __device__ inline int fwd_words(int C, int n, bool fields_in_smem) {
  return WorldSmem(C, n).words + (fields_in_smem ? NUM_FIELDS * C : 0);
}

__global__ void __launch_bounds__(LANES * MAX_WORLDS_PER_BLOCK)
contact_solve_kernel(const SolveOps o, const FwdPlanes pl, const BodyOut out,
                     float* scratch, int fields_in_smem, int B, int W) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / LANES;
  const int b = blockIdx.x * W + warp;
  if (b >= B) return;
  const size_t Bs = B;
  const int words = fwd_words(o.C, o.n, fields_in_smem);
  float* s = smem + warp * words;
  float* t = fields_in_smem ? s + WorldSmem(o.C, o.n).words
                            : scratch + (size_t)b * NUM_FIELDS * o.C;
  const WorldIO io{
      Rows{pl.pen_x + b, Bs}, Rows{pl.pen_y + b, Bs},
      Rows{pl.pt_x + b, Bs}, Rows{pl.pt_y + b, Bs},
      pl.active + b, Bs,
      Rows{pl.px + b, Bs}, Rows{pl.py + b, Bs}, Rows{pl.vx + b, Bs},
      Rows{pl.vy + b, Bs}, Rows{pl.ang + b, Bs}, Rows{pl.om + b, Bs}};
  Walk<false> w(o, io, t, s, threadIdx.x % LANES);
  w.solve();
  w.write(out, Bs, b);
}

}  // namespace

extern "C" int contact_solver_num_fields() { return NUM_FIELDS; }

// Bytes of dynamic shared memory one world of the solve takes, with its
// lane fields (fields_in_smem 1) or without (0).
extern "C" int contact_solver_fwd_smem_bytes(int C, int n, int fields_in_smem) {
  return fwd_words(C, n, fields_in_smem != 0) * (int)sizeof(float);
}

// Launches the solve on `stream` and returns cudaGetLastError().  All
// planes are float32, row-major and contiguous: contact planes [C, B]
// (active as uint8), body planes [n, B]; body_lanes is the per-body lane
// list of SolveOps; scratch is [B, NUM_FIELDS * C] where fields_in_smem is
// 0, else unused; worlds_per_block (1 to 8) worlds share a block, one warp
// each.
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
    const int32_t* body_lanes, float* scratch,
    int B, int C, int n, int J, int iterations, int position_iterations,
    float dt, float baumgarte, float slop, float baumgarte_dt,
    float max_bias, int has_max_bias, int fields_in_smem,
    int worlds_per_block, void* stream) {
  const int W = worlds_per_block;
  const size_t smem =
      (size_t)W * fwd_words(C, n, fields_in_smem != 0) * sizeof(float);
  if (B <= 0 || W < 1 || W > MAX_WORLDS_PER_BLOCK ||
      smem > SMEM_LIMIT || (!fields_in_smem && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        contact_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const SolveOps ops{body_a, body_b, partner, lane_const, movable,
                     body_im, body_ii, joint_body, joint_f, body_lanes,
                     C, n, J, iterations, position_iterations,
                     dt, baumgarte, slop, baumgarte_dt, max_bias, has_max_bias};
  const FwdPlanes planes{pen_x, pen_y, pt_x, pt_y, active,
                         px, py, vx, vy, ang, om};
  const BodyOut out{opx, opy, ovx, ovy, oang, oom};
  const int blocks = (B + W - 1) / W, threads = W * LANES;
  contact_solve_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      ops, planes, out, scratch, fields_in_smem != 0, B, W);
  return (int)cudaGetLastError();
}
