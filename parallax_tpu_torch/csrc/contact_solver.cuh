// Constants and helpers shared by every kernel of the port: the solver's per-lane fields and lane constants, and the NaN-propagating
// min and max.  The solver's warp walk (solver_walk.cuh) and the fused
// step's lanes (fused_step.cuh) build on them.
//
// Everything computes what engine/batched.py:solve_contacts_bm followed by
// apply_joints_bm compute, lane for lane, and rounds each product and sum
// on its own (the files are built with --fmad=false and without fast
// math).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// per-lane solver fields, F_NX ... F_BIAS from the setup, then the normal,
// friction and position impulses
enum Field {
  F_NX, F_NY, F_RAX, F_RAY, F_RBX, F_RBY,
  F_KN, F_KT, F_KNP, F_KTP, F_TARGET, F_BIAS,
  F_JN, F_JT, F_PJ,
  NUM_FIELDS
};

// rows of lane_const [6, C]
enum LaneRow { R_IM_A, R_IM_B, R_II_A, R_II_B, R_E, R_MU };

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

}  // namespace
