// QSGD of one coordinate, shared by K6 (qsgd.cu) and K2 (choco_fused.cu).
#pragma once

#include "common.cuh"

// q = sign(v) * norm * floor(s |v| / norm + xi) / sc for a row of norm
// `norm`, with xi uniform in [0, 1), s the number of levels and sc the f32
// constant s * c; 0 when the row's norm is not > 0. The reference's order
// of operations, each step rounded on its own (the intrinsics keep nvcc
// from contracting anything into an fma). sign(+0) = sign(-0) = +0, as in
// the plain version, so a zero coordinate maps to +0 and a negative one
// whose level is 0 to -0.
__device__ __forceinline__ float qsgd_coord(float v, float xi, float norm, float s, float sc) {
  if (!(norm > 0.0f)) return 0.0f;
  const float lvl = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(s, fabsf(v)), norm), xi));
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return __fdiv_rn(__fmul_rn(__fmul_rn(sgn, norm), lvl), sc);
}
