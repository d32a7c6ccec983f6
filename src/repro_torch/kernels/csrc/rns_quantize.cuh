// The fixed-point rule of core/quantize.quantize_with_scale, shared by the
// forward conversion (rns_convert.cu) and the quantize prologues of the
// fused encode + matmul (rns_matmul.cu) and the fused dot
// (rns_fused_mma.cu): v = clip(round_half_even(x * s), -qmax, qmax).
#pragma once

// __fmul_rn: one rounded float32 product, never contracted into an FMA;
// rintf rounds half to even like torch.round / jnp.round
__device__ __forceinline__ int quantize_rn(float x, float s, float qmax) {
  float v = rintf(__fmul_rn(x, s));
  return (int)fminf(fmaxf(v, -qmax), qmax);
}

