// K3 on Hopper: the counter-derived noise stream as __device__ helpers.
//
// Replaces repro/kernels/noise.py (splitmix32, _bits_to_unit,
// counter_uniform_at, global_cell_index, stuck_cell_masks, counter_normal).
// The JAX functions have no pallas_call of their own: they are traced into
// the fused analogue rollout and the crossbar VMM, and run on the host for
// the fault masks and hardware-aware training.  Here they are inline device
// functions that K4 (fused_analogue.cu) and K7 (crossbar_vmm.cu) include,
// and K3's own library (counter_noise.cu: a fill, the masks of a whole
// programming, the hardware-aware write path) so that
// repro_torch.kernels.noise computes on CUDA tensors too.
//
// Every sample is a pure function of (seed, salt, element id):
//   base = splitmix32(seed * 0x9E3779B9 + splitmix32(salt))
//   uniform(id) = 2 - float((splitmix32(base ^ id) >> 9) | 0x3F800000)
//   normal(id)  = sqrt(-2 log u1) * cos(2 pi u2), u1 from h1 = splitmix32(base
//                 ^ id), u2 from splitmix32(h1 ^ 0x85EBCA6B)
// All integer arithmetic is uint32 and wraps, as JAX's.  Hash bits,
// uniforms and masks are bitwise those of the JAX package; the normals use
// the precise logf/cosf/sqrtf (no fast-math: _build.py passes no such flag)
// and stay within ~1e-6 of the plain version.
//
// Bound.  The stream moves no bytes at all: an element costs ~10 integer
// operations per hash and, for a normal, one logf, one cosf and one sqrtf
// (~40-60 FP32 instructions), so the callers' noise work is bound by
// instruction issue.  Its design answer is that the noise never
// materialises in device memory: K4 and K7 regenerate it where they use it.
#pragma once

#include <stdint.h>

#define CN_POLARITY_SALT_OFFSET 0x00800000u
// JAX's float32 constant jnp.float32(2.0 * 3.14159265358979).
#define CN_TWO_PI ((float)(2.0 * 3.14159265358979))

__device__ __forceinline__ uint32_t cn_splitmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// uint32 -> float32 uniform in (0, 1]; exact.
__device__ __forceinline__ float cn_bits_to_unit(uint32_t bits) {
  return 2.0f - __uint_as_float((bits >> 9) | 0x3F800000u);
}

// The stream's key for one (seed, salt).
__device__ __forceinline__ uint32_t cn_base(uint32_t seed, uint32_t salt) {
  return cn_splitmix32(seed * 0x9E3779B9u + cn_splitmix32(salt));
}

__device__ __forceinline__ float cn_uniform_from_base(uint32_t base,
                                                      uint32_t idx) {
  return cn_bits_to_unit(cn_splitmix32(base ^ idx));
}

__device__ __forceinline__ float counter_uniform_at(uint32_t seed,
                                                    uint32_t salt,
                                                    uint32_t idx) {
  return cn_uniform_from_base(cn_base(seed, salt), idx);
}

__device__ __forceinline__ float cn_normal_from_base(uint32_t base,
                                                     uint32_t idx) {
  const uint32_t h1 = cn_splitmix32(base ^ idx);
  const uint32_t h2 = cn_splitmix32(h1 ^ 0x85EBCA6Bu);
  const float u1 = cn_bits_to_unit(h1);
  const float u2 = cn_bits_to_unit(h2);
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(CN_TWO_PI * u2);
}

__device__ __forceinline__ float counter_normal_at(uint32_t seed,
                                                   uint32_t salt,
                                                   uint32_t flat_idx) {
  return cn_normal_from_base(cn_base(seed, salt), flat_idx);
}

// The stuck-cell fault of one cell at global id `idx` of the array with salt
// `salt`: returns g unchanged, or g_on / g_off where the cell is stuck.  The
// decision and the polarity compare float32 uniforms with the float32 rate
// and on-fraction, as stuck_cell_masks does.
__device__ __forceinline__ float stuck_at(float g, uint32_t seed,
                                          uint32_t salt, uint32_t idx,
                                          float rate, float on_frac,
                                          float g_on, float g_off) {
  if (counter_uniform_at(seed, salt, idx) < rate) {
    const bool on = counter_uniform_at(seed, salt + CN_POLARITY_SALT_OFFSET,
                                       idx) < on_frac;
    return on ? g_on : g_off;
  }
  return g;
}
