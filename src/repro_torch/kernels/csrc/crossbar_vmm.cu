// K7 on Hopper: the differential-pair crossbar VMM with its read.
//
// Replaces repro/kernels/crossbar_vmm.py:crossbar_matmul (the Pallas kernel
// _kernel there).  It computes
//   y = clip((x @ G) * inv_scale, -clamp, clamp)        x (M, K), y (M, N)
// where G (K, N) is what one read of the pair (G+, G-) gives (k7_g):
//   * float storage: G+ - G-; uint8 level indices: (i+ - i-) * g_step, the
//     G_min offsets cancelling in the clean pair;
//   * with read noise or stuck cells, uint8 indices are first rebuilt to
//     absolute conductances g_min + i * g_step; stuck cells are pinned to
//     g_max / g_min at their global ids row * N + col (counter_noise.cuh's
//     stuck_at, bitwise the masks core/faults.py bakes); read noise
//     multiplies each half by (1 + s e) with e drawn per 128 x 128 tile of
//     G, salt k_tile * 2 * 65536 + n_tile * 2 (+1 for G-), element ids
//     local to that tile, as the reference kernel draws them;
//   * then the drift factor; cells past (K, N) contribute exactly zero.
//
// Bound on this card (H100 SXM), the scorecard width's middle array
// (M = 1024 twins, K = 513, N = 512): the 3xTF32 products are
// 3 * 2 M K N = 1.615 GFLOP, 3.3 us at the 495 TFLOP/s dense TF32
// tensor-core peak; the bytes (x, the uint8 pair, y: 4.7 MB) take 1.4 us
// at 3.35 TB/s, so the operations bound it.  A noisy read adds ~69 FP32
// operations per cell on the CUDA cores (0.27 us at 67 TFLOP/s).
//
// Design.
//  * Read pass (k7_read_kernel), once per call: one thread per cell
//    writes k7_g into a float32 G (1.05 MB at the shape above, resident in
//    L2), so each counter normal and stuck test is computed once per call,
//    not once per 64-row block of the GEMM.  The values are bitwise
//    ref.crossbar_effective_g's.  Every read takes this pass, clean ones
//    too: the GEMM on its G is faster than one that decodes the stored
//    pair as it stages it.
//  * GEMM (k7_gemm_kernel): 64 x 64 output tiles, so 128 blocks at
//    1024 x 512 fill most of the 132 SMs (128 x 128 tiles would leave 32
//    blocks).  4 warps, each a 32 x 32 sub-tile of 2 x 4
//    mma.sync.m16n8k8 TF32 products.  TF32 keeps 10 mantissa bits, too few
//    for the 1e-4-of-the-peak agreement K7 is held to, so every operand a
//    is split as big = tf32_rna(a), small = tf32_rna(a - big), and the
//    float32 fragments accumulate small.big + big.small + big.big (3xTF32,
//    ~21 bits per product); small.small is dropped.  The rounding is done
//    on the bit pattern, (bits + 0x1000) & ~0x1fff: two integer
//    instructions where sm_90 spends four on cvt.rna.tf32.
//  * K walks in 32-deep slabs, double-buffered: the slabs of step s + 1
//    are in flight while slab s is multiplied.  x and G come through
//    cp.async (4 bytes a thread, since rows of K = 513 floats are not
//    16-byte aligned; rows and columns past the array are zero-filled by
//    the copy).  Rows padded (x: 36, G: 72 floats) make the fragment reads
//    conflict-free.
//  * What bounds it now: per MMA the loop issues several other
//    instructions (the operand splits, cp.async addressing), with one warp
//    per scheduler; a deeper ring or 8 warps per block did not make it
//    faster.  wgmma, which reads both operands from shared memory without
//    per-fragment splits in registers, is the next step.
//  * Epilogue unchanged: __fmul_rn(acc, inv_scale), then the clamp.
//  * No split-K and no atomics: the summation order is fixed, so repeats
//    are bitwise.
// Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

#define K7_BM 64
#define K7_BN 64
#define K7_NOISE_TILE 128

struct K7Read {
  int u8;                 // 1: uint8 level indices, 0: float32 conductances
  float g_step, g_min, g_max;
  float read_noise;
  uint32_t noise_seed;
  float stuck_rate, stuck_on_frac;
  uint32_t fault_seed, salt_p, salt_m;
  float drift;
  float inv_scale;
  int has_clamp;
  float clamp;
};

// G of cell (k, n) from its stored pair (a, b), as the read sees it, in
// ref.crossbar_effective_g's order.
__device__ __forceinline__ float k7_read_cell(float a, float b, int N, int k,
                                              int n, const K7Read& rd) {
  const bool noisy = rd.read_noise > 0.0f;
  const bool stuck = rd.stuck_rate > 0.0f;
  if (rd.u8 && (noisy || stuck)) {
    a = __fadd_rn(rd.g_min, __fmul_rn(a, rd.g_step));
    b = __fadd_rn(rd.g_min, __fmul_rn(b, rd.g_step));
  }
  if (stuck) {
    const uint32_t id = (uint32_t)k * (uint32_t)N + (uint32_t)n;
    a = stuck_at(a, rd.fault_seed, rd.salt_p, id, rd.stuck_rate,
                 rd.stuck_on_frac, rd.g_max, rd.g_min);
    b = stuck_at(b, rd.fault_seed, rd.salt_m, id, rd.stuck_rate,
                 rd.stuck_on_frac, rd.g_max, rd.g_min);
  }
  if (noisy) {
    const uint32_t salt = (uint32_t)(k / K7_NOISE_TILE) * (2u * 65536u) +
                          (uint32_t)(n / K7_NOISE_TILE) * 2u;
    const uint32_t local = (uint32_t)(k % K7_NOISE_TILE) * K7_NOISE_TILE +
                           (uint32_t)(n % K7_NOISE_TILE);
    const float ep = counter_normal_at(rd.noise_seed, salt, local);
    const float em = counter_normal_at(rd.noise_seed, salt + 1u, local);
    a = __fmul_rn(a, __fadd_rn(1.0f, __fmul_rn(rd.read_noise, ep)));
    b = __fmul_rn(b, __fadd_rn(1.0f, __fmul_rn(rd.read_noise, em)));
  }
  float g = __fsub_rn(a, b);
  if (rd.u8 && !noisy && !stuck) g = __fmul_rn(g, rd.g_step);
  if (rd.drift != 1.0f) g = __fmul_rn(g, rd.drift);
  return g;
}

// One element of G as the read sees it (zero past the array).
__device__ __forceinline__ float k7_g(const void* gp, const void* gm, int K,
                                      int N, int k, int n, const K7Read& rd) {
  if (k >= K || n >= N) return 0.0f;
  const long long i = (long long)k * N + n;
  const float a = rd.u8 ? (float)static_cast<const unsigned char*>(gp)[i]
                        : static_cast<const float*>(gp)[i];
  const float b = rd.u8 ? (float)static_cast<const unsigned char*>(gm)[i]
                        : static_cast<const float*>(gm)[i];
  return k7_read_cell(a, b, N, k, n, rd);
}

// float32 -> TF32 by round to nearest, ties away from zero, on the bit
// pattern: what cvt.rna.tf32.f32 gives for every finite a (Inf and quiet
// NaN pass too), in two integer instructions where sm_90 spends four on
// the cvt.
__device__ __forceinline__ uint32_t k7_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a -> (big, small) with big = tf32_rna(a), small = tf32_rna(a - big)
__device__ __forceinline__ void k7_split(float a, uint32_t& big,
                                         uint32_t& small) {
  big = k7_tf32(a);
  small = k7_tf32(__fsub_rn(a, __uint_as_float(big)));
}

// c (16 x 8, float32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void k7_mma(float (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 bytes global -> shared, or a zero where !valid (source size 0)
__device__ __forceinline__ void k7_cp_async4(float* dst, const float* src,
                                             bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__global__ void k7_read_kernel(const void* __restrict__ gp,
                               const void* __restrict__ gm,
                               float* __restrict__ g, int K, int N,
                               const K7Read rd) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)K * N) return;
  const int k = (int)(i / N);
  g[i] = k7_g(gp, gm, K, N, k, (int)(i - (long long)k * N), rd);
}

#define K7_GBK 32
#define K7_GTHREADS 128
#define K7_XLD (K7_GBK + 4)
#define K7_GLD (K7_BN + 8)

__global__ void __launch_bounds__(K7_GTHREADS)
k7_gemm_kernel(const float* __restrict__ x, const float* __restrict__ G,
               float* __restrict__ y, int M, int K, int N, const K7Read rd) {
  __shared__ __align__(16) float xs[2][K7_BM * K7_XLD];    // [m][k]
  __shared__ __align__(16) float gs[2][K7_GBK * K7_GLD];   // [k][n]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;   // the warp's 32 x 32 sub-tile
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * K7_BM;
  const int n0 = blockIdx.x * K7_BN;
  // staging: x column xc of rows xr + 4 i, G column gc of rows gr + 2 i
  const int xc = tid & 31, xr = tid >> 5;
  const int gc = tid & 63, gr = tid >> 6;
  const int gn = n0 + gc;

  auto load = [&](int buf, int k0) {
    const bool k_ok = k0 + xc < K;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = m0 + xr + 4 * i;
      const bool ok = k_ok && m < M;
      k7_cp_async4(&xs[buf][(xr + 4 * i) * K7_XLD + xc],
                   ok ? x + (long long)m * K + k0 + xc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = k0 + gr + 2 * i;
      const bool ok = gn < N && k < K;
      k7_cp_async4(&gs[buf][(gr + 2 * i) * K7_GLD + gc],
                   ok ? G + (long long)k * N + gn : G, ok);
    }
  };

  float acc[2][4][4] = {};
  const int slabs = (K + K7_GBK - 1) / K7_GBK;
  load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int s = 0; s < slabs; ++s) {
    const int buf = s & 1;
    // the other buffer was last read before the last barrier
    if (s + 1 < slabs) load(buf ^ 1, (s + 1) * K7_GBK);
    asm volatile("cp.async.commit_group;\n" ::);   // possibly empty
    asm volatile("cp.async.wait_group 1;\n" ::);   // slab s has landed
    __syncthreads();
    const float* xb = xs[buf];
    const float* gb = gs[buf];
#pragma unroll
    for (int kk = 0; kk < K7_GBK; kk += 8) {
      uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* xf = xb + (wm + i * 16 + g) * K7_XLD + kk + t;
        k7_split(xf[0], ab[i][0], as[i][0]);
        k7_split(xf[8 * K7_XLD], ab[i][1], as[i][1]);
        k7_split(xf[4], ab[i][2], as[i][2]);
        k7_split(xf[8 * K7_XLD + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* gf = gb + (kk + t) * K7_GLD + wn + j * 8 + g;
        k7_split(gf[0], bb[j][0], bs[j][0]);
        k7_split(gf[4 * K7_GLD], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          k7_mma(acc[i][j], as[i], bb[j]);
          k7_mma(acc[i][j], ab[i], bs[j]);
          k7_mma(acc[i][j], ab[i], bb[j]);
        }
    }
    __syncthreads();    // every warp is done with slab s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        float v = __fmul_rn(acc[i][j][e], rd.inv_scale);
        if (rd.has_clamp) v = fminf(fmaxf(v, -rd.clamp), rd.clamp);
        y[(long long)m * N + n] = v;
      }
}

// The read pass: g (K, N) float32 = k7_g of every cell of the pair gp/gm
// (f32 or uint8 per read->u8), device pointers; `read` a host K7Read.
// Returns the launch's cudaError_t; nothing is allocated or synchronised.
extern "C" int k7_crossbar_read(const void* gp, const void* gm, void* g,
                                int K, int N, const void* read,
                                void* stream) {
  if (K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const K7Read rd = *static_cast<const K7Read*>(read);
  cudaGetLastError();   // clear any stale error first
  const long long cells = (long long)K * N;
  const int threads = 256;
  k7_read_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      gp, gm, static_cast<float*>(g), K, N, rd);
  return (int)cudaGetLastError();
}

// Launch K7's GEMM on `stream`: x (M, K) f32, g the read pass's float32
// G (K, N), y (M, N) f32, all device pointers; `read` a host K7Read (its
// inv_scale and clamp).  Returns the launch's cudaError_t; nothing is
// allocated and nothing synchronises.
extern "C" int k7_crossbar_matmul_f32(const void* x, const void* g, void* y,
                                      int M, int K, int N, const void* read,
                                      void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const K7Read rd = *static_cast<const K7Read*>(read);
  cudaGetLastError();   // clear any stale error first
  const dim3 grid((N + K7_BN - 1) / K7_BN, (M + K7_BM - 1) / K7_BM);
  k7_gemm_kernel<<<grid, K7_GTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(y), M, K, N, rd);
  return (int)cudaGetLastError();
}
