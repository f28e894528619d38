// K7 on Hopper: the differential-pair crossbar VMM with its fused read.
//
// Replaces repro/kernels/crossbar_vmm.py:crossbar_matmul (the Pallas kernel
// _kernel there).  It computes
//   y = clip((x @ G) * inv_scale, -clamp, clamp)        x (M, K), y (M, N)
// where G (K, N) is what one read of the pair (G+, G-) gives:
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
// Design: a plain tiled FP32 GEMM on CUDA cores (no tensor cores, no TF32).
// A block of 256 threads computes one 64 x 64 output tile as a 4 x 4
// register micro-tile per thread and walks K in 16-deep slabs: each slab of
// x is staged transposed in shared memory, and each slab of G is built in
// shared memory as it is loaded, the dequantisation, pinning, noise and
// padding mask applied per element there, so the pair never exists
// combined in device memory.  The reference's 128 x 128 noise tiles are
// recomputed from each element's global (k, n), so the GEMM tile is free.
// Each product is an fmaf chain in order k = 0..K-1 (not cuBLAS's or the
// plain version's order): kernel vs plain is held to 1e-4 of the peak.
//
// Bound on this card (H100 SXM), the scorecard width's middle array
// (M = 1024 twins, K = 513, N = 512): 2 M K N = 0.538 GFLOP, 8.0 us at the
// 67 TFLOP/s FP32 peak; the bytes (x, G+, G-, y: 5.3 MB in float storage)
// take 1.6 us at 3.35 TB/s, so the operations bound it.  With read noise
// every block regenerates the normals of its G slabs (M / 64 times over),
// which makes the noisy read bound by that instruction work; the clean
// path is a textbook SGEMM that a later PR can move to wgmma.

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

#define K7_BM 64
#define K7_BN 64
#define K7_BK 16
#define K7_THREADS 256
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

// One element of G as the read sees it (zero past the array).
__device__ __forceinline__ float k7_g(const void* gp, const void* gm, int K,
                                      int N, int k, int n, const K7Read& rd) {
  if (k >= K || n >= N) return 0.0f;
  const long long i = (long long)k * N + n;
  float a = rd.u8 ? (float)static_cast<const unsigned char*>(gp)[i]
                  : static_cast<const float*>(gp)[i];
  float b = rd.u8 ? (float)static_cast<const unsigned char*>(gm)[i]
                  : static_cast<const float*>(gm)[i];
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
  if (rd.u8 && !(noisy || stuck)) g = __fmul_rn(g, rd.g_step);
  if (rd.drift != 1.0f) g = __fmul_rn(g, rd.drift);
  return g;
}

__global__ void __launch_bounds__(K7_THREADS)
k7_crossbar_kernel(const float* __restrict__ x, const void* __restrict__ gp,
                   const void* __restrict__ gm, float* __restrict__ y, int M,
                   int K, int N, const K7Read rd) {
  __shared__ float xs[K7_BK][K7_BM + 4];   // x slab, transposed
  __shared__ float gs[K7_BK][K7_BN + 4];   // G slab as read
  const int tid = threadIdx.x;
  const int tx = tid % 16;                 // output columns tx*4 .. +3
  const int ty = tid / 16;                 // output rows ty*4 .. +3
  const int m0 = blockIdx.y * K7_BM;
  const int n0 = blockIdx.x * K7_BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += K7_BK) {
    // 16 x 64 elements of each slab, 4 per thread, neighbouring threads on
    // neighbouring addresses of the row-major source.
    for (int e = tid; e < K7_BK * K7_BM; e += K7_THREADS) {
      const int r = e / K7_BK;             // row of x within the tile
      const int c = e % K7_BK;             // k within the slab
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? x[(long long)m * K + k] : 0.0f;
    }
    for (int e = tid; e < K7_BK * K7_BN; e += K7_THREADS) {
      const int r = e / K7_BN;             // k within the slab
      const int c = e % K7_BN;             // column within the tile
      gs[r][c] = k7_g(gp, gm, K, N, k0 + r, n0 + c, rd);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < K7_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = gs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = __fmul_rn(acc[i][j], rd.inv_scale);
      if (rd.has_clamp) v = fminf(fmaxf(v, -rd.clamp), rd.clamp);
      y[(long long)m * N + n] = v;
    }
  }
}

// Launch K7 on `stream`: x (M, K) f32, gp/gm (K, N) f32 or uint8 (read->u8),
// y (M, N) f32, all device pointers; `read` a host K7Read.  Returns the
// launch's cudaError_t; nothing is allocated and nothing synchronises.
extern "C" int k7_crossbar_matmul_f32(const void* x, const void* gp,
                                      const void* gm, void* y, int M, int K,
                                      int N, const void* read, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const K7Read rd = *static_cast<const K7Read*>(read);
  cudaGetLastError();   // clear any stale error first
  dim3 grid((N + K7_BN - 1) / K7_BN, (M + K7_BM - 1) / K7_BM);
  k7_crossbar_kernel<<<grid, K7_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), gp, gm, static_cast<float*>(y), M, K, N,
      rd);
  return (int)cudaGetLastError();
}
