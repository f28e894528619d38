// K9 on Hopper: the selective-SSM scan of Mamba.
//
// Replaces repro/kernels/legacy/ssm_scan.py:ssm_scan (body _kernel): per
// batch row and channel d the recurrence over the whole sequence
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n]
// from h_0 = 0, with dt, x (B, S, DI), B, C (B, S, N), A (DI, N) and
// outputs y (B, S, DI) and the final state h (B, DI, N), all float32.
//
// Design.
//  * One thread per channel (batch row, d) holds its N <= 16 states in
//    registers for the whole sequence: the TPU kernel's (d_tile, N) state
//    resident in VMEM, mapped onto threads.  A grid of (DI / 128, B) blocks
//    of 128 threads; nothing carries across blocks.
//  * The sequence goes in chunks of 32 steps.  Per chunk each thread stages
//    its own dt and x of the 32 steps in shared memory (coalesced loads
//    across the block's channels, all in flight together), and the block
//    stages the chunk's B and C rows, which every channel reads; one
//    barrier after the loads and one before the next chunk overwrites them.
//  * y is a coalesced store per step; the final state is written as N
//    consecutive floats per channel into (B, DI, N).
//  * Arithmetic in the plain version's order (kernels/ref.py:ssm_scan_ref):
//    exp with the precise expf (no fast math), __fmul_rn / __fadd_rn so nvcc
//    contracts nothing into an FMA, and the sum over n in order 0..N-1.
//    A = -exp(A_log) is formed by the caller, as JAX's mamba_prefill does.
//
// Bound on this card (H100 SXM).  At the Jamba prefill, B = 2, S = 4096,
// DI = 8192, N = 16: the scan reads dt and x and writes y (805 MB at f32)
// and does 1.07 G expf and ~5 G other operations; bytes bound it at
// ~0.24 ms at 3.35 TB/s.  The 16384 channels give 4 warps per SM, and each
// step is a dependent chain per state, so latency, not bytes, sets its
// time (PERF.md); splitting a channel's states over several lanes is later
// work.

#include <cuda_runtime.h>

#define K9_THREADS 128
#define K9_CHUNK 32
#define K9_NMAX 16

__global__ void __launch_bounds__(K9_THREADS)
k9_ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ x,
                   const float* __restrict__ a, float* __restrict__ y,
                   float* __restrict__ hout, int S, int DI, int N) {
  __shared__ float s_dt[K9_CHUNK][K9_THREADS];
  __shared__ float s_x[K9_CHUNK][K9_THREADS];
  __shared__ float s_b[K9_CHUNK][K9_NMAX];
  __shared__ float s_c[K9_CHUNK][K9_NMAX];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * K9_THREADS + tid;
  const int bi = blockIdx.y;
  const bool live = d < DI;

  float av[K9_NMAX], h[K9_NMAX];
#pragma unroll
  for (int n = 0; n < K9_NMAX; ++n) {
    av[n] = (live && n < N) ? a[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }

  const long long row0 = (long long)bi * S;
  for (int t0 = 0; t0 < S; t0 += K9_CHUNK) {
    const int tc = min(K9_CHUNK, S - t0);
    __syncthreads();    // the last chunk's readers are done
    if (live) {
      for (int j = 0; j < tc; ++j) {
        const long long off = (row0 + t0 + j) * DI + d;
        s_dt[j][tid] = dt[off];
        s_x[j][tid] = x[off];
      }
    }
    for (int e = tid; e < tc * N; e += K9_THREADS) {
      const int j = e / N;
      const int n = e - j * N;
      const long long off = (row0 + t0 + j) * N + n;
      s_b[j][n] = bm[off];
      s_c[j][n] = cm[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < tc; ++j) {
      const float dtv = s_dt[j][tid];
      const float dtx = __fmul_rn(dtv, s_x[j][tid]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < K9_NMAX; ++n) {
        if (n < N) {
          const float da = expf(__fmul_rn(dtv, av[n]));
          const float dbx = __fmul_rn(dtx, s_b[j][n]);
          h[n] = __fadd_rn(__fmul_rn(da, h[n]), dbx);
          acc = __fadd_rn(acc, __fmul_rn(h[n], s_c[j][n]));
        }
      }
      y[(row0 + t0 + j) * DI + d] = acc;
    }
  }
  if (live) {
    float* hp = hout + ((long long)bi * DI + d) * N;
#pragma unroll
    for (int n = 0; n < K9_NMAX; ++n)
      if (n < N) hp[n] = h[n];
  }
}

// Launch K9 on `stream`.  All pointers are contiguous float32 device arrays
// of the shapes above.  Returns the cudaError_t of the launch (0 on
// success); nothing is allocated and nothing synchronises.
extern "C" int k9_ssm_scan_f32(const void* dt, const void* b, const void* c,
                               const void* x, const void* a, void* y,
                               void* hout, int B, int S, int DI, int N,
                               void* stream) {
  if (B < 1 || B > 65535 || S < 1 || DI < 1 || N < 1 || N > K9_NMAX)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();   // clear any stale error first
  const dim3 grid((DI + K9_THREADS - 1) / K9_THREADS, B);
  k9_ssm_scan_kernel<<<grid, K9_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(x),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(hout), S, DI, N);
  return (int)cudaGetLastError();
}
