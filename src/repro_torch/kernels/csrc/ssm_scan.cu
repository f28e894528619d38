// K9 on Hopper: the selective-SSM scan of Mamba.
//
// Replaces repro/kernels/legacy/ssm_scan.py:ssm_scan (body _kernel): per
// batch row and channel d the recurrence over the whole sequence
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n]
// from h_0 = 0, with dt, x (B, S, DI), B, C (B, S, N), A (DI, N) and
// outputs y (B, S, DI) and the final state h (B, DI, N), all float32.
//
// Bound on this card (H100 SXM).  At the Jamba prefill, B = 2, S = 4096,
// DI = 8192, N = 16: the scan reads dt and x and writes y (805 MB at f32,
// 0.24 ms at 3.35 TB/s), and takes 1.07 G expf, each one MUFU.EX2 on the
// special-function units (16 a clock per SM: 0.26 ms at 1.98 GHz) beside
// ~13 FP32 instructions per state and step (~0.47 ms of FP32 issue at one
// warp instruction a clock per scheduler).  So instruction issue, not
// bytes, bounds it; the design keeps every scheduler issuing.
//
// Design.
//  * A team of K9_Q = 4 lanes per channel (batch row, d), each holding
//    N / 4 of the channel's N <= 16 states in registers for the whole
//    sequence (the TPU kernel's (d_tile, N) state resident in VMEM, spread
//    over lanes).  A block owns 64 consecutive channels of one batch row:
//    256 threads, a grid of (DI / 64, B).  The Jamba prefill runs 65,536
//    threads, 16 warps per SM, where one thread per channel gave 4; each
//    lane's step is 4 independent state chains.  4 lanes were chosen by
//    timing 2, 4 and 8 on the H100 (PERF.md): 2 leave each scheduler too
//    few warps, 8 add shuffles and loads.
//  * Each state's recurrence is the plain version's arithmetic, exactly:
//    precise expf(__fmul_rn(dt, a)) (no fast math), __fmul_rn / __fadd_rn so
//    nvcc contracts nothing into an FMA.  The final state is therefore the
//    same bits as the plain version's where the card's exp is expf.  y's sum: each lane adds its states in order, then
//    the team meets in a fixed xor butterfly (a + b == b + a, so every lane
//    ends with the same bits and repeats are bitwise).
//  * Staging: the sequence goes in chunks of 32 steps.  A chunk's dt and x
//    tiles (32 x 64 floats, the block's channels being contiguous in DI) and
//    its B and C rows come into shared memory by 16-byte cp.async (4-byte
//    where DI or N is not a multiple of 4 or a pointer is not 16-byte
//    aligned), double-buffered: chunk k + 1's copies are in flight while
//    chunk k computes.  Two barriers per chunk.
//  * y: lane 0 of each team writes its channel's y into a (32, 64) shared
//    tile; after the chunk the block stores whole rows of 64 channels with
//    16-byte stores.  The final state is written as N consecutive floats
//    per channel into (B, DI, N).
//  A = -exp(A_log) is formed by the caller, as JAX's mamba_prefill does.

#include <cuda_runtime.h>
#include <stdint.h>

#define K9_CH 64        // channels per block
#define K9_Q 4          // lanes per channel
#define K9_TC 32        // steps per chunk
#define K9_NMAX 16      // states per channel the kernel holds
#define K9_FULL_MASK 0xffffffffu

// Floats of dynamic shared memory: dt, x (two buffers of K9_TC x K9_CH), B,
// C (two buffers of K9_TC x K9_NMAX), y (K9_TC x K9_CH).
#define K9_SMEM_FLOATS (4 * K9_TC * K9_CH + 4 * K9_TC * K9_NMAX + K9_TC * K9_CH)

__device__ __forceinline__ void k9_cp_async(float* dst, const float* src,
                                            int bytes16) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// Copy rows [row, row + tc) of dt and x (the block's channels d0 ..
// d0 + 63) and of B and C into one buffer; one commit group.
template <bool kVec>
__device__ __forceinline__ void k9_stage(
    float* s_dt, float* s_x, float* s_b, float* s_c,
    const float* __restrict__ dt, const float* __restrict__ x,
    const float* __restrict__ bm, const float* __restrict__ cm,
    long long row, int tc, int d0, int DI, int N) {
  const int tid = threadIdx.x, nt = blockDim.x;
  constexpr int V = kVec ? 4 : 1;               // floats per copy
  constexpr int per_row = K9_CH / V;
  for (int e = tid; e < tc * per_row; e += nt) {
    const int r = e / per_row;
    const int col = (e - r * per_row) * V;
    if (d0 + col < DI) {
      const long long off = (row + r) * DI + d0 + col;
      k9_cp_async(s_dt + r * K9_CH + col, dt + off, kVec);
      k9_cp_async(s_x + r * K9_CH + col, x + off, kVec);
    }
  }
  const int nv = N / V;
  for (int e = tid; e < tc * nv; e += nt) {
    const int r = e / nv;
    const int n = (e - r * nv) * V;
    const long long off = (row + r) * N + n;
    k9_cp_async(s_b + r * K9_NMAX + n, bm + off, kVec);
    k9_cp_async(s_c + r * K9_NMAX + n, cm + off, kVec);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int NS>
__device__ __forceinline__ void k9_load_states(float (&v)[NS], const float* p) {
  static_assert(NS % 4 == 0, "k9_load_states: whole float4s");
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

// One step of one lane: its NS states, then the team's sum of y.  States
// past N hold a = 0, B = C = 0 and stay 0, adding exact zeros to y.
template <int NS>
__device__ __forceinline__ void k9_step(float (&h)[NS], const float (&av)[NS],
                                        const float* s_dt, const float* s_x,
                                        const float* s_b, const float* s_c,
                                        float* s_y, int j, int ch, int q) {
  const float dtv = s_dt[j * K9_CH + ch];
  const float dtx = __fmul_rn(dtv, s_x[j * K9_CH + ch]);
  float bv[NS], cv[NS];
  k9_load_states<NS>(bv, s_b + j * K9_NMAX + q * NS);
  k9_load_states<NS>(cv, s_c + j * K9_NMAX + q * NS);
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float da = expf(__fmul_rn(dtv, av[i]));
    h[i] = __fadd_rn(__fmul_rn(da, h[i]), __fmul_rn(dtx, bv[i]));
    part = __fadd_rn(part, __fmul_rn(h[i], cv[i]));
  }
#pragma unroll
  for (int m = 1; m < K9_Q; m <<= 1)
    part = __fadd_rn(part, __shfl_xor_sync(K9_FULL_MASK, part, m));
  if (q == 0) s_y[j * K9_CH + ch] = part;
}

template <bool kVec>
__global__ void __launch_bounds__(K9_CH * K9_Q)
k9_ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                   const float* __restrict__ cm, const float* __restrict__ x,
                   const float* __restrict__ a, float* __restrict__ y,
                   float* __restrict__ hout, int S, int DI, int N) {
  constexpr int NS = K9_NMAX / K9_Q;
  extern __shared__ __align__(16) float smem[];
  float* s_dt = smem;                           // [2][K9_TC][K9_CH]
  float* s_x = s_dt + 2 * K9_TC * K9_CH;        // [2][K9_TC][K9_CH]
  float* s_b = s_x + 2 * K9_TC * K9_CH;         // [2][K9_TC][K9_NMAX]
  float* s_c = s_b + 2 * K9_TC * K9_NMAX;       // [2][K9_TC][K9_NMAX]
  float* s_y = s_c + 2 * K9_TC * K9_NMAX;       // [K9_TC][K9_CH]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ch = tid / K9_Q, q = tid % K9_Q;
  const int d0 = blockIdx.x * K9_CH;
  const int d = d0 + ch;
  const bool live = d < DI;
  const long long row0 = (long long)blockIdx.y * S;

  // B and C past N are never copied: zero once
  for (int i = tid; i < 4 * K9_TC * K9_NMAX; i += nt) s_b[i] = 0.0f;
  float av[NS], h[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int n = q * NS + i;
    av[i] = (live && n < N) ? a[(long long)d * N + n] : 0.0f;
    h[i] = 0.0f;
  }
  __syncthreads();

  constexpr int buf_ch = K9_TC * K9_CH, buf_n = K9_TC * K9_NMAX;
  const int nchunks = (S + K9_TC - 1) / K9_TC;
  k9_stage<kVec>(s_dt, s_x, s_b, s_c, dt, x, bm, cm, row0, min(K9_TC, S),
                 d0, DI, N);
  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * K9_TC;
    const int tc = min(K9_TC, S - t0);
    const int cur = k & 1;
    if (k + 1 < nchunks) {
      // buffer cur ^ 1 held chunk k - 1, read before the last barrier
      const int nxt = cur ^ 1;
      k9_stage<kVec>(s_dt + nxt * buf_ch, s_x + nxt * buf_ch,
                     s_b + nxt * buf_n, s_c + nxt * buf_n, dt, x, bm, cm,
                     row0 + t0 + K9_TC, min(K9_TC, S - t0 - K9_TC), d0, DI,
                     N);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();                            // chunk k has landed
    const float* pdt = s_dt + cur * buf_ch;
    const float* px = s_x + cur * buf_ch;
    const float* pb = s_b + cur * buf_n;
    const float* pc = s_c + cur * buf_n;
#pragma unroll
    for (int j = 0; j < K9_TC; ++j)
      if (j < tc) k9_step<NS>(h, av, pdt, px, pb, pc, s_y, j, ch, q);
    __syncthreads();                            // y tile complete
    constexpr int V = kVec ? 4 : 1;
    constexpr int per_row = K9_CH / V;
    for (int e = tid; e < tc * per_row; e += nt) {
      const int r = e / per_row;
      const int col = (e - r * per_row) * V;
      if (d0 + col < DI) {
        float* dst = y + (row0 + t0 + r) * DI + d0 + col;
        if (kVec)
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(s_y + r * K9_CH + col);
        else
          *dst = s_y[r * K9_CH + col];
      }
    }
  }
  if (live) {
    float* hp = hout + ((long long)blockIdx.y * DI + d) * N;
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (q * NS + i < N) hp[q * NS + i] = h[i];
  }
}

template <bool kVec>
static int k9_launch(const float* dt, const float* b, const float* c,
                     const float* x, const float* a, float* y, float* hout,
                     int B, int S, int DI, int N, cudaStream_t st) {
  const size_t smem = 4 * K9_SMEM_FLOATS;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k9_ssm_scan_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((DI + K9_CH - 1) / K9_CH, B);
  k9_ssm_scan_kernel<kVec><<<grid, K9_CH * K9_Q, smem, st>>>(
      dt, b, c, x, a, y, hout, S, DI, N);
  return (int)cudaGetLastError();
}

// Launch K9 on `stream`.  All pointers are contiguous float32 device
// arrays of the shapes above.  Returns the cudaError_t of the launch (0 on
// success); nothing is allocated and nothing synchronises.
extern "C" int k9_ssm_scan_f32(const void* dt, const void* b, const void* c,
                               const void* x, const void* a, void* y,
                               void* hout, int B, int S, int DI, int N,
                               void* stream) {
  if (B < 1 || B > 65535 || S < 1 || DI < 1 || N < 1 || N > K9_NMAX)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();   // clear any stale error first
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(dt) |
                              reinterpret_cast<uintptr_t>(b) |
                              reinterpret_cast<uintptr_t>(c) |
                              reinterpret_cast<uintptr_t>(x) |
                              reinterpret_cast<uintptr_t>(y);
  const bool vec = DI % 4 == 0 && N % 4 == 0 && addr_bits % 16 == 0;
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    return k9_launch<true>(dtf, bf, cf, xf, af, yf, hf, B, S, DI, N, st);
  return k9_launch<false>(dtf, bf, cf, xf, af, yf, hf, B, S, DI, N, st);
}
