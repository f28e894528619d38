// K8 on Hopper: causal GQA flash attention.
//
// Replaces repro/kernels/legacy/flash_attention.py:flash_attention_pallas
// (body _kernel): for each (batch, head) out = softmax(q k^T * scale,
// causal) v over q (B, H, S, d) and k, v (B, Hkv, S, d) with Hkv | H, the kv
// head of query head h being h / (H / Hkv), as the Pallas BlockSpec index
// maps have it.  The same constants as the TPU kernel: masked scores are
// -1e30 (not -inf), the denominator is max(l, 1e-30), and the output is
// cast to q's dtype.  Inputs float32 or bfloat16; every score, probability
// and sum in float32.
//
// Design.
//  * One block of 256 threads per (q tile of 64 rows, head, batch); the
//    block walks the kv tiles of 64 from the first up to the diagonal and
//    stops there, so the tiles above it are never loaded (the TPU kernel
//    skips them with @pl.when).  The q tiles with the most kv tiles are
//    scheduled first.
//  * The Q tile is staged in shared memory once, as float32; each K and V
//    tile per step.  The running max m, the denominator l and the (64, d)
//    accumulator stay in registers for the whole walk: thread (ty, tx) of
//    the 16 x 16 grid owns rows ty + 16 i (i < 4), and in the score tile
//    columns tx + 16 j (j < 4), in the accumulator columns tx + 16 j
//    (j < d / 16).  A row's max and sum are shuffle reductions over the 16
//    lanes that share ty (one half of a warp); the probabilities go through
//    shared memory to the P.V product.
//  * Q and K rows are read as float4 along d (row stride d + 4 keeps the
//    eight lanes of each 128-bit phase on distinct banks); V is read one
//    column per lane.
//  * Arithmetic on CUDA cores in float32: score = (q . k) * scale with the
//    dot product summed in order over d by FMAs, precise expf, and
//    acc / max(l, 1e-30) by IEEE division.  Tensor cores (mma.sync or wgmma
//    on bf16 operands), TMA and larger tiles are later work.
//  * Inputs are addressed through (batch, head, row) strides in elements and
//    a contiguous last dimension, so the model's (B, S, H, d) activations go
//    in without a copy; the output is written through strides of its own.
//  * At d = 128 a block holds 115 KiB of shared memory (117,760 bytes),
//    above the 48 KB static limit: the launch raises the block's dynamic
//    allowance first.
//
// Bound on this card (H100 SXM).  At the Jamba prefill, B = 2, H = 32,
// Hkv = 8, S = 4096, d = 128, bf16: the causal half of Q K^T and of P V is
// ~275 GFLOP, 0.28 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// ~168 MB of Q, K, V and O (0.05 ms at 3.35 TB/s; hbm_traffic_bytes in
// flash_attention.py): operations bound it.
// This kernel does the products on CUDA cores in float32 (67 TFLOP/s
// peak), so it cannot come closer than ~4 ms; its measured time is in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define K8_BQ 64
#define K8_BK 64
#define K8_THREADS 256
#define K8_NEG_INF (-1e30f)
#define K8_PS (K8_BK + 4)

__device__ __forceinline__ float k8_load(const float* p) { return *p; }
__device__ __forceinline__ float k8_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void k8_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void k8_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct K8Strides {
  long long b, h, s;   // elements between batches, heads and rows
};

template <int D>
constexpr int k8_smem_floats() {
  return K8_BQ * (D + 4) + K8_BK * (D + 4) + K8_BK * D + K8_BQ * K8_PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(K8_THREADS)
k8_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int S, int group,
                K8Strides qs, K8Strides ks, K8Strides vs, K8Strides os,
                float scale) {
  constexpr int QS = D + 4;       // row stride of the Q and K tiles
  constexpr int J = D / 16;       // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                       // [BQ][QS]
  float* kt = qt + K8_BQ * QS;            // [BK][QS]
  float* vt = kt + K8_BK * QS;            // [BK][D]
  float* pt = vt + K8_BK * D;             // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qi * K8_BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < K8_BQ * D; e += K8_THREADS) {
    const int r = e / D;
    const int c = e - r * D;
    const int s = q0 + r;
    qt[r * QS + c] = s < S ? k8_load(qb + s * qs.s + c) : 0.f;
  }

  float m[4], l[4], acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = K8_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  }

  // kv tile ki holds columns ki*64 .. ki*64+63: visible to some row of this
  // q tile iff ki <= qi (equal tile sizes), so the walk stops at the diagonal
  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * K8_BK;
    __syncthreads();    // the last tile's readers of kt, vt and pt are done
    for (int e = tid; e < K8_BK * D; e += K8_THREADS) {
      const int r = e / D;
      const int c = e - r * D;
      const int s = k0 + r;
      kt[r * QS + c] = s < S ? k8_load(kb + s * ks.s + c) : 0.f;
      vt[r * D + c] = s < S ? k8_load(vb + s * vs.s + c) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16i against columns tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qt + (ty + 16 * i) * QS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * QS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // scale, causal mask, online softmax: each row's max and sum over the
    // 16 lanes that own it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = K8_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float s = __fmul_rn(sc[i][j], scale);
        if (kpos > qpos) s = K8_NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = fmaf(l[i], corr, rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt[(ty + 16 * i) * K8_PS + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

    // acc += P V over the tile's 64 kv rows
#pragma unroll 2
    for (int c = 0; c < K8_BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(pt + (ty + 16 * i) * K8_PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[J];
#pragma unroll
        for (int j = 0; j < J; ++j) vv[j] = vt[(c + cc) * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < J; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < J; ++j)
        k8_store(ob + s * os.s + tx + 16 * j, acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
static int k8_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int group, int S, const long long* st,
                     float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * k8_smem_floats<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k8_flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const K8Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + K8_BQ - 1) / K8_BQ, H, B);
  k8_flash_kernel<T, D><<<grid, K8_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, group, qs, ks, vs, os,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int k8_dispatch(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int group, int S, int D,
                       const long long* st, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return k8_launch<T, 16>(q, k, v, o, B, H, group, S, st, scale, stream);
    case 32: return k8_launch<T, 32>(q, k, v, o, B, H, group, S, st, scale, stream);
    case 64: return k8_launch<T, 64>(q, k, v, o, B, H, group, S, st, scale, stream);
    case 128: return k8_launch<T, 128>(q, k, v, o, B, H, group, S, st, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch K8 on `stream`.  q, k, v and o are device pointers of one dtype
// (bf16 = 0: float32, 1: bfloat16) with a contiguous last dimension of d
// elements; `strides` is a host array of 12 element strides, (batch, head,
// row) of q, k, v and o in that order.  Returns the cudaError_t of the
// launch (0 on success); nothing is allocated and nothing synchronises.
extern "C" int k8_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int bf16, int B,
                                  int H, int Hkv, int S, int D,
                                  const void* strides, float scale,
                                  void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();   // clear any stale error first
  const long long* st = static_cast<const long long*>(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return k8_dispatch<__nv_bfloat16>(q, k, v, o, B, H, H / Hkv, S, D, st,
                                      scale, s);
  return k8_dispatch<float>(q, k, v, o, B, H, H / Hkv, S, D, st, scale, s);
}
