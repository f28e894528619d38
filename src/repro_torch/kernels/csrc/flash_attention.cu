// K8 on Hopper: causal GQA flash attention.
//
// Replaces repro/kernels/legacy/flash_attention.py:flash_attention_pallas
// (body _kernel): for each (batch, head) out = softmax(q k^T * scale,
// causal) v over q (B, H, S, d), k (B, Hkv, S, d) and v (B, Hkv, S, dv) with
// Hkv | H, the kv head of query head h being h / (H / Hkv), as the Pallas
// BlockSpec index maps have it; the output is (B, H, S, dv).  The same
// constants as the TPU kernel: masked scores are -1e30 (not -inf), the
// denominator is max(l, 1e-30), and the output is cast to q's dtype.  Every
// score, probability and sum is float32.  Inputs are addressed through
// (batch, head, row) strides in elements and a contiguous last dimension, so
// the model's (B, S, H, d) activations go in without a copy; the output is
// written through strides of its own.  Every kernel below walks, per block,
// the kv tiles from the first up to the diagonal and stops there (the TPU
// kernel skips the tiles above it with @pl.when), and schedules the q tiles
// with the longest walks first.
//
// Compiled (d, dv) pairs: (16, 16), (32, 32), (64, 64), (128, 128) (the GQA
// configs), (48, 32) (the DeepSeek-V2 smoke configs' absorbed MLA: kv_lora 32
// + rope 16 scored, kv_lora read as the values) and (576, 512) (DeepSeek-V2's
// absorbed MLA: kv_lora 512 + rope 64, one kv head for all query heads).
// k8_flash_attention refuses any other pair.
//
// Bound on this card (H100 SXM).  At the Jamba prefill, B = 2, H = 32,
// Hkv = 8, S = 4096, d = 128, bf16: the causal half of Q K^T and of P V is
// ~275 GFLOP, 0.278 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// ~168 MB of Q, K, V and O (0.05 ms at 3.35 TB/s; hbm_traffic_bytes in
// flash_attention.py): operations bound it.  At DeepSeek-V2-Lite's prefill,
// B = 2, H = 16, Hkv = 1, S = 4096, (d, dv) = (576, 512): ~292 GFLOP, 0.30
// ms, against ~303 MB (0.09 ms): operations again.
//
// bfloat16, d <= 128: k8_flash_mma_kernel, on the tensor cores
// (FlashAttention-2's structure on mma.sync).
//  * One block of 4 warps per (q tile of 64 rows, head, batch); warp w owns
//    rows 16w .. 16w + 15 of the tile.  Q, K and V stay bf16 in shared
//    memory, rows padded to d + 8 (V: dv + 8) elements so that the eight rows
//    each ldmatrix phase reads fall on distinct 16-byte bank groups.  At d =
//    128 a block holds 85 KiB (Q once, K and V twice), so two blocks share
//    an SM.
//  * Q is loaded once and kept as A fragments in registers.  K and V tiles
//    come through cp.async, 16 bytes a thread, double-buffered: tile i + 1
//    is in flight while tile i is computed.  Rows at or past S are filled
//    with zeros by the copy itself (source size 0), so any S >= 1 works.
//  * S = Q K^T by mma.sync.m16n8k16 (bf16 x bf16 -> float32), K fragments
//    by ldmatrix.  A bf16 x bf16 product is exact in float32, so only the
//    order of the sums differs from the CUDA-core kernel.
//  * Scale, the causal mask on the diagonal tile (-1e30 for a key past the
//    row or past S) and the online softmax run on the accumulator fragments
//    in registers: a row lives on the four lanes of a quad, so its max and
//    sum are two shuffles; l accumulates the float32 probabilities.  The
//    softmax runs in base 2, log2(e) folded into the scale, so each
//    probability is one exp2f (a few instructions) where the precise expf
//    took about ten: the loop issues several times more other instructions
//    than MMAs, so each one saved counts.
//  * P V reuses the score fragments as the A operand, with no trip through
//    shared memory.  P rounded to bf16 would add up to 2^-9 relative error
//    per term, more than the per-element bound the kernel is held to
//    (2^-8 |want| + 2e-5 of the peak, of which the output's own rounding
//    takes most), so P is split into hi = bf16(p) and lo = bf16(p - hi) and
//    both are multiplied by V (ldmatrix.trans fragments) into the float32
//    O fragments: P keeps ~16 significant bits.  That makes P V two
//    products, ~412 GFLOP of MMAs in all at the Jamba prefill.
//  * Epilogue: O / max(l, 1e-30) by IEEE division, rounded to bf16 and
//    stored two elements at a time.
//  * wgmma, TMA and a producer warp are later work.
//
// bfloat16, (576, 512): k8_flash_mla_kernel, the same arithmetic (scores,
// base-2 online softmax, P hi + lo, constants) in a layout of its own,
// because the d <= 128 one breaks there: Q as A fragments would be 144
// registers a lane, a 64-row O accumulator 256 registers a lane at 4 warps,
// and Q plus double-buffered 64-row K and V tiles 374 KB of shared memory
// against 227 KB.
//  * One block of 8 warps (two warpgroups) per (q tile of 64 rows, head,
//    batch): warp w owns rows 16 (w % 4) .. + 15 and output columns
//    256 (w / 4) .. + 255, so a lane keeps 32 x 4 = 128 float32
//    accumulators.
//  * Q stays in shared memory and is read by ldmatrix for every k-step of
//    every kv tile (36 k-steps of 16).  kv tiles are 32 rows, double-
//    buffered by cp.async: Q 74.8 KB + 2 x (K 37.4 + V 33.3) KB = 216 KB,
//    one block an SM.
//  * Both warpgroups compute the same 16 x 32 score tile of their rows and
//    the same softmax (the same instructions on the same data, so the same
//    bits), and each multiplies its P by its 256 columns of V, four
//    16-column fragments at a time.  That spends 36% more MMAs than
//    computing P once and passing it through shared memory, and needs no
//    exchange and no barrier beyond the tile's.
//  * The diagonal: the last two kv tiles of a q tile carry the causal mask
//    (and any key past S); a warp whose rows all precede a tile computes it
//    and adds exact zeros.
//  * wgmma/TMA, one K/V load shared by all query heads of the kv head, V
//    read as the first dv columns of the K tile and P shared between the
//    warpgroups are later work.
//
// float32: k8_flash_kernel, on CUDA cores (TF32 operands would miss the
// 2e-5-of-the-peak agreement float32 is held to).  One block of 256 threads
// per (q tile, head, batch); the Q tile is staged in shared memory once, as
// float32, each K and V tile per step; m, l and the (BT, dv) accumulator
// stay in registers: thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i
// (i < BT / 16), and in the score tile columns tx + 16 j (j < BT / 16), in
// the accumulator columns tx + 16 j (j < dv / 16).  A row's max and sum are
// shuffle reductions over the 16 lanes that share ty; the probabilities go
// through shared memory to the P.V product.  score = (q . k) * scale summed
// in order over d by FMAs, precise expf.  Tiles are BT = 64 rows and keys
// (at d = 128 the block holds 115 KiB), and BT = 32 at (576, 512), where a
// 64-row float32 Q tile alone is 147 KB (BT = 32: 214 KiB).  At the 67
// TFLOP/s FP32 peak it cannot come under ~4 ms at the Jamba prefill's
// shape; it serves the float32 parity prefills.
//
// Measured times of all three are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define K8_BQ 64
#define K8_BK 64
#define K8_THREADS 256
#define K8_MMA_THREADS 128
#define K8_NEG_INF (-1e30f)
#define K8_MLA_BQ 64
#define K8_MLA_BK 32
#define K8_MLA_THREADS 256

struct K8Strides {
  long long b, h, s;   // elements between batches, heads and rows
};

// -- float32 on CUDA cores -----------------------------------------------------

// q and kv tile rows of the float32 kernel at (d, dv)
template <int D>
constexpr int k8_f32_tile() {
  return D > 256 ? 32 : 64;
}

template <int D, int DV, int BT>
constexpr int k8_smem_floats() {
  return BT * (D + 4) + BT * (D + 4) + BT * DV + BT * (BT + 4);
}

__device__ __forceinline__ float k8_load(const float* p) { return *p; }
__device__ __forceinline__ void k8_store(float* p, float v) { *p = v; }

template <typename T, int D, int DV, int BT>
__global__ void __launch_bounds__(K8_THREADS)
k8_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int S, int group,
                K8Strides qs, K8Strides ks, K8Strides vs, K8Strides os,
                float scale) {
  constexpr int QS = D + 4;       // row stride of the Q and K tiles
  constexpr int PS = BT + 4;      // row stride of the P tile
  constexpr int RI = BT / 16;     // rows (and score columns) per thread
  constexpr int J = DV / 16;      // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                       // [BT][QS]
  float* kt = qt + BT * QS;               // [BT][QS]
  float* vt = kt + BT * QS;               // [BT][DV]
  float* pt = vt + BT * DV;               // [BT][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qi * BT;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BT * D; e += K8_THREADS) {
    const int r = e / D;
    const int c = e - r * D;
    const int s = q0 + r;
    qt[r * QS + c] = s < S ? k8_load(qb + s * qs.s + c) : 0.f;
  }

  float m[RI], l[RI], acc[RI][J];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = K8_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  }

  // kv tile ki holds columns ki*BT .. ki*BT+BT-1: visible to some row of
  // this q tile iff ki <= qi (equal tile sizes), so the walk stops at the
  // diagonal
  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * BT;
    __syncthreads();    // the last tile's readers of kt, vt and pt are done
    for (int e = tid; e < BT * D; e += K8_THREADS) {
      const int r = e / D;
      const int c = e - r * D;
      const int s = k0 + r;
      kt[r * QS + c] = s < S ? k8_load(kb + s * ks.s + c) : 0.f;
    }
    for (int e = tid; e < BT * DV; e += K8_THREADS) {
      const int r = e / DV;
      const int c = e - r * DV;
      const int s = k0 + r;
      vt[r * DV + c] = s < S ? k8_load(vb + s * vs.s + c) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16i against columns tx + 16j
    float sc[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float4 qv[RI], kv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qt + (ty + 16 * i) * QS + c);
#pragma unroll
      for (int j = 0; j < RI; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * QS + c);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
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
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = K8_NEG_INF;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
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
      for (int j = 0; j < RI; ++j) {
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
      for (int j = 0; j < RI; ++j)
        pt[(ty + 16 * i) * PS + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

    // acc += P V over the tile's BT kv rows
#pragma unroll 2
    for (int c = 0; c < BT; c += 4) {
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(pt + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[J];
#pragma unroll
        for (int j = 0; j < J; ++j) vv[j] = vt[(c + cc) * DV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
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
  for (int i = 0; i < RI; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < J; ++j)
        k8_store(ob + s * os.s + tx + 16 * j, acc[i][j] / denom);
    }
  }
}

// -- bfloat16 on the tensor cores --------------------------------------------

__device__ __forceinline__ uint32_t k8_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (source size 0).
__device__ __forceinline__ void k8_cp_async16(void* dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   k8_smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void k8_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void k8_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void k8_ldmatrix_x4(uint32_t (&r)[4],
                                               const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(k8_smem_addr(p)));
}
__device__ __forceinline__ void k8_ldmatrix_x4_trans(uint32_t (&r)[4],
                                                     const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(k8_smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void k8_mma(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t k8_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (p0, p1) -> hi = bf16(p), lo = bf16(p - hi), each packed low element first
__device__ __forceinline__ void k8_split(float p0, float p1, uint32_t& hi,
                                         uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = k8_bits(h);
  lo = k8_bits(__floats2bfloat162_rn(p0 - __low2float(h),
                                     p1 - __high2float(h)));
}

// the P fragments (hi, lo) of k-step kk (16 keys) from the score n-tiles
__device__ __forceinline__ void k8_split_frag(const float (&s0)[4],
                                              const float (&s1)[4],
                                              uint32_t (&ph)[4],
                                              uint32_t (&pl)[4]) {
  k8_split(s0[0], s0[1], ph[0], pl[0]);
  k8_split(s0[2], s0[3], ph[1], pl[1]);
  k8_split(s1[0], s1[1], ph[2], pl[2]);
  k8_split(s1[2], s1[3], ph[3], pl[3]);
}

// rows r0 .. r0 + rows - 1 of src (16-byte chunks `ch` a row, source row
// stride rs) into dst (row stride ld), from `threads` threads; rows >= S
// become zeros
__device__ __forceinline__ void k8_load_rows(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long rs, int r0, int rows,
                                             int ch, int ld, int S, int tid,
                                             int threads) {
  for (int c = tid; c < rows * ch; c += threads) {
    const int r = c / ch;
    const int col = (c - r * ch) * 8;
    const int s = r0 + r;
    k8_cp_async16(dst + r * ld + col, src + (s < S ? s : 0) * rs + col,
                  s < S);
  }
}

// Scale, causal mask (where `diag`) and the base-2 online softmax of a
// warp's score fragments sc[NJ][4] (rows row0 and row1 = row0 + 8, keys k0
// + 8 j + 2 t + e % 2): sc becomes P, m and l are updated, and the rows'
// corrections are returned in c0 and c1.
template <int NJ>
__device__ __forceinline__ void k8_softmax(float (&sc)[NJ][4], bool diag,
                                           int k0, int row0, int row1, int t,
                                           int S, float scale_log2,
                                           float& m0, float& m1, float& l0,
                                           float& l1, float& c0, float& c1) {
  float mx0 = K8_NEG_INF, mx1 = K8_NEG_INF;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = __fmul_rn(sc[j][e], scale_log2);
      if (diag) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        if (kpos > (e < 2 ? row0 : row1) || kpos >= S) s = K8_NEG_INF;
      }
      sc[j][e] = s;
      if (e < 2) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  c0 = exp2f(m0 - mn0);
  c1 = exp2f(m1 - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[j][e] - (e < 2 ? mn0 : mn1));
      sc[j][e] = p;
      if (e < 2) rs0 += p; else rs1 += p;
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
  }
  l0 = fmaf(l0, c0, rs0);
  l1 = fmaf(l1, c1, rs1);
  m0 = mn0;
  m1 = mn1;
}

template <int D, int DV>
constexpr int k8_mma_smem_bytes() {
  return ((K8_BQ + 2 * K8_BK) * (D + 8) + 2 * K8_BK * (DV + 8)) * 2;
}

template <int D, int DV>
__global__ void __launch_bounds__(K8_MMA_THREADS, 2)
k8_flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int S, int group,
                    K8Strides qs, K8Strides ks, K8Strides vs, K8Strides os,
                    float scale) {
  constexpr int LD = D + 8;       // row stride of the Q and K tiles
  constexpr int LDV = DV + 8;     // row stride of the V tiles
  constexpr int CH = D / 8;       // 16-byte chunks per Q or K row
  constexpr int CHV = DV / 8;     // 16-byte chunks per V row
  constexpr int KS = D / 16;      // k-steps of Q K^T
  constexpr int NT = DV / 8;      // n-tiles of O
  extern __shared__ __align__(16) unsigned char k8_smem[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(k8_smem);  // [BQ][LD]
  __nv_bfloat16* kt = qt + K8_BQ * LD;       // [2][BK][LD]
  __nv_bfloat16* vt = kt + 2 * K8_BK * LD;   // [2][BK][LDV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;        // fragment row (and row + 8)
  const int t = lane & 3;         // fragment column pair
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qi * K8_BQ;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;

  k8_load_rows(qt, qb, qs.s, q0, K8_BQ, CH, LD, S, tid, K8_MMA_THREADS);
  k8_load_rows(kt, kb, ks.s, 0, K8_BK, CH, LD, S, tid, K8_MMA_THREADS);
  k8_load_rows(vt, vb, vs.s, 0, K8_BK, CHV, LDV, S, tid, K8_MMA_THREADS);
  k8_cp_async_commit();

  uint32_t qf[KS][4];
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = K8_NEG_INF, m1 = K8_NEG_INF, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + warp * 16 + g;   // this thread's two rows
  const float scale_log2 = __fmul_rn(scale, 1.4426950408889634f);
  const int row1 = row0 + 8;

  for (int ki = 0; ki <= qi; ++ki) {
    const int buf = ki & 1;
    const int k0 = ki * K8_BK;
    if (ki < qi) {     // the next tile flies while this one is computed
      k8_load_rows(kt + (buf ^ 1) * K8_BK * LD, kb, ks.s, k0 + K8_BK, K8_BK,
                   CH, LD, S, tid, K8_MMA_THREADS);
      k8_load_rows(vt + (buf ^ 1) * K8_BK * LDV, vb, vs.s, k0 + K8_BK, K8_BK,
                   CHV, LDV, S, tid, K8_MMA_THREADS);
      k8_cp_async_commit();
      k8_cp_async_wait<1>();
    } else {
      k8_cp_async_wait<0>();
    }
    __syncthreads();
    if (ki == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        k8_ldmatrix_x4(qf[kk], qt + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                   (lane >> 4) * 8);
    }
    const __nv_bfloat16* kc = kt + buf * K8_BK * LD;
    const __nv_bfloat16* vc = vt + buf * K8_BK * LDV;

    // scores of the warp's 16 rows against the tile's 64 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        k8_ldmatrix_x4(kf, kc + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        k8_mma(sc[2 * np], qf[kk], kf[0], kf[1]);
        k8_mma(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // scale, causal mask (diagonal tile only), online softmax per row, in
    // base 2: s = score * scale * log2(e), p = 2^(s - m)
    float c0, c1;
    k8_softmax<8>(sc, ki == qi, k0, row0, row1, t, S, scale_log2, m0, m1, l0,
                  l1, c0, c1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }

    // O += P_hi V + P_lo V, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      k8_split_frag(sc[2 * kk], sc[2 * kk + 1], ph, pl);
      uint32_t vf[DV / 16][4];
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp)
        k8_ldmatrix_x4_trans(vf[dp], vc + (kk * 16 + (lane & 15)) * LDV +
                                         dp * 16 + (lane >> 4) * 8);
      // all hi products, then all lo: consecutive MMAs are independent, so
      // none waits for another's result
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        k8_mma(oacc[2 * dp], ph, vf[dp][0], vf[dp][1]);
        k8_mma(oacc[2 * dp + 1], ph, vf[dp][2], vf[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        k8_mma(oacc[2 * dp], pl, vf[dp][0], vf[dp][1]);
        k8_mma(oacc[2 * dp + 1], pl, vf[dp][2], vf[dp][3]);
      }
    }
    __syncthreads();    // every warp is done with this buffer
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os.s + col) =
          __floats2bfloat162_rn(oacc[n][0] / d0, oacc[n][1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * os.s + col) =
          __floats2bfloat162_rn(oacc[n][2] / d1, oacc[n][3] / d1);
  }
}

template <int D, int DV>
constexpr int k8_mla_smem_bytes() {
  return (K8_MLA_BQ * (D + 8) + 2 * K8_MLA_BK * (D + 8) +
          2 * K8_MLA_BK * (DV + 8)) * 2;
}

template <int D, int DV>
__global__ void __launch_bounds__(K8_MLA_THREADS, 1)
k8_flash_mla_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int S, int group,
                    K8Strides qs, K8Strides ks, K8Strides vs, K8Strides os,
                    float scale) {
  constexpr int LD = D + 8;       // row stride of the Q and K tiles
  constexpr int LDV = DV + 8;     // row stride of the V tiles
  constexpr int CH = D / 8;       // 16-byte chunks per Q or K row
  constexpr int CHV = DV / 8;     // 16-byte chunks per V row
  constexpr int KS = D / 16;      // k-steps of Q K^T
  constexpr int DVW = DV / 2;     // output columns of a warpgroup
  constexpr int NT = DVW / 8;     // n-tiles of a warp's O
  constexpr int NJ = K8_MLA_BK / 8;   // n-tiles of a score tile
  static_assert(D % 16 == 0 && DVW % 64 == 0, "k8_flash_mla_kernel shapes");
  extern __shared__ __align__(16) unsigned char k8_smem[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(k8_smem);  // [BQ][LD]
  __nv_bfloat16* kt = qt + K8_MLA_BQ * LD;       // [2][BK][LD]
  __nv_bfloat16* vt = kt + 2 * K8_MLA_BK * LD;   // [2][BK][LDV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp & 3;        // row group: rows 16 wr .. 16 wr + 15
  const int half = warp >> 2;     // warpgroup: columns half * DVW ..
  const int lane = tid & 31;
  const int g = lane >> 2;        // fragment row (and row + 8)
  const int t = lane & 3;         // fragment column pair
  const int qi = gridDim.x - 1 - blockIdx.x;   // longest walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qi * K8_MLA_BQ;
  // kv tiles up to the one holding the tile's last row (or S - 1)
  const int nkv = (min(q0 + K8_MLA_BQ, S) - 1) / K8_MLA_BK + 1;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;

  k8_load_rows(qt, qb, qs.s, q0, K8_MLA_BQ, CH, LD, S, tid, K8_MLA_THREADS);
  k8_load_rows(kt, kb, ks.s, 0, K8_MLA_BK, CH, LD, S, tid, K8_MLA_THREADS);
  k8_load_rows(vt, vb, vs.s, 0, K8_MLA_BK, CHV, LDV, S, tid, K8_MLA_THREADS);
  k8_cp_async_commit();

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = K8_NEG_INF, m1 = K8_NEG_INF, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + wr * 16 + g;     // this thread's two rows
  const int row1 = row0 + 8;
  const float scale_log2 = __fmul_rn(scale, 1.4426950408889634f);
  const __nv_bfloat16* qrow = qt + (wr * 16 + (lane & 15)) * LD +
                              (lane >> 4) * 8;

  for (int ki = 0; ki < nkv; ++ki) {
    const int buf = ki & 1;
    const int k0 = ki * K8_MLA_BK;
    if (ki + 1 < nkv) {    // the next tile flies while this one is computed
      k8_load_rows(kt + (buf ^ 1) * K8_MLA_BK * LD, kb, ks.s, k0 + K8_MLA_BK,
                   K8_MLA_BK, CH, LD, S, tid, K8_MLA_THREADS);
      k8_load_rows(vt + (buf ^ 1) * K8_MLA_BK * LDV, vb, vs.s,
                   k0 + K8_MLA_BK, K8_MLA_BK, CHV, LDV, S, tid,
                   K8_MLA_THREADS);
      k8_cp_async_commit();
      k8_cp_async_wait<1>();
    } else {
      k8_cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kc = kt + buf * K8_MLA_BK * LD;
    const __nv_bfloat16* vc = vt + buf * K8_MLA_BK * LDV;

    // scores of the warp's 16 rows against the tile's 32 keys, Q fragments
    // read from shared memory at every k-step
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4];
      k8_ldmatrix_x4(qf, qrow + kk * 16);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t kf[4];
        k8_ldmatrix_x4(kf, kc + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        k8_mma(sc[2 * np], qf, kf[0], kf[1]);
        k8_mma(sc[2 * np + 1], qf, kf[2], kf[3]);
      }
    }

    // the last two tiles of the walk may hold keys past a row (or past S)
    float c0, c1;
    k8_softmax<NJ>(sc, k0 + K8_MLA_BK - 1 > q0, k0, row0, row1, t, S,
                   scale_log2, m0, m1, l0, l1, c0, c1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }

    // O[:, half] += P_hi V[:, half] + P_lo V[:, half], 16 keys per k-step,
    // four 16-column V fragments at a time
#pragma unroll
    for (int kk = 0; kk < K8_MLA_BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      k8_split_frag(sc[2 * kk], sc[2 * kk + 1], ph, pl);
      const __nv_bfloat16* vrow = vc + (kk * 16 + (lane & 15)) * LDV +
                                  half * DVW + (lane >> 4) * 8;
#pragma unroll
      for (int dc = 0; dc < DVW / 16; dc += 4) {
        uint32_t vf[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          k8_ldmatrix_x4_trans(vf[u], vrow + (dc + u) * 16);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          k8_mma(oacc[2 * (dc + u)], ph, vf[u][0], vf[u][1]);
          k8_mma(oacc[2 * (dc + u) + 1], ph, vf[u][2], vf[u][3]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          k8_mma(oacc[2 * (dc + u)], pl, vf[u][0], vf[u][1]);
          k8_mma(oacc[2 * (dc + u) + 1], pl, vf[u][2], vf[u][3]);
        }
      }
    }
    __syncthreads();    // every warp is done with this buffer
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = half * DVW + n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os.s + col) =
          __floats2bfloat162_rn(oacc[n][0] / d0, oacc[n][1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * os.s + col) =
          __floats2bfloat162_rn(oacc[n][2] / d1, oacc[n][3] / d1);
  }
}

// the dynamic shared-memory allowance of `kernel` raised to `smem` bytes
template <typename K>
static int k8_allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, int DV>
static int k8_launch_f32(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int group, int S,
                         const K8Strides* st, float scale,
                         cudaStream_t stream) {
  constexpr int BT = k8_f32_tile<D>();
  const size_t smem = sizeof(float) * k8_smem_floats<D, DV, BT>();
  const int err = k8_allow_smem(k8_flash_kernel<float, D, DV, BT>, smem);
  if (err) return err;
  const dim3 grid((S + BT - 1) / BT, H, B);
  k8_flash_kernel<float, D, DV, BT><<<grid, K8_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, group, st[0],
      st[1], st[2], st[3], scale);
  return (int)cudaGetLastError();
}

template <int D, int DV>
static int k8_launch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int H, int group, int S,
                          const K8Strides* st, float scale,
                          cudaStream_t stream) {
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  if constexpr (D > 256) {
    const size_t smem = k8_mla_smem_bytes<D, DV>();
    const int err = k8_allow_smem(k8_flash_mla_kernel<D, DV>, smem);
    if (err) return err;
    const dim3 grid((S + K8_MLA_BQ - 1) / K8_MLA_BQ, H, B);
    k8_flash_mla_kernel<D, DV><<<grid, K8_MLA_THREADS, smem, stream>>>(
        qp, kp, vp, op, S, group, st[0], st[1], st[2], st[3], scale);
  } else {
    const size_t smem = k8_mma_smem_bytes<D, DV>();
    const int err = k8_allow_smem(k8_flash_mma_kernel<D, DV>, smem);
    if (err) return err;
    const dim3 grid((S + K8_BQ - 1) / K8_BQ, H, B);
    k8_flash_mma_kernel<D, DV><<<grid, K8_MMA_THREADS, smem, stream>>>(
        qp, kp, vp, op, S, group, st[0], st[1], st[2], st[3], scale);
  }
  return (int)cudaGetLastError();
}

template <int D, int DV>
static int k8_launch(const void* q, const void* k, const void* v, void* o,
                     int bf16, int B, int H, int group, int S,
                     const K8Strides* st, float scale, cudaStream_t stream) {
  return bf16 ? k8_launch_bf16<D, DV>(q, k, v, o, B, H, group, S, st, scale,
                                      stream)
              : k8_launch_f32<D, DV>(q, k, v, o, B, H, group, S, st, scale,
                                     stream);
}

// Launch K8 on `stream`.  q, k, v and o are device pointers of one dtype
// (bf16 = 0: float32, on CUDA cores; 1: bfloat16, on the tensor cores) with
// a contiguous last dimension: d elements for q and k, dv for v and o;
// `strides` is a host array of 12 element strides, (batch, head, row) of q,
// k, v and o in that order.  For bfloat16 the q, k and v pointers and their
// strides must be multiples of 16 bytes (the wrapper sees to it).  Returns
// the cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// (d, dv) pair that is not compiled); nothing is allocated and nothing
// synchronises.
extern "C" int k8_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int bf16, int B,
                                  int H, int Hkv, int S, int D, int DV,
                                  const void* strides, float scale,
                                  void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();   // clear any stale error first
  const long long* p = static_cast<const long long*>(strides);
  const K8Strides st[4] = {{p[0], p[1], p[2]}, {p[3], p[4], p[5]},
                           {p[6], p[7], p[8]}, {p[9], p[10], p[11]}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / Hkv;
#define K8_PAIR(d, dv)                                                     \
  if (D == d && DV == dv)                                                  \
    return k8_launch<d, dv>(q, k, v, o, bf16, B, H, group, S, st, scale, s);
  K8_PAIR(16, 16)
  K8_PAIR(32, 32)
  K8_PAIR(64, 64)
  K8_PAIR(128, 128)
  K8_PAIR(48, 32)
  K8_PAIR(576, 512)
#undef K8_PAIR
  return (int)cudaErrorInvalidValue;
}
