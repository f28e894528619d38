// K1w and K4w on Hopper: the fused RK4 rollouts of K1 and K4 at widths
// whose weights do not fit one block, on thread-block clusters.
//
// Replace, at such widths, repro/kernels/fused_ode_mlp.py:fused_node_rollout
// (K1w) and repro/kernels/fused_analogue.py:fused_analogue_rollout (K4w).
// The Pallas kernels hold the Lorenz96 twin of the paper's scorecard,
// 6->512->512->6 (1.07 MB of float32 weights), in their 14 MiB of VMEM; a
// Hopper block has 227 KB, so the resident kernels (fused_ode_mlp.cu,
// fused_analogue.cu) refuse it and the wrappers' launch_geometry sends it
// here.  They compute what K1 and K4 compute: out (T+1, B, D) float32, row 0
// = y0, the RK4 trajectory of dy/dt = MLP([u(t), y]), K4 through the
// crossbar read semantics of fused_analogue.cu (scale, drift, clamp, uint8
// levels, stuck cells at their global ids, read noise from K4's pre-pass).
//
// Design: one cluster of C CTAs (C = 8, the portable maximum) owns RT twins
// (1, or 4 once the fleet fills the card) for all T steps; the CTAs split
// every layer between them and keep their slices of the weights in shared
// memory for all 4 T evaluations (distributed shared memory joins them):
//  * layer 0 (in_0 -> h_1, in_0 the few state and drive columns) is cheap,
//    so every CTA computes all of h_1 itself: no exchange before layer 1;
//  * a hidden-to-hidden layer l is split by output columns: the CTA of rank
//    c owns columns [c q, c q + q) (q = ceil(width / C) padded to 4), reads
//    its whole input locally and writes its slice of h_{l+1}; a second one
//    (MLPs deeper than the twins') first gathers h_l from every CTA
//    (cluster barrier, map_shared_rank);
//  * the last layer is split by rows: rank c sums the rows of its own slice
//    of h_{L-1} into partials of all D outputs; after one cluster barrier
//    every CTA adds the C partials in rank order, then the bias, so every
//    CTA holds the same bits of k and runs the same RK4 update on its
//    replica of the state; rank 0 writes the trajectory.
//  At 6->512->512->6 an evaluation is one cluster barrier and three block
//  barriers; a CTA holds W1 (7 x 512), its 513 x 64 slice of W2, its 64 x 6
//  rows of W3 and the bias of W3: 158,880 B at four twins.  The partials are
//  double-buffered by stage, so a CTA can write stage n + 1's while a slower
//  one still reads stage n's; a last cluster barrier keeps every CTA's
//  shared memory alive until the others are done reading it.
//  * Products: fused_mlp_eval.cuh's fm_matvec on a product table built per
//    rank (the team split depends on the reduction length alone), so a
//    trajectory does not depend on RT; h_1 and the hidden slices are summed
//    as K1 sums them, the last layer as C rank partials, so the result
//    differs from the resident K1 in the last layer's summation order only.
//  * K4w noise-free: each CTA combines its slice of every pair once,
//    (G+ - G-)[* g_step] * (1/scale), stuck cells at their global
//    (layer, row, column) ids, as fused_analogue.cu does.
//  * K4w under read noise: the resident K4's pre-pass (k4_noise_kernel, the
//    same layout and time chunks, fused_analogue.noise_chunk_steps) writes
//    every evaluation's noisy pairs S, keyed by global ids; each CTA streams
//    its slices of evaluation n + 1's S by 16-byte cp.async into the layer's
//    one buffer as soon as evaluation n has finished with that layer, so the
//    copy overlaps the rest of evaluation n (one copy group per layer in
//    flight; no double buffer fits beside the 131 KB of a W2 slice).
//  * Deterministic: no atomics, fixed summation orders, the RK4 and read
//    arithmetic in __fmul_rn / __fadd_rn as the resident kernels.
//  * Launched with cudaLaunchKernelEx and a cluster-dimension attribute;
//    cudaOccupancyMaxActiveClusters is asked first, and a cluster the card
//    cannot schedule returns an error instead of a silent fallback.
//
// Bound on this card (H100 SXM), the scorecard's Lorenz96 twin (B = 1,
// T = 1800): 7200 evaluations x 268,288 MACs = 3.86 GFLOP, 0.058 ms at the
// 67 TFLOP/s FP32 peak; the 1.07 MB of weights and the 43 KB trajectory are
// 0.33 us at 3.35 TB/s.  So the operations bound it; the kernel waits on its
// chain of 7200 dependent evaluations, each a cluster barrier and three
// block barriers on a 128-thread CTA (measured times in PERF.md).  At the
// fleet shape (B = 1024, T = 50) 110 GFLOP, 1.64 ms at the peak.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"
#include "fused_mlp_eval.cuh"

namespace cg = cooperative_groups;

#define KW_MAX_THREADS 512
#define KW_MAX_CLUSTER 8
#define KW_SMEM_LIMIT 232448
// Words of the per-rank product table at the start of shared memory.
#define KW_OPS_WORDS (FM_MAX_LAYERS * 8)

// Where a CTA keeps its slices (floats from the start of dynamic shared
// memory): the product table, then per layer the rows of its slice, row
// stride ws, and the bias row.  Layer 0 is whole; a hidden-to-hidden layer
// l holds all in_l rows of its q[l+1] columns; the last layer holds q[L-1]
// rows (its slice of h_{L-1}) of all D columns, and the whole last bias.
struct KwLayout {
  int L, C;
  int sizes[FM_MAX_LAYERS + 1];
  int q[FM_MAX_LAYERS + 1];    // slice of hidden width l (1 <= l < L), % 4 == 0
  int w[FM_MAX_LAYERS];
  int ws[FM_MAX_LAYERS];
  int b[FM_MAX_LAYERS];
  int src[FM_MAX_LAYERS];      // layer l in one evaluation of the pre-pass
  int total;                   // floats of the table and the weights
  int hfull;                   // floats of a whole hidden vector per twin
  int qmax;                    // floats of a hidden slice per twin
};

__host__ __device__ inline int kw_count(int n, int q, int rank) {
  const int c = n - rank * q;
  return c < 0 ? 0 : (c < q ? c : q);
}

__host__ __device__ inline KwLayout kw_layout(const int* sizes, int L, int C) {
  KwLayout k = {};
  k.L = L;
  k.C = C;
  for (int l = 0; l <= FM_MAX_LAYERS; ++l) k.sizes[l] = l <= L ? sizes[l] : 0;
  for (int l = 1; l < L; ++l) k.q[l] = fm_round4((sizes[l] + C - 1) / C);
  int off = KW_OPS_WORDS, soff = 0;
  for (int l = 0; l < L; ++l) {
    const int din = sizes[l], dout = sizes[l + 1];
    k.src[l] = soff;
    soff += (din + 1) * fm_round4(dout);
    k.w[l] = off;
    if (l == 0 || l == L - 1) {
      k.ws[l] = fm_round4(dout);
      off += (l == 0 ? din : k.q[l]) * k.ws[l];
    } else {
      k.ws[l] = k.q[l + 1];
      off += din * k.ws[l];
    }
    k.b[l] = off;
    off += k.ws[l];
  }
  k.total = off;
  int hf = sizes[1];
  for (int l = 2; l + 1 < L; ++l) hf = hf > sizes[l] ? hf : sizes[l];
  k.hfull = fm_round4(hf);
  k.qmax = 0;
  for (int l = 2; l < L; ++l) k.qmax = k.qmax > k.q[l] ? k.qmax : k.q[l];
  return k;
}

// Floats of dynamic shared memory one CTA needs (fused_ode_mlp.wide_smem_bytes
// computes the same number): the layout, then the stage input, a whole
// hidden vector, two hidden slices, the partials of two stages, the state
// and the RK4 sum, and 2 tc + 1 half-steps of the drive, per twin.
static long long kw_smem_floats(const KwLayout& k, int rt, int tc) {
  const int D4 = fm_round4(k.sizes[k.L]);
  const int Du = k.sizes[0] - k.sizes[k.L];
  return (long long)k.total +
         (long long)rt * (fm_round4(k.sizes[0]) + k.hfull + 2 * k.qmax +
                          4 * D4) +
         fm_round4((2 * tc + 1) * Du * rt);
}

// Product l of rank `rank`: the whole layer 0, a column slice of a hidden
// layer, the row slice of the last layer (partials, no bias).
__device__ inline FmOp kw_op(const KwLayout& k, int l, int rank) {
  int n_red, n_out, bias;
  if (l == 0) {
    n_red = k.sizes[0];
    n_out = k.sizes[1];
    bias = k.b[0];
  } else if (l < k.L - 1) {
    n_red = k.sizes[l];
    n_out = kw_count(k.sizes[l + 1], k.q[l + 1], rank);
    bias = k.b[l];
  } else {
    n_red = kw_count(k.sizes[l], k.q[l], rank);
    n_out = k.sizes[k.L];
    bias = -1;
  }
  const int S = fm_ksplit(n_red);
  return FmOp{k.w[l], k.ws[l], n_red, n_out, bias,
              fm_matvec_lanes(n_red, n_out), fm_log2(S), fm_log2(32 / S)};
}

__device__ __forceinline__ FmOp kw_op_at(const float* smem, int l) {
  const int4 a = reinterpret_cast<const int4*>(smem)[2 * l];
  const int4 b = reinterpret_cast<const int4*>(smem)[2 * l + 1];
  return FmOp{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// The region of layer l one CTA holds: rows [row0, row0 + nrows) and the
// bias row, columns [col0, col0 + ncols).
struct KwRegion {
  int row0, nrows, col0, ncols;
};

__device__ __forceinline__ KwRegion kw_region(const KwLayout& k, int l,
                                              int rank) {
  KwRegion g = {0, k.sizes[l], 0, k.sizes[l + 1]};
  if (l > 0 && l == k.L - 1) {
    g.row0 = rank * k.q[l];
    g.nrows = kw_count(k.sizes[l], k.q[l], rank);
  } else if (l > 0) {
    g.col0 = rank * k.q[l + 1];
    g.ncols = kw_count(k.sizes[l + 1], k.q[l + 1], rank);
  }
  return g;
}

// fn(shared offset, global row, global column) for every weight and bias of
// layer l this CTA holds (global row in_l: the bias).
template <class Fn>
__device__ __forceinline__ void kw_for_slice(const KwLayout& k, int l,
                                             int rank, Fn fn) {
  const KwRegion g = kw_region(k, l, rank);
  const int n = (g.nrows + 1) * g.ncols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / g.ncols, c = i - r * g.ncols;
    const bool bias = r == g.nrows;
    fn(bias ? k.b[l] + c : k.w[l] + r * k.ws[l] + c,
       bias ? k.sizes[l] : g.row0 + r, g.col0 + c);
  }
}

// ---------------------------------------------------------------------------
// Layer outputs.
// ---------------------------------------------------------------------------

// K1: sums + bias.
struct KwDenseOut {
  __device__ __forceinline__ float operator()(int, float a, float b) const {
    return __fadd_rn(a, b);
  }
};

// K4 (fused_analogue.cu's K4Out): sums + bias, times 1/scale under read
// noise, times the drift factor, then the clamp.
template <bool kNoisy> struct KwAnalogueOut {
  const float* inv_s;   // per layer, in shared memory
  float dfac, v_clamp;
  bool drift, clamp;
  __device__ __forceinline__ float operator()(int l, float a, float b) const {
    float v = __fadd_rn(a, b);
    if (kNoisy) v = __fmul_rn(v, inv_s[l]);
    if (drift) v = __fmul_rn(v, dfac);
    if (clamp) v = fminf(fmaxf(v, -v_clamp), v_clamp);
    return v;
  }
};

// A layer 0 or hidden slice's epilogue: the output, then ReLU.
template <int RT, class Out> struct KwHiddenEpi {
  float* out;
  int l;
  Out f;
  __device__ __forceinline__ void operator()(int j0, int n_out, int r,
                                             const float (&a)[4],
                                             float4 b4) const {
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j < n_out) {
        float v = f(l, a[c], b[c]);
        if (v < 0.0f) v = 0.0f;
        out[j * RT + r] = v;
      }
    }
  }
};

// The last layer's epilogue: the rank's partial sums as they are.
template <int RT> struct KwPartEpi {
  float* out;
  __device__ __forceinline__ void operator()(int j0, int n_out, int r,
                                             const float (&a)[4],
                                             float4) const {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + c < n_out) out[(j0 + c) * RT + r] = a[c];
  }
};

// ---------------------------------------------------------------------------
// Modes: where the weights come from, and the layer output.
// ---------------------------------------------------------------------------

// K1w: float32 weights and biases in device memory, (in_l, out_l) row-major.
struct KwK1 {
  static constexpr bool kStream = false;
  typedef KwDenseOut Out;
  const float* w[FM_MAX_LAYERS];
  const float* b[FM_MAX_LAYERS];
  __device__ __forceinline__ void setup(float*) const {}
  __device__ __forceinline__ Out out(const float*) const { return Out{}; }
  __device__ __forceinline__ void begin_step(Out&, int) const {}
  __device__ __forceinline__ void load(float* smem, const KwLayout& k,
                                       int rank, const float*) const {
    for (int l = 0; l < k.L; ++l) {
      const int din = k.sizes[l], dout = k.sizes[l + 1];
      const float* wl = w[l];
      const float* bl = b[l];
      kw_for_slice(k, l, rank, [&](int dst, int row, int col) {
        smem[dst] = row < din ? wl[row * dout + col] : bl[col];
      });
    }
  }
  __device__ __forceinline__ void fetch(float*, const KwLayout&, int, int,
                                        int) const {}
};

// The kernel's view of the pairs and of the read: fused_analogue.cu's
// K4Arrays and K4Read, field for field (the wrapper's ctypes struct
// _K4Read is laid out after K4Read).
struct KwArrays {
  const void* gp[FM_MAX_LAYERS];   // (in_l + 1, out_l) row-major, f32 or uint8
  const void* gm[FM_MAX_LAYERS];
  int sizes[FM_MAX_LAYERS + 1];
  int num_layers;
};

struct KwRead {
  float dt, dt2, dt6;
  int u8;
  float g_step, g_min, g_max;
  int has_clamp;
  float v_clamp;
  float read_noise;
  uint32_t noise_seed;
  float stuck_rate, stuck_on_frac;
  uint32_t fault_seed;
  long long salt_base;
  float drift_nu, drift_tau;
  long long drift_n0;
  long long step_offset;
};

__device__ __forceinline__ float kw_load(const void* p, int u8, int i) {
  return u8 ? (float)static_cast<const unsigned char*>(p)[i]
            : static_cast<const float*>(p)[i];
}

// Element i of layer l's pair before the combination (fused_analogue.cu's
// k4_pair): stored values, absolute conductances where stuck cells need
// them, the stuck cells pinned at their global ids.
__device__ __forceinline__ void kw_pair(const KwArrays& arr, const KwRead& rd,
                                        bool absolute, int l, int i, float& a,
                                        float& b) {
  a = kw_load(arr.gp[l], rd.u8, i);
  b = kw_load(arr.gm[l], rd.u8, i);
  if (rd.u8 && absolute) {
    a = __fadd_rn(rd.g_min, __fmul_rn(a, rd.g_step));
    b = __fadd_rn(rd.g_min, __fmul_rn(b, rd.g_step));
  }
  if (rd.stuck_rate > 0.0f) {
    const uint32_t salt = (uint32_t)(rd.salt_base + 2 * l);
    a = stuck_at(a, rd.fault_seed, salt, (uint32_t)i, rd.stuck_rate,
                 rd.stuck_on_frac, rd.g_max, rd.g_min);
    b = stuck_at(b, rd.fault_seed, salt + 1, (uint32_t)i, rd.stuck_rate,
                 rd.stuck_on_frac, rd.g_max, rd.g_min);
  }
}

__device__ __forceinline__ void kw_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void kw_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n copy groups of this thread are in flight.
__device__ __forceinline__ void kw_wait_groups(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// K4w.  Noise-free (kNoisy false): the CTA's slices of the combined pairs,
// scale folded in.  Read noise: the slices of the pre-pass's S, streamed
// per evaluation (kStream).
template <bool kNoisy> struct KwK4 {
  static constexpr bool kStream = kNoisy;
  typedef KwAnalogueOut<kNoisy> Out;
  KwArrays arr;
  KwRead rd;
  const float* scales;
  const float* noise;   // the pre-pass's S of this launch's evaluations
  int ev_floats;        // floats of one evaluation's S
  int ev_count;         // evaluations of this launch (4 T)
  __device__ __forceinline__ void setup(float* inv_s) const {
    if ((int)threadIdx.x < arr.num_layers)
      inv_s[threadIdx.x] = __fdiv_rn(1.0f, scales[threadIdx.x]);
  }
  __device__ __forceinline__ Out out(const float* inv_s) const {
    Out f;
    f.inv_s = inv_s;
    f.dfac = 1.0f;
    f.v_clamp = rd.v_clamp;
    f.drift = rd.drift_nu > 0.0f;
    f.clamp = rd.has_clamp != 0;
    return f;
  }
  __device__ __forceinline__ void begin_step(Out& f, int t) const {
    if (f.drift) {
      const float n = (float)(rd.drift_n0 + 4 * (rd.step_offset + t));
      f.dfac = expf(__fmul_rn(-rd.drift_nu,
                              log1pf(__fdiv_rn(n, rd.drift_tau))));
    }
  }
  __device__ __forceinline__ void load(float* smem, const KwLayout& k,
                                       int rank, const float* inv_s) const {
    if (kNoisy) {
      for (int l = 0; l < k.L; ++l) fetch(smem, k, rank, l, 0);
      return;
    }
    const bool stuck = rd.stuck_rate > 0.0f;
    for (int l = 0; l < k.L; ++l) {
      const int dout = k.sizes[l + 1];
      const float inv = inv_s[l];
      kw_for_slice(k, l, rank, [&](int dst, int row, int col) {
        float a, b;
        kw_pair(arr, rd, stuck, l, row * dout + col, a, b);
        float g = __fsub_rn(a, b);
        if (rd.u8 && !stuck) g = __fmul_rn(g, rd.g_step);
        smem[dst] = __fmul_rn(g, inv);
      });
    }
  }
  // Under read noise: copy layer l's slices of evaluation e's S (rows of
  // round4(out_l) floats, the bias row last) into the layer's buffer, 16
  // bytes a copy, as one commit group (empty past the launch's last
  // evaluation, so that every layer's wait counts the same groups).
  __device__ __forceinline__ void fetch(float* smem, const KwLayout& k,
                                        int rank, int l, int e) const {
    if (kNoisy && e < ev_count) {
      const KwRegion g = kw_region(k, l, rank);
      const int nc4 = fm_round4(g.ncols) >> 2;
      const int stride = fm_round4(k.sizes[l + 1]);
      const float* S = noise + (long long)e * ev_floats + k.src[l];
      const int n = (g.nrows + 1) * nc4;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / nc4, c = 4 * (i - r * nc4);
        const bool bias = r == g.nrows;
        const int row = bias ? k.sizes[l] : g.row0 + r;
        kw_cp_async16(smem + (bias ? k.b[l] + c : k.w[l] + r * k.ws[l] + c),
                      S + row * stride + g.col0 + c);
      }
    }
    if (kNoisy) kw_commit();
  }
};

// ---------------------------------------------------------------------------
// The rollout.
// ---------------------------------------------------------------------------

template <int RT, class Mode>
__global__ void __launch_bounds__(KW_MAX_THREADS)
kw_rollout_kernel(const float* __restrict__ y0, const float* __restrict__ u,
                  float* __restrict__ out, const Mode mode, const KwLayout lay,
                  int B, int T, long long u_twin_stride, int tc, float dt,
                  float dt2, float dt6) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float inv_s[FM_MAX_LAYERS];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = lay.C;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = lay.L;
  const int D = lay.sizes[L];
  const int D4 = fm_round4(D);
  const int in0 = lay.sizes[0];
  const int Du = in0 - D;
  const int r0 = (int)(blockIdx.x / C) * RT;
  const int nr = min(RT, B - r0);

  float* xs = smem + lay.total;              // [in0][RT] stage input
  float* hf = xs + fm_round4(in0) * RT;      // [hfull][RT] whole h_1 / h_l
  float* hs = hf + lay.hfull * RT;           // 2 x [qmax][RT] hidden slices
  float* part = hs + 2 * lay.qmax * RT;      // 2 x [D4][RT] last-layer partials
  float* ys = part + 2 * D4 * RT;            // [D4][RT] state y_t
  float* acc = ys + D4 * RT;                 // [D4][RT] k1 + 2 k2 + 2 k3
  float* ubuf = acc + D4 * RT;               // [2 tc + 1][Du][RT] drive chunk
  const int nall = (int)(ubuf - smem) + fm_round4((2 * tc + 1) * Du * RT);

  for (int i = tid; i < nall; i += nt) smem[i] = 0.0f;
  __syncthreads();
  if (tid < L) {
    const FmOp o = kw_op(lay, tid, rank);
    int4* p = reinterpret_cast<int4*>(smem) + 2 * tid;
    p[0] = make_int4(o.m, o.ms, o.n_red, o.n_out);
    p[1] = make_int4(o.bias, o.lanes, o.s_log2, o.pw_log2);
  }
  mode.setup(inv_s);
  __syncthreads();
  mode.load(smem, lay, rank, inv_s);
  if (Du > 0 && T > 0)
    fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 0, 2 * min(tc, T) + 1, r0,
                       nr);
  for (int i = tid; i < D * RT; i += nt) {
    const int j = i / RT, r = i % RT;
    if (r < nr) {
      const float v = y0[(long long)(r0 + r) * D + j];
      ys[i] = v;
      xs[Du * RT + i] = v;                     // step 0's first input
      if (rank == 0) out[(long long)(r0 + r) * D + j] = v;   // row 0 = y0
    }
  }
  __syncthreads();
  for (int e = tid; e < Du * RT; e += nt) xs[e] = ubuf[e];
  __syncthreads();

  typename Mode::Out f = mode.out(inv_s);
  const int qlast = lay.q[L - 1];
  const float* hlast = (L == 2) ? hf + rank * qlast * RT
                                : hs + ((L - 2) & 1) * lay.qmax * RT;
  int c0 = 0;                                  // first step of the drive chunk
  for (int t = 0; t < T; ++t) {
    if (Du > 0 && t > 0 && t % tc == 0) {
      c0 = t;
      fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 2 * t,
                         2 * min(tc, T - t) + 1, r0, nr);
      __syncthreads();
    }
    mode.begin_step(f, t);
    float* out_next = out + ((long long)(t + 1) * B + r0) * D;
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * t + s;
      // layer 0: the stage input -> all of h_1
      if (Mode::kStream) {
        kw_wait_groups(L - 1);
        __syncthreads();
      }
      fm_matvec<RT, false>(kw_op_at(smem, 0), smem, xs, nt,
                           KwHiddenEpi<RT, typename Mode::Out>{hf, 0, f});
      __syncthreads();
      mode.fetch(smem, lay, rank, 0, n + 1);
      // hidden-to-hidden layers: this rank's columns of h_{l+1}, from the
      // whole h_l in hf
      for (int l = 1; l < L - 1; ++l) {
        if (l >= 2) {
          // gather h_l, sliced over the cluster, into hf
          cluster.sync();
          const float* prev = hs + ((l - 1) & 1) * lay.qmax * RT;
          const int q = lay.q[l];
          for (int i = tid; i < lay.sizes[l] * RT; i += nt) {
            const int j = i / RT;
            const int c = j / q;
            hf[i] =
                cluster.map_shared_rank(prev, c)[(j - c * q) * RT + i % RT];
          }
          __syncthreads();
        }
        if (Mode::kStream) {
          kw_wait_groups(L - 1);
          __syncthreads();
        }
        fm_matvec<RT, false>(
            kw_op_at(smem, l), smem, hf, nt,
            KwHiddenEpi<RT, typename Mode::Out>{
                hs + (l & 1) * lay.qmax * RT, l, f});
        __syncthreads();
        mode.fetch(smem, lay, rank, l, n + 1);
      }
      // the last layer: this rank's rows, into the stage's partials
      float* pn = part + (n & 1) * D4 * RT;
      if (Mode::kStream) {
        kw_wait_groups(L - 1);
        __syncthreads();
      }
      fm_matvec<RT, false>(kw_op_at(smem, L - 1), smem, hlast, nt,
                           KwPartEpi<RT>{pn});
      cluster.sync();
      // k = the partials in rank order + the bias, then RK4 as K1StepEpi
      const float cnext = (s == 2) ? dt : dt2;
      for (int i = tid; i < D * RT; i += nt) {
        const int j = i / RT, r = i % RT;
        // every rank's partial in flight at once, then the sum in rank order
        float pv[KW_MAX_CLUSTER];
#pragma unroll
        for (int c = 0; c < KW_MAX_CLUSTER; ++c)
          pv[c] = c < C ? cluster.map_shared_rank(pn, c)[i] : 0.0f;
        float p = pv[0];
#pragma unroll
        for (int c = 1; c < KW_MAX_CLUSTER; ++c)
          if (c < C) p = __fadd_rn(p, pv[c]);
        const float k = f(L - 1, p, smem[lay.b[L - 1] + j]);
        float v;
        if (s == 3) {
          v = __fadd_rn(ys[i], __fmul_rn(dt6, __fadd_rn(acc[i], k)));
          ys[i] = v;
          if (rank == 0 && r < nr) out_next[r * D + j] = v;
        } else {
          acc[i] = (s == 0) ? k : __fadd_rn(acc[i], __fmul_rn(2.0f, k));
          v = fm_stage_y(ys[i], cnext, k);
        }
        xs[(Du + j) * RT + r] = v;
      }
      // the drive columns of the next stage's input
      const int hn = 2 * t + (s == 2 || s == 3 ? 2 : 1);
      if (s < 3 || t + 1 < T)
        for (int e = tid; e < Du * RT; e += nt)
          xs[e] = ubuf[(hn - 2 * c0) * Du * RT + e];
      __syncthreads();
      mode.fetch(smem, lay, rank, L - 1, n + 1);
    }
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int RT, class Mode>
static int kw_config(int clusters, int C, int threads, long long smem_bytes,
                     cudaStream_t st, cudaLaunchConfig_t& cfg,
                     cudaLaunchAttribute* attr) {
  const cudaError_t err = cudaFuncSetAttribute(
      kw_rollout_kernel<RT, Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(clusters * C), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return 0;
}

// Clusters of this launch's shape the card can hold at once (0: none).
template <int RT, class Mode>
static int kw_active(int C, int threads, long long smem_bytes, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = kw_config<RT, Mode>(1, C, threads, smem_bytes, 0, cfg, attr);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(n, kw_rollout_kernel<RT, Mode>,
                                             &cfg);
}

template <int RT, class Mode>
static int kw_launch(const Mode& mode, const KwLayout& lay, int B, int T,
                     long long u_twin_stride, int tc, float dt, float dt2,
                     float dt6, int threads, long long smem_bytes,
                     cudaStream_t st, const float* y0, const float* u,
                     float* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int clusters = (B + RT - 1) / RT;
  int err = kw_config<RT, Mode>(clusters, lay.C, threads, smem_bytes, st, cfg,
                                attr);
  if (err) return err;
  int active = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&active,
                                            kw_rollout_kernel<RT, Mode>, &cfg);
  if (err) return err;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  err = (int)cudaLaunchKernelEx(&cfg, kw_rollout_kernel<RT, Mode>, y0, u, out,
                                mode, lay, B, T, u_twin_stride, tc, dt, dt2,
                                dt6);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <class Mode>
static int kw_launch_rt(int twins, const Mode& mode, const KwLayout& lay,
                        int B, int T, long long u_twin_stride, int tc,
                        float dt, float dt2, float dt6, int threads,
                        long long smem_bytes, void* stream, const void* y0,
                        const void* u, void* out) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  const float* uf = static_cast<const float*>(u);
  float* outf = static_cast<float*>(out);
  if (twins == 4)
    return kw_launch<4>(mode, lay, B, T, u_twin_stride, tc, dt, dt2, dt6,
                        threads, smem_bytes, st, y0f, uf, outf);
  return kw_launch<1>(mode, lay, B, T, u_twin_stride, tc, dt, dt2, dt6,
                      threads, smem_bytes, st, y0f, uf, outf);
}

// The shape checks both entry points share; false when the launch does not
// describe a wide rollout these kernels take.
static bool kw_valid(const int* sz, int num_layers, int B, int T, int D,
                     int Du, int cluster, int twins, int threads, int tc,
                     long long smem_bytes, KwLayout& lay) {
  if (num_layers < 2 || num_layers > FM_MAX_LAYERS || B < 1 || T < 0 ||
      cluster < 1 || cluster > KW_MAX_CLUSTER || (twins != 1 && twins != 4) ||
      threads < 32 || threads % 32 != 0 || threads > KW_MAX_THREADS || tc < 1)
    return false;
  for (int l = 0; l <= num_layers; ++l)
    if (sz[l] < 1) return false;
  if (sz[0] != Du + D || sz[num_layers] != D) return false;
  lay = kw_layout(sz, num_layers, cluster);
  return smem_bytes == 4 * kw_smem_floats(lay, twins, tc) &&
         smem_bytes <= KW_SMEM_LIMIT;
}

// Launch K1w on `stream`.  Arguments as k1_fused_node_rollout_f32's
// (fused_ode_mlp.cu), with `cluster` the CTAs of one cluster and `twins`
// the twins one cluster owns; twins, threads, tc and smem_bytes (per CTA)
// are the wrapper's wide_geometry.  Returns the cudaError_t of the launch
// (cudaErrorLaunchOutOfResources when no such cluster fits the card);
// nothing is allocated and nothing synchronises.
extern "C" int k1w_fused_node_rollout_f32(
    const void* y0, const void* u, void* out, const void* w_ptrs,
    const void* b_ptrs, const void* sizes, int num_layers, int B, int T,
    int D, int Du, long long u_twin_stride, float dt, float dt2, float dt6,
    int cluster, int twins, int threads, int tc, long long smem_bytes,
    void* stream) {
  KwLayout lay;
  if (!kw_valid(static_cast<const int*>(sizes), num_layers, B, T, D, Du,
                cluster, twins, threads, tc, smem_bytes, lay))
    return (int)cudaErrorInvalidValue;
  KwK1 mode = {};
  const void* const* w = static_cast<const void* const*>(w_ptrs);
  const void* const* b = static_cast<const void* const*>(b_ptrs);
  for (int l = 0; l < num_layers; ++l) {
    mode.w[l] = static_cast<const float*>(w[l]);
    mode.b[l] = static_cast<const float*>(b[l]);
  }
  cudaGetLastError();                      // clear any stale error first
  return kw_launch_rt(twins, mode, lay, B, T, u_twin_stride, tc, dt, dt2, dt6,
                      threads, smem_bytes, stream, y0, u, out);
}

// Launch K4w on `stream`.  Arguments as k4_fused_analogue_rollout_f32's
// (fused_analogue.cu), with `cluster` as k1w's; `noise` is the resident
// pre-pass's output (k4_noise_pass_f32) for these T steps when
// read->read_noise > 0, else null.
extern "C" int k4w_fused_analogue_rollout_f32(
    const void* y0, const void* u, void* out, const void* scales,
    const void* gp_ptrs, const void* gm_ptrs, const void* sizes,
    int num_layers, const void* read, const void* noise, int B, int T, int D,
    int Du, long long u_twin_stride, int cluster, int twins, int threads,
    int tc, long long smem_bytes, void* stream) {
  KwLayout lay;
  if (!kw_valid(static_cast<const int*>(sizes), num_layers, B, T, D, Du,
                cluster, twins, threads, tc, smem_bytes, lay))
    return (int)cudaErrorInvalidValue;
  const KwRead rd = *static_cast<const KwRead*>(read);
  const bool noisy = rd.read_noise > 0.0f;
  if (noisy && T > 0 && noise == nullptr) return (int)cudaErrorInvalidValue;
  KwArrays arr = {};
  const void* const* gp = static_cast<const void* const*>(gp_ptrs);
  const void* const* gm = static_cast<const void* const*>(gm_ptrs);
  arr.num_layers = num_layers;
  for (int l = 0; l < num_layers; ++l) {
    arr.gp[l] = gp[l];
    arr.gm[l] = gm[l];
  }
  for (int l = 0; l <= num_layers; ++l) arr.sizes[l] = lay.sizes[l];
  int ev = 0;
  for (int l = 0; l < num_layers; ++l)
    ev += (lay.sizes[l] + 1) * fm_round4(lay.sizes[l + 1]);
  cudaGetLastError();                      // clear any stale error first
  if (noisy) {
    KwK4<true> mode = {arr, rd, static_cast<const float*>(scales),
                       static_cast<const float*>(noise), ev, 4 * T};
    return kw_launch_rt(twins, mode, lay, B, T, u_twin_stride, tc, rd.dt,
                        rd.dt2, rd.dt6, threads, smem_bytes, stream, y0, u,
                        out);
  }
  KwK4<false> mode = {arr, rd, static_cast<const float*>(scales), nullptr, ev,
                      4 * T};
  return kw_launch_rt(twins, mode, lay, B, T, u_twin_stride, tc, rd.dt, rd.dt2,
                      rd.dt6, threads, smem_bytes, stream, y0, u, out);
}

// How many clusters of a launch's shape the card holds at once, into *n:
// kind 0 K1w, 1 K4w noise-free, 2 K4w under read noise.  Returns the
// cudaError_t of the query.
extern "C" int kw_max_active_clusters(int kind, int cluster, int twins,
                                      int threads, long long smem_bytes,
                                      int* n) {
  *n = 0;
  if (cluster < 1 || cluster > KW_MAX_CLUSTER || (twins != 1 && twins != 4))
    return (int)cudaErrorInvalidValue;
#define KW_ACTIVE(MODE)                                                  \
  return twins == 4 ? kw_active<4, MODE>(cluster, threads, smem_bytes, n) \
                    : kw_active<1, MODE>(cluster, threads, smem_bytes, n)
  if (kind == 0) KW_ACTIVE(KwK1);
  if (kind == 1) KW_ACTIVE(KwK4<false>);
  KW_ACTIVE(KwK4<true>);
#undef KW_ACTIVE
}

// ---------------------------------------------------------------------------
// The clock of the chain bound: what one cluster barrier, one block barrier
// and one exchange of the last layer's partials cost on a cluster of this
// shape (chip_smoke.py prices K1w's and K4w's chain of barriered
// evaluations with them).
// ---------------------------------------------------------------------------

// Rank 0's first thread writes, in clock cycles over `iters` repeats:
// out[0] cluster barriers, out[1] block barriers, out[2] the kernels'
// exchange (a cluster barrier, then D = 8 threads each load one partial
// from every rank and add them in rank order, then a block barrier),
// out[3] the same exchange pushed (each rank stores its partials into every
// rank's shared memory before the barrier; the sum reads locally).
__global__ void kw_sync_probe_kernel(int iters, long long* out) {
  __shared__ float part[2][KW_MAX_CLUSTER * 8];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * KW_MAX_CLUSTER * 8; i += blockDim.x)
    (&part[0][0])[i] = (float)i;
  cluster.sync();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) cluster.sync();
  const long long t1 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  const long long t2 = clock64();
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    cluster.sync();
    if (tid < 8) {
      float pv[KW_MAX_CLUSTER];
#pragma unroll
      for (int c = 0; c < KW_MAX_CLUSTER; ++c)
        pv[c] = c < C ? cluster.map_shared_rank(&part[i & 1][0], c)[tid]
                      : 0.0f;
      float p = pv[0];
#pragma unroll
      for (int c = 1; c < KW_MAX_CLUSTER; ++c)
        if (c < C) p = __fadd_rn(p, pv[c]);
      acc = __fadd_rn(acc, p);
    }
    __syncthreads();
  }
  const long long t3 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (tid < 8)
      for (int c = 0; c < C; ++c)
        cluster.map_shared_rank(&part[i & 1][0], c)[rank * 8 + tid] = acc;
    cluster.sync();
    if (tid < 8) {
      float p = part[i & 1][tid];
      for (int c = 1; c < C; ++c) p = __fadd_rn(p, part[i & 1][c * 8 + tid]);
      acc = __fadd_rn(acc, 1e-30f * p);
    }
    __syncthreads();
  }
  const long long t4 = clock64();
  cluster.sync();
  if (rank == 0 && tid == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3 + (acc == 12345.0f);
  }
}

// One cluster of `cluster` CTAs of `threads` threads on `stream`: `out`
// (device, 4 long longs) gets kw_sync_probe_kernel's cycles.  Returns the
// cudaError_t of the launch.
extern "C" int kw_sync_probe(int cluster, int threads, int iters, void* out,
                             void* stream) {
  if (cluster < 1 || cluster > KW_MAX_CLUSTER || threads < 32 ||
      threads > KW_MAX_THREADS || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaGetLastError();
  const int err = (int)cudaLaunchKernelEx(&cfg, kw_sync_probe_kernel, iters,
                                          static_cast<long long*>(out));
  if (err) return err;
  return (int)cudaGetLastError();
}
