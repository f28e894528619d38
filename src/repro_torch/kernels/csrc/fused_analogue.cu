// K4 on Hopper: the fused analogue RK4 rollout through memristor crossbar
// pairs, and its read-noise pre-pass.
//
// Replaces repro/kernels/fused_analogue.py:fused_analogue_rollout (the
// Pallas kernel built by _make_kernel there).  It computes the trajectory
// of dy/dt = MLP_analogue([u(t), y]) for a fleet of B twins, out (T+1, B, D)
// float32, row 0 = y0, where each layer l is a differential pair of
// conductance arrays G+, G- of shape (in_l + 1, out_l), the bias folded in
// as the last row, read as
//   noise-free:  y = x @ W[:-1] + W[-1],  W = ((G+ - G-)[* g_step]) * (1/scale_l)
//   read noise:  S = G+ (1 + s e+) - G- (1 + s e-)  (e+-, e- fresh per read)
//                y = (x @ S[:-1] + S[-1]) * (1/scale_l)
// then * dfac (live drift), then the clamp, then ReLU between layers.
//
// Design: K1's rollout (fused_ode_mlp.cu) on K1's MLP evaluation
// (fused_mlp_eval.cuh), with the crossbar read around it.
//  * Geometry: K1's (fused_ode_mlp.launch_geometry): one twin per block while
//    four per block would leave SMs idle, four at the fleet; a lane for every
//    lane of the widest product; each block owns its twins for all T steps.
//    The Lorenz96 (6->64->64->6) and HP (2->14->14->1) widths are compiled
//    in, other widths run the same code with run-time widths.
//  * Noise-free (clean, drift, clamp, stuck cells, uint8 storage): each pair
//    is combined once at block start into the header's weight layout (rows
//    padded to 4 floats, then the bias) with the scale folded in (uint8
//    level indices dequantised through g_step; with stuck cells the
//    absolute conductances g_min + idx * g_step are rebuilt and pinned
//    first), and every evaluation is K1's.
//  * Read noise: the noise is the same for every twin, so it is drawn once
//    per evaluation for the whole fleet, not once per block.  A pre-pass
//    (k4_noise_kernel, one launch per time chunk) writes every evaluation's
//    S in the weight layout to device memory; the rollout streams evaluation
//    e + 1's S into the second of two weight blocks in shared memory with
//    16-byte cp.async while evaluation e runs, and waits for it just before
//    e's last barrier.  A layer's output is then (sums + S_bias) * (1/scale).
//  * The chunk rule (fused_analogue.noise_chunk_steps): a chunk holds at most
//    NOISE_CHUNK_BYTES = 24 MiB of S, under half the 50 MB L2, so the
//    pre-pass's writes are still in L2 when the blocks read them; the
//    Lorenz96 fleet request (200 steps of 20.5 KB x 4 evaluations, 16.4 MB)
//    is one chunk.  A longer rollout runs chunk by chunk, each a pre-pass
//    and a rollout launch resuming from the chunk's first trajectory row.
//  * Noise: counter_noise.cuh (K3).  Salt ((step_offset + t) * 8L +
//    stage * 2L) + 2 l (+1 for G-), element id the row-major flat index
//    over the whole (in_l + 1, out_l) array, as the JAX kernel draws over
//    unblocked arrays.  Stuck cells use the global ids of the same arrays,
//    so they are bitwise the masks core/faults.py bakes at programming time.
//    The pre-pass is bitwise ref.fused_analogue_noisy_pairs_ref; step_offset
//    is an argument, so a rollout resumed at step k with step_offset = k
//    replays the unsplit rollout's salts and drift.
//  * Arithmetic: products and sums that the reference rounds separately
//    use __fmul_rn / __fadd_rn so nvcc cannot contract them; the dot
//    products are the header's fixed-order team sums (a twin's trajectory
//    is the same bits at one and at four twins per block), not the plain
//    version's matmul order, so kernel vs plain is held to 1e-4 of the peak.
//
// Bound on this card (H100 SXM), Lorenz96 fleet request (B=1024, T=200,
// 6->64->64->6): the MLP is 7.97 GFLOP, 0.119 ms at the 67 TFLOP/s FP32
// peak; the 4.9 MB trajectory write is 1.5 us.  With read noise each
// evaluation also needs 2 * 4,998 normals (~31 FP32 operations each),
// 0.4 GFLOP more, drawn once by the pre-pass.  So the operations bound it;
// like K1 the rollout is further bound by its chain of 4 L barriered
// phases per step (measured times in PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"
#include "fused_mlp_eval.cuh"

#define K4_MAX_THREADS 512
#define K4_NOISE_THREADS 256

struct K4Arrays {
  const void* gp[FM_MAX_LAYERS];   // (in_l + 1, out_l) row-major, f32 or uint8
  const void* gm[FM_MAX_LAYERS];
  int sizes[FM_MAX_LAYERS + 1];    // in_0, out_0 = in_1, ..., out_{L-1}
  int num_layers;
};

struct K4Read {
  float dt, dt2, dt6;
  int u8;                 // 1: uint8 level indices, 0: float32 conductances
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
  long long step_offset;  // global step of y0
};

__device__ __forceinline__ float k4_load(const void* p, int u8, int i) {
  return u8 ? (float)static_cast<const unsigned char*>(p)[i]
            : static_cast<const float*>(p)[i];
}

// Element i of layer l's pair as a read sees it before noise: the stored
// values, as absolute conductances (uint8 decoded) when read noise or stuck
// cells need them, with the stuck cells pinned.
__device__ __forceinline__ void k4_pair(const K4Arrays& arr, const K4Read& rd,
                                        bool absolute, int l, int i, float& a,
                                        float& b) {
  a = k4_load(arr.gp[l], rd.u8, i);
  b = k4_load(arr.gm[l], rd.u8, i);
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

// Floats of dynamic shared memory one rollout block needs (the Python
// wrapper's launch_geometry computes the same number): K1's layout, with a
// second weight block under read noise.
static long long k4_smem_floats(const int* sizes, int L, int rt, int tc,
                                bool noisy) {
  const FmLayout lay = fm_layout_of(sizes, L, false);
  int hidden = 0;
  for (int l = 0; l + 1 < L; ++l)
    if (sizes[l + 1] > hidden) hidden = sizes[l + 1];
  const int D = sizes[L];
  const int Du = sizes[0] - D;
  const long long act = (long long)rt * (2 * fm_round4(sizes[0]) +
                                         2 * fm_round4(hidden) +
                                         2 * fm_round4(D));
  return (noisy ? 2 : 1) * (long long)lay.total + act +
         fm_round4((2 * tc + 1) * Du * rt);
}

// ---------------------------------------------------------------------------
// The read-noise pre-pass: S of every evaluation of a time chunk, in the
// weight layout without its op table (evaluation e = 4 (t - t0) + stage at
// noise + e * ev_floats; padding zero).  One thread per element: x over the
// layout, y over the evaluations.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(K4_NOISE_THREADS)
k4_noise_kernel(const K4Arrays arr, const K4Read rd, const FmLayout lay,
                int ev_floats, float* __restrict__ noise) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ev_floats) return;
  const int e = blockIdx.y;
  const int L = arr.num_layers;
  const int w = i + FM_OPS_WORDS;          // offset in the weight block
  int l = 0;
  while (l + 1 < L && w >= lay.w[l + 1]) ++l;
  const int row = (w - lay.w[l]) / lay.ws[l];          // in_l: the bias row
  const int j = w - lay.w[l] - row * lay.ws[l];
  const int dout = arr.sizes[l + 1];
  float v = 0.0f;
  if (j < dout) {
    const int idx = row * dout + j;
    float a, b;
    k4_pair(arr, rd, true, l, idx, a, b);
    const long long gstep = rd.step_offset + e / 4;
    const long long salt = gstep * 8LL * L + (long long)(e & 3) * 2 * L + 2 * l;
    const float ep = cn_normal_from_base(
        cn_base(rd.noise_seed, (uint32_t)salt), (uint32_t)idx);
    const float em = cn_normal_from_base(
        cn_base(rd.noise_seed, (uint32_t)(salt + 1)), (uint32_t)idx);
    v = __fsub_rn(__fmul_rn(a, __fadd_rn(1.0f, __fmul_rn(rd.read_noise, ep))),
                  __fmul_rn(b, __fadd_rn(1.0f, __fmul_rn(rd.read_noise, em))));
  }
  noise[(long long)e * ev_floats + i] = v;
}

// ---------------------------------------------------------------------------
// The rollout.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void k4_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Copy one evaluation's S (ev_floats, a multiple of 4) behind the op table
// of weight block wb, 16 bytes a thread; one commit group.
__device__ __forceinline__ void k4_fetch_noise(float* wb, const float* src,
                                               int ev_floats) {
  for (int i = 4 * threadIdx.x; i < ev_floats; i += 4 * blockDim.x)
    k4_cp_async16(wb + FM_OPS_WORDS + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// The hook before a stage's last barrier under read noise: the next
// evaluation's S has landed (this thread's copies; the barrier then shows
// every thread's).
struct K4WaitNoise {
  __device__ __forceinline__ void operator()() const {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

// A layer's output: sums + bias, times 1/scale under read noise (noise-free,
// the scale is folded into W), times the drift factor, then the clamp.
template <bool kNoisy> struct K4Out {
  float inv_s[FM_MAX_LAYERS];   // per layer (read noise); registers where
                                // the widths are compiled in
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

// A hidden layer's epilogue: K4Out, then ReLU.
template <int RT, bool kNoisy> struct K4DenseEpi {
  float* out;
  int l;
  K4Out<kNoisy> f;
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

// fm_mlp's hidden_epi: hidden layer l writes dst through K4DenseEpi.
template <int RT, bool kNoisy> struct K4Hidden {
  K4Out<kNoisy> f;
  __device__ __forceinline__ K4DenseEpi<RT, kNoisy> operator()(
      int l, float* dst) const {
    return K4DenseEpi<RT, kNoisy>{dst, l, f};
  }
};

// The last layer's epilogue: K1's (fused_ode_mlp.cu, K1StepEpi) on K4's
// layer output k_{s+1} = f(sums, bias).  After stage s of step t: acc = k1,
// then acc += 2 k2, acc += 2 k3, the next input y + c k; after the last
// stage y <- y + (dt/6) (acc + k4), stored as trajectory row t + 1 and as the
// y columns of step t + 1's first input.  Each (j, twin) has one lane.
template <int RT, bool kNoisy> struct K4StepEpi {
  float* ys;        // [D][RT]
  float* acc;       // [D][RT]
  float* xnext;     // [in0][RT] the next stage's input
  float* out_next;  // trajectory row t + 1 at this block's first twin
  int s, Du, D, nr;
  float cnext, dt6;
  int last;         // the last layer
  K4Out<kNoisy> f;
  __device__ __forceinline__ void operator()(int j0, int n_out, int r,
                                             const float (&a)[4],
                                             float4 b4) const {
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j < n_out) {
        const float k = f(last, a[c], b[c]);
        const int i = j * RT + r;
        float v;
        if (s == 3) {
          v = __fadd_rn(ys[i], __fmul_rn(dt6, __fadd_rn(acc[i], k)));
          ys[i] = v;
          if (r < nr) out_next[r * D + j] = v;
        } else {
          acc[i] = (s == 0) ? k : __fadd_rn(acc[i], __fmul_rn(2.0f, k));
          v = fm_stage_y(ys[i], cnext, k);
        }
        xnext[(Du + j) * RT + r] = v;
      }
    }
  }
};

template <int RT, bool kNoisy, class Shape>
__global__ void __launch_bounds__(K4_MAX_THREADS)
k4_rollout_kernel(const float* __restrict__ y0, const float* __restrict__ u,
                  float* __restrict__ out, const float* __restrict__ scales,
                  const float* __restrict__ noise, const K4Arrays arr,
                  const K4Read rd, const FmLayout lay, const FmOps ops,
                  const Shape shape, int B, int T, long long u_twin_stride,
                  int tc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float inv_s[FM_MAX_LAYERS];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = shape.layers();
  const int D = shape.width(L);
  const int in0 = shape.width(0);
  const int Du = in0 - D;
  const int r0 = blockIdx.x * RT;
  const int nr = min(RT, B - r0);
  int hidden = 0;
#pragma unroll(Shape::kUnroll)
  for (int l = 1; l < L; ++l) hidden = max(hidden, shape.width(l));
  const int hstep = fm_round4(hidden) * RT;
  const int xstep = fm_round4(in0) * RT;
  const int ev = lay.total - FM_OPS_WORDS;   // floats of one evaluation's S
  const int nwb = kNoisy ? 2 : 1;

  float* wb0 = smem;                         // weight block(s)
  float* xs = smem + nwb * lay.total;        // 2 x [in0][RT] stage inputs
  float* h0 = xs + 2 * xstep;                // [hidden][RT] ping, then pong
  float* ys = h0 + 2 * hstep;                // [D][RT] state y_t
  float* acc = ys + fm_round4(D) * RT;       // [D][RT] k1 + 2 k2 + 2 k3
  float* ubuf = acc + fm_round4(D) * RT;     // [2 tc + 1][Du][RT] drive chunk
  const int nact = (int)(ubuf - xs) + fm_round4((2 * tc + 1) * Du * RT);

  if (tid < L) inv_s[tid] = __fdiv_rn(1.0f, scales[tid]);
  // op tables and zero padding of the weight block(s), zero activations
  for (int i = tid; i < nwb * lay.total; i += nt) {
    const int k = i % lay.total;
    smem[i] = k < FM_OPS_WORDS
                  ? __int_as_float(reinterpret_cast<const int*>(&ops)[k])
                  : 0.0f;
  }
  for (int i = tid; i < nact; i += nt) xs[i] = 0.0f;
  __syncthreads();
  if (kNoisy) {
    if (T > 0) k4_fetch_noise(wb0, noise, ev);
  } else {
    // each pair combined once, the scale folded in
    for (int l = 0; l < L; ++l) {
      const int dout = arr.sizes[l + 1];
      const int n = (arr.sizes[l] + 1) * dout;
      const bool stuck = rd.stuck_rate > 0.0f;
      for (int i = tid; i < n; i += nt) {
        float a, b;
        k4_pair(arr, rd, stuck, l, i, a, b);
        float g = __fsub_rn(a, b);
        if (rd.u8 && !stuck) g = __fmul_rn(g, rd.g_step);
        const int row = i / dout;
        wb0[lay.w[l] + row * lay.ws[l] + (i - row * dout)] =
            __fmul_rn(g, inv_s[l]);
      }
    }
  }
  if (Du > 0 && T > 0)
    fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 0, 2 * min(tc, T) + 1, r0,
                       nr);
  for (int i = tid; i < D * RT; i += nt) {
    const int j = i / RT, r = i % RT;
    if (r < nr) {
      const float v = y0[(long long)(r0 + r) * D + j];
      ys[i] = v;
      xs[Du * RT + i] = v;                     // step 0's first input
      out[(long long)(r0 + r) * D + j] = v;    // trajectory row 0 = y0
    }
  }
  if (kNoisy) K4WaitNoise{}();
  __syncthreads();
  for (int e = tid; e < Du * RT; e += nt) xs[e] = ubuf[e];
  __syncthreads();

  K4Out<kNoisy> f;
  for (int l = 0; l < FM_MAX_LAYERS; ++l) f.inv_s[l] = l < L ? inv_s[l] : 0.0f;
  f.v_clamp = rd.v_clamp;
  f.drift = rd.drift_nu > 0.0f;
  f.clamp = rd.has_clamp != 0;
  int c0 = 0;                                  // first step of the drive chunk
  for (int t = 0; t < T; ++t) {
    if (Du > 0 && t > 0 && t % tc == 0) {
      c0 = t;
      fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 2 * t,
                         2 * min(tc, T - t) + 1, r0, nr);
      __syncthreads();
    }
    f.dfac = 1.0f;
    if (f.drift) {
      const float n = (float)(rd.drift_n0 + 4 * (rd.step_offset + t));
      f.dfac = expf(__fmul_rn(-rd.drift_nu,
                              log1pf(__fdiv_rn(n, rd.drift_tau))));
    }
    float* out_next = out + ((long long)(t + 1) * B + r0) * D;
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * t + s;
      const float* xcur = xs + (n & 1) * xstep;
      float* xnext = xs + ((n + 1) & 1) * xstep;
      const float* w = wb0;
      if (kNoisy) {
        // evaluation n reads block n & 1; n + 1's S goes into the other,
        // free since evaluation n - 1's last barrier
        w = wb0 + (n & 1) * lay.total;
        if (n + 1 < 4 * T)
          k4_fetch_noise(wb0 + ((n + 1) & 1) * lay.total,
                         noise + (long long)(n + 1) * ev, ev);
      }
      const int hn = 2 * t + (s == 2 || s == 3 ? 2 : 1);
      if (s < 3 || t + 1 < T)
        for (int e = tid; e < Du * RT; e += nt)
          xnext[e] = ubuf[(hn - 2 * c0) * Du * RT + e];
      const K4StepEpi<RT, kNoisy> epi{
          ys, acc, xnext, out_next, s, Du, D, nr, (s == 2) ? rd.dt : rd.dt2,
          rd.dt6, L - 1, f};
      const K4Hidden<RT, kNoisy> hidden{f};
      if (kNoisy)
        fm_mlp<RT>(shape, w, xcur, h0, hstep, 1, epi, hidden, K4WaitNoise{});
      else
        fm_mlp<RT>(shape, w, xcur, h0, hstep, 1, epi, hidden);
    }
  }
}

template <int RT, bool kNoisy, class Shape>
static int k4_launch(const Shape& shape, int grid, int threads,
                     long long smem_bytes, cudaStream_t st, const float* y0,
                     const float* u, float* out, const float* scales,
                     const float* noise, const K4Arrays& arr, const K4Read& rd,
                     const FmLayout& lay, const FmOps& ops, int B, int T,
                     long long u_twin_stride, int tc) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k4_rollout_kernel<RT, kNoisy, Shape>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  k4_rollout_kernel<RT, kNoisy, Shape><<<grid, threads, (size_t)smem_bytes,
                                         st>>>(y0, u, out, scales, noise, arr,
                                               rd, lay, ops, shape, B, T,
                                               u_twin_stride, tc);
  return (int)cudaGetLastError();
}

template <int RT, class Shape>
static int k4_launch_mode(const Shape& shape, bool noisy, int grid,
                          int threads, long long smem_bytes, cudaStream_t st,
                          const float* y0, const float* u, float* out,
                          const float* scales, const float* noise,
                          const K4Arrays& arr, const K4Read& rd,
                          const FmLayout& lay, const FmOps& ops, int B, int T,
                          long long u_twin_stride, int tc) {
  if (noisy)
    return k4_launch<RT, true>(shape, grid, threads, smem_bytes, st, y0, u,
                               out, scales, noise, arr, rd, lay, ops, B, T,
                               u_twin_stride, tc);
  return k4_launch<RT, false>(shape, grid, threads, smem_bytes, st, y0, u, out,
                              scales, noise, arr, rd, lay, ops, B, T,
                              u_twin_stride, tc);
}

// The Lorenz96 twin and the HP memristor twin, compiled for their widths.
using K4L96 = FmFixedShape<6, 64, 64, 6>;
using K4HP = FmFixedShape<2, 14, 14, 1>;

// The arrays and widths from the wrapper's host arrays; false when they do
// not make an MLP the kernels take.
static bool k4_arrays(const void* gp_ptrs, const void* gm_ptrs,
                      const void* sizes, int num_layers, K4Arrays& arr) {
  if (num_layers < 1 || num_layers > FM_MAX_LAYERS) return false;
  const void* const* gp = static_cast<const void* const*>(gp_ptrs);
  const void* const* gm = static_cast<const void* const*>(gm_ptrs);
  const int* sz = static_cast<const int*>(sizes);
  arr.num_layers = num_layers;
  for (int l = 0; l < num_layers; ++l) {
    arr.gp[l] = gp[l];
    arr.gm[l] = gm[l];
  }
  for (int l = 0; l <= FM_MAX_LAYERS; ++l)
    arr.sizes[l] = l <= num_layers ? sz[l] : 0;
  for (int l = 0; l <= num_layers; ++l)
    if (arr.sizes[l] < 1) return false;
  return true;
}

// Launch the read-noise pre-pass on `stream`: S of the n_evals evaluations
// from global step read->step_offset into `noise` ((n_evals, ev_floats)
// float32, ev_floats the weight layout's floats after its op table).
// Pointers are device pointers except gp_ptrs, gm_ptrs, sizes (host arrays
// of num_layers, num_layers and num_layers + 1 entries) and `read`, a host
// K4Read.  Returns the cudaError_t of the launch.
extern "C" int k4_noise_pass_f32(const void* gp_ptrs, const void* gm_ptrs,
                                 const void* sizes, int num_layers,
                                 const void* read, int n_evals,
                                 int ev_floats, void* noise, void* stream) {
  K4Arrays arr;
  if (!k4_arrays(gp_ptrs, gm_ptrs, sizes, num_layers, arr) || n_evals < 1 ||
      n_evals > 65535)
    return (int)cudaErrorInvalidValue;
  const FmLayout lay = fm_layout_of(arr.sizes, num_layers, false);
  if (ev_floats != lay.total - FM_OPS_WORDS) return (int)cudaErrorInvalidValue;
  const K4Read rd = *static_cast<const K4Read*>(read);
  cudaGetLastError();                      // clear any stale error first
  const dim3 grid((ev_floats + K4_NOISE_THREADS - 1) / K4_NOISE_THREADS,
                  n_evals);
  k4_noise_kernel<<<grid, K4_NOISE_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      arr, rd, lay, ev_floats, static_cast<float*>(noise));
  return (int)cudaGetLastError();
}

// Launch the rollout on `stream`.  As k4_noise_pass_f32 for the arrays and
// `read`; y0, u, out, scales are device pointers, u may be null when
// Du == 0; u_twin_stride is 0 for a drive shared by the fleet and (2T'+1)*Du
// for one drive per twin over the whole rollout.  `noise` is the pre-pass's
// output for these T steps when read->read_noise > 0 (else null).  twins
// (1 or 4), threads, tc (drive steps staged per load) and smem_bytes are
// the wrapper's launch_geometry; smem_bytes must equal the layout's.
// Returns the cudaError_t of the launch (0 on success); nothing is
// allocated and nothing synchronises.
extern "C" int k4_fused_analogue_rollout_f32(
    const void* y0, const void* u, void* out, const void* scales,
    const void* gp_ptrs, const void* gm_ptrs, const void* sizes,
    int num_layers, const void* read, const void* noise, int B, int T, int D,
    int Du, long long u_twin_stride, int twins, int threads, int tc,
    long long smem_bytes, void* stream) {
  K4Arrays arr;
  if (!k4_arrays(gp_ptrs, gm_ptrs, sizes, num_layers, arr) || B < 1 ||
      T < 0 || (twins != 1 && twins != 4) || threads < 32 ||
      threads % 32 != 0 || threads > K4_MAX_THREADS || tc < 1)
    return (int)cudaErrorInvalidValue;
  const K4Read rd = *static_cast<const K4Read*>(read);
  const bool noisy = rd.read_noise > 0.0f;
  if (arr.sizes[0] != Du + D || arr.sizes[num_layers] != D ||
      (noisy && T > 0 && noise == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != 4 * k4_smem_floats(arr.sizes, num_layers, twins, tc, noisy))
    return (int)cudaErrorInvalidValue;
  FmMlp mlp = {};
  FmDynShape dyn;
  mlp.num_layers = dyn.L = num_layers;
  for (int l = 0; l <= FM_MAX_LAYERS; ++l) mlp.sizes[l] = dyn.size[l] = arr.sizes[l];
  const FmLayout lay = fm_layout(mlp, false);
  const FmOps ops = fm_ops(mlp, lay, false);
  cudaGetLastError();                      // clear any stale error first
  const int grid = (B + twins - 1) / twins;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* y0f = static_cast<const float*>(y0);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(scales);
  const float* nf = static_cast<const float*>(noise);
  float* outf = static_cast<float*>(out);
#define K4_LAUNCH(RT, SHAPE)                                                 \
  return k4_launch_mode<RT>(SHAPE, noisy, grid, threads, smem_bytes, st, y0f, \
                            uf, outf, sf, nf, arr, rd, lay, ops, B, T,        \
                            u_twin_stride, tc)
  if (K4L96::matches(arr.sizes, num_layers)) {
    if (twins == 4) K4_LAUNCH(4, K4L96{});
    K4_LAUNCH(1, K4L96{});
  }
  if (K4HP::matches(arr.sizes, num_layers) && twins == 1) K4_LAUNCH(1, K4HP{});
  if (twins == 4) K4_LAUNCH(4, dyn);
  K4_LAUNCH(1, dyn);
#undef K4_LAUNCH
}
