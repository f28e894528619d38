// K1 on Hopper: weights-stationary RK4 rollout of a ReLU-MLP neural ODE.
//
// Replaces repro/kernels/fused_ode_mlp.py:fused_node_rollout (the Pallas
// kernel built by _make_kernel there) under its three precision policies.
// It computes the full trajectory of dy/dt = MLP([u(t), y]) for a fleet of
// B twins and returns it as out (T+1, B, D), row 0 = y0.  One kernel,
// k1_rollout_kernel, is instantiated per policy (K1F32, K1Bf16 below).
//
// Design.
//  * No grid-carried state.  The Pallas grid walks (batch tiles, time
//    chunks) in order and carries the RK4 state across chunks in VMEM
//    scratch.  CUDA blocks run concurrently and in no order, so each block
//    owns RT twins (RT = 1 or 4) and loops over all T steps itself.
//  * Weights stationary in shared memory, read from there for all 4 * T
//    evaluations; the state, the RK4 sum, the activations and a chunk of
//    the drive stay in shared memory too.  Device-memory traffic is y0 and
//    the drive in (tc steps of it per load, one barrier per chunk), the
//    trajectory out.
//  * Geometry (fused_ode_mlp.py:launch_geometry).  One twin per block while
//    four per block would leave SMs idle (every training shape: B <= 132
//    blocks, one per twin); once the fleet fills the card at four twins
//    per block (B >= 528), four, so each weight quad read from shared
//    memory feeds 16 FMAs, and the 1024-twin request runs 256 blocks of 128
//    threads, two per SM.  Threads: a lane for every lane of the widest
//    product.  The wrapper sizes the shared memory and refuses an MLP that
//    does not fit the 227 KB a block may use.
//  * The MLP evaluation is fused_mlp_eval.cuh: each layer a team-split
//    product with a fixed summation order that depends on the layer's
//    widths only, so a twin's trajectory is the same bits whatever the
//    twins per block and the thread count; K2 recomputes the stages with the
//    same code.  The Lorenz96 (6->64->64->6) and HP (2->14->14->1) twins
//    run instantiations with their widths compiled in; every other width
//    runs the same code with run-time widths.
//  * Arithmetic, term by term as the JAX kernel (make_rk4_step): the host
//    rounds dt, dt/2 and dt/6 once from float64 to float32; a layer is dot,
//    then + b, then ReLU (none on the last layer); the update is
//    y + (dt/6) * (((k1 + 2 k2) + 2 k3) + k4).  The RK4 combinations use
//    __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs; the dot
//    products' order is fused_mlp_eval.cuh's, not XLA's or PyTorch's, so
//    parity with the plain version is to a tolerance (1e-4 of the
//    trajectory's peak), not bitwise.
//  * Per step: 4 * L layer phases, each ending in a block barrier.  The
//    last layer's epilogue does the RK4 bookkeeping and writes the next
//    stage's input (two input buffers alternate), so no phase only
//    assembles a stage input.
//  * The bf16 policies ("bf16_f32acc", "bf16"), as the JAX kernel's
//    make_rk4_step under them, term by term: the weights, biases and drive
//    arrive as bfloat16 (half the bytes) and are widened to float32 in
//    shared memory, where the products read them as before (a product of
//    two bf16 values is exact in float32, so the sums are float32 sums in
//    fused_mlp_eval.cuh's fixed order); every layer input (the stage input
//    [u, y + c k] and each hidden activation) is rounded to bf16; under
//    "bf16" the dot's sum, the bias add and every RK4 operation are rounded
//    too, with the step constants rounded to bf16 by the host; the carry
//    starts from y0 rounded to bf16, and under "bf16_f32acc" it is float32
//    and is rounded to bf16 after every rc steps counted from step 0 of the
//    call (the JAX kernel's time chunk, where its grid cell ends); the
//    trajectory is written as bfloat16.  The policy is a template argument
//    whose float32 case rounds nowhere, so that instantiation is the
//    float32 arithmetic above; the shared-memory layout is the same.
//
// Bound on this card (H100 SXM).  For the Lorenz96 fleet request (B=1024
// twins, T=200 steps, 6->64->64->6): 4 evaluations * 2 * 4,864 MACs =
// 38,912 FLOP per twin-step, 7.97 GFLOP per request, 0.119 ms at the
// 67 TFLOP/s FP32 peak without tensor cores; the 4.94 MB trajectory write
// is 1.5 us at 3.35 TB/s.  So the operations bound it.  The chain of
// 200 * 4 * L dependent barriered phases, each a few hundred cycles, is
// what the kernel waits on; the measured times are in PERF.md.  One call is
// one launch.

#include "fused_mlp_eval.cuh"

#define K1_MAX_THREADS 512

// Floats of dynamic shared memory one block needs (the Python wrapper's
// smem_bytes computes the same number).
static long long k1_smem_floats(const FmMlp& m, int rt, int tc) {
  const FmLayout lay = fm_layout(m, false);
  int hidden = 0;
  for (int l = 0; l + 1 < m.num_layers; ++l)
    if (m.sizes[l + 1] > hidden) hidden = m.sizes[l + 1];
  const int D = m.sizes[m.num_layers];
  const int Du = m.sizes[0] - D;
  const long long act = (long long)rt * (2 * fm_round4(m.sizes[0]) +
                                         2 * fm_round4(hidden) +
                                         2 * fm_round4(D));
  return lay.total + act + fm_round4((2 * tc + 1) * Du * rt);
}

// K1's precision policies: the type the drive, the weights and the
// trajectory are stored as, and where the arithmetic rounds to bf16.  K1F32
// rounds nowhere (the float32 policy); K1Bf16<false> is "bf16_f32acc",
// K1Bf16<true> is "bf16" (fused_mlp_eval.cuh's bf16 epilogues).
struct K1F32 {
  using Store = float;
  static constexpr bool kRoundsCarry = false;
  template <int RT> using Hidden = FmDenseHidden<RT>;
  // a layer input (the seed, the next step's y columns)
  static __device__ __forceinline__ float in(float v) { return v; }
  static __device__ __forceinline__ float bias(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float stage_y(float y, float c, float k) {
    return fm_stage_y(y, c, k);
  }
  static __device__ __forceinline__ float rk4_acc(float acc, float k) {
    return __fadd_rn(acc, __fmul_rn(2.0f, k));
  }
  static __device__ __forceinline__ float rk4_update(float y, float dt6,
                                                     float acc, float k) {
    return __fadd_rn(y, __fmul_rn(dt6, __fadd_rn(acc, k)));
  }
};

template <bool PURE> struct K1Bf16 {
  using Store = __nv_bfloat16;
  static constexpr bool kRoundsCarry = true;
  template <int RT> using Hidden = FmDenseHiddenBf<RT, PURE>;
  static __device__ __forceinline__ float in(float v) { return fm_rbf(v); }
  static __device__ __forceinline__ float bias(float a, float b) {
    return fm_bias_bf<PURE>(a, b);
  }
  static __device__ __forceinline__ float stage_y(float y, float c, float k) {
    return fm_stage_y_bf<PURE>(y, c, k);
  }
  static __device__ __forceinline__ float rk4_acc(float acc, float k) {
    return fm_rk4_acc_bf<PURE>(acc, k);
  }
  static __device__ __forceinline__ float rk4_update(float y, float dt6,
                                                     float acc, float k) {
    return fm_rk4_update_bf<PURE>(y, dt6, acc, k);
  }
};

__device__ __forceinline__ void k1_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void k1_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The last layer's epilogue: k_{s+1} = sums + b goes straight into the RK4
// bookkeeping and the y columns of the next stage's input, so a stage is
// L barriered phases.  After stage s of step t (s = 0..3): acc = k1, then
// acc += 2 k2, acc += 2 k3, the next input y + c k; after the last stage
// y <- y + (dt/6) (acc + k4) (rounded to bf16 where round_carry: the step
// ends a rounding chunk), stored as trajectory row t + 1 and as the y
// columns of step t + 1's first input.  Each (j, twin) has one lane.
template <int RT, class P> struct K1StepEpi {
  float* ys;                     // [D][RT] the carry
  float* acc;                    // [D][RT]
  float* xnext;                  // [in0][RT] the next stage's input
  typename P::Store* out_next;   // trajectory row t + 1 at the first twin
  int s, Du, D, nr;
  float cnext, dt6;
  bool round_carry;
  __device__ __forceinline__ void operator()(int j0, int n_out, int r,
                                             const float (&a)[4],
                                             float4 b4) const {
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j < n_out) {
        const float k = P::bias(a[c], b[c]);
        const int i = j * RT + r;
        float v;
        if (s == 3) {
          v = P::rk4_update(ys[i], dt6, acc[i], k);
          if (round_carry) v = fm_rbf(v);
          ys[i] = v;
          if (r < nr) k1_store(out_next + r * D + j, v);
          v = P::in(v);
        } else {
          acc[i] = (s == 0) ? k : P::rk4_acc(acc[i], k);
          v = P::stage_y(ys[i], cnext, k);
        }
        xnext[(Du + j) * RT + r] = v;
      }
    }
  }
};

template <int RT, class Shape, class P>
__global__ void __launch_bounds__(K1_MAX_THREADS)
k1_rollout_kernel(const float* __restrict__ y0,
                  const typename P::Store* __restrict__ u,
                  typename P::Store* __restrict__ out, const FmMlp mlp,
                  const FmWeightsOf<typename P::Store> wts,
                  const FmLayout lay, const FmOps ops, const Shape shape,
                  int B, int T, long long u_twin_stride, float dt, float dt2,
                  float dt6, int rc, int tc) {
  extern __shared__ __align__(16) float smem[];
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

  float* xs = smem + lay.total;              // 2 x [in0][RT] stage inputs
  float* h0 = xs + 2 * xstep;                // [hidden][RT] ping, then pong
  float* ys = h0 + 2 * hstep;                // [D][RT] state y_t
  float* acc = ys + fm_round4(D) * RT;       // [D][RT] k1 + 2 k2 + 2 k3
  float* ubuf = acc + fm_round4(D) * RT;     // [2 tc + 1][Du][RT] drive chunk
  const int nact = (int)(ubuf - xs) + fm_round4((2 * tc + 1) * Du * RT);

  fm_load_weights_of(smem, mlp, wts.w, wts.b, lay, ops, false);
  for (int i = tid; i < nact; i += nt) xs[i] = 0.0f;
  __syncthreads();
  if (Du > 0 && T > 0)
    fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 0, 2 * min(tc, T) + 1, r0,
                       nr);
  for (int i = tid; i < D * RT; i += nt) {
    const int j = i / RT, r = i % RT;
    if (r < nr) {
      // the seed is y0 (rounded to bf16 under a bf16 policy)
      const float v = P::in(y0[(long long)(r0 + r) * D + j]);
      ys[i] = v;
      xs[Du * RT + i] = v;                           // step 0's first input
      k1_store(out + (long long)(r0 + r) * D + j, v);  // trajectory row 0
    }
  }
  __syncthreads();
  for (int e = tid; e < Du * RT; e += nt) xs[e] = ubuf[e];
  __syncthreads();

  int c0 = 0;                                  // first step of the drive chunk
  for (int t = 0; t < T; ++t) {
    if (Du > 0 && t > 0 && t % tc == 0) {
      // step t's first input already holds u at half-step 2t (the last row
      // of the previous chunk); the new chunk serves the later stages
      c0 = t;
      fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 2 * t,
                         2 * min(tc, T - t) + 1, r0, nr);
      __syncthreads();
    }
    typename P::Store* out_next = out + ((long long)(t + 1) * B + r0) * D;
    const bool round_carry = P::kRoundsCarry && (t + 1) % rc == 0;
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * t + s;
      const float* xcur = xs + (n & 1) * xstep;
      float* xnext = xs + ((n + 1) & 1) * xstep;
      // the drive columns of the next stage's input (half-steps 2t+1,
      // 2t+1, 2t+2, then 2t+2 for step t+1's first stage)
      const int hn = 2 * t + (s == 2 || s == 3 ? 2 : 1);
      if (s < 3 || t + 1 < T)
        for (int e = tid; e < Du * RT; e += nt)
          xnext[e] = ubuf[(hn - 2 * c0) * Du * RT + e];
      fm_mlp<RT>(shape, smem, xcur, h0, hstep, 1,
                 K1StepEpi<RT, P>{ys, acc, xnext, out_next, s, Du, D, nr,
                                  (s == 2) ? dt : dt2, dt6, round_carry},
                 typename P::template Hidden<RT>());
    }
  }
}

// The Lorenz96 twin and the HP memristor twin, compiled for their widths.
using K1L96 = FmFixedShape<6, 64, 64, 6>;
using K1HP = FmFixedShape<2, 14, 14, 1>;

// One call's launch, as the host entry point checked it.
struct K1Call {
  const void* y0;
  const void* u;
  void* out;
  const void* const* w;
  const void* const* b;
  FmMlp mlp;
  FmLayout lay;
  FmOps ops;
  int B, T, twins, grid, threads, rc, tc;
  long long u_twin_stride, smem_bytes;
  float dt, dt2, dt6;
  cudaStream_t st;
};

template <class P, int RT, class Shape>
static int k1_launch(const Shape& shape, const K1Call& c) {
  using S = typename P::Store;
  FmWeightsOf<S> wts = {};
  for (int l = 0; l < c.mlp.num_layers; ++l) {
    wts.w[l] = static_cast<const S*>(c.w[l]);
    wts.b[l] = static_cast<const S*>(c.b[l]);
  }
  if (c.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_rollout_kernel<RT, Shape, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  k1_rollout_kernel<RT, Shape, P>
      <<<c.grid, c.threads, (size_t)c.smem_bytes, c.st>>>(
          static_cast<const float*>(c.y0), static_cast<const S*>(c.u),
          static_cast<S*>(c.out), c.mlp, wts, c.lay, c.ops, shape, c.B, c.T,
          c.u_twin_stride, c.dt, c.dt2, c.dt6, c.rc, c.tc);
  return (int)cudaGetLastError();
}

// The instantiation for the call's widths and twins per block.
template <class P>
static int k1_dispatch(const K1Call& c) {
  const int L = c.mlp.num_layers;
  if (K1L96::matches(c.mlp.sizes, L))
    return c.twins == 4 ? k1_launch<P, 4>(K1L96{}, c)
                        : k1_launch<P, 1>(K1L96{}, c);
  if (K1HP::matches(c.mlp.sizes, L) && c.twins == 1)
    return k1_launch<P, 1>(K1HP{}, c);
  FmDynShape dyn;
  dyn.L = L;
  for (int l = 0; l <= FM_MAX_LAYERS; ++l) dyn.size[l] = c.mlp.sizes[l];
  return c.twins == 4 ? k1_launch<P, 4>(dyn, c) : k1_launch<P, 1>(dyn, c);
}

// Launch K1 on `stream` under a precision policy: 0 "f32", 1
// "bf16_f32acc", 2 "bf16".  Pointers are device pointers except w_ptrs,
// b_ptrs and sizes, which are host arrays of num_layers, num_layers and
// num_layers + 1 entries.  y0 is float32; u, out and the weights and biases
// are float32 under "f32" and bfloat16 under the bf16 policies.  u may be
// null when Du == 0; u_twin_stride is 0 for a drive shared by the fleet and
// (2T+1)*Du for one drive per twin.  dt, dt2, dt6 are the policy's step
// constants (bf16-rounded under "bf16"); rc >= 1 is the rounding chunk of
// the carry (unused under "f32").  twins (1 or 4), threads, tc (drive steps
// staged per load) and smem_bytes are the wrapper's launch_geometry;
// smem_bytes must equal the layout's.  Returns the cudaError_t of the
// launch (0 on success); nothing is allocated and nothing synchronises.
extern "C" int k1_fused_node_rollout(
    const void* y0, const void* u, void* out, const void* w_ptrs,
    const void* b_ptrs, const void* sizes, int num_layers, int B, int T,
    int D, int Du, long long u_twin_stride, float dt, float dt2, float dt6,
    int policy, int rc, int twins, int threads, int tc, long long smem_bytes,
    void* stream) {
  if (num_layers < 1 || num_layers > FM_MAX_LAYERS || B < 1 || T < 0 ||
      (twins != 1 && twins != 4) || threads < 32 || threads % 32 != 0 ||
      threads > K1_MAX_THREADS || tc < 1 || rc < 1 || policy < 0 ||
      policy > 2)
    return (int)cudaErrorInvalidValue;
  K1Call c = {};
  const int* sz = static_cast<const int*>(sizes);
  c.mlp.num_layers = num_layers;
  for (int l = 0; l <= FM_MAX_LAYERS; ++l)
    c.mlp.sizes[l] = l <= num_layers ? sz[l] : 0;
  if (c.mlp.sizes[0] != Du + D || c.mlp.sizes[num_layers] != D)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != 4 * k1_smem_floats(c.mlp, twins, tc))
    return (int)cudaErrorInvalidValue;
  c.y0 = y0;
  c.u = u;
  c.out = out;
  c.w = static_cast<const void* const*>(w_ptrs);
  c.b = static_cast<const void* const*>(b_ptrs);
  c.lay = fm_layout(c.mlp, false);
  c.ops = fm_ops(c.mlp, c.lay, false);
  c.B = B;
  c.T = T;
  c.twins = twins;
  c.grid = (B + twins - 1) / twins;
  c.threads = threads;
  c.rc = rc;
  c.tc = tc;
  c.u_twin_stride = u_twin_stride;
  c.smem_bytes = smem_bytes;
  c.dt = dt;
  c.dt2 = dt2;
  c.dt6 = dt6;
  c.st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();                      // clear any stale error first
  if (policy == 0) return k1_dispatch<K1F32>(c);
  if (policy == 1) return k1_dispatch<K1Bf16<false>>(c);
  return k1_dispatch<K1Bf16<true>>(c);
}
