// K1 on Hopper: weights-stationary RK4 rollout of a ReLU-MLP neural ODE.
//
// Replaces repro/kernels/fused_ode_mlp.py:fused_node_rollout (the Pallas
// kernel built by _make_kernel there), float32 policy only.  It computes the
// full trajectory of dy/dt = MLP([u(t), y]) for a fleet of B twins and
// returns it as out (T+1, B, D), row 0 = y0.
//
// Design.
//  * No grid-carried state.  The Pallas grid walks (batch tiles, time
//    chunks) in order and carries the RK4 state across chunks in VMEM
//    scratch.  CUDA blocks run concurrently and in no order, so each block
//    owns `rows` twins and loops over all T steps itself.  Time chunking was
//    a VMEM-budget artifact and is gone: drive rows are read straight from
//    device memory, and under f32 the chunk-boundary rounding is a no-op.
//  * Weights stationary in shared memory.  Every w_l (in, out) and b_l (out,)
//    is copied into shared memory once and read from there for all
//    4 * T evaluations; the state, the RK4 sum and the activations stay in
//    shared memory too.  Device-memory traffic is y0 and the drive in, the
//    trajectory out.  The wrapper (fused_ode_mlp.py:smem_bytes) sizes the
//    block's dynamic shared memory and refuses an MLP that does not fit
//    the 227 KB a block may use.
//  * Geometry.  A block of K1_THREADS threads owns `rows` twins (the
//    wrapper passes 8: 1024 twins -> 128 blocks on the 132 SMs).  Each layer
//    is a (rows, in) x (in, out) product: thread i computes output
//    (i / out, i % out) as a sequential FMA chain over `in`.  Activation
//    rows are stored with an odd stride so that threads of one warp reading
//    different rows at the same k hit different banks.
//  * Arithmetic, term by term as the JAX kernel (make_rk4_step): the host
//    rounds dt, dt/2 and dt/6 once from float64 to float32; a layer is dot,
//    then + b, then ReLU (none on the last layer); the update is
//    y + (dt/6) * (((k1 + 2 k2) + 2 k3) + k4).  The RK4 combinations use
//    __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs; the dot
//    products use fmaf and sum in order k = 0..in-1, which is not the
//    order of XLA's or PyTorch's matmul, so parity with the plain version
//    is to a tolerance (1e-4 of the trajectory's peak), not bitwise.
//
// Bound on this card (H100 SXM).  For the Lorenz96 fleet request (B=1024
// twins, T=200 steps, 6->64->64->6): 4 evaluations * 2 * 4,864 MACs =
// 9,728 FLOP per twin-step, 7.97 GFLOP per request, about 0.12 ms at the
// 67 TFLOP/s FP32 peak without tensor cores; the 4.94 MB trajectory write
// is 1.5 us at 3.35 TB/s.  So the operations bound it, and in this simple
// kernel the serial chain of 200 * 4 * 3 dependent layers (each ending in
// a block barrier) bounds it further: the measured time is in PERF.md.
// wgmma, TMA and clusters are later work.

#include <cuda_runtime.h>

#define K1_MAX_LAYERS 8
#define K1_THREADS 256

struct K1Mlp {
  const float* w[K1_MAX_LAYERS];   // (in_l, out_l) row-major
  const float* b[K1_MAX_LAYERS];   // (out_l,)
  int sizes[K1_MAX_LAYERS + 1];    // in_0, out_0 = in_1, ..., out_{L-1}
  int num_layers;
};

// Floats of dynamic shared memory one block needs (the Python wrapper's
// smem_bytes computes the same number).
static long long k1_smem_floats(const K1Mlp& m, int rows) {
  long long params = 0;
  int hidden = 0;
  for (int l = 0; l < m.num_layers; ++l) {
    params += (long long)m.sizes[l] * m.sizes[l + 1] + m.sizes[l + 1];
    if (l + 1 < m.num_layers && m.sizes[l + 1] > hidden) hidden = m.sizes[l + 1];
  }
  const int D = m.sizes[m.num_layers];
  const int xstride = m.sizes[0] | 1;
  const int hstride = hidden > 0 ? (hidden | 1) : 0;
  return params + (long long)rows * (3 * D + xstride + 2 * hstride);
}

__global__ void __launch_bounds__(K1_THREADS)
k1_rollout_kernel(const float* __restrict__ y0, const float* __restrict__ u,
                  float* __restrict__ out, const K1Mlp mlp, int B, int T,
                  int D, int Du, long long u_twin_stride, float dt, float dt2,
                  float dt6, int rows, int hstride) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = mlp.num_layers;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);

  // Weights resident for the whole rollout.
  int off = 0;
  for (int l = 0; l < L; ++l) {
    const int nw = mlp.sizes[l] * mlp.sizes[l + 1];
    const int nb = mlp.sizes[l + 1];
    const float* w = mlp.w[l];
    const float* b = mlp.b[l];
    for (int i = tid; i < nw; i += nt) smem[off + i] = w[i];
    off += nw;
    for (int i = tid; i < nb; i += nt) smem[off + i] = b[i];
    off += nb;
  }
  const int in0 = mlp.sizes[0];
  const int xstride = in0 | 1;
  float* ys = smem + off;              // (rows, D)   state y_t
  float* acc = ys + rows * D;          // (rows, D)   k1 + 2 k2 + 2 k3
  float* ks = acc + rows * D;          // (rows, D)   last layer's output k_s
  float* xs = ks + rows * D;           // (rows, xstride)  MLP input [u, y']
  float* h0 = xs + rows * xstride;     // (rows, hstride)  hidden ping
  float* h1 = h0 + rows * hstride;     // (rows, hstride)  hidden pong

  for (int i = tid; i < nr * D; i += nt) {
    const float v = y0[(long long)r0 * D + i];
    ys[i] = v;
    out[(long long)r0 * D + i] = v;    // trajectory row 0 = y0
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int s = 0; s < 4; ++s) {
      // Stage input: u at half-step h, and y + c * k_{s-1}; fold k_{s-1}
      // into the RK4 sum on the way.
      const int h = 2 * t + (s == 0 ? 0 : (s == 3 ? 2 : 1));
      const float c = (s == 3) ? dt : dt2;
      for (int i = tid; i < nr * in0; i += nt) {
        const int r = i / in0;
        const int col = i - r * in0;
        float v;
        if (col < Du) {
          v = u[(long long)(r0 + r) * u_twin_stride + (long long)h * Du + col];
        } else {
          const int j = r * D + (col - Du);
          v = ys[j];
          if (s > 0) {
            const float k = ks[j];
            v = __fadd_rn(v, __fmul_rn(c, k));
            acc[j] = (s == 1) ? k : __fadd_rn(acc[j], __fmul_rn(2.0f, k));
          }
        }
        xs[r * xstride + col] = v;
      }
      __syncthreads();

      // MLP: dot, + b, ReLU (none on the last layer).
      const float* src = xs;
      int sstride = xstride;
      int woff = 0;
      for (int l = 0; l < L; ++l) {
        const int din = mlp.sizes[l];
        const int dout = mlp.sizes[l + 1];
        const float* W = smem + woff;
        const float* bias = W + din * dout;
        woff += din * dout + dout;
        const bool last = (l == L - 1);
        float* dst = last ? ks : ((l & 1) ? h1 : h0);
        const int dstride = last ? D : hstride;
        for (int i = tid; i < nr * dout; i += nt) {
          const int r = i / dout;
          const int j = i - r * dout;
          const float* x = src + r * sstride;
          float a = 0.0f;
#pragma unroll 4
          for (int k = 0; k < din; ++k) a = fmaf(x[k], W[k * dout + j], a);
          a = __fadd_rn(a, bias[j]);
          if (!last && a < 0.0f) a = 0.0f;
          dst[r * dstride + j] = a;
        }
        __syncthreads();
        src = dst;
        sstride = dstride;
      }
    }
    // ks holds k4: y <- y + (dt/6) * (acc + k4); store trajectory row t+1.
    float* row = out + ((long long)(t + 1) * B + r0) * D;
    for (int i = tid; i < nr * D; i += nt) {
      const float y = __fadd_rn(ys[i], __fmul_rn(dt6, __fadd_rn(acc[i], ks[i])));
      ys[i] = y;
      row[i] = y;
    }
    __syncthreads();
  }
}

// Launch K1 on `stream`.  Pointers are device pointers except w_ptrs,
// b_ptrs and sizes, which are host arrays of num_layers, num_layers and
// num_layers + 1 entries.  u may be null when Du == 0; u_twin_stride is 0
// for a drive shared by the fleet and (2T+1)*Du for one drive per twin.
// Returns the cudaError_t of the launch (0 on success); nothing is
// allocated and nothing synchronises.
extern "C" int k1_fused_node_rollout_f32(
    const void* y0, const void* u, void* out, const void* w_ptrs,
    const void* b_ptrs, const void* sizes, int num_layers, int B, int T,
    int D, int Du, long long u_twin_stride, float dt, float dt2, float dt6,
    int rows, long long smem_bytes, void* stream) {
  if (num_layers < 1 || num_layers > K1_MAX_LAYERS || B < 1 || T < 0 ||
      rows < 1)
    return (int)cudaErrorInvalidValue;
  K1Mlp mlp;
  const void* const* w = static_cast<const void* const*>(w_ptrs);
  const void* const* b = static_cast<const void* const*>(b_ptrs);
  const int* sz = static_cast<const int*>(sizes);
  mlp.num_layers = num_layers;
  int hidden = 0;
  for (int l = 0; l < num_layers; ++l) {
    mlp.w[l] = static_cast<const float*>(w[l]);
    mlp.b[l] = static_cast<const float*>(b[l]);
    if (l + 1 < num_layers && sz[l + 1] > hidden) hidden = sz[l + 1];
  }
  for (int l = 0; l <= num_layers; ++l) mlp.sizes[l] = sz[l];
  if (mlp.sizes[0] != Du + D || mlp.sizes[num_layers] != D)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != 4 * k1_smem_floats(mlp, rows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();   // clear any stale error first
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(k1_rollout_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int hstride = hidden > 0 ? (hidden | 1) : 0;
  const int grid = (B + rows - 1) / rows;
  k1_rollout_kernel<<<grid, K1_THREADS, (size_t)smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y0), static_cast<const float*>(u),
      static_cast<float*>(out), mlp, B, T, D, Du, u_twin_stride, dt, dt2, dt6,
      rows, hstride);
  return (int)cudaGetLastError();
}
