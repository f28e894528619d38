// K2 on Hopper: reverse-time VJP of the weights-stationary RK4 rollout.
//
// Replaces repro/kernels/fused_ode_mlp_bwd.py:fused_node_rollout_bwd (the
// Pallas kernel built by _make_bwd_kernel there), float32 policy only.
// Given the forward trajectory traj (T+1, B, D) that K1 wrote, the drive at
// half-steps, the MLP weights w_l (in, out) and biases b_l (out,), and the
// cotangent g (T+1, B, D) of every trajectory row, it returns
//   dy0 (B, D)   the cotangent of y0 (g[0] included),
//   grads (P,)   dW_0, db_0, dW_1, db_1, ... flattened row-major, summed
//                over the fleet and all T steps.
// The drive is data: it gets no cotangent.
//
// Design.
//  * No grid-carried state.  The Pallas grid walks time chunks in reverse
//    and accumulates dW/db into one output block for the whole grid, which
//    relies on the TPU running grid cells in order.  Here each block owns
//    `rows` twins for all T steps and carries their adjoint a (rows, D) in
//    shared memory; nothing crosses blocks during the sweep.
//  * No replay of chunks.  Step t reads its state straight from trajectory
//    row t: these are exactly the states K1 continued with.  The step's
//    four stages are recomputed into shared memory with K1's arithmetic
//    (the same fmaf order, the same host-rounded dt, dt/2, dt/6), so the
//    stage inputs and post-ReLU activations equal the forward's bit for
//    bit; an activation's sign is the ReLU mask.  relu'(0) = 0, as
//    torch.relu's gradient in the plain version (the JAX kernel's
//    jnp.maximum(x, 0) splits a tie 0.5/0.5; only an exactly zero
//    pre-activation tells the two apart).
//  * Pull-back through the exact update y + (dt/6)*(((k1 + 2k2) + 2k3) + k4)
//    whose stages sample the drive at u0, um, um, u1:
//      c = (dt/6) a;  gk1 = gk4 = c;  gk2 = gk3 = 2c;
//    then stages 4, 3, 2, 1, each back through the MLP to the cotangent gx
//    of its input y + c_s k_{s-1}:  a += gx;  gk_{s-1} += c_s gx
//    (c_s = dt for stage 4, dt/2 for stages 3 and 2).
//  * Weight gradients without atomics.  Each weight or bias entry is owned
//    by one thread of the block, which adds its block's contribution in a
//    fixed order (twins 0..rows-1 within a stage, stages 4..1 within a
//    step, steps T-1..0).  At the end each block writes its sums to row
//    blockIdx.x of a (blocks, P) buffer, and k2_reduce_kernel sums the rows
//    in block order.  So one K2 call is two launches, and a repeated call
//    gives bitwise-identical gradients.
//  * Shared memory.  The weights (rows padded to an odd stride so that a
//    warp reading a column, as the backward product does, hits 32
//    different banks), the gradient accumulators, and per twin the
//    adjoint, the state, the stage output, four stage cotangents, four
//    stage inputs and the 4 * (L-1) hidden activations of the step, plus
//    two hidden-width buffers for the backward.  fused_ode_mlp_bwd.py:
//    smem_bytes_bwd computes the same size and refuses a width over the
//    227 KB a block may use; above 48 KB the launch raises the block's
//    dynamic allowance first.
//
// Bound on this card (H100 SXM).  Per twin-step, the forward recompute is
// 4 * 2 * MACs FLOP and the backward per stage a second product for the
// weight gradient and a third for the input cotangent: ~3x K1's work, so
// the operations bound it (at B=1024, T=200, 6->64->64->6: ~23.9 GFLOP,
// ~0.36 ms at 67 TFLOP/s FP32).  Like K1, this simple kernel is held back
// by its serial chain instead: per step 4 stages x 2 directions x L layers,
// each ending in a block barrier.  The measured times are in PERF.md.

#include <cuda_runtime.h>

#define K2_MAX_LAYERS 8
#define K2_THREADS 256
#define K2_REDUCE_THREADS 256

struct K2Mlp {
  const float* w[K2_MAX_LAYERS];   // (in_l, out_l) row-major
  const float* b[K2_MAX_LAYERS];   // (out_l,)
  int sizes[K2_MAX_LAYERS + 1];    // in_0, out_0 = in_1, ..., out_{L-1}
  int num_layers;
};

// Floats of dynamic shared memory one block needs (the Python wrapper's
// smem_bytes_bwd computes the same number).
static long long k2_smem_floats(const K2Mlp& m, int rows) {
  long long wpad = 0, params = 0;
  int hidden = 0;
  for (int l = 0; l < m.num_layers; ++l) {
    const int din = m.sizes[l], dout = m.sizes[l + 1];
    wpad += (long long)din * (dout | 1) + dout;
    params += (long long)din * dout + dout;
    if (l + 1 < m.num_layers && dout > hidden) hidden = dout;
  }
  const int L = m.num_layers;
  const int D = m.sizes[L];
  const int xstride = m.sizes[0] | 1;
  const int hstride = hidden > 0 ? (hidden | 1) : 0;
  return wpad + params +
         (long long)rows * (7 * D + 4 * xstride + 4 * (L - 1) * hstride +
                            2 * hstride);
}

__global__ void __launch_bounds__(K2_THREADS)
k2_rollout_bwd_kernel(const float* __restrict__ traj,
                      const float* __restrict__ u,
                      const float* __restrict__ g, float* __restrict__ dy0,
                      float* __restrict__ partial, const K2Mlp mlp, int B,
                      int T, int D, int Du, long long u_twin_stride,
                      long long P, float dt, float dt2, float dt6, int rows,
                      int hstride) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = mlp.num_layers;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);

  // Layout: padded weights + biases, then the flat gradient accumulators.
  int woffs[K2_MAX_LAYERS], goffs[K2_MAX_LAYERS];
  int off = 0, goff = 0;
  for (int l = 0; l < L; ++l) {
    const int din = mlp.sizes[l], dout = mlp.sizes[l + 1];
    woffs[l] = off;
    goffs[l] = goff;
    off += din * (dout | 1) + dout;
    goff += din * dout + dout;
  }
  float* gacc = smem + off;                       // (P,) dW_0, db_0, ...
  const int in0 = mlp.sizes[0];
  const int xstride = in0 | 1;
  float* a = gacc + P;                            // (rows, D) adjoint
  float* ys = a + rows * D;                       // (rows, D) y_t
  float* ks = ys + rows * D;                      // (rows, D) stage output
  float* gk = ks + rows * D;                      // 4 x (rows, D)
  float* xs = gk + 4 * rows * D;                  // 4 x (rows, xstride)
  float* hs = xs + 4 * rows * xstride;            // 4 x (L-1) x (rows, hstride)
  float* d0 = hs + 4 * (L - 1) * rows * hstride;  // (rows, hstride)
  float* d1 = d0 + rows * hstride;                // (rows, hstride)

  for (int l = 0; l < L; ++l) {
    const int din = mlp.sizes[l], dout = mlp.sizes[l + 1];
    const int ws = dout | 1;
    float* W = smem + woffs[l];
    float* bias = W + din * ws;
    for (int i = tid; i < din * dout; i += nt) {
      const int k = i / dout;
      W[k * ws + (i - k * dout)] = mlp.w[l][i];
    }
    for (int i = tid; i < dout; i += nt) bias[i] = mlp.b[l][i];
  }
  for (long long i = tid; i < P; i += nt) gacc[i] = 0.0f;
  for (int i = tid; i < nr * D; i += nt) a[i] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // The adjoint picks up the cotangent of row t+1; load the state y_t.
    const long long row_t = ((long long)t * B + r0) * D;
    const long long row_t1 = row_t + (long long)B * D;
    for (int i = tid; i < nr * D; i += nt) {
      ys[i] = traj[row_t + i];
      a[i] = __fadd_rn(a[i], g[row_t1 + i]);
    }
    __syncthreads();

    // -- forward recompute of the step's four stages (K1's arithmetic) ----
    for (int s = 0; s < 4; ++s) {
      const int h = 2 * t + (s == 0 ? 0 : (s == 3 ? 2 : 1));
      const float c = (s == 3) ? dt : dt2;
      float* xs_s = xs + s * rows * xstride;
      for (int i = tid; i < nr * in0; i += nt) {
        const int r = i / in0;
        const int col = i - r * in0;
        float v;
        if (col < Du) {
          v = u[(long long)(r0 + r) * u_twin_stride + (long long)h * Du + col];
        } else {
          const int j = r * D + (col - Du);
          v = ys[j];
          if (s > 0) v = __fadd_rn(v, __fmul_rn(c, ks[j]));
        }
        xs_s[r * xstride + col] = v;
      }
      __syncthreads();
      const float* src = xs_s;
      int sstride = xstride;
      for (int l = 0; l < L; ++l) {
        const int din = mlp.sizes[l], dout = mlp.sizes[l + 1];
        const int ws = dout | 1;
        const float* W = smem + woffs[l];
        const float* bias = W + din * ws;
        const bool last = (l == L - 1);
        float* dst = last ? ks : hs + (s * (L - 1) + l) * rows * hstride;
        const int dstride = last ? D : hstride;
        for (int i = tid; i < nr * dout; i += nt) {
          const int r = i / dout;
          const int j = i - r * dout;
          const float* x = src + r * sstride;
          float acc = 0.0f;
#pragma unroll 4
          for (int k = 0; k < din; ++k) acc = fmaf(x[k], W[k * ws + j], acc);
          acc = __fadd_rn(acc, bias[j]);
          if (!last && acc < 0.0f) acc = 0.0f;
          dst[r * dstride + j] = acc;
        }
        __syncthreads();
        src = dst;
        sstride = dstride;
      }
    }

    // -- pull-back through the RK4 update ----------------------------------
    for (int i = tid; i < nr * D; i += nt) {
      const float cst = __fmul_rn(dt6, a[i]);
      const float c2 = __fmul_rn(2.0f, cst);
      gk[i] = cst;
      gk[rows * D + i] = c2;
      gk[2 * rows * D + i] = c2;
      gk[3 * rows * D + i] = cst;
    }
    __syncthreads();

    // -- stages 4, 3, 2, 1 back through the MLP ------------------------------
    for (int s = 3; s >= 0; --s) {
      const float* xs_s = xs + s * rows * xstride;
      const float cs = (s == 3) ? dt : dt2;     // stage input y + cs k_{s-1}
      const float* delta = gk + s * rows * D;   // cotangent of this layer's
      int dstr = D;                             // pre-activation output
      for (int l = L - 1; l >= 0; --l) {
        const int din = mlp.sizes[l], dout = mlp.sizes[l + 1];
        const int ws = dout | 1;
        const float* W = smem + woffs[l];
        const float* in = (l == 0) ? xs_s
                                   : hs + (s * (L - 1) + l - 1) * rows * hstride;
        const int istr = (l == 0) ? xstride : hstride;
        float* gW = gacc + goffs[l];
        float* gb = gW + din * dout;
        // weight and bias gradients: entry i is owned by one thread
        for (int i = tid; i < din * dout + dout; i += nt) {
          float acc = 0.0f;
          if (i < din * dout) {
            const int k = i / dout;
            const int j = i - k * dout;
            for (int r = 0; r < nr; ++r)
              acc = fmaf(in[r * istr + k], delta[r * dstr + j], acc);
            gW[i] = __fadd_rn(gW[i], acc);
          } else {
            const int j = i - din * dout;
            for (int r = 0; r < nr; ++r) acc = __fadd_rn(acc, delta[r * dstr + j]);
            gb[j] = __fadd_rn(gb[j], acc);
          }
        }
        if (l > 0) {
          // cotangent of the layer's input, masked by the ReLU that made it
          float* dn = (delta == d0) ? d1 : d0;
          for (int i = tid; i < nr * din; i += nt) {
            const int r = i / din;
            const int k = i - r * din;
            float acc = 0.0f;
            for (int j = 0; j < dout; ++j)
              acc = fmaf(W[k * ws + j], delta[r * dstr + j], acc);
            dn[r * hstride + k] = (in[r * istr + k] > 0.0f) ? acc : 0.0f;
          }
          __syncthreads();
          delta = dn;
          dstr = hstride;
        } else {
          // cotangent of the stage input's y columns: into a and k_{s-1}
          for (int i = tid; i < nr * D; i += nt) {
            const int r = i / D;
            const int k = Du + (i - r * D);
            float acc = 0.0f;
            for (int j = 0; j < dout; ++j)
              acc = fmaf(W[k * ws + j], delta[r * dstr + j], acc);
            a[i] = __fadd_rn(a[i], acc);
            if (s > 0) {
              float* gprev = gk + (s - 1) * rows * D;
              gprev[i] = __fadd_rn(gprev[i], __fmul_rn(cs, acc));
            }
          }
          __syncthreads();
        }
      }
    }
  }

  // dL/dy0 = a + g[0]; this block's gradient sums to its partial row.
  for (int i = tid; i < nr * D; i += nt)
    dy0[(long long)r0 * D + i] = __fadd_rn(a[i], g[(long long)r0 * D + i]);
  float* prow = partial + (long long)blockIdx.x * P;
  for (long long i = tid; i < P; i += nt) prow[i] = gacc[i];
}

// grads[p] = sum over blocks b = 0, 1, ... of partial[b, p], in that order.
__global__ void k2_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ grads, int blocks,
                                 long long P) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc = __fadd_rn(acc, partial[b * P + p]);
  grads[p] = acc;
}

// Launch K2 on `stream`: the reverse sweep, then the fixed-order reduction.
// Pointers are device pointers except w_ptrs, b_ptrs and sizes, which are
// host arrays of num_layers, num_layers and num_layers + 1 entries.  u may
// be null when Du == 0; u_twin_stride is 0 for a drive shared by the fleet
// and (2T+1)*Du for one drive per twin.  partial holds ceil(B/rows) * P
// floats of scratch; grads receives P floats.  Returns the cudaError_t of
// the launches (0 on success); nothing is allocated and nothing
// synchronises.
extern "C" int k2_fused_node_rollout_bwd_f32(
    const void* traj, const void* u, const void* g, void* dy0, void* partial,
    void* grads, const void* w_ptrs, const void* b_ptrs, const void* sizes,
    int num_layers, int B, int T, int D, int Du, long long u_twin_stride,
    float dt, float dt2, float dt6, int rows, long long smem_bytes,
    void* stream) {
  if (num_layers < 1 || num_layers > K2_MAX_LAYERS || B < 1 || T < 0 ||
      rows < 1)
    return (int)cudaErrorInvalidValue;
  K2Mlp mlp;
  const void* const* w = static_cast<const void* const*>(w_ptrs);
  const void* const* b = static_cast<const void* const*>(b_ptrs);
  const int* sz = static_cast<const int*>(sizes);
  mlp.num_layers = num_layers;
  int hidden = 0;
  long long P = 0;
  for (int l = 0; l < num_layers; ++l) {
    mlp.w[l] = static_cast<const float*>(w[l]);
    mlp.b[l] = static_cast<const float*>(b[l]);
    if (l + 1 < num_layers && sz[l + 1] > hidden) hidden = sz[l + 1];
    P += (long long)sz[l] * sz[l + 1] + sz[l + 1];
  }
  for (int l = 0; l <= num_layers; ++l) mlp.sizes[l] = sz[l];
  if (mlp.sizes[0] != Du + D || mlp.sizes[num_layers] != D)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != 4 * k2_smem_floats(mlp, rows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();   // clear any stale error first
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(k2_rollout_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int hstride = hidden > 0 ? (hidden | 1) : 0;
  const int blocks = (B + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k2_rollout_bwd_kernel<<<blocks, K2_THREADS, (size_t)smem_bytes, st>>>(
      static_cast<const float*>(traj), static_cast<const float*>(u),
      static_cast<const float*>(g), static_cast<float*>(dy0),
      static_cast<float*>(partial), mlp, B, T, D, Du, u_twin_stride, P, dt,
      dt2, dt6, rows, hstride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rgrid = (int)((P + K2_REDUCE_THREADS - 1) / K2_REDUCE_THREADS);
  k2_reduce_kernel<<<rgrid, K2_REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads), blocks,
      P);
  return (int)cudaGetLastError();
}
