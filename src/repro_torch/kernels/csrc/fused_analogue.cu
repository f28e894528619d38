// K4 on Hopper: the fused analogue RK4 rollout through memristor crossbar
// pairs, and the K3 fill kernel.
//
// Replaces repro/kernels/fused_analogue.py:fused_analogue_rollout (the
// Pallas kernel built by _make_kernel there).  It computes the trajectory
// of dy/dt = MLP_analogue([u(t), y]) for a fleet of B twins, out (T+1, B, D)
// float32, row 0 = y0, where each layer l is a differential pair of
// conductance arrays G+, G- of shape (in_l + 1, out_l), the bias folded in
// as the last row, read as
//   noise-free:  y = x @ W[:-1] + W[-1],  W = ((G+ - G-)[* g_step]) * (1/scale_l)
//   read noise:  g = G+ (1 + s e+) - G- (1 + s e-)  (e+-, e- fresh per read)
//                y = (x @ g[:-1] + g[-1]) * (1/scale_l)
// then * dfac (live drift), then the clamp, then ReLU between layers.
//
// Design (K1's, fused_ode_mlp.cu, with the crossbar read inside):
//  * One block of 256 threads owns `rows` twins (the wrapper passes 8) for
//    all T steps; the Pallas grid's carried chunk state has no counterpart.
//  * The arrays are resident in shared memory.  Noise-free, each pair is
//    combined once at block start into W with the scale folded in (uint8
//    level indices dequantised through g_step; with stuck cells the
//    absolute conductances g_min + idx * g_step are rebuilt and pinned
//    first), so the inner loop is K1's.  With read noise both halves stay
//    as absolute float32 conductances (stuck cells pinned once), and for
//    every evaluation and layer all threads write the noisy difference into
//    a shared scratch of the largest layer's size, synchronise, then run
//    the layer.
//  * Noise: counter_noise.cuh (K3).  Salt ((step_offset + t) * 8L +
//    stage * 2L) + 2 l (+1 for G-), element id the row-major flat index
//    over the whole (in_l + 1, out_l) array, as the JAX kernel draws over
//    unblocked arrays.  The noise is the same for every twin, so every
//    block computes the same numbers: that redundancy (B/rows times the
//    generation) is accepted in this first version and written down in
//    PERF.md.  Stuck cells use the global ids of the same arrays, so they
//    are bitwise the masks core/faults.py bakes at programming time.
//  * step_offset is an argument, so a rollout resumed at step k with
//    step_offset = k replays the unsplit rollout's salts and drift.
//  * Arithmetic: products and sums that the reference rounds separately
//    use __fmul_rn / __fadd_rn so nvcc cannot contract them; dot products
//    are fmaf chains in order k = 0..in-1 (not the plain version's matmul
//    order), so kernel vs plain is held to 1e-4 of the peak.
//
// Bound on this card (H100 SXM), Lorenz96 fleet request (B=1024, T=200,
// 6->64->64->6): the MLP is 7.97 GFLOP, 0.119 ms at the 67 TFLOP/s FP32
// peak; the 4.9 MB trajectory write is 1.5 us.  With read noise each
// evaluation also needs 2 * 4,998 normals (~50 FP32 operations each, once
// per evaluation however many blocks redo them): 0.4 GFLOP more.  So the
// operations bound it; like K1 this simple kernel is further bound by its
// serial chain of barriered layers (measured times in PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

#define K4_MAX_LAYERS 8
#define K4_THREADS 256

struct K4Arrays {
  const void* gp[K4_MAX_LAYERS];   // (in_l + 1, out_l) row-major, f32 or uint8
  const void* gm[K4_MAX_LAYERS];
  int sizes[K4_MAX_LAYERS + 1];    // in_0, out_0 = in_1, ..., out_{L-1}
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
  long long step_offset;
};

// Floats of dynamic shared memory one block needs (the Python wrapper's
// smem_bytes_analogue computes the same number).
static long long k4_smem_floats(const K4Arrays& a, int rows, bool noisy) {
  long long arrays = 0, largest = 0;
  int hidden = 0;
  for (int l = 0; l < a.num_layers; ++l) {
    const long long n = (long long)(a.sizes[l] + 1) * a.sizes[l + 1];
    arrays += n;
    if (n > largest) largest = n;
    if (l + 1 < a.num_layers && a.sizes[l + 1] > hidden) hidden = a.sizes[l + 1];
  }
  if (noisy) arrays = 2 * arrays + largest;
  const int D = a.sizes[a.num_layers];
  const int xstride = a.sizes[0] | 1;
  const int hstride = hidden > 0 ? (hidden | 1) : 0;
  return arrays + (long long)rows * (3 * D + xstride + 2 * hstride);
}

__device__ __forceinline__ float k4_load(const void* p, int u8, int i) {
  return u8 ? (float)static_cast<const unsigned char*>(p)[i]
            : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(K4_THREADS)
k4_rollout_kernel(const float* __restrict__ y0, const float* __restrict__ u,
                  float* __restrict__ out, const float* __restrict__ scales,
                  const K4Arrays arr, const K4Read rd, int B, int T, int D,
                  int Du, long long u_twin_stride, int rows, int hstride) {
  extern __shared__ float smem[];
  __shared__ float inv_s[K4_MAX_LAYERS];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = arr.num_layers;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);
  const bool noisy = rd.read_noise > 0.0f;
  const bool stuck = rd.stuck_rate > 0.0f;
  const bool drift = rd.drift_nu > 0.0f;

  if (tid < L) inv_s[tid] = __fdiv_rn(1.0f, scales[tid]);
  __syncthreads();

  // Resident arrays: W per layer (noise-free), or G+ per layer then G- per
  // layer then the noise scratch (read noise).
  int total = 0, largest = 0;
  for (int l = 0; l < L; ++l) {
    const int n = (arr.sizes[l] + 1) * arr.sizes[l + 1];
    total += n;
    largest = max(largest, n);
  }
  float* GP = smem;                          // W when noise-free
  float* GM = smem + total;                  // noisy only
  float* S = smem + 2 * total;               // noisy only
  float* acts = noisy ? S + largest : smem + total;
  int off = 0;
  for (int l = 0; l < L; ++l) {
    const int n = (arr.sizes[l] + 1) * arr.sizes[l + 1];
    const uint32_t salt_p = (uint32_t)(rd.salt_base + 2 * l);
    const uint32_t salt_m = (uint32_t)(rd.salt_base + 2 * l + 1);
    for (int i = tid; i < n; i += nt) {
      float a = k4_load(arr.gp[l], rd.u8, i);
      float b = k4_load(arr.gm[l], rd.u8, i);
      if (rd.u8 && (noisy || stuck)) {
        a = __fadd_rn(rd.g_min, __fmul_rn(a, rd.g_step));
        b = __fadd_rn(rd.g_min, __fmul_rn(b, rd.g_step));
      }
      if (stuck) {
        a = stuck_at(a, rd.fault_seed, salt_p, (uint32_t)i, rd.stuck_rate,
                     rd.stuck_on_frac, rd.g_max, rd.g_min);
        b = stuck_at(b, rd.fault_seed, salt_m, (uint32_t)i, rd.stuck_rate,
                     rd.stuck_on_frac, rd.g_max, rd.g_min);
      }
      if (noisy) {
        GP[off + i] = a;
        GM[off + i] = b;
      } else {
        float g = __fsub_rn(a, b);
        if (rd.u8 && !stuck) g = __fmul_rn(g, rd.g_step);
        GP[off + i] = __fmul_rn(g, inv_s[l]);
      }
    }
    off += n;
  }

  const int in0 = arr.sizes[0];
  const int xstride = in0 | 1;
  float* ys = acts;                    // (rows, D)   state y_t
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
    const long long gstep = rd.step_offset + t;
    float dfac = 1.0f;
    if (drift) {
      const float n = (float)(rd.drift_n0 + 4 * gstep);
      dfac = expf(__fmul_rn(-rd.drift_nu, log1pf(__fdiv_rn(n, rd.drift_tau))));
    }
    const long long step_salt = noisy ? gstep * 8LL * L : 0;
    for (int s = 0; s < 4; ++s) {
      // Stage input: u at half-step h, and y + c * k_{s-1}; fold k_{s-1}
      // into the RK4 sum on the way (K1's arithmetic).
      const int h = 2 * t + (s == 0 ? 0 : (s == 3 ? 2 : 1));
      const float c = (s == 3) ? rd.dt : rd.dt2;
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

      const long long eval_salt = step_salt + (long long)s * 2 * L;
      const float* src = xs;
      int sstride = xstride;
      int woff = 0;
      for (int l = 0; l < L; ++l) {
        const int din = arr.sizes[l];
        const int dout = arr.sizes[l + 1];
        const int n = (din + 1) * dout;
        const float* W = GP + woff;
        if (noisy) {
          const uint32_t bp = cn_base(rd.noise_seed,
                                      (uint32_t)(eval_salt + 2 * l));
          const uint32_t bm = cn_base(rd.noise_seed,
                                      (uint32_t)(eval_salt + 2 * l + 1));
          const float* gp = GP + woff;
          const float* gm = GM + woff;
          for (int i = tid; i < n; i += nt) {
            const float ep = cn_normal_from_base(bp, (uint32_t)i);
            const float em = cn_normal_from_base(bm, (uint32_t)i);
            const float a = __fmul_rn(
                gp[i], __fadd_rn(1.0f, __fmul_rn(rd.read_noise, ep)));
            const float b = __fmul_rn(
                gm[i], __fadd_rn(1.0f, __fmul_rn(rd.read_noise, em)));
            S[i] = __fsub_rn(a, b);
          }
          __syncthreads();
          W = S;
        }
        woff += n;
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
          a = __fadd_rn(a, W[din * dout + j]);
          if (noisy) a = __fmul_rn(a, inv_s[l]);
          if (drift) a = __fmul_rn(a, dfac);
          if (rd.has_clamp) a = fminf(fmaxf(a, -rd.v_clamp), rd.v_clamp);
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
      const float y = __fadd_rn(ys[i],
                                __fmul_rn(rd.dt6, __fadd_rn(acc[i], ks[i])));
      ys[i] = y;
      row[i] = y;
    }
    __syncthreads();
  }
}

// Launch K4 on `stream`.  Pointers are device pointers except gp_ptrs,
// gm_ptrs and sizes, which are host arrays of num_layers, num_layers and
// num_layers + 1 entries, and `read`, a host K4Read.  u may be null when
// Du == 0; u_twin_stride is 0 for a drive shared by the fleet and
// (2T+1)*Du for one drive per twin.  Returns the cudaError_t of the launch
// (0 on success); nothing is allocated and nothing synchronises.
extern "C" int k4_fused_analogue_rollout_f32(
    const void* y0, const void* u, void* out, const void* scales,
    const void* gp_ptrs, const void* gm_ptrs, const void* sizes,
    int num_layers, const void* read, int B, int T, int D, int Du,
    long long u_twin_stride, int rows, long long smem_bytes, void* stream) {
  if (num_layers < 1 || num_layers > K4_MAX_LAYERS || B < 1 || T < 0 ||
      rows < 1)
    return (int)cudaErrorInvalidValue;
  K4Arrays arr;
  const void* const* gp = static_cast<const void* const*>(gp_ptrs);
  const void* const* gm = static_cast<const void* const*>(gm_ptrs);
  const int* sz = static_cast<const int*>(sizes);
  const K4Read rd = *static_cast<const K4Read*>(read);
  arr.num_layers = num_layers;
  int hidden = 0;
  for (int l = 0; l < num_layers; ++l) {
    arr.gp[l] = gp[l];
    arr.gm[l] = gm[l];
    if (l + 1 < num_layers && sz[l + 1] > hidden) hidden = sz[l + 1];
  }
  for (int l = 0; l <= num_layers; ++l) arr.sizes[l] = sz[l];
  if (arr.sizes[0] != Du + D || arr.sizes[num_layers] != D)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != 4 * k4_smem_floats(arr, rows, rd.read_noise > 0.0f))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();   // clear any stale error first
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(k4_rollout_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int hstride = hidden > 0 ? (hidden | 1) : 0;
  const int grid = (B + rows - 1) / rows;
  k4_rollout_kernel<<<grid, K4_THREADS, (size_t)smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y0), static_cast<const float*>(u),
      static_cast<float*>(out), static_cast<const float*>(scales), arr, rd, B,
      T, D, Du, u_twin_stride, rows, hstride);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3 fill kernel: the counter stream written to device memory, for
// repro_torch.kernels.noise on CUDA tensors (and chip_smoke.py's check of
// the stream alone).  Modes:
//   0  out0[i] (int64) = splitmix32(in[i])                      i < n
//   1  out0[i] (f32)   = counter_uniform_at(seed, salt, in[i])  i < n
//   2  out0[i] (f32)   = counter_normal_at(seed, salt, i)       i < n
//   3  out0/out1 (bool) = is_stuck / stuck_on of the (rows, cols) block at
//      (row0, col0) of a (?, ncols) array, ids (row0 + r) * ncols + col0 + c
// Integer inputs are uint32 values held in int64, as the plain version
// holds them.
// ---------------------------------------------------------------------------

__global__ void k3_fill_kernel(int mode, uint32_t seed, uint32_t salt,
                               const long long* __restrict__ in, long long n,
                               int cols, uint32_t row0, uint32_t col0,
                               uint32_t ncols, float rate, float on_frac,
                               void* out0, void* out1) {
  const uint32_t base = cn_base(seed, salt);
  const uint32_t base_on = cn_base(seed, salt + CN_POLARITY_SALT_OFFSET);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (mode == 0) {
      static_cast<long long*>(out0)[i] =
          (long long)cn_splitmix32((uint32_t)in[i]);
    } else if (mode == 1) {
      static_cast<float*>(out0)[i] = cn_uniform_from_base(base, (uint32_t)in[i]);
    } else if (mode == 2) {
      static_cast<float*>(out0)[i] = cn_normal_from_base(base, (uint32_t)i);
    } else {
      const uint32_t r = (uint32_t)(i / cols);
      const uint32_t c = (uint32_t)(i - (long long)r * cols);
      const uint32_t idx = (row0 + r) * ncols + (col0 + c);
      static_cast<unsigned char*>(out0)[i] =
          cn_uniform_from_base(base, idx) < rate ? 1 : 0;
      static_cast<unsigned char*>(out1)[i] =
          cn_uniform_from_base(base_on, idx) < on_frac ? 1 : 0;
    }
  }
}

// Launch the K3 fill on `stream` over n elements (mode 3: n = rows * cols);
// returns the launch's cudaError_t.
extern "C" int k3_counter_fill(int mode, unsigned int seed, unsigned int salt,
                               const void* in, long long n, int cols,
                               unsigned int row0, unsigned int col0,
                               unsigned int ncols, float rate, float on_frac,
                               void* out0, void* out1, void* stream) {
  if (mode < 0 || mode > 3 || n < 0 || (mode == 3 && cols < 1) ||
      ((mode == 0 || mode == 1) && in == nullptr && n > 0))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();   // clear any stale error first
  if (n == 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  k3_fill_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, seed, salt, static_cast<const long long*>(in), n, cols, row0,
      col0, ncols, rate, on_frac, out0, out1);
  return (int)cudaGetLastError();
}
