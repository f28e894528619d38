// K3 on Hopper, as its own library: the counter-noise stream written to
// device memory where a caller needs it there.
//
// Replaces repro/kernels/noise.py (splitmix32, counter_uniform_at,
// stuck_cell_masks, counter_normal) where the JAX package runs those
// functions as jnp outside any Pallas kernel: the stuck-cell masks of a
// programming (repro/core/faults.py, repro/core/analogue.py) and the write
// path of hardware-aware training (repro/train/hw_aware.py:140-210,
// write_path_tensor).  Inside K4 and K7 the same stream is
// counter_noise.cuh's inline helpers, which this file includes too.
//
// Entry points (each returns the launch's cudaError_t):
//   k3_counter_fill   one array: splitmix32 bits, uniforms at given ids,
//                     normals at flat ids, or one block's stuck masks;
//   k3_stuck_masks    the (is_stuck, stuck_on) masks of a list of whole
//                     arrays (salt, rows, cols, offset in a descriptor table
//                     passed as a kernel parameter) in one launch: a
//                     programming's 2 L arrays;
//   k3_hw_write_path  hardware-aware training's write path for every layer
//                     and every draw of a step in one launch: from the
//                     folded f32 weights (w rows, bias as the last row) to
//                     w_hw, through JAX's write_path_tensor order
//                       1. differential pair at the layer's scale,
//                       2. 6-bit quantise,
//                       3. programming noise, clipped to [0, 1.5 g_max],
//                       4. stuck pinning,
//                       5. drift snapshot (per-draw factor from the host),
//                       6. read noise,
//                       7. (g+ - g-) / scale,
//                     optionally as the straight-through value
//                     folded + (w_hw - folded).
//
// Bits.  The per-element arithmetic is the plain version's
// (ref.hw_write_tensor_ref) operation by operation, with __fmul_rn /
// __fadd_rn / __fdiv_rn so nvcc cannot contract it: the scale is
// reciprocal(max|w|) * g_range (torch's g_range / tensor), the level
// rintf((g - g_min) / g_step) (round half to even, a true division), the
// read back a true division by the scale.  Each block reduces its layer's
// max|w| itself (a max is exact in any order), so no pass precedes the
// kernel and nothing is read back to the host.  Salts are computed in
// uint32 that wraps, as JAX's: salt_base + ((step k + draw) L + layer) 4
// + 2 pair + channel; the normal's id is the row-major flat index of the
// folded array; under the fault ensemble the stuck seed is
// splitmix32(seed ^ (step k + draw)).  The step is the launch struct's
// ``step`` or, when ``step_ptr`` is set, the int32 counter it points to in
// device memory, read as uint32 (so -1 is step 2^32 - 1): a training step
// captured in a CUDA graph keeps its kernel arguments by value, and the
// counter is what advances between replays.  Uniforms, masks and quantised
// levels are therefore bitwise the plain version's; the normals use
// counter_noise.cuh's precise logf/cosf (within ~1e-6 of torch's).
//
// Bound.  The write path moves the folded weights in once and k_draws
// outputs out (HP at k = 2: 1.1 KB in, 2.1 KB out); with noise each element
// of each draw needs 4 normals (~31 FP32 operations each).  At the training
// shapes both are nanoseconds on this card, so a launch is latency: the
// design answer is one launch per step for all draws and layers (the JAX
// package traces the same chain into its step's jit), the noise generated
// where it is used and never written, and a block per (draw, layer, tile of
// 1024 elements).  The mask fill is likewise one launch per programming.
// No atomics; every output element is written by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_noise.cuh"

#define K3_THREADS 256
#define CN_MAX_ARRAYS 32
#define HW_MAX_LAYERS 8
#define HW_MAX_DRAWS 32
#define HW_TILE (K3_THREADS * 4)

// ---------------------------------------------------------------------------
// k3_counter_fill: the stream of one array.  Modes:
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

// Launch the fill on `stream` over n elements (mode 3: n = rows * cols).
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
  const long long want = (n + K3_THREADS - 1) / K3_THREADS;
  const int blocks = (int)(want < 4096 ? want : 4096);
  k3_fill_kernel<<<blocks, K3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, seed, salt, static_cast<const long long*>(in), n, cols, row0,
      col0, ncols, rate, on_frac, out0, out1);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// k3_stuck_masks: the masks of up to CN_MAX_ARRAYS whole arrays, array a
// (salt, rows, cols) at out[off, off + rows * cols), ids r * cols + c (the
// flat index), block row blockIdx.y = the array.
// ---------------------------------------------------------------------------

struct CnArray {
  unsigned int salt;
  int rows, cols;
  long long off;
};

struct CnArrays {
  CnArray a[CN_MAX_ARRAYS];
  int count;
};

__global__ void __launch_bounds__(K3_THREADS)
k3_masks_kernel(const CnArrays t, uint32_t seed, float rate, float on_frac,
                unsigned char* __restrict__ is_stuck,
                unsigned char* __restrict__ stuck_on) {
  const CnArray a = t.a[blockIdx.y];
  const long long n = (long long)a.rows * a.cols;
  const uint32_t base = cn_base(seed, a.salt);
  const uint32_t base_on = cn_base(seed, a.salt + CN_POLARITY_SALT_OFFSET);
  for (long long i = blockIdx.x * (long long)K3_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * K3_THREADS) {
    is_stuck[a.off + i] = cn_uniform_from_base(base, (uint32_t)i) < rate;
    stuck_on[a.off + i] = cn_uniform_from_base(base_on, (uint32_t)i) < on_frac;
  }
}

extern "C" int k3_stuck_masks(const void* arrays, unsigned int seed,
                              float rate, float on_frac, void* is_stuck,
                              void* stuck_on, void* stream) {
  if (arrays == nullptr || is_stuck == nullptr || stuck_on == nullptr)
    return (int)cudaErrorInvalidValue;
  const CnArrays t = *static_cast<const CnArrays*>(arrays);
  if (t.count < 1 || t.count > CN_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int i = 0; i < t.count; ++i) {
    if (t.a[i].rows < 0 || t.a[i].cols < 0 || t.a[i].off < 0)
      return (int)cudaErrorInvalidValue;
    const long long n = (long long)t.a[i].rows * t.a[i].cols;
    most = n > most ? n : most;
  }
  cudaGetLastError();
  if (most == 0) return 0;
  const long long want = (most + K3_THREADS - 1) / K3_THREADS;
  const dim3 grid((unsigned)(want < 1024 ? want : 1024), (unsigned)t.count);
  k3_masks_kernel<<<grid, K3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, seed, rate, on_frac, static_cast<unsigned char*>(is_stuck),
      static_cast<unsigned char*>(stuck_on));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// k3_hw_write_path: one block per (draw, layer, tile of HW_TILE elements);
// blockIdx.y = draw_local * num_layers + layer_local.  Layer l's folded
// array is (rows + 1, cols): w (rows, cols) row-major, then the bias b
// (cols); its w_hw of draw d goes to out[d * draw_stride + out_l + i].
// ---------------------------------------------------------------------------

struct HwLayer {
  const float* w;
  const float* b;
  int rows, cols;
  long long out;
};

struct HwWrite {
  HwLayer layer[HW_MAX_LAYERS];
  float dfac[HW_MAX_DRAWS];      // drift factor of each draw of the launch
  int num_layers;                // layers in this launch
  int layer0;                    // global index of the first (salts)
  int salt_layers;               // L of the salt formula
  int draw0, ndraws;             // the launch's draws: draw0 .. + ndraws
  unsigned int step, k_draws, noise_seed, fault_seed;
  unsigned int salt_base;        // the write path's salt block
  unsigned int fault_salt_base;  // the fault masks' salt block
  int ensemble;                  // stuck seed per (step, draw)
  int quantize, stuck, ste;
  float g_min, g_max, g_step, g_range, clip_hi, levels_m1;
  float prog_noise, read_sigma, stuck_rate, on_frac;
  long long draw_stride;         // floats between two draws' outputs
  const int* step_ptr;           // device int32 step counter, or null: step
};

__device__ __forceinline__ float hw_folded(const HwLayer& L, long long i) {
  const long long kn = (long long)L.rows * L.cols;
  return i < kn ? L.w[i] : L.b[i - kn];
}

// torch.round((g - g_min) / g_step) clamped to [0, levels - 1], back to
// g_min + q * g_step.
__device__ __forceinline__ float hw_quantize(float g, const HwWrite& p) {
  float q = rintf(__fdiv_rn(__fsub_rn(g, p.g_min), p.g_step));
  q = fminf(fmaxf(q, 0.0f), p.levels_m1);
  return __fadd_rn(p.g_min, __fmul_rn(q, p.g_step));
}

// g * (1 + sigma * e)
__device__ __forceinline__ float hw_noisy(float g, float sigma, float e) {
  return __fmul_rn(g, __fadd_rn(1.0f, __fmul_rn(sigma, e)));
}

__device__ __forceinline__ float hw_block_max(float m) {
  __shared__ float part[K3_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
  for (int w = 1; w < K3_THREADS / 32; ++w) m = fmaxf(m, part[w]);
  return m;
}

__global__ void __launch_bounds__(K3_THREADS)
k3_hw_write_kernel(const HwWrite p, float* __restrict__ out) {
  const int li = blockIdx.y % p.num_layers;
  const int dl = blockIdx.y / p.num_layers;
  const HwLayer L = p.layer[li];
  const long long n = (long long)(L.rows + 1) * L.cols;
  const long long start = (long long)blockIdx.x * HW_TILE;
  if (start >= n) return;                       // the whole block: uniform

  // the layer's scale, reduced again by each of its blocks
  float m = 0.0f;
  for (long long i = threadIdx.x; i < n; i += K3_THREADS)
    m = fmaxf(m, fabsf(hw_folded(L, i)));
  m = hw_block_max(m);
  const float scale = __fmul_rn(__frcp_rn(fmaxf(m, 1e-12f)), p.g_range);

  const uint32_t draw = (uint32_t)(p.draw0 + dl);
  const uint32_t layer = (uint32_t)(p.layer0 + li);
  const uint32_t step =
      p.step_ptr != nullptr ? (uint32_t)__ldg(p.step_ptr) : p.step;
  const uint32_t sd = step * p.k_draws + draw;
  const uint32_t s0 =
      p.salt_base + (sd * (uint32_t)p.salt_layers + layer) * 4u;
  const uint32_t bp_prog = cn_base(p.noise_seed, s0);        // pair 0, prog
  const uint32_t bp_read = cn_base(p.noise_seed, s0 + 1u);   // pair 0, read
  const uint32_t bm_prog = cn_base(p.noise_seed, s0 + 2u);   // pair 1, prog
  const uint32_t bm_read = cn_base(p.noise_seed, s0 + 3u);   // pair 1, read
  const uint32_t sseed =
      p.ensemble ? cn_splitmix32(p.fault_seed ^ sd) : p.fault_seed;
  const uint32_t fs = p.fault_salt_base + 2u * layer;
  const uint32_t sp = cn_base(sseed, fs);
  const uint32_t sp_on = cn_base(sseed, fs + CN_POLARITY_SALT_OFFSET);
  const uint32_t sm = cn_base(sseed, fs + 1u);
  const uint32_t sm_on = cn_base(sseed, fs + 1u + CN_POLARITY_SALT_OFFSET);
  const float dfac = p.dfac[dl];

  float* o = out + (long long)dl * p.draw_stride + L.out;
  const long long end = start + HW_TILE < n ? start + HW_TILE : n;
  for (long long i = start + threadIdx.x; i < end; i += K3_THREADS) {
    const float f = hw_folded(L, i);
    const uint32_t id = (uint32_t)i;
    const float gv = __fadd_rn(p.g_min, __fmul_rn(fabsf(f), scale));
    float gp = f >= 0.0f ? gv : p.g_min;
    float gm = f >= 0.0f ? p.g_min : gv;
    if (p.quantize) {
      gp = hw_quantize(gp, p);
      gm = hw_quantize(gm, p);
    }
    if (p.prog_noise > 0.0f) {
      gp = fminf(fmaxf(hw_noisy(gp, p.prog_noise,
                                cn_normal_from_base(bp_prog, id)), 0.0f),
                 p.clip_hi);
      gm = fminf(fmaxf(hw_noisy(gm, p.prog_noise,
                                cn_normal_from_base(bm_prog, id)), 0.0f),
                 p.clip_hi);
    }
    if (p.stuck) {
      if (cn_uniform_from_base(sp, id) < p.stuck_rate)
        gp = cn_uniform_from_base(sp_on, id) < p.on_frac ? p.g_max : p.g_min;
      if (cn_uniform_from_base(sm, id) < p.stuck_rate)
        gm = cn_uniform_from_base(sm_on, id) < p.on_frac ? p.g_max : p.g_min;
    }
    gp = __fmul_rn(gp, dfac);           // 1.0 without drift: exact
    gm = __fmul_rn(gm, dfac);
    if (p.read_sigma > 0.0f) {
      gp = hw_noisy(gp, p.read_sigma, cn_normal_from_base(bp_read, id));
      gm = hw_noisy(gm, p.read_sigma, cn_normal_from_base(bm_read, id));
    }
    float w = __fdiv_rn(__fsub_rn(gp, gm), scale);
    if (p.ste) w = __fadd_rn(f, __fsub_rn(w, f));
    o[i] = w;
  }
}

extern "C" int k3_hw_write_path(const void* params, void* out, void* stream) {
  if (params == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  const HwWrite p = *static_cast<const HwWrite*>(params);
  if (p.num_layers < 1 || p.num_layers > HW_MAX_LAYERS || p.ndraws < 1 ||
      p.ndraws > HW_MAX_DRAWS || p.salt_layers < 1 || p.draw0 < 0 ||
      p.layer0 < 0 || p.draw_stride < 0 || !(p.g_step > 0.0f))
    return (int)cudaErrorInvalidValue;
  long long tiles = 0;
  for (int l = 0; l < p.num_layers; ++l) {
    const HwLayer& L = p.layer[l];
    if (L.w == nullptr || L.b == nullptr || L.rows < 0 || L.cols < 1 ||
        L.out < 0)
      return (int)cudaErrorInvalidValue;
    const long long t = ((long long)(L.rows + 1) * L.cols + HW_TILE - 1) / HW_TILE;
    tiles = t > tiles ? t : tiles;
  }
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaGetLastError();
  const dim3 grid((unsigned)tiles, (unsigned)(p.ndraws * p.num_layers));
  k3_hw_write_kernel<<<grid, K3_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
