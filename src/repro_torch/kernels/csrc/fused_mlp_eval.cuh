// One ReLU-MLP evaluation for a tile of twins, shared by K1 (fused_ode_mlp.cu)
// and K2's forward recompute (fused_ode_mlp_bwd.cu), so K2's activations and
// ReLU masks are K1's bit for bit by construction.
//
// Layout.  A block owns RT twins (RT = 1 or 4, a template parameter).  Every
// per-twin vector in shared memory is feature-major, [feature][RT], each buffer
// padded to a multiple of 4 floats: with RT = 4 one 128-bit load brings one
// feature of all four twins.  Weights sit in shared memory as w_l (in, out)
// with rows padded to a multiple of 4 floats (zeros), then b_l.  K2 also keeps
// w_l transposed (out, in) for its input-cotangent products.
//
// One product, out_j = sum_k in_k M[k][j] (fm_matvec).  Outputs come in groups
// of 4 columns; a team of S lanes owns a group, lane s sums k = s, s+S, s+2S, ...
// as a chain of fmaf for its twins and 4 columns, reading one 128-bit weight
// quad and the input per k, and the S partial sums meet in a fixed xor
// butterfly (a + b == b + a in IEEE, so every lane of the team ends with the
// same bits).  S depends on the reduction length alone (fm_ksplit), so each
// sum is rounded the same way whatever the number of twins per block or
// threads per block: a twin's trajectory and its K2 cotangents do not depend
// on the launch geometry.  A lane sums all RT twins (each weight quad feeds
// 4 RT FMAs), except in a product narrow enough that one lane per twin fits
// in the block (the 6->64 and 64->6 layers at four twins per block).  A
// team's lanes sit 32 / S apart in the warp, so the 8 lanes of one 128-bit
// load phase read one weight row at 8 column groups (distinct banks) for
// S <= 4.
//
// Shapes.  FmFixedShape compiles the widths of the repository's twins in:
// every offset, trip count and lane map is a constant.  FmDynShape takes any
// other widths and reads each product's descriptor (FmOp) from a table the
// host works out, at the start of shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FM_MAX_LAYERS 8
#define FM_FULL_MASK 0xffffffffu

// A stored value as float32: a float as it is, a bfloat16 widened (exact).
__device__ __forceinline__ float fm_ld(float x) { return x; }
__device__ __forceinline__ float fm_ld(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct FmMlp {
  const float* w[FM_MAX_LAYERS];   // (in_l, out_l) row-major, device memory
  const float* b[FM_MAX_LAYERS];   // (out_l,)
  int sizes[FM_MAX_LAYERS + 1];    // in_0, out_0 = in_1, ..., out_{L-1}
  int num_layers;
};

// One product out_j = sum_k in_k M[k][j] as the block runs it: M's offset
// in the weight block and row stride, the lengths, the bias offset (-1:
// none), the threads it needs, and log2 of the team size S and of the
// teams per warp 32 / S.  No division is left for the kernel to do.
struct FmOp {
  int m, ms, n_red, n_out, bias, lanes, s_log2, pw_log2;
};

// The products of one kernel: K1's L layers, then (K2) the L transposed.
struct FmOps {
  FmOp op[2 * FM_MAX_LAYERS];
};

// Words of the op table at the start of dynamic shared memory.
#define FM_OPS_WORDS (2 * FM_MAX_LAYERS * 8)

// Offsets (floats) of each layer's arrays in the shared weight block.
struct FmLayout {
  int w[FM_MAX_LAYERS];    // w_l, row stride ws[l]
  int ws[FM_MAX_LAYERS];
  int b[FM_MAX_LAYERS];    // b_l
  int wt[FM_MAX_LAYERS];   // w_l transposed (K2 only), row stride wts[l]
  int wts[FM_MAX_LAYERS];
  int total;               // floats of the weight block
};

__host__ __device__ constexpr int fm_round4(int n) { return (n + 3) & ~3; }

// Lanes that split a sum of n products: the largest power of two <= 8 that
// leaves each lane at least 8 terms (1 below 16 terms).
__host__ __device__ constexpr int fm_ksplit(int n) {
  int s = 1;
  while (s < 8 && 16 * s <= n) s *= 2;
  return s;
}

// Threads one fm_matvec needs to give every team its own lanes.
__host__ __device__ constexpr int fm_matvec_lanes(int n_red, int n_out) {
  const int per_warp = 32 / fm_ksplit(n_red);
  const int groups = (n_out + 3) / 4;
  return 32 * ((groups + per_warp - 1) / per_warp);
}

// The weight block: w_l and b_l per layer, then (transposed) the w_l^T;
// offsets count from the start of dynamic shared memory, after the op table.
__host__ __device__ constexpr FmLayout fm_layout_of(const int* sizes, int L,
                                                 bool transposed) {
  FmLayout lay = {};
  int off = FM_OPS_WORDS;
  for (int l = 0; l < L; ++l) {
    const int din = sizes[l], dout = sizes[l + 1];
    lay.w[l] = off;
    lay.ws[l] = fm_round4(dout);
    off += din * lay.ws[l];
    lay.b[l] = off;
    off += fm_round4(dout);
  }
  for (int l = 0; l < L; ++l) {
    const int din = sizes[l], dout = sizes[l + 1];
    lay.wt[l] = off;
    lay.wts[l] = fm_round4(din);
    if (transposed) off += dout * lay.wts[l];
  }
  lay.total = off;
  return lay;
}

__host__ __device__ inline FmLayout fm_layout(const FmMlp& m, bool transposed) {
  return fm_layout_of(m.sizes, m.num_layers, transposed);
}

__host__ __device__ constexpr int fm_log2(int x) {
  int n = 0;
  while ((1 << n) < x) ++n;
  return n;
}

// Product i of an MLP of widths sizes: layer i (w_i, + b_i) for i < L, then
// w_{i-L}^T (no bias) for the input cotangents.
__host__ __device__ constexpr FmOp fm_op_of(const FmLayout& lay, const int* sizes,
                                         int L, int i) {
  const bool t = i >= L;
  const int l = t ? i - L : i;
  const int n_red = t ? sizes[l + 1] : sizes[l];
  const int n_out = t ? sizes[l] : sizes[l + 1];
  const int S = fm_ksplit(n_red);
  return FmOp{t ? lay.wt[l] : lay.w[l], t ? lay.wts[l] : lay.ws[l], n_red,
              n_out, t ? -1 : lay.b[l], fm_matvec_lanes(n_red, n_out),
              fm_log2(S), fm_log2(32 / S)};
}

// The op table of one kernel: the L layers, and with transposed the L w^T.
__host__ inline FmOps fm_ops(const FmMlp& m, const FmLayout& lay,
                             bool transposed) {
  FmOps ops = {};
  const int L = m.num_layers;
  for (int i = 0; i < (transposed ? 2 * L : L); ++i)
    ops.op[i] = fm_op_of(lay, m.sizes, L, i);
  return ops;
}

// Widths known only at run time: products read their op from the table,
// and a product wider than the block loops over its lanes.
struct FmDynShape {
  static constexpr int kUnroll = 1;
  static constexpr bool kOneRound = false;
  int L;
  int size[FM_MAX_LAYERS + 1];
  __device__ __forceinline__ int layers() const { return L; }
  __device__ __forceinline__ int width(int l) const { return size[l]; }
  // threads a twin-split product may use: the block's
  __device__ __forceinline__ int split_lanes() const { return blockDim.x; }
  __device__ __forceinline__ FmOp op(const float* smem, int i) const {
    const int4 a = reinterpret_cast<const int4*>(smem)[2 * i];
    const int4 b = reinterpret_cast<const int4*>(smem)[2 * i + 1];
    return FmOp{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  }
};

// Widths fixed at compile time (the twins the repository trains and
// serves): every op is a compile-time constant, so offsets, trip counts and
// lane maps fold into the code, and the block has a thread for every lane
// of every product (launch_geometry sizes it so).  The arithmetic is the
// run-time shape's, term for term.
template <int... W> struct FmFixedShape {
  static constexpr int kUnroll = FM_MAX_LAYERS;
  static constexpr bool kOneRound = true;
  static constexpr int kL = sizeof...(W) - 1;
  __host__ __device__ static constexpr int layers() { return kL; }
  __host__ __device__ static constexpr int width(int l) {
    constexpr int w[] = {W...};
    return w[l];
  }
  // threads a twin-split product may use: the widest layer's lanes, which
  // K1's and K2's blocks always have (launch_geometry)
  __device__ __forceinline__ static constexpr int split_lanes() {
    constexpr int w[] = {W...};
    int n = 32;
    for (int l = 0; l < kL; ++l)
      if (fm_matvec_lanes(w[l], w[l + 1]) > n)
        n = fm_matvec_lanes(w[l], w[l + 1]);
    return n;
  }
  template <int I>
  __device__ __forceinline__ static constexpr FmOp op_at() {
    constexpr int w[] = {W...};
    constexpr FmOp o = fm_op_of(fm_layout_of(w, kL, true), w, kL, I);
    return o;
  }
  __device__ __forceinline__ FmOp op(const float*, int i) const {
    static_assert(2 * kL <= 16, "FmFixedShape: at most 8 layers");
    switch (i) {
      case 0: return op_at<0>();
      case 1: return op_at<1>();
      case 2: return op_at<2 < 2 * kL ? 2 : 0>();
      case 3: return op_at<3 < 2 * kL ? 3 : 0>();
      case 4: return op_at<4 < 2 * kL ? 4 : 0>();
      case 5: return op_at<5 < 2 * kL ? 5 : 0>();
      case 6: return op_at<6 < 2 * kL ? 6 : 0>();
      case 7: return op_at<7 < 2 * kL ? 7 : 0>();
      case 8: return op_at<8 < 2 * kL ? 8 : 0>();
      case 9: return op_at<9 < 2 * kL ? 9 : 0>();
      case 10: return op_at<10 < 2 * kL ? 10 : 0>();
      case 11: return op_at<11 < 2 * kL ? 11 : 0>();
      case 12: return op_at<12 < 2 * kL ? 12 : 0>();
      case 13: return op_at<13 < 2 * kL ? 13 : 0>();
      case 14: return op_at<14 < 2 * kL ? 14 : 0>();
      default: return op_at<15 < 2 * kL ? 15 : 0>();
    }
  }
  // Whether the run-time widths are these.
  __host__ static bool matches(const int* sizes, int L) {
    constexpr int w[] = {W...};
    if (L != kL) return false;
    for (int l = 0; l <= kL; ++l)
      if (sizes[l] != w[l]) return false;
    return true;
  }
};

// Copy the op table, the weights w[l] and biases b[l] of m's widths (and,
// with transposed, w_l^T) into shared memory as float32 (a bfloat16 weight
// widened exactly); padding is zero.  The block synchronises afterwards.
template <class T>
__device__ inline void fm_load_weights_of(float* smem, const FmMlp& m,
                                          const T* const* w,
                                          const T* const* b,
                                          const FmLayout& lay,
                                          const FmOps& ops, bool transposed) {
  for (int i = threadIdx.x; i < lay.total; i += blockDim.x)
    smem[i] = i < FM_OPS_WORDS
                  ? __int_as_float(reinterpret_cast<const int*>(&ops)[i])
                  : 0.0f;
  __syncthreads();
  for (int l = 0; l < m.num_layers; ++l) {
    const int din = m.sizes[l], dout = m.sizes[l + 1];
    const T* wl = w[l];
    for (int i = threadIdx.x; i < din * dout; i += blockDim.x) {
      const int k = i / dout, j = i - k * dout;
      const float v = fm_ld(wl[i]);
      smem[lay.w[l] + k * lay.ws[l] + j] = v;
      if (transposed) smem[lay.wt[l] + j * lay.wts[l] + k] = v;
    }
    for (int j = threadIdx.x; j < dout; j += blockDim.x)
      smem[lay.b[l] + j] = fm_ld(b[l][j]);
  }
}

// fm_load_weights_of the float32 weights behind m.
__device__ inline void fm_load_weights(float* smem, const FmMlp& m,
                                       const FmLayout& lay, const FmOps& ops,
                                       bool transposed) {
  fm_load_weights_of(smem, m, m.w, m.b, lay, ops, transposed);
}

// RT twins' values of one feature: a scalar, or one 128-bit load.
template <int RT> struct FmTile;
template <> struct FmTile<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
};
template <> struct FmTile<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

// Sums of twin r for the 4 outputs of group g, lane s of S: k = s, s+S, ...
// as fmaf chains, then the xor butterfly over the team (lanes pw apart).
// in is [n_red][RT]; with one twin per lane (TW = 1) only twin r is read.
template <int RT, int TW>
__device__ __forceinline__ void fm_team_sums(const FmOp& o, const float* smem,
                                             const float* __restrict__ in,
                                             int s, int g, int r, bool active,
                                             float (&acc)[4][TW]) {
  const int S = 1 << o.s_log2;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int q = 0; q < TW; ++q) acc[c][q] = 0.0f;
  if (active) {
    const float* xp = in + s * RT + (TW == 1 ? r : 0);
    const float* wp = smem + o.m + 4 * g + s * o.ms;
    const int xstep = S * RT, wstep = S * o.ms;
    // terms k = s + i S; a constant count when S divides n_red
    const int iters = (o.n_red % S == 0)
                          ? o.n_red >> o.s_log2
                          : (o.n_red - s + S - 1) >> o.s_log2;
    int i = 0;
    // four terms at a time: every load first, then the FMAs in k order
    for (; i + 4 <= iters; i += 4) {
      FmTile<TW> x[4];
      float4 w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q].load(xp + q * xstep);
        w[q] = *reinterpret_cast<const float4*>(wp + q * wstep);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int t = 0; t < TW; ++t) {
          acc[0][t] = fmaf(x[q].v[t], w[q].x, acc[0][t]);
          acc[1][t] = fmaf(x[q].v[t], w[q].y, acc[1][t]);
          acc[2][t] = fmaf(x[q].v[t], w[q].z, acc[2][t]);
          acc[3][t] = fmaf(x[q].v[t], w[q].w, acc[3][t]);
        }
      xp += 4 * xstep;
      wp += 4 * wstep;
    }
    for (; i < iters; ++i) {
      FmTile<TW> x;
      x.load(xp);
      const float4 w = *reinterpret_cast<const float4*>(wp);
#pragma unroll
      for (int t = 0; t < TW; ++t) {
        acc[0][t] = fmaf(x.v[t], w.x, acc[0][t]);
        acc[1][t] = fmaf(x.v[t], w.y, acc[1][t]);
        acc[2][t] = fmaf(x.v[t], w.z, acc[2][t]);
        acc[3][t] = fmaf(x.v[t], w.w, acc[3][t]);
      }
      xp += xstep;
      wp += wstep;
    }
  }
  for (int m = S >> 1; m >= 1; m >>= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int t = 0; t < TW; ++t)
        acc[c][t] = __fadd_rn(acc[c][t],
                              __shfl_xor_sync(FM_FULL_MASK, acc[c][t],
                                              m << o.pw_log2));
  }
}

// b[4g .. 4g+3] of op o (zeros without a bias), loaded ahead of the sums.
__device__ __forceinline__ float4 fm_bias4(const FmOp& o, const float* smem,
                                           int g, bool active) {
  return (active && o.bias >= 0)
             ? *reinterpret_cast<const float4*>(smem + o.bias + 4 * g)
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// out_j[r] = sum_{k < n_red} in[k][r] * M[k * ms + j] for j < n_out, r < RT,
// summed in the fixed order described at the top, for product o (M at
// smem + o.m); M's rows are 16-byte aligned with zero padding to a multiple
// of 4 columns.  epi(j0, n_out, r, acc, bias) runs once per group of 4
// outputs and twin, on the team's lane 0, with acc[c] the sum of twin r for
// output j0 + c and bias the op's b[j0 .. j0+3] (zeros without one).  A
// product whose lanes for all RT twins fit in split_lanes threads gives each
// twin its own lanes (the narrow layers at four twins per block), else a
// lane sums all RT twins.  Every thread of the block must call it (the loop
// count is the same for all, so the shuffles see full warps).  kOneRound:
// the block has a thread for every lane.
template <int RT, bool kOneRound, class Epi>
__device__ __forceinline__ void fm_matvec(const FmOp& o, const float* smem,
                                          const float* __restrict__ in,
                                          int split_lanes, const Epi& epi) {
  const int lanes = o.lanes, pw_log2 = o.pw_log2;
  const int groups = (o.n_out + 3) >> 2;
  if (RT > 1 && lanes * RT <= split_lanes) {
    const int v = threadIdx.x;
    int r = 0;
#pragma unroll
    for (int q = 1; q < RT; ++q) r += v >= q * lanes;
    const int vt = v - r * lanes;
    const int lw = vt & 31;
    const int s = lw >> pw_log2;
    const int g = ((vt >> 5) << pw_log2) + (lw & ((1 << pw_log2) - 1));
    const bool active = v < RT * lanes && g < groups;
    const float4 b4 = fm_bias4(o, smem, g, active);
    float acc[4][1];
    fm_team_sums<RT, 1>(o, smem, in, s, g, r, active, acc);
    if (active && s == 0) {
      const float a[4] = {acc[0][0], acc[1][0], acc[2][0], acc[3][0]};
      epi(4 * g, o.n_out, r, a, b4);
    }
    return;
  }
  for (int v0 = 0; kOneRound ? v0 == 0 : v0 < lanes; v0 += blockDim.x) {
    const int v = v0 + threadIdx.x;
    const int lw = v & 31;
    const int s = lw >> pw_log2;
    const int g = ((v >> 5) << pw_log2) + (lw & ((1 << pw_log2) - 1));
    const bool active = v < lanes && g < groups;
    const float4 b4 = fm_bias4(o, smem, g, active);
    float acc[4][RT];
    fm_team_sums<RT, RT>(o, smem, in, s, g, 0, active, acc);
    if (active && s == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float a[4] = {acc[0][r], acc[1][r], acc[2][r], acc[3][r]};
        epi(4 * g, o.n_out, r, a, b4);
      }
    }
  }
}

// A dense layer's epilogue: + b, then ReLU (none on the last layer).
template <int RT> struct FmDenseEpi {
  float* out;
  bool relu;
  __device__ __forceinline__ void operator()(int j0, int n_out, int r,
                                             const float (&a)[4],
                                             float4 b4) const {
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j < n_out) {
        float v = __fadd_rn(a[c], b[c]);
        if (relu && v < 0.0f) v = 0.0f;
        out[j * RT + r] = v;
      }
    }
  }
};

// The epilogue of hidden layer l writing dst: K1's and K2's dense one; K4
// (fused_analogue.cu) passes its own, which also scales, follows drift and
// clamps.
template <int RT> struct FmDenseHidden {
  __device__ __forceinline__ FmDenseEpi<RT> operator()(int, float* dst) const {
    return FmDenseEpi<RT>{dst, true};
  }
};

// Nothing to do before a stage's last barrier (K4 waits there for the next
// evaluation's noisy pairs).
struct FmNoHook {
  __device__ __forceinline__ void operator()() const {}
};

// The MLP on one stage input x ([in_0][RT]), layer l being op l: hidden
// layer l writes hidden + (l & hid_mask) * hid_step through hidden_epi(l,
// dst) (K1 and K4 ping-pong two buffers with mask 1, K2 keeps every layer
// with mask ~0), the last layer writes through last_epi.  Each layer ends
// in a block barrier; hook() runs just before the last one.
template <int RT, class Shape, class LastEpi, class Hidden = FmDenseHidden<RT>,
          class Hook = FmNoHook>
__device__ __forceinline__ void fm_mlp(const Shape& shape, const float* smem,
                                       const float* x, float* hidden,
                                       int hid_step, int hid_mask,
                                       const LastEpi& last_epi,
                                       const Hidden& hidden_epi = Hidden(),
                                       const Hook& hook = Hook()) {
  const float* src = x;
  const int L = shape.layers();
  const int split = shape.split_lanes();
#pragma unroll(Shape::kUnroll)
  for (int l = 0; l < L - 1; ++l) {
    float* dst = hidden + (l & hid_mask) * hid_step;
    fm_matvec<RT, Shape::kOneRound>(shape.op(smem, l), smem, src, split,
                                    hidden_epi(l, dst));
    __syncthreads();
    src = dst;
  }
  fm_matvec<RT, Shape::kOneRound>(shape.op(smem, L - 1), smem, src, split,
                                  last_epi);
  hook();
  __syncthreads();
}

// A stage input's y column: y + c * k_{s-1}, as the JAX kernel's
// make_rk4_step rounds it (no contraction into an FMA).
__device__ __forceinline__ float fm_stage_y(float y, float c, float k) {
  return __fadd_rn(y, __fmul_rn(c, k));
}

// The half-step of the drive that RK4 stage s of step t reads.
__device__ __forceinline__ int fm_stage_half_step(int t, int s) {
  return 2 * t + (s == 0 ? 0 : (s == 3 ? 2 : 1));
}

// ubuf[(h - h0)][col][r] = u at half-step h for twin r0 + r, for the nh
// half-steps from h0 (zero for twins past the fleet), widened to float32
// from float or bfloat16.  u is (2T+1, Du) shared (twin stride 0) or (B,
// 2T+1, Du).  No barrier.
template <int RT, class T>
__device__ __forceinline__ void fm_stage_drive(float* ubuf, const T* u,
                                               long long u_twin_stride,
                                               int Du, int h0, int nh, int r0,
                                               int nr) {
  const int n = nh * Du * RT;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i % RT;
    const int hc = i / RT;               // (h - h0) * Du + col
    ubuf[i] = (r < nr) ? fm_ld(u[(long long)(r0 + r) * u_twin_stride +
                                 (long long)h0 * Du + hc])
                       : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// The bf16 policies (fused_ode_mlp.py): the weights, biases and drive arrive
// as bfloat16 and sit in shared memory widened to float32 (exact, by
// fm_load_weights_of and fm_stage_drive), so the products above run
// unchanged; what changes is where values are rounded to bf16, which the
// epilogues below do.  PURE = false is "bf16_f32acc": every
// layer input is rounded, the bias add, ReLU and the RK4 combination run in
// float32.  PURE = true is "bf16": the dot's sum and the bias add are
// rounded too, as is every RK4 operation.
// ---------------------------------------------------------------------------

// x rounded to the nearest bfloat16 (ties to even), as a float.
__device__ __forceinline__ float fm_rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Device pointers of the weights and biases stored as T (FmMlp keeps the
// widths).
template <class T> struct FmWeightsOf {
  const T* w[FM_MAX_LAYERS];
  const T* b[FM_MAX_LAYERS];
};
using FmWeightsBf16 = FmWeightsOf<__nv_bfloat16>;

// A layer's output sum a plus its bias b under the policy.
template <bool PURE>
__device__ __forceinline__ float fm_bias_bf(float a, float b) {
  return PURE ? fm_rbf(__fadd_rn(fm_rbf(a), b)) : __fadd_rn(a, b);
}

// A dense layer's epilogue under a bf16 policy: + b, then for a hidden
// layer ReLU and the rounding of the next layer's input.
template <int RT, bool PURE> struct FmDenseEpiBf {
  float* out;
  bool relu;
  __device__ __forceinline__ void operator()(int j0, int n_out, int r,
                                             const float (&a)[4],
                                             float4 b4) const {
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (j < n_out) {
        float v = fm_bias_bf<PURE>(a[c], b[c]);
        if (relu) v = fm_rbf(v < 0.0f ? 0.0f : v);
        out[j * RT + r] = v;
      }
    }
  }
};

template <int RT, bool PURE> struct FmDenseHiddenBf {
  __device__ __forceinline__ FmDenseEpiBf<RT, PURE> operator()(
      int, float* dst) const {
    return FmDenseEpiBf<RT, PURE>{dst, true};
  }
};

// A stage input's y column under the policy: y + c k rounded to bf16 (the
// layer input), the product rounded first under PURE.
template <bool PURE>
__device__ __forceinline__ float fm_stage_y_bf(float y, float c, float k) {
  const float m = __fmul_rn(c, k);
  return fm_rbf(__fadd_rn(y, PURE ? fm_rbf(m) : m));
}

// acc + 2 k (the RK4 sum after stages 2 and 3) under the policy.
template <bool PURE>
__device__ __forceinline__ float fm_rk4_acc_bf(float acc, float k) {
  const float v = __fadd_rn(acc, __fmul_rn(2.0f, k));
  return PURE ? fm_rbf(v) : v;
}

// y + (dt/6) (acc + k4) under the policy.
template <bool PURE>
__device__ __forceinline__ float fm_rk4_update_bf(float y, float dt6,
                                                  float acc, float k) {
  if (!PURE) return __fadd_rn(y, __fmul_rn(dt6, __fadd_rn(acc, k)));
  return fm_rbf(__fadd_rn(y, fm_rbf(__fmul_rn(dt6, fm_rbf(__fadd_rn(acc, k))))));
}
