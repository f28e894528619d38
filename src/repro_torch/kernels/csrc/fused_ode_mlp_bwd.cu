// K2 on Hopper: reverse-time VJP of the weights-stationary RK4 rollout.
//
// Replaces repro/kernels/fused_ode_mlp_bwd.py:fused_node_rollout_bwd (the
// Pallas kernel built by _make_bwd_kernel there) under its three precision
// policies: k2_rollout_bwd_kernel is the float32 policy, described here;
// the bf16 policies are k2_rollout_bwd_bf16_kernel at the end of this file.
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
//    relies on the TPU running grid cells in order.  Here each block owns RT
//    twins (launch geometry as K1's: one per block at the training shapes,
//    four at the fleet shape) for all T steps and carries their adjoint a
//    in shared memory; nothing crosses blocks during the sweep.
//  * No replay of chunks.  Step t reads its state from trajectory row t:
//    these are exactly the states K1 continued with.  Rows of traj, g and
//    the drive come into shared memory tc steps at a time.  The step's four
//    stages are recomputed with K1's own code (fused_mlp_eval.cuh), so the
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
//    (c_s = dt for stage 4, dt/2 for stages 3 and 2).  The input-cotangent
//    products run on w_l^T, kept transposed in shared memory, with the same
//    team-split fixed-order sums as the forward, so dy0 of a twin does not
//    depend on the geometry either.
//  * Weight gradients off the chain, without atomics.  The backward keeps
//    every stage's layer inputs and output cotangents of the step; after the
//    step one phase adds them into the gradient.  The gradient is cut into
//    4 x 4 tiles of (w_l; b_l), each owned by one thread, which holds its
//    tiles (at most K2_MAX_TILES) in registers for the whole sweep and adds
//    in a fixed order (steps T-1..0, stages 4..1, twins 0..RT-1).  At the
//    end each block writes its tiles to row blockIdx.x of a (blocks, P)
//    buffer, and k2_reduce_kernel sums the rows in block order.  So one K2
//    call is two launches, and a repeated call gives bitwise-identical
//    gradients.
//  * Per step: one load phase, the recompute's 4 * (1 + L) phases, 4 * L
//    input-cotangent phases and the gradient phase, each ending in a block
//    barrier.  Widths are compiled in for the Lorenz96 and HP twins, as in
//    K1.
//
// Bound on this card (H100 SXM).  Per twin-step, the forward recompute is
// 4 * 2 * MACs FLOP and the backward per stage a second product for the
// weight gradient and a third for the input cotangent (only the y columns
// of layer 0): ~3x K1's work, so the operations bound it (at B=1024, T=200,
// 6->64->64->6: ~23.9 GFLOP, ~0.36 ms at 67 TFLOP/s FP32).  At the training
// shapes (one twin per block, B <= 29 blocks) the chain of ~30 barriered
// phases per step is what it waits on.  The measured times are in PERF.md.

#include "fused_mlp_eval.cuh"

#define K2_MAX_THREADS 512
#define K2_MAX_TILES 4
#define K2_REDUCE_THREADS 256

// Tiles of layer l's gradient: ceil(in/4) + 1 (the bias) rows of
// ceil(out/4) tiles.
__host__ __device__ inline int k2_layer_tiles(int din, int dout) {
  return ((din + 3) / 4 + 1) * ((dout + 3) / 4);
}

static int k2_hidden(const FmMlp& m) {
  int hidden = 0;
  for (int l = 0; l + 1 < m.num_layers; ++l)
    if (m.sizes[l + 1] > hidden) hidden = m.sizes[l + 1];
  return hidden;
}

// Floats of dynamic shared memory one block needs (the Python wrapper's
// smem_bytes_bwd computes the same number).
static long long k2_smem_floats(const FmMlp& m, int rt, int tc) {
  const FmLayout lay = fm_layout(m, true);
  const int L = m.num_layers;
  const int D4 = fm_round4(m.sizes[L]);
  const int Du = m.sizes[0] - m.sizes[L];
  const long long act =
      (long long)rt * (7 * D4 + 4 * fm_round4(m.sizes[0]) +
                       8 * (L - 1) * fm_round4(k2_hidden(m)) + 2 * tc * D4);
  return lay.total + act + fm_round4((2 * tc + 1) * Du * rt);
}

// A hidden layer's input cotangent, masked by the ReLU that made the input.
template <int RT> struct K2MaskEpi {
  const float* act;    // [n][RT] the layer's input (post-ReLU)
  float* out;          // [n][RT]
  __device__ __forceinline__ void operator()(int k0, int n, int r,
                                             const float (&a)[4],
                                             float4) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      if (k < n) out[k * RT + r] = (act[k * RT + r] > 0.0f) ? a[c] : 0.0f;
    }
  }
};

// Layer 0's input cotangent: its y columns go into a and k_{s-1}'s
// cotangent (gprev, null for stage 1).
template <int RT> struct K2InputEpi {
  float* a;
  float* gprev;
  float cs;
  int Du;
  __device__ __forceinline__ void operator()(int k0, int din, int r,
                                             const float (&v)[4],
                                             float4) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      if (k >= Du && k < din) {
        const int i = (k - Du) * RT + r;
        a[i] = __fadd_rn(a[i], v[c]);
        if (gprev) gprev[i] = __fadd_rn(gprev[i], __fmul_rn(cs, v[c]));
      }
    }
  }
};

// Features f0 .. f0+3 of the RT twins from a [n][RT] buffer, q[a][r]: one
// 128-bit load for RT = 1, four for RT = 4.
template <int RT>
__device__ __forceinline__ void k2_quad(const float* p, float (&q)[4][RT]) {
  if (RT == 1) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    q[0][0] = v.x; q[1][0] = v.y; q[2][0] = v.z; q[3][0] = v.w;
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      FmTile<RT> t;
      t.load(p + a * RT);
#pragma unroll
      for (int r = 0; r < RT; ++r) q[a][r] = t.v[r];
    }
  }
}

template <int RT, class Shape>
__global__ void __launch_bounds__(K2_MAX_THREADS)
k2_rollout_bwd_kernel(const float* __restrict__ traj,
                      const float* __restrict__ u,
                      const float* __restrict__ g, float* __restrict__ dy0,
                      float* __restrict__ partial, const FmMlp mlp,
                      const FmLayout lay, const FmOps ops, const Shape shape,
                      int B, int T, long long u_twin_stride, long long P,
                      float dt, float dt2, float dt6, int tc) {
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
  const int D4 = fm_round4(D) * RT;           // floats of one [D][RT] vector
  const int X4 = fm_round4(in0) * RT;
  const int H4 = fm_round4(hidden) * RT;

  float* ys = smem + lay.total;               // [D][RT] y_t
  float* a = ys + D4;                         // [D][RT] adjoint
  float* ks = a + D4;                         // [D][RT] stage output
  float* gk = ks + D4;                        // 4 x [D][RT] stage cotangents
  float* xs = gk + 4 * D4;                    // 4 x [in0][RT] stage inputs
  float* hs = xs + 4 * X4;                    // 4 x (L-1) x [hidden][RT]
  float* dn = hs + 4 * (L - 1) * H4;          // 4 x (L-1) x [hidden][RT]
  float* tbuf = dn + 4 * (L - 1) * H4;        // tc x [D][RT] traj rows
  float* gbuf = tbuf + tc * D4;               // tc x [D][RT] g rows
  float* ubuf = gbuf + tc * D4;               // [2 tc + 1][Du][RT] drive
  const int nact = (int)(ubuf - ys) + fm_round4((2 * tc + 1) * Du * RT);

  // This thread's gradient tiles: ids tid, tid + nt, ... over all layers.
  float tacc[K2_MAX_TILES][16];
#pragma unroll
  for (int i = 0; i < K2_MAX_TILES; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) tacc[i][e] = 0.0f;

  fm_load_weights(smem, mlp, lay, ops, true);
  for (int i = tid; i < nact; i += nt) ys[i] = 0.0f;
  __syncthreads();

  int c0 = T;                                 // first step of the staged chunk
  for (int t = T - 1; t >= 0; --t) {
    if (t < c0) {
      // Stage steps [c0, t] going down: traj rows c0..t, g rows c0+1..t+1,
      // drive half-steps 2 c0 .. 2 t + 2.
      c0 = (t / tc) * tc;
      const int n = (t + 1 - c0) * D * RT;
      for (int i = tid; i < n; i += nt) {
        const int r = i % RT;
        const int j = (i / RT) % D;
        const int row = i / (RT * D);
        float tv = 0.0f, gv = 0.0f;
        if (r < nr) {
          const long long o = ((long long)(c0 + row) * B + r0 + r) * D + j;
          tv = traj[o];
          gv = g[o + (long long)B * D];
        }
        tbuf[row * D4 + j * RT + r] = tv;
        gbuf[row * D4 + j * RT + r] = gv;
      }
      if (Du > 0)
        fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 2 * c0,
                           2 * (t - c0) + 3, r0, nr);
      __syncthreads();
    }
    // The adjoint picks up the cotangent of row t+1; load the state y_t;
    // seed the stage cotangents from the RK4 update.
    for (int i = tid; i < D * RT; i += nt) {
      ys[i] = tbuf[(t - c0) * D4 + i];
      const float av = __fadd_rn(a[i], gbuf[(t - c0) * D4 + i]);
      a[i] = av;
      const float cst = __fmul_rn(dt6, av);
      const float c2 = __fmul_rn(2.0f, cst);
      gk[i] = cst;
      gk[D4 + i] = c2;
      gk[2 * D4 + i] = c2;
      gk[3 * D4 + i] = cst;
    }
    __syncthreads();

    // -- forward recompute of the step's four stages (K1's arithmetic) ----
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      const float* urow =
          ubuf + (fm_stage_half_step(t, s) - 2 * c0) * Du * RT;
      const float c = (s == 3) ? dt : dt2;
      float* xs_s = xs + s * X4;
      for (int e = tid; e < in0 * RT; e += nt) {
        float v;
        if (e < Du * RT) {
          v = urow[e];
        } else {
          const int i = e - Du * RT;
          v = (s == 0) ? ys[i] : fm_stage_y(ys[i], c, ks[i]);
        }
        xs_s[e] = v;
      }
      __syncthreads();
      fm_mlp<RT>(shape, smem, xs_s, hs + s * (L - 1) * H4, H4, ~0,
                 FmDenseEpi<RT>{ks, false});
    }

    // -- stages 4, 3, 2, 1 back through the MLP ------------------------------
#pragma unroll 1
    for (int s = 3; s >= 0; --s) {
      const float* delta = gk + s * D4;   // cotangent of the layer's output
#pragma unroll(Shape::kUnroll)
      for (int l = L - 1; l >= 1; --l) {
        float* d_in = dn + (s * (L - 1) + l - 1) * H4;
        fm_matvec<RT, Shape::kOneRound>(shape.op(smem, L + l), smem, delta,
                                        shape.split_lanes(),
                      K2MaskEpi<RT>{hs + (s * (L - 1) + l - 1) * H4, d_in});
        __syncthreads();
        delta = d_in;
      }
      fm_matvec<RT, Shape::kOneRound>(shape.op(smem, L), smem, delta,
                                      shape.split_lanes(),
                    K2InputEpi<RT>{a, s > 0 ? gk + (s - 1) * D4 : nullptr,
                                   (s == 3) ? dt : dt2, Du});
      __syncthreads();
    }

    // -- this step's weight and bias gradients, tile by tile -----------------
#pragma unroll
    for (int i = 0; i < K2_MAX_TILES; ++i) {
      int tile = tid + i * nt;
      int l = 0;
#pragma unroll(Shape::kUnroll)
      for (; l < L; ++l) {
        const int n = k2_layer_tiles(shape.width(l), shape.width(l + 1));
        if (tile < n) break;
        tile -= n;
      }
      if (l == L) continue;
      const int din = shape.width(l), dout = shape.width(l + 1);
      const int gw = (dout + 3) / 4;
      const int kq = tile / gw, jq = tile - kq * gw;
      const bool bias = 4 * kq >= din;
#pragma unroll
      for (int s = 3; s >= 0; --s) {
        const float* in = (l == 0) ? xs + s * X4
                                   : hs + (s * (L - 1) + l - 1) * H4;
        const float* del = (l == L - 1) ? gk + s * D4
                                        : dn + (s * (L - 1) + l) * H4;
        float d[4][RT];
        k2_quad<RT>(del + 4 * jq * RT, d);
        if (bias) {
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (r < nr)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                tacc[i][c] = __fadd_rn(tacc[i][c], d[c][r]);
        } else {
          float x[4][RT];
          k2_quad<RT>(in + 4 * kq * RT, x);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (r < nr)
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  tacc[i][q * 4 + c] = fmaf(x[q][r], d[c][r], tacc[i][q * 4 + c]);
        }
      }
    }
    __syncthreads();
  }

  // dL/dy0 = a + g[0]; this thread's gradient tiles to the block's row.
  for (int i = tid; i < D * RT; i += nt) {
    const int j = i / RT, r = i % RT;
    if (r < nr) {
      const long long o = (long long)(r0 + r) * D + j;
      dy0[o] = __fadd_rn(a[i], g[o]);
    }
  }
  float* prow = partial + (long long)blockIdx.x * P;
#pragma unroll
  for (int i = 0; i < K2_MAX_TILES; ++i) {
    int tile = tid + i * nt;
    long long off = 0;
    int l = 0;
#pragma unroll(Shape::kUnroll)
    for (; l < L; ++l) {
      const int n = k2_layer_tiles(shape.width(l), shape.width(l + 1));
      if (tile < n) break;
      tile -= n;
      off += (long long)shape.width(l) * shape.width(l + 1) + shape.width(l + 1);
    }
    if (l == L) continue;
    const int din = shape.width(l), dout = shape.width(l + 1);
    const int gw = (dout + 3) / 4;
    const int kq = tile / gw, jq = tile - kq * gw;
    if (4 * kq >= din) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * jq + c;
        if (j < dout) prow[off + (long long)din * dout + j] = tacc[i][c];
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * kq + q, j = 4 * jq + c;
          if (k < din && j < dout) prow[off + (long long)k * dout + j] = tacc[i][q * 4 + c];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 policies ("bf16_f32acc", PURE = false; "bf16", PURE = true).
//
// What changes against the float32 kernel above:
//  * Chunks are replayed.  K1 rounds its float32 carry to bf16 only every
//    rc steps, so the trajectory's bf16 rows inside a chunk are not the
//    states K1 continued from.  The block walks the chunks [j0, j0 + rc)
//    from the last to the first; for each it replays the steps forward
//    from row j0 (exactly K1's carry there) with K1's arithmetic, keeping
//    each state y_t at the carry dtype, as the JAX kernel's fwd_body does;
//    then it sweeps the chunk in reverse as above, staging the replayed
//    states in place of the trajectory's rows.  The states sit in shared
//    memory after the drive buffer (min(rc, T) x [D][RT] floats) where they
//    fit beside the rest (rep_smem, the wrapper's choice), else in rep, a
//    float32 scratch of (min(rc, T), B, D) in device memory that the
//    wrapper allocates (each block its own twins).
//  * The weights, biases, drive, trajectory and cotangent rows 1..T arrive
//    as bfloat16; g0 (the cotangent of row 0) as float32.
//  * The recompute rounds as K1's bf16 variant does (fused_mlp_eval.cuh's
//    bf16 epilogues), so the stage inputs and activations are K1's bits.
//  * The transposed products round as the forward's inputs do: a layer's
//    input cotangent is rounded to bf16.  Under PURE the adjoint and the
//    stage cotangents are bf16 too: a + g, (dt/6) a, the adjoint's sums and
//    gk += c gx are rounded op by op, with bf16 step constants.
//  * dW and db are summed in float32 over twins, stages and steps as
//    above (the JAX kernel rounds each grid cell's per-step weight
//    cotangent to bf16 before adding it; the port does not, so its
//    gradient does not depend on a batch tile).
// The shared-memory layout is the f32 kernel's (k2_smem_floats).
// ---------------------------------------------------------------------------

// A hidden layer's input cotangent, rounded to bf16 and masked by the ReLU.
template <int RT> struct K2MaskEpiBf {
  const float* act;
  float* out;
  __device__ __forceinline__ void operator()(int k0, int n, int r,
                                             const float (&a)[4],
                                             float4) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      if (k < n) out[k * RT + r] = (act[k * RT + r] > 0.0f) ? fm_rbf(a[c])
                                                             : 0.0f;
    }
  }
};

// Layer 0's input cotangent under the policy: its y columns, rounded to
// bf16, go into a and k_{s-1}'s cotangent.
template <int RT, bool PURE> struct K2InputEpiBf {
  float* a;
  float* gprev;
  float cs;
  int Du;
  __device__ __forceinline__ void operator()(int k0, int din, int r,
                                             const float (&v)[4],
                                             float4) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + c;
      if (k >= Du && k < din) {
        const int i = (k - Du) * RT + r;
        const float gx = fm_rbf(v[c]);
        if (PURE) {
          a[i] = fm_rbf(__fadd_rn(a[i], gx));
          if (gprev)
            gprev[i] = fm_rbf(__fadd_rn(gprev[i], fm_rbf(__fmul_rn(cs, gx))));
        } else {
          a[i] = __fadd_rn(a[i], gx);
          if (gprev) gprev[i] = __fadd_rn(gprev[i], __fmul_rn(cs, gx));
        }
      }
    }
  }
};

template <int RT, class Shape, bool PURE>
__global__ void __launch_bounds__(K2_MAX_THREADS)
k2_rollout_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ traj,
                           const __nv_bfloat16* __restrict__ u,
                           const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ g0, float* rep,
                           float* __restrict__ dy0,
                           float* __restrict__ partial, const FmMlp mlp,
                           const FmWeightsBf16 wb, const FmLayout lay,
                           const FmOps ops, const Shape shape, int B, int T,
                           long long u_twin_stride, long long P, float dt,
                           float dt2, float dt6, int rc, int tc,
                           int rep_smem) {
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
  const int D4 = fm_round4(D) * RT;
  const int X4 = fm_round4(in0) * RT;
  const int H4 = fm_round4(hidden) * RT;

  float* ys = smem + lay.total;               // [D][RT] y_t
  float* a = ys + D4;                         // [D][RT] adjoint
  float* ks = a + D4;                         // [D][RT] stage output
  float* gk = ks + D4;                        // 4 x [D][RT] stage cotangents
  float* xs = gk + 4 * D4;                    // 4 x [in0][RT] stage inputs
  float* hs = xs + 4 * X4;                    // 4 x (L-1) x [hidden][RT]
  float* dn = hs + 4 * (L - 1) * H4;          // 4 x (L-1) x [hidden][RT]
  float* tbuf = dn + 4 * (L - 1) * H4;        // tc x [D][RT] replayed rows
  float* gbuf = tbuf + tc * D4;               // tc x [D][RT] g rows
  float* ubuf = gbuf + tc * D4;               // [2 tc + 1][Du][RT] drive
  const int nact = (int)(ubuf - ys) + fm_round4((2 * tc + 1) * Du * RT);
  float* reps = ys + nact;                    // min(rc, T) x [D][RT] states
  float* acc = gk;                            // the replay's RK4 sum

  float tacc[K2_MAX_TILES][16];
#pragma unroll
  for (int i = 0; i < K2_MAX_TILES; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) tacc[i][e] = 0.0f;

  fm_load_weights_of(smem, mlp, wb.w, wb.b, lay, ops, true);
  for (int i = tid; i < nact; i += nt) ys[i] = 0.0f;
  __syncthreads();

  for (int j0 = T > 0 ? ((T - 1) / rc) * rc : -1; j0 >= 0; j0 -= rc) {
    const int j1 = min(j0 + rc, T);
    // -- replay the chunk from row j0 at the carry dtype, into rep --------
    for (int i = tid; i < D * RT; i += nt) {
      const int j = i / RT, r = i % RT;
      ys[i] = (r < nr) ? __bfloat162float(
                             traj[((long long)j0 * B + r0 + r) * D + j])
                       : 0.0f;
    }
    __syncthreads();
    for (int t = j0; t < j1; ++t) {
      for (int i = tid; i < D * RT; i += nt) {
        const int j = i / RT, r = i % RT;
        if (rep_smem)
          reps[(t - j0) * D4 + i] = ys[i];
        else if (r < nr)
          rep[((long long)(t - j0) * B + r0 + r) * D + j] = ys[i];
      }
      if (t + 1 == j1) break;
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {
        const int h = fm_stage_half_step(t, s);
        const float c = (s == 3) ? dt : dt2;
        for (int e = tid; e < in0 * RT; e += nt) {
          float v;
          if (e < Du * RT) {
            const int col = e / RT, r = e % RT;
            v = (r < nr) ? __bfloat162float(
                               u[(long long)(r0 + r) * u_twin_stride +
                                 (long long)h * Du + col])
                         : 0.0f;
          } else {
            const int i = e - Du * RT;
            v = (s == 0) ? fm_rbf(ys[i])
                         : fm_stage_y_bf<PURE>(ys[i], c, ks[i]);
          }
          xs[e] = v;
        }
        __syncthreads();
        fm_mlp<RT>(shape, smem, xs, hs, H4, 1,
                   FmDenseEpiBf<RT, PURE>{ks, false},
                   FmDenseHiddenBf<RT, PURE>());
        for (int i = tid; i < D * RT; i += nt) {
          const float k = ks[i];
          if (s == 0)
            acc[i] = k;
          else if (s < 3)
            acc[i] = fm_rk4_acc_bf<PURE>(acc[i], k);
          else
            ys[i] = fm_rk4_update_bf<PURE>(ys[i], dt6, acc[i], k);
        }
        __syncthreads();
      }
    }
    __syncthreads();

    // -- the chunk's steps in reverse ----------------------------------------
    int c0 = j1;
    for (int t = j1 - 1; t >= j0; --t) {
      if (t < c0) {
        c0 = max(j0, (t / tc) * tc);
        const int n = (t + 1 - c0) * D * RT;
        for (int i = tid; i < n; i += nt) {
          const int r = i % RT;
          const int j = (i / RT) % D;
          const int row = i / (RT * D);
          float tv = 0.0f, gv = 0.0f;
          if (r < nr) {
            tv = rep_smem
                     ? reps[(c0 - j0 + row) * D4 + j * RT + r]
                     : rep[((long long)(c0 - j0 + row) * B + r0 + r) * D + j];
            gv = __bfloat162float(
                g[((long long)(c0 + row + 1) * B + r0 + r) * D + j]);
          }
          tbuf[row * D4 + j * RT + r] = tv;
          gbuf[row * D4 + j * RT + r] = gv;
        }
        if (Du > 0)
          fm_stage_drive<RT>(ubuf, u, u_twin_stride, Du, 2 * c0,
                                  2 * (t - c0) + 3, r0, nr);
        __syncthreads();
      }
      for (int i = tid; i < D * RT; i += nt) {
        ys[i] = tbuf[(t - c0) * D4 + i];
        float av = __fadd_rn(a[i], gbuf[(t - c0) * D4 + i]);
        if (PURE) av = fm_rbf(av);
        a[i] = av;
        float cst = __fmul_rn(dt6, av);
        if (PURE) cst = fm_rbf(cst);
        const float c2 = __fmul_rn(2.0f, cst);
        gk[i] = cst;
        gk[D4 + i] = c2;
        gk[2 * D4 + i] = c2;
        gk[3 * D4 + i] = cst;
      }
      __syncthreads();

      // -- forward recompute of the step's four stages (K1's bf16 bits) --
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {
        const float* urow =
            ubuf + (fm_stage_half_step(t, s) - 2 * c0) * Du * RT;
        const float c = (s == 3) ? dt : dt2;
        float* xs_s = xs + s * X4;
        for (int e = tid; e < in0 * RT; e += nt) {
          float v;
          if (e < Du * RT) {
            v = urow[e];
          } else {
            const int i = e - Du * RT;
            v = (s == 0) ? fm_rbf(ys[i])
                         : fm_stage_y_bf<PURE>(ys[i], c, ks[i]);
          }
          xs_s[e] = v;
        }
        __syncthreads();
        fm_mlp<RT>(shape, smem, xs_s, hs + s * (L - 1) * H4, H4, ~0,
                   FmDenseEpiBf<RT, PURE>{ks, false},
                   FmDenseHiddenBf<RT, PURE>());
      }

      // -- stages 4, 3, 2, 1 back through the MLP ----------------------------
#pragma unroll 1
      for (int s = 3; s >= 0; --s) {
        const float* delta = gk + s * D4;
#pragma unroll(Shape::kUnroll)
        for (int l = L - 1; l >= 1; --l) {
          float* d_in = dn + (s * (L - 1) + l - 1) * H4;
          fm_matvec<RT, Shape::kOneRound>(shape.op(smem, L + l), smem, delta,
                                          shape.split_lanes(),
                        K2MaskEpiBf<RT>{hs + (s * (L - 1) + l - 1) * H4, d_in});
          __syncthreads();
          delta = d_in;
        }
        fm_matvec<RT, Shape::kOneRound>(shape.op(smem, L), smem, delta,
                                        shape.split_lanes(),
                      K2InputEpiBf<RT, PURE>{a, s > 0 ? gk + (s - 1) * D4
                                                      : nullptr,
                                             (s == 3) ? dt : dt2, Du});
        __syncthreads();
      }

      // -- this step's weight and bias gradients (the f32 kernel's tiles) --
#pragma unroll
      for (int i = 0; i < K2_MAX_TILES; ++i) {
        int tile = tid + i * nt;
        int l = 0;
#pragma unroll(Shape::kUnroll)
        for (; l < L; ++l) {
          const int n = k2_layer_tiles(shape.width(l), shape.width(l + 1));
          if (tile < n) break;
          tile -= n;
        }
        if (l == L) continue;
        const int din = shape.width(l), dout = shape.width(l + 1);
        const int gw = (dout + 3) / 4;
        const int kq = tile / gw, jq = tile - kq * gw;
        const bool bias = 4 * kq >= din;
#pragma unroll
        for (int s = 3; s >= 0; --s) {
          const float* in = (l == 0) ? xs + s * X4
                                     : hs + (s * (L - 1) + l - 1) * H4;
          const float* del = (l == L - 1) ? gk + s * D4
                                          : dn + (s * (L - 1) + l) * H4;
          float d[4][RT];
          k2_quad<RT>(del + 4 * jq * RT, d);
          if (bias) {
#pragma unroll
            for (int r = 0; r < RT; ++r)
              if (r < nr)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  tacc[i][c] = __fadd_rn(tacc[i][c], d[c][r]);
          } else {
            float x[4][RT];
            k2_quad<RT>(in + 4 * kq * RT, x);
#pragma unroll
            for (int r = 0; r < RT; ++r)
              if (r < nr)
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    tacc[i][q * 4 + c] =
                        fmaf(x[q][r], d[c][r], tacc[i][q * 4 + c]);
          }
        }
      }
      __syncthreads();
    }
  }

  // dL/dy0 = a + g0 in float32; this thread's tiles to the block's row.
  for (int i = tid; i < D * RT; i += nt) {
    const int j = i / RT, r = i % RT;
    if (r < nr) {
      const long long o = (long long)(r0 + r) * D + j;
      dy0[o] = __fadd_rn(a[i], g0[o]);
    }
  }
  float* prow = partial + (long long)blockIdx.x * P;
#pragma unroll
  for (int i = 0; i < K2_MAX_TILES; ++i) {
    int tile = tid + i * nt;
    long long off = 0;
    int l = 0;
#pragma unroll(Shape::kUnroll)
    for (; l < L; ++l) {
      const int n = k2_layer_tiles(shape.width(l), shape.width(l + 1));
      if (tile < n) break;
      tile -= n;
      off += (long long)shape.width(l) * shape.width(l + 1) + shape.width(l + 1);
    }
    if (l == L) continue;
    const int din = shape.width(l), dout = shape.width(l + 1);
    const int gw = (dout + 3) / 4;
    const int kq = tile / gw, jq = tile - kq * gw;
    if (4 * kq >= din) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * jq + c;
        if (j < dout) prow[off + (long long)din * dout + j] = tacc[i][c];
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * kq + q, j = 4 * jq + c;
          if (k < din && j < dout) prow[off + (long long)k * dout + j] = tacc[i][q * 4 + c];
        }
    }
  }
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

template <int RT, class Shape>
static int k2_launch(const Shape& shape, int blocks, int threads,
                     long long smem_bytes, cudaStream_t st, const float* traj,
                     const float* u, const float* g, float* dy0,
                     float* partial, const FmMlp& mlp, const FmLayout& lay,
                     const FmOps& ops, int B, int T, long long u_twin_stride,
                     long long P, float dt, float dt2, float dt6, int tc) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k2_rollout_bwd_kernel<RT, Shape>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  k2_rollout_bwd_kernel<RT, Shape><<<blocks, threads, (size_t)smem_bytes,
                                     st>>>(traj, u, g, dy0, partial, mlp, lay,
                                           ops, shape, B, T, u_twin_stride, P,
                                           dt, dt2, dt6, tc);
  return (int)cudaGetLastError();
}

// The Lorenz96 twin and the HP memristor twin, compiled for their widths.
using K2L96 = FmFixedShape<6, 64, 64, 6>;
using K2HP = FmFixedShape<2, 14, 14, 1>;

// Launch K2 on `stream`: the reverse sweep, then the fixed-order reduction.
// Pointers are device pointers except w_ptrs, b_ptrs and sizes, which are
// host arrays of num_layers, num_layers and num_layers + 1 entries.  u may
// be null when Du == 0; u_twin_stride is 0 for a drive shared by the fleet
// and (2T+1)*Du for one drive per twin.  twins (1 or 4), threads, tc and
// smem_bytes are the wrapper's launch_geometry (backward); threads must
// own every gradient tile.  partial holds ceil(B/twins) * P floats of
// scratch; grads receives P floats.  Returns the cudaError_t of the
// launches (0 on success); nothing is allocated and nothing synchronises.
extern "C" int k2_fused_node_rollout_bwd_f32(
    const void* traj, const void* u, const void* g, void* dy0, void* partial,
    void* grads, const void* w_ptrs, const void* b_ptrs, const void* sizes,
    int num_layers, int B, int T, int D, int Du, long long u_twin_stride,
    float dt, float dt2, float dt6, int twins, int threads, int tc,
    long long smem_bytes, void* stream) {
  if (num_layers < 1 || num_layers > FM_MAX_LAYERS || B < 1 || T < 0 ||
      (twins != 1 && twins != 4) || threads < 32 || threads % 32 != 0 ||
      threads > K2_MAX_THREADS || tc < 1)
    return (int)cudaErrorInvalidValue;
  FmMlp mlp;
  FmDynShape dyn;
  const void* const* w = static_cast<const void* const*>(w_ptrs);
  const void* const* b = static_cast<const void* const*>(b_ptrs);
  const int* sz = static_cast<const int*>(sizes);
  mlp.num_layers = num_layers;
  dyn.L = num_layers;
  long long P = 0, tiles = 0;
  for (int l = 0; l < num_layers; ++l) {
    mlp.w[l] = static_cast<const float*>(w[l]);
    mlp.b[l] = static_cast<const float*>(b[l]);
    P += (long long)sz[l] * sz[l + 1] + sz[l + 1];
    tiles += k2_layer_tiles(sz[l], sz[l + 1]);
  }
  for (int l = 0; l <= FM_MAX_LAYERS; ++l)
    mlp.sizes[l] = dyn.size[l] = l <= num_layers ? sz[l] : 0;
  if (mlp.sizes[0] != Du + D || mlp.sizes[num_layers] != D ||
      tiles > (long long)K2_MAX_TILES * threads)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes != 4 * k2_smem_floats(mlp, twins, tc))
    return (int)cudaErrorInvalidValue;
  const FmLayout lay = fm_layout(mlp, true);
  const FmOps ops = fm_ops(mlp, lay, true);
  cudaGetLastError();                      // clear any stale error first
  const int blocks = (B + twins - 1) / twins;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(traj);
  const float* uf = static_cast<const float*>(u);
  const float* gf = static_cast<const float*>(g);
  float* dyf = static_cast<float*>(dy0);
  float* pf = static_cast<float*>(partial);
  int err;
#define K2_LAUNCH(RT, SHAPE)                                                 \
  err = k2_launch<RT>(SHAPE, blocks, threads, smem_bytes, st, tf, uf, gf,    \
                      dyf, pf, mlp, lay, ops, B, T, u_twin_stride, P, dt,    \
                      dt2, dt6, tc)
  if (K2L96::matches(sz, num_layers)) {
    if (twins == 4) {
      K2_LAUNCH(4, K2L96{});
    } else {
      K2_LAUNCH(1, K2L96{});
    }
  } else if (K2HP::matches(sz, num_layers) && twins == 1) {
    K2_LAUNCH(1, K2HP{});
  } else if (twins == 4) {
    K2_LAUNCH(4, dyn);
  } else {
    K2_LAUNCH(1, dyn);
  }
#undef K2_LAUNCH
  if (err != cudaSuccess) return err;
  const int rgrid = (int)((P + K2_REDUCE_THREADS - 1) / K2_REDUCE_THREADS);
  k2_reduce_kernel<<<rgrid, K2_REDUCE_THREADS, 0, st>>>(pf,
      static_cast<float*>(grads), blocks, P);
  return (int)cudaGetLastError();
}

template <int RT, bool PURE, class Shape>
static int k2_launch_bf16(const Shape& shape, int blocks, int threads,
                          long long smem_bytes, cudaStream_t st,
                          const __nv_bfloat16* traj, const __nv_bfloat16* u,
                          const __nv_bfloat16* g, const float* g0, float* rep,
                          float* dy0, float* partial, const FmMlp& mlp,
                          const FmWeightsBf16& wb, const FmLayout& lay,
                          const FmOps& ops, int B, int T,
                          long long u_twin_stride, long long P, float dt,
                          float dt2, float dt6, int rc, int tc,
                          int rep_smem) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k2_rollout_bwd_bf16_kernel<RT, Shape, PURE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  k2_rollout_bwd_bf16_kernel<RT, Shape, PURE>
      <<<blocks, threads, (size_t)smem_bytes, st>>>(
          traj, u, g, g0, rep, dy0, partial, mlp, wb, lay, ops, shape, B, T,
          u_twin_stride, P, dt, dt2, dt6, rc, tc, rep_smem);
  return (int)cudaGetLastError();
}

// Launch K2 under a bf16 policy on `stream` (pure = 1 for "bf16", 0 for
// "bf16_f32acc"): the reverse sweep with its chunk replays, then the
// fixed-order reduction.  As k2_fused_node_rollout_bwd_f32, except that
// traj, u, g (rows 1..T read) and the weights and biases are bfloat16, g0
// (B, D) float32 is the cotangent of row 0, dt, dt2, dt6 are the policy's
// step constants and rc >= 1 is the forward's rounding chunk.  With
// rep_smem = 1 the replayed states sit in shared memory, and smem_bytes
// holds k2_smem_floats plus min(rc, T) * round4(D) * twins floats; with
// rep_smem = 0 rep holds min(rc, T) * B * D floats of scratch.
extern "C" int k2_fused_node_rollout_bwd_bf16(
    const void* traj, const void* u, const void* g, const void* g0,
    void* rep, void* dy0, void* partial, void* grads, const void* w_ptrs,
    const void* b_ptrs, const void* sizes, int num_layers, int B, int T,
    int D, int Du, long long u_twin_stride, float dt, float dt2, float dt6,
    int pure, int rc, int rep_smem, int twins, int threads, int tc,
    long long smem_bytes, void* stream) {
  if (num_layers < 1 || num_layers > FM_MAX_LAYERS || B < 1 || T < 0 ||
      (twins != 1 && twins != 4) || threads < 32 || threads % 32 != 0 ||
      threads > K2_MAX_THREADS || tc < 1 || rc < 1 ||
      (pure != 0 && pure != 1) || (rep_smem != 0 && rep_smem != 1))
    return (int)cudaErrorInvalidValue;
  FmMlp mlp = {};
  FmWeightsBf16 wb = {};
  FmDynShape dyn;
  const void* const* w = static_cast<const void* const*>(w_ptrs);
  const void* const* b = static_cast<const void* const*>(b_ptrs);
  const int* sz = static_cast<const int*>(sizes);
  mlp.num_layers = num_layers;
  dyn.L = num_layers;
  long long P = 0, tiles = 0;
  for (int l = 0; l < num_layers; ++l) {
    wb.w[l] = static_cast<const __nv_bfloat16*>(w[l]);
    wb.b[l] = static_cast<const __nv_bfloat16*>(b[l]);
    P += (long long)sz[l] * sz[l + 1] + sz[l + 1];
    tiles += k2_layer_tiles(sz[l], sz[l + 1]);
  }
  for (int l = 0; l <= FM_MAX_LAYERS; ++l)
    mlp.sizes[l] = dyn.size[l] = l <= num_layers ? sz[l] : 0;
  if (mlp.sizes[0] != Du + D || mlp.sizes[num_layers] != D ||
      tiles > (long long)K2_MAX_TILES * threads)
    return (int)cudaErrorInvalidValue;
  const long long rep_floats =
      rep_smem ? (long long)min(rc, max(T, 1)) * fm_round4(D) * twins : 0;
  if (smem_bytes != 4 * (k2_smem_floats(mlp, twins, tc) + rep_floats))
    return (int)cudaErrorInvalidValue;
  const FmLayout lay = fm_layout(mlp, true);
  const FmOps ops = fm_ops(mlp, lay, true);
  cudaGetLastError();                      // clear any stale error first
  const int blocks = (B + twins - 1) / twins;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* tb = static_cast<const __nv_bfloat16*>(traj);
  const __nv_bfloat16* ub = static_cast<const __nv_bfloat16*>(u);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const float* g0f = static_cast<const float*>(g0);
  float* repf = static_cast<float*>(rep);
  float* dyf = static_cast<float*>(dy0);
  float* pf = static_cast<float*>(partial);
  int err;
#define K2B_LAUNCH(RT, SHAPE)                                                \
  err = pure ? k2_launch_bf16<RT, true>(SHAPE, blocks, threads, smem_bytes, \
                                        st, tb, ub, gb, g0f, repf, dyf, pf, \
                                        mlp, wb, lay, ops, B, T,            \
                                        u_twin_stride, P, dt, dt2, dt6, rc, \
                                        tc, rep_smem)                       \
             : k2_launch_bf16<RT, false>(SHAPE, blocks, threads,            \
                                         smem_bytes, st, tb, ub, gb, g0f,   \
                                         repf, dyf, pf, mlp, wb, lay, ops,  \
                                         B, T, u_twin_stride, P, dt, dt2,   \
                                         dt6, rc, tc, rep_smem)
  if (K2L96::matches(sz, num_layers)) {
    if (twins == 4) {
      K2B_LAUNCH(4, K2L96{});
    } else {
      K2B_LAUNCH(1, K2L96{});
    }
  } else if (K2HP::matches(sz, num_layers) && twins == 1) {
    K2B_LAUNCH(1, K2HP{});
  } else if (twins == 4) {
    K2B_LAUNCH(4, dyn);
  } else {
    K2B_LAUNCH(1, dyn);
  }
#undef K2B_LAUNCH
  if (err != cudaSuccess) return err;
  const int rgrid = (int)((P + K2_REDUCE_THREADS - 1) / K2_REDUCE_THREADS);
  k2_reduce_kernel<<<rgrid, K2_REDUCE_THREADS, 0, st>>>(pf,
      static_cast<float*>(grads), blocks, P);
  return (int)cudaGetLastError();
}
