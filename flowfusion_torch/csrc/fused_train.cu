// A whole training epoch of a score or velocity MLP in one launch, for Hopper.
//
// Replaces flowfusion_tpu/kernels/fused_train.py::_kernel (the Pallas kernel,
// pallas_call at fused_train.py:708), reached through fused_train_epoch
// (fused_train.py:751) and, one launch a stack, fused_train_epoch_symplectic
// (fused_train.py:466), in the JAX kernel's three compute modes (the
// template's P, below).  Build without --use_fast_math: sigmoid goes through expf, gelu
// through erff, Adam through sqrtf and the bias corrections through
// expf/logf, the Fourier features through sinf/cosf.  Those features
// [sin(2 pi t W) | cos(2 pi t W)] of score nets are computed for every row of
// every step by a small kernel of their own (fourier_table_kernel), launched
// on the same stream just before the training kernel: sinf's slow-path range
// reduction keeps a 32-byte local array a thread, which the training kernel,
// at one block an SM and 0 local bytes, does without.
//
// What it computes, step s = 0 .. steps-1, for the per-step tables
// xt, zw (steps, bs, D), t, beta (steps, bs), cond (steps, bs, C):
//   u     = [sin(2 pi t W) | cos(2 pi t W) | xt | cond]   (score nets, E2 > 0)
//         = [xt | t | cond]                                (velocity nets)
//   forward through the layers, keeping every layer input and act'(a);
//   r     = zw + beta * net,  loss[s] = inv * sum r^2
//   delta = 2 inv beta r; per layer dW = h^T delta, db = sum_rows delta,
//           delta <- (delta W^T) * act'
//   Adam (optax.adam): m = b1 m + (1-b1) g, v = b2 v + (1-b2) g g,
//           p -= lr (m / bc1) / (sqrt(v / bc2) + eps),
//           bc = 1 - exp(t log b) with t = step0 + s + 1
//   EMA of the updated parameters: ema = d ema + (1-d) p.
// The Fourier W is an input only.
//
// What bounds a step on this card.  Its flops, 3 x 2 H (K + (n_hidden - 1) H
// + D) a row (fused_train.py:705-717), are 105 MFLOP for the flagship net at
// bs 512, 1.57 us at 67 TFLOP/s; but a step is a serial chain (the forward's
// layer products, the backward's delta products, the weight gradients, Adam)
// and the next step's forward needs this step's Adam, so a step is as fast
// as its chain on the busiest SM plus two grid barriers.  The first version
// took 88.6 us a step at bs 512 (a clock64-stamped copy on the H100,
// 175k cycles at 1.98 GHz): it planned 32 rows a block, so 16 of 132 SMs
// worked at bs 512 and 4 at bs 128; each busy block spent 12% of a step in
// each hidden forward product and 16% in each delta product (half its
// threads held outputs, every row group re-read the weights from L2), 9% in
// the output layer on 4 threads, 13% in per-block weight gradients, and
// 5-8% in phase B and the two barriers.  This design takes ~55k cycles a
// bs-512 step (same stamping): staging the net 18% (L2 bandwidth: 145 KB a
// block a step), the forward 27%, the delta products 14%, phase B 24%, the
// barriers' waits 10%.
//
// What the design does about it.
//   * One persistent cooperative launch for the whole call (the grid no
//     larger than the card holds at once); cooperative_groups' grid barrier
//     separates the two phases of every step.
//   * Phase A, rows: the plan (kernels/fused_train.py::train_plan) takes the
//     fewest rows a block among those that give the busiest of 132 SMs the
//     fewest row tiles: 4 rows at bs 512 (128 row tiles), 1 at bs 128 (8 or
//     2 rows measured slower).  A block runs forward, loss and backward of
//     its tile in shared memory and writes each row's layer inputs h_l,
//     deltas delta_l and loss into a global workspace (bs rows): no
//     gradient leaves phase A, and phase A keeps no reduction tree.
//   * Layer products give every thread outputs: a thread owns RT rows of one
//     output column (forward) or one input column (delta product), RT the
//     most of 4, 2, 1 that still gives a block 256 items, so all 256 threads
//     hold outputs from 2 rows a block up; the output layer is one thread an
//     output.  The activation runs in the forward product's epilogue and
//     keeps act'.  Cells are walked without a division a cell.
//   * The weights do not change during phase A: a block stages the whole net
//     into shared memory with cp.async (cg: through L2, which holds this
//     step's parameters) at the top of the step, one group a layer, and
//     each forward product waits for its own layer; the delta products read
//     the same copy, rows N + 4 floats apart (conflict-free float4 reads
//     down k).  Where the net does not fit beside the row tile (conditional
//     H = 256), each layer is staged in k-chunks before each product.
//     Direct __ldcg reads of the weights were 1.3-2.3x slower a launch,
//     and are not kept.  TMA bulk copies, one a weight row on a layer's mbarrier, were
//     1.23-1.35x slower than cp.async and are not used.
//   * Phase B, parameters: the grid strides over tiles of the parameters,
//     16 weight rows by 32 columns or a bias row by 32 (the wrapper's tile
//     map, largest first: 89 tiles for the flagship net, so no block takes
//     two).  A block streams the tile's h and delta columns of every row
//     through two shared-memory buffers by cp.async; warp c sums over the
//     rows of fixed chunk c (ceil(bs / 8) rows), a lane a 4 k by 4 n
//     register tile, one fmaf chain a parameter in row order; the 8 chunk
//     partials are added in chunk order, then Adam and the EMA run in the
//     same pass, their operands loaded before the sums.  Eight threads of
//     the last block sum the per-row losses the same way.  Every read of
//     data written inside the launch goes through __ldcg or cp.async.cg.
// Compute modes.  The mode reaches the three layer products and the
// activation, as the JAX kernel's _make_dots and _act_pair_fn take it
// (fused_train.py:164-199, :281-283): the forward products (layer 0 on the
// whole input u), the delta products by W^T and phase B's weight gradients.
//   float32   strict IEEE fp32: one fmaf a product;
//   highf32   3xTF32: each operand split into TF32 halves (split_tf32) as it
//             is read, the product lo.hi + hi.lo + hi.hi in FMAs (fma_split,
//             the counterpart of bf16_3pass_dot_general);
//   bfloat16  each operand rounded to bf16 (round_bf16) as it is read, the
//             product then exact in one fmaf: bf16 operands, fp32 sums.
// Both throughput modes take the tanh-form sigmoid (act_pair_highf32).  The
// products run on the CUDA cores, in the same chains as float32 (the same
// order, so the invariant below holds in every mode), not on the tensor
// cores: a step is a serial chain of narrow products (1-4 rows a block),
// and this keeps the plan, the shared memory and the tile map of float32.
// The biases, the residual and loss, the output delta, the bias gradient
// (an unrounded sum of the deltas), the multiply by act', Adam, the
// moments, the EMA and the Fourier features stay fp32.  Operands are split
// or rounded in registers; nothing of the mode is stored.
//
// The invariant: no sum's order depends on the plan.  Each row's forward and
// delta chains are one fmaf chain over k (n) from 0, then + bias (* act');
// each parameter's gradient and the loss are summed in an order fixed by bs
// alone.  So a launch is bitwise equal to the same launch at any other rows
// a block, grid or staging.  Padded rows and columns (K, H, D to multiples
// of 4) get exactly zero gradient and stay zero; rows past bs in the last
// tile are never written to the workspace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace ffk;
namespace cg = cooperative_groups;

// Phase B: the batch sums run in kChunks fixed row chunks, a warp each; a
// lane owns a 4 k by 4 n register tile of a parameter tile (kTileItems such
// items at most: 16 rows by 32 columns).
constexpr int kChunks = kThreads / 32;
constexpr int kTileItems = 32;
constexpr int kWPad = 4;  // floats past N in a staged weight row
// The least shared floats a block has before its staged weights: phase B's
// partials (16 a thread), then two buffers of at least 42 rows of its
// widest tile row (16 k + 32 n).
constexpr int kPartials = 16 * kThreads;
constexpr int kPhaseBFloats = 2 * kPartials;
constexpr float kTwoPi = 6.28318548f;  // float32(2 pi), as the plain version rounds it
// The compute modes, the templates' P (the wrapper's precision index).
enum Precision { kFloat32 = 0, kHighF32 = 1, kBFloat16 = 2 };

// An operand of a layer product in compute mode P, prepared once as it is
// read: float32 as it is, highf32 its TF32 halves, bfloat16 rounded to bf16.
template <int P>
struct Operand {
  float hi, lo;
  __device__ __forceinline__ explicit Operand(float x) {
    if constexpr (P == kHighF32) {
      split_tf32(x, hi, lo);
    } else {
      hi = P == kBFloat16 ? round_bf16(x) : x;
      lo = 0.0f;
    }
  }
};

// acc + a b in compute mode P: one fmaf, or fma_split's three in highf32.
template <int P>
__device__ __forceinline__ float mac(const Operand<P>& a, const Operand<P>& b, float acc) {
  if constexpr (P == kHighF32) return fma_split(a.hi, a.lo, b.hi, b.lo, acc);
  return fmaf(a.hi, b.hi, acc);
}

// act(a) and act'(a) in compute mode P: SiLU's sigmoid in tanh form in
// highf32 and bfloat16.
template <int P>
__device__ __forceinline__ void act_mode(int act, float a, float& h, float& dh) {
  if constexpr (P == kFloat32) act_pair(act, a, h, dh);
  else act_pair_highf32(act, a, h, dh);
}

struct TrainArgs {
  const float* xt;
  const float* zw;
  const float* t;
  const float* beta;
  const float* cond;  // null without conditionals
  const float* temb;  // (steps, bs, 2 E2) Fourier features (fourier_table_kernel); null for velocity nets
  const int* tiles;   // (n_ptiles, 5): layer, k0, kc, n0, nc
  float* p;
  float* m;
  float* v;
  float* ema;      // null without EMA
  float* ws_h;     // (bs, K + n_hidden H): each row's layer inputs
  float* ws_d;     // (bs, n_hidden H + Dp): each row's layer deltas
  float* ws_loss;  // (bs,): each row's sum of squared residuals
  float* loss;     // (steps,)
  int steps, bs, D, C, E2, K, H, n_hidden, Dp, act, R, step0, n_tiles, n_ptiles, acts, wbuf;
  float lr, beta1, beta2, eps, ema_decay, inv;
};

__device__ __forceinline__ int layer_in(const TrainArgs& a, int l) { return l == 0 ? a.K : a.H; }
__device__ __forceinline__ int layer_out(const TrainArgs& a, int l) {
  return l == a.n_hidden ? a.Dp : a.H;
}

// Offset of layer l's weight in a flat buffer; its bias follows the weight.
__device__ int weight_offset(const TrainArgs& a, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += (layer_in(a, i) + 1) * layer_out(a, i);
  return off;
}

// Offset of layer l's weight in the staged copy of the whole net.
__device__ int staged_offset(const TrainArgs& a, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += layer_in(a, i) * (layer_out(a, i) + kWPad);
  return off;
}

// A thread's walk over the (r, c) cells of a grid of `cols` columns,
// kThreads cells apart, with no division a cell.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ explicit Walk(int n) : cols(n) {
    r = threadIdx.x / n;
    c = threadIdx.x - r * n;
    dr = kThreads / n;
    dc = kThreads - dr * n;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most n committed cp.async groups of this thread are pending
// (more than 7: at most 7, which waits longer).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

// Rows [k0, k1) of a row-major (., N) weight into dst at row stride
// N + kWPad, by cp.async; the caller waits.
__device__ void stage_rows(const float* w, int N, int k0, int k1, float* dst) {
  const int q = N >> 2;
  for (Walk g(q); g.r < k1 - k0; g.next())
    cp_async16(dst + g.r * (N + kWPad) + 4 * g.c, w + (size_t)(k0 + g.r) * N + 4 * g.c);
}

// out[r][n] (row stride N) of in[r] @ w for R rows (in of row stride K),
// k over [kb, ke): w holds those weight rows in shared memory at row stride
// ws.  `first`
// starts each chain at 0, else it continues from out; `last` adds the bias
// and, for act >= 0, applies the activation and keeps act' in dh.  A thread
// owns RT rows of one column.  Products in compute mode P.
template <int P, int RT>
__device__ void fwd_cols(const float* w, int ws, int kb, int ke, const float* bias, const float* in, int K,
                         float* out, float* dh, int N, int R, bool first, bool last, int act) {
  for (Walk g(N); g.r < R / RT; g.next()) {
    const int n = g.c;
    const int r0 = g.r * RT;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = first ? 0.0f : out[(r0 + i) * N + n];
    for (int k = kb; k < ke; k += 4) {
      float4 hv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) hv[i] = *reinterpret_cast<const float4*>(in + (r0 + i) * K + k);
      const float* wk = w + (size_t)(k - kb) * ws + n;
      const Operand<P> w0(wk[0]);
      const Operand<P> w1(wk[ws]);
      const Operand<P> w2(wk[2 * ws]);
      const Operand<P> w3(wk[3 * ws]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        acc[i] = mac<P>(Operand<P>(hv[i].x), w0, acc[i]);
        acc[i] = mac<P>(Operand<P>(hv[i].y), w1, acc[i]);
        acc[i] = mac<P>(Operand<P>(hv[i].z), w2, acc[i]);
        acc[i] = mac<P>(Operand<P>(hv[i].w), w3, acc[i]);
      }
    }
    if (!last) {
#pragma unroll
      for (int i = 0; i < RT; ++i) out[(r0 + i) * N + n] = acc[i];
      continue;
    }
    const float b = __ldcg(bias + n);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float a = acc[i] + b;
      if (act < 0) {
        out[(r0 + i) * N + n] = a;
      } else {
        float h, d;
        act_mode<P>(act, a, h, d);
        out[(r0 + i) * N + n] = h;
        dh[(r0 + i) * N + n] = d;
      }
    }
  }
}

// dh[r][k] (row stride K) *= sum_n delta[r][n] w[k][n] for R rows and k in
// [kb, ke): the product by W^T of the backward, times the stored act'.  w
// holds those weight rows at row stride ws.  A thread owns RT rows of one k.
// Products in compute mode P; the multiply by act' in fp32.
template <int P, int RT>
__device__ void bwd_cols(const float* w, int ws, int kb, int ke, const float* delta, int N, float* dh,
                         int K, int R) {
  for (Walk g(ke - kb); g.r < R / RT; g.next()) {
    const int k = kb + g.c;
    const int r0 = g.r * RT;
    const float* wk = w + (size_t)g.c * ws;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
    for (int n = 0; n < N; n += 4) {
      const float4 q = *reinterpret_cast<const float4*>(wk + n);
      const Operand<P> q0(q.x), q1(q.y), q2(q.z), q3(q.w);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 dv = *reinterpret_cast<const float4*>(delta + (r0 + i) * N + n);
        acc[i] = mac<P>(Operand<P>(dv.x), q0, acc[i]);
        acc[i] = mac<P>(Operand<P>(dv.y), q1, acc[i]);
        acc[i] = mac<P>(Operand<P>(dv.z), q2, acc[i]);
        acc[i] = mac<P>(Operand<P>(dv.w), q3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* o = dh + (r0 + i) * K + k;
      *o = acc[i] * *o;
    }
  }
}

// Rows a thread owns in a product with `cols` output columns: the most of 4,
// 2, 1 dividing R that still gives the block kThreads items.
__device__ __forceinline__ int row_tile_of(int R, int cols) {
  if (R % 4 == 0 && (R / 4) * cols >= kThreads) return 4;
  if (R % 2 == 0 && (R / 2) * cols >= kThreads) return 2;
  return 1;
}

template <int P>
__device__ void fwd_any(const float* w, int ws, int kb, int ke, const float* bias, const float* in, int K,
                        float* out, float* dh, int N, int R, bool first, bool last, int act) {
  switch (row_tile_of(R, N)) {
    case 4: fwd_cols<P, 4>(w, ws, kb, ke, bias, in, K, out, dh, N, R, first, last, act); break;
    case 2: fwd_cols<P, 2>(w, ws, kb, ke, bias, in, K, out, dh, N, R, first, last, act); break;
    default: fwd_cols<P, 1>(w, ws, kb, ke, bias, in, K, out, dh, N, R, first, last, act);
  }
}

template <int P>
__device__ void bwd_any(const float* w, int ws, int kb, int ke, const float* delta, int N, float* dh, int K,
                        int R) {
  switch (row_tile_of(R, ke - kb)) {
    case 4: bwd_cols<P, 4>(w, ws, kb, ke, delta, N, dh, K, R); break;
    case 2: bwd_cols<P, 2>(w, ws, kb, ke, delta, N, dh, K, R); break;
    default: bwd_cols<P, 1>(w, ws, kb, ke, delta, N, dh, K, R);
  }
}

// Weight rows of layer l (N columns) a k-chunk stages: a multiple of 4.
__device__ __forceinline__ int chunk_rows(const TrainArgs& a, int N) {
  return (a.wbuf / (N + kWPad)) & ~3;
}

// Layer l's forward product over R rows, from the net staged at the top of
// the step (resident) or layer l staged in k-chunks; ends with a barrier.
template <int P>
__device__ void layer_fwd(const TrainArgs& a, int l, const float* in, float* out, float* dh, int act,
                          const float* wsm, bool resident) {
  const int K = layer_in(a, l), N = layer_out(a, l);
  const float* w = a.p + weight_offset(a, l);
  const float* bias = w + (size_t)K * N;
  if (resident) {
    cp_async_wait_pending(a.n_hidden - l);  // layer l of the net staged at the top of the step
    __syncthreads();
    fwd_any<P>(wsm + staged_offset(a, l), N + kWPad, 0, K, bias, in, K, out, dh, N, a.R, true, true, act);
  } else {
    const int kc = chunk_rows(a, N);
    for (int kb = 0; kb < K; kb += kc) {
      const int ke = min(K, kb + kc);
      stage_rows(w, N, kb, ke, const_cast<float*>(wsm));
      cp_async_wait_all();
      __syncthreads();
      fwd_any<P>(wsm, N + kWPad, kb, ke, bias, in, K, out, dh, N, a.R, kb == 0, ke == K, act);
      if (ke < K) __syncthreads();
    }
  }
  __syncthreads();
}

// The delta product through layer l (l >= 1): dh of layer l - 1 *= delta_l W_l^T.
template <int P>
__device__ void layer_bwd(const TrainArgs& a, int l, const float* delta, float* dh, const float* wsm,
                          bool resident) {
  const int K = layer_in(a, l), N = layer_out(a, l);
  const float* w = a.p + weight_offset(a, l);
  if (resident) {
    bwd_any<P>(wsm + staged_offset(a, l), N + kWPad, 0, K, delta, N, dh, K, a.R);
  } else {
    const int kc = chunk_rows(a, N);
    for (int kb = 0; kb < K; kb += kc) {
      const int ke = min(K, kb + kc);
      stage_rows(w, N, kb, ke, const_cast<float*>(wsm));
      cp_async_wait_all();
      __syncthreads();
      bwd_any<P>(wsm, N + kWPad, kb, ke, delta, N, dh, K, a.R);
      if (ke < K) __syncthreads();
    }
  }
  __syncthreads();
}

// cols columns of `rows` rows (row stride cols in shared memory) into the
// workspace at row stride ld, column offset c0; cols a multiple of 4.
__device__ void to_workspace(const float* src, int rows, int cols, float* dst, int ld, int c0) {
  for (Walk g(cols >> 2); g.r < rows; g.next())
    __stcg(reinterpret_cast<float4*>(dst + (size_t)g.r * ld + c0 + 4 * g.c),
           *reinterpret_cast<const float4*>(src + g.r * cols + 4 * g.c));
}

// Phase A for one row tile of step s: forward, per-row loss, backward; each
// row's layer inputs, deltas and loss into the workspace.
template <int P>
__device__ void row_tile(const TrainArgs& a, int s, int tile, float* smem, const float* wsm, bool resident) {
  const int R = a.R, K = a.K, H = a.H, Dp = a.Dp, L = a.n_hidden;
  const int rh = R * H;
  float* u = smem;             // R x K: the input features
  float* hs = u + R * K;       // L buffers of R x H: act(a_l), the input of layer l + 1
  float* dhs = hs + L * rh;    // L buffers: act'(a_l), then the backward's deltas
  float* dout = dhs + L * rh;  // R x Dp: net, then dL/dnet
  const int row0 = tile * R;
  const int valid = min(R, a.bs - row0);

  for (Walk g(K); g.r < R; g.next()) {
    const int row = row0 + g.r;
    float val = 0.0f;
    if (row < a.bs) {
      const size_t rs = (size_t)s * a.bs + row;
      int f = g.c;
      if (a.E2 > 0) {  // [sin | cos | x | cond]
        if (f < 2 * a.E2) {
          val = a.temb[rs * 2 * a.E2 + f];
          f = -1;
        } else {
          f -= 2 * a.E2;
        }
        if (f >= 0 && f < a.D) val = a.xt[rs * a.D + f];
        else if (f >= a.D && f < a.D + a.C) val = a.cond[rs * a.C + (f - a.D)];
      } else {  // [x | t | cond]
        if (f < a.D) val = a.xt[rs * a.D + f];
        else if (f == a.D) val = a.t[rs];
        else if (f < a.D + 1 + a.C) val = a.cond[rs * a.C + (f - a.D - 1)];
      }
    }
    u[g.r * K + g.c] = val;
  }
  __syncthreads();

  // forward, keeping every layer input and act'
  for (int l = 0; l <= L; ++l) {
    const float* in = l == 0 ? u : hs + (l - 1) * rh;
    if (l < L) layer_fwd<P>(a, l, in, hs + l * rh, dhs + l * rh, a.act, wsm, resident);
    else layer_fwd<P>(a, l, in, dout, nullptr, -1, wsm, resident);
  }
  const int SH = K + L * H;
  to_workspace(u, valid, K, a.ws_h + (size_t)row0 * SH, SH, 0);
  for (int l = 0; l < L; ++l) to_workspace(hs + l * rh, valid, H, a.ws_h + (size_t)row0 * SH, SH, K + l * H);

  // residual, each row's loss and the output delta, a thread a row; masked
  // rows and padded outputs get zero
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int row = row0 + r;
    float lsum = 0.0f;
    for (int d = 0; d < Dp; ++d) {
      float dl = 0.0f;
      if (row < a.bs && d < a.D) {
        const size_t rs = (size_t)s * a.bs + row;
        const float bt = a.beta[rs];
        const float res = a.zw[rs * a.D + d] + bt * dout[r * Dp + d];
        lsum += res * res;
        dl = (2.0f * a.inv) * bt * res;
      }
      dout[r * Dp + d] = dl;
    }
    if (row < a.bs) __stcg(a.ws_loss + row, lsum);
  }
  __syncthreads();

  // backward: the delta of layer l - 1 into the act' buffer it multiplies
  for (int l = L; l >= 1; --l) layer_bwd<P>(a, l, l == L ? dout : dhs + l * rh, dhs + (l - 1) * rh, wsm, resident);
  const int SD = L * H + Dp;
  for (int l = 0; l < L; ++l) to_workspace(dhs + l * rh, valid, H, a.ws_d + (size_t)row0 * SD, SD, l * H);
  to_workspace(dout, valid, Dp, a.ws_d + (size_t)row0 * SD, SD, L * H);
  __syncthreads();
}

// Rows [r0, r1) of a phase-B batch into a lane's 4 k by 4 n register tile
// (acc[k][n]): hb the tile's input columns (row stride kh) from column 4 ik,
// db its delta columns (row stride nc) from column c4, one chain a parameter
// in row order, products in compute mode P.  The bias row (kh = 0: its input
// is 1, and only k = 0 is kept) sums the deltas unrounded in every mode.
template <int P>
__device__ __forceinline__ void sum_rows(float (&acc)[4][4], const float* hb, const float* db, int kh, int nc,
                                         int ik, int c4, int r0, int r1) {
  if (kh == 0) {
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float4 d = *reinterpret_cast<const float4*>(db + r * nc + c4);
      acc[0][0] += d.x;
      acc[0][1] += d.y;
      acc[0][2] += d.z;
      acc[0][3] += d.w;
    }
    return;
  }
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const float4 h = *reinterpret_cast<const float4*>(hb + r * kh + 4 * ik);
    const float4 d = *reinterpret_cast<const float4*>(db + r * nc + c4);
    const float hv[4] = {h.x, h.y, h.z, h.w};
    const Operand<P> d0(d.x), d1(d.y), d2(d.z), d3(d.w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Operand<P> x(hv[i]);
      acc[i][0] = mac<P>(x, d0, acc[i][0]);
      acc[i][1] = mac<P>(x, d1, acc[i][1]);
      acc[i][2] = mac<P>(x, d2, acc[i][2]);
      acc[i][3] = mac<P>(x, d3, acc[i][3]);
    }
  }
}

// Phase B for parameter tile j: each parameter's gradient summed over the
// batch in the fixed chunk order, then Adam and the EMA.  A tile is kc <= 16
// weight rows [k0, k0 + kc) by nc <= 32 columns, or the bias row (k0 = K_l,
// kc = 1).  Its inputs and deltas come through shared memory (phase A's
// tile and the staged weights are free here): batches of RB rows of the
// tile's h and delta columns by cp.async into two buffers, the next batch
// in flight while warp c sums this batch's rows of chunk c, a lane a 4 k by
// 4 n register tile, one fmaf chain a parameter in row order, batch after
// batch, so the order does not depend on RB; then the chunks' partials are
// added in chunk order.  The Adam operands of a thread's outputs are loaded
// before the sums.  Products in compute mode P (sum_rows).
template <int P>
__device__ void param_tile(const TrainArgs& a, int j, float* smem, float bc1, float bc2) {
  const int* tl = a.tiles + 5 * j;
  const int l = tl[0], k0 = tl[1], kc = tl[2], n0 = tl[3], nc = tl[4];
  const int K = layer_in(a, l), N = layer_out(a, l), L = a.n_hidden;
  const int SH = a.K + L * a.H, SD = L * a.H + a.Dp;
  const int kh = k0 == K ? 0 : kc;  // input columns to load: none for the bias row (its input is 1)
  const int n_out = kc * nc;        // <= 2 kThreads
  float* part = smem;               // kChunks x kTileItems x 16 partials
  const float* hsrc = a.ws_h + (l == 0 ? 0 : a.K + (l - 1) * a.H) + k0;
  const float* dsrc = a.ws_d + l * a.H + n0;
  const size_t off = weight_offset(a, l);

  // this thread's outputs o = threadIdx.x + i kThreads: parameter k0 + o / nc, column n0 + o % nc
  size_t idx[2];
  float m0[2], v0[2], p0[2], e0[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = threadIdx.x + i * kThreads;
    const int kk = o / nc;
    idx[i] = off + (size_t)(k0 + kk) * N + n0 + (o - kk * nc);
    if (o < n_out) {
      m0[i] = __ldcg(a.m + idx[i]);
      v0[i] = __ldcg(a.v + idx[i]);
      p0[i] = __ldcg(a.p + idx[i]);
      e0[i] = a.ema != nullptr ? __ldcg(a.ema + idx[i]) : 0.0f;
    }
  }

  // two buffers of RB rows (kh inputs, then nc deltas a row): the next
  // batch streams in while this one is summed
  const int cap = (a.acts + a.wbuf - kPartials) / (2 * (kh + nc));
  const int n_batches = max(2, (a.bs + cap - 1) / cap);
  const int RB = (a.bs + n_batches - 1) / n_batches;
  const int q = nc >> 2;
  const int qh = kh >> 2;
  const int chunk = threadIdx.x >> 5;
  const int item = threadIdx.x & 31;
  const bool active = item < (kh ? qh : 1) * q;
  const int ik = active ? item / q : 0;
  const int c4 = 4 * (item - ik * q);
  const int cs = (a.bs + kChunks - 1) / kChunks;
  const int c0 = chunk * cs, c1 = min(a.bs, c0 + cs);
  auto buffer = [&](int b) { return smem + kPartials + (b & 1) * RB * (kh + nc); };
  auto load = [&](int b) {
    float* hb = buffer(b);
    float* db = hb + RB * kh;
    const int b0 = b * RB;
    const int nb = min(RB, a.bs - b0);
    for (Walk g(qh + q); g.r < nb; g.next()) {
      const int row = b0 + g.r;
      if (g.c < qh) cp_async16(hb + g.r * kh + 4 * g.c, hsrc + (size_t)row * SH + 4 * g.c);
      else cp_async16(db + g.r * nc + 4 * (g.c - qh), dsrc + (size_t)row * SD + 4 * (g.c - qh));
    }
    cp_async_commit();
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) acc[i][jn] = 0.0f;
  load(0);
  for (int b = 0; b * RB < a.bs; ++b) {
    const bool more = (b + 1) * RB < a.bs;
    if (more) load(b + 1);
    cp_async_wait_pending(more ? 1 : 0);
    __syncthreads();
    const float* hb = buffer(b);
    const float* db = hb + RB * kh;
    const int b0 = b * RB;
    if (active) sum_rows<P>(acc, hb, db, kh, nc, ik, c4, max(c0, b0) - b0, min(c1, b0 + RB) - b0);
    __syncthreads();
  }
  // part[c][item][4 k x 4 n]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(part)[4 * threadIdx.x + i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o >= n_out) break;
    const int kk = o / nc;
    const int col = o - kk * nc;
    const int slot = 16 * ((kk >> 2) * q + (col >> 2)) + 4 * (kk & 3) + (col & 3);
    float g = part[slot];
#pragma unroll
    for (int c = 1; c < kChunks; ++c) g += part[16 * kTileItems * c + slot];
    const float mi = a.beta1 * m0[i] + (1.0f - a.beta1) * g;
    const float vi = a.beta2 * v0[i] + (1.0f - a.beta2) * g * g;
    const float pi = p0[i] - a.lr * (mi / bc1) / (sqrtf(vi / bc2) + a.eps);
    a.m[idx[i]] = mi;
    a.v[idx[i]] = vi;
    a.p[idx[i]] = pi;
    if (a.ema != nullptr) a.ema[idx[i]] = a.ema_decay * e0[i] + (1.0f - a.ema_decay) * pi;
  }
  __syncthreads();
}

// loss[s] = inv * the per-row losses summed in the fixed chunk order:
// batches of rows through shared memory, then a thread a chunk, in order.
__device__ void loss_sum(const TrainArgs& a, int s, float* smem) {
  const int cap = a.acts + a.wbuf;
  const int cs = (a.bs + kChunks - 1) / kChunks;
  float part = 0.0f;
  for (int b0 = 0; b0 < a.bs; b0 += cap) {
    const int nb = min(cap, a.bs - b0);
    for (int r = threadIdx.x; r < nb; r += kThreads) smem[r] = __ldcg(a.ws_loss + b0 + r);
    __syncthreads();
    if (threadIdx.x < kChunks) {
      const int r0 = max((int)threadIdx.x * cs, b0) - b0;
      const int r1 = min(min(a.bs, ((int)threadIdx.x + 1) * cs), b0 + nb) - b0;
      for (int r = r0; r < r1; ++r) part += smem[r];
    }
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    float total = __shfl_sync(0xffffffffu, part, 0);
#pragma unroll
    for (int c = 1; c < kChunks; ++c) total += __shfl_sync(0xffffffffu, part, c);
    if (threadIdx.x == 0) a.loss[s] = a.inv * total;
  }
}

// The Fourier features of n_rows rows (every step's t, row-major) into temb
// (n_rows, 2 E2): proj = (t W[f mod E2]) float32(2 pi), sinf for f < E2,
// cosf after, the order in which the plain version's fourier_time_embedding
// rounds them.  A thread an entry, grid-strided.
__global__ void __launch_bounds__(kThreads) fourier_table_kernel(const float* t, const float* wemb, int n_rows,
                                                                 int E2, float* temb) {
  const size_t n = (size_t)n_rows * 2 * E2;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += (size_t)gridDim.x * kThreads) {
    const size_t row = i / (2 * E2);
    const int f = (int)(i - row * 2 * E2);
    const float proj = (t[row] * wemb[f < E2 ? f : f - E2]) * kTwoPi;
    temb[i] = f < E2 ? sinf(proj) : cosf(proj);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1) fused_train_kernel(TrainArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem + a.acts;
  const bool resident = a.wbuf >= staged_offset(a, a.n_hidden + 1);
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < a.steps; ++s) {
    if (resident && (int)blockIdx.x < a.n_tiles)
      for (int l = 0; l <= a.n_hidden; ++l) {  // one cp.async group a layer, waited layer by layer
        stage_rows(a.p + weight_offset(a, l), layer_out(a, l), 0, layer_in(a, l), wsm + staged_offset(a, l));
        cp_async_commit();
      }
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) row_tile<P>(a, s, tile, smem, wsm, resident);
    grid.sync();
    const float tstep = (float)(a.step0 + s + 1);
    const float bc1 = 1.0f - expf(tstep * logf(a.beta1));
    const float bc2 = 1.0f - expf(tstep * logf(a.beta2));
    if (blockIdx.x == gridDim.x - 1) loss_sum(a, s, smem);
    for (int j = blockIdx.x; j < a.n_ptiles; j += gridDim.x) param_tile<P>(a, j, smem, bc1, bc2);
    grid.sync();
  }
}

// The kernel's instantiation for a precision index; null for none.
using TrainKernel = void (*)(TrainArgs);
TrainKernel train_kernel(int precision) {
  switch (precision) {
    case kFloat32: return fused_train_kernel<kFloat32>;
    case kHighF32: return fused_train_kernel<kHighF32>;
    case kBFloat16: return fused_train_kernel<kBFloat16>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Blocks of the kernel's instantiation for `precision` with `smem` bytes of
// shared memory that one SM holds at once, and the SM count; a cooperative
// grid may not exceed their product.  Returns a cudaError_t
// (cudaErrorNotSupported without cooperative launches).
int ff_fused_train_capacity(int precision, size_t smem, int* blocks_per_sm, int* sm_count) {
  const TrainKernel kernel = train_kernel(precision);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  int coop = 0;
  st = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (st != cudaSuccess) return (int)st;
  if (!coop) return (int)cudaErrorNotSupported;
  st = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (st != cudaSuccess) return (int)st;
  st = allow_smem(kernel, smem);
  if (st != cudaSuccess) return (int)st;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

// Registers and local-memory bytes a thread of the instantiation for
// `precision`.
int ff_fused_train_attributes(int precision, int* regs, int* local_bytes) {
  const TrainKernel kernel = train_kernel(precision);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t st = cudaFuncGetAttributes(&attr, kernel);
  if (st != cudaSuccess) return (int)st;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// One cooperative launch of `grid` blocks on `stream` for the whole call,
// after the Fourier table's launch for score nets; returns the cudaError_t
// of the launches (0 on success).  p, m, v and ema (null without EMA) are
// flat buffers of the layers' (K_l + 1, N_l) blocks, updated in place; ws_h
// (bs, K_pad + n_hidden H), ws_d (bs, n_hidden H + D_pad) and ws_loss (bs,)
// are scratch; wemb is the (E2,) Fourier weight and temb (steps, bs, 2 E2)
// scratch for its table (both null for velocity nets); tiles is the
// (n_ptiles, 5) parameter tile map;
// loss is (steps,).  K_pad, H and D_pad are multiples of 4; E2 = 0 selects
// the velocity input [x | t | cond]; precision is the compute mode (0
// float32, 1 highf32, 2 bfloat16).  Shared memory: acts floats of row tile
// (at least kPhaseBFloats, phase B's), then wbuf floats of staged weights
// (the whole net, or at least 4 rows of the widest layer for k-chunks).
int ff_fused_train(const float* xt, const float* zw, const float* t, const float* beta, const float* cond,
                   const float* wemb, float* temb, const int* tiles, float* p, float* m, float* v, float* ema, float* ws_h,
                   float* ws_d, float* ws_loss, float* loss, int steps, int bs, int D, int C, int E2, int K_pad,
                   int H, int n_hidden, int D_pad, int act, int rows, int n_ptiles, int step0, int wbuf, int precision,
                   float lr, float beta1, float beta2, float eps, float ema_decay, float inv, int grid, void* stream) {
  const TrainKernel kernel = train_kernel(precision);
  const int acts_rows = rows * (K_pad + 2 * n_hidden * H + D_pad);
  const int acts = acts_rows > kPhaseBFloats ? acts_rows : kPhaseBFloats;
  const int widest = H > D_pad ? H : D_pad;
  if (steps < 1 || bs < 1 || D < 1 || D > D_pad || K_pad % 4 || H % 4 || D_pad % 4 || rows < 1 ||
      n_hidden < 1 || grid < 1 || n_ptiles < 1 || wbuf < 4 * (widest + kWPad) || kernel == nullptr ||
      (E2 > 0 && (wemb == nullptr || temb == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  TrainArgs a;
  a.xt = xt;
  a.zw = zw;
  a.t = t;
  a.beta = beta;
  a.cond = cond;
  a.temb = temb;
  a.tiles = tiles;
  a.p = p;
  a.m = m;
  a.v = v;
  a.ema = ema;
  a.ws_h = ws_h;
  a.ws_d = ws_d;
  a.ws_loss = ws_loss;
  a.loss = loss;
  a.steps = steps;
  a.bs = bs;
  a.D = D;
  a.C = C;
  a.E2 = E2;
  a.K = K_pad;
  a.H = H;
  a.n_hidden = n_hidden;
  a.Dp = D_pad;
  a.act = act;
  a.R = rows;
  a.step0 = step0;
  a.n_tiles = (bs + rows - 1) / rows;
  a.n_ptiles = n_ptiles;
  a.acts = acts;
  a.wbuf = wbuf;
  a.lr = lr;
  a.beta1 = beta1;
  a.beta2 = beta2;
  a.eps = eps;
  a.ema_decay = ema_decay;
  a.inv = inv;
  const size_t smem = 4 * ((size_t)acts + wbuf);
  cudaError_t st = allow_smem(kernel, smem);
  if (st != cudaSuccess) return (int)st;
  if (E2 > 0) {
    const size_t entries = (size_t)steps * bs * 2 * E2;
    const size_t blocks = (entries + kThreads - 1) / kThreads;
    fourier_table_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t, wemb, steps * bs, E2, temb);
    st = cudaGetLastError();
    if (st != cudaSuccess) return (int)st;
  }
  void* args[] = {&a};
  st = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads), args, smem,
                                   static_cast<cudaStream_t>(stream));
  if (st != cudaSuccess) return (int)st;
  return (int)cudaGetLastError();
}

}  // extern "C"
