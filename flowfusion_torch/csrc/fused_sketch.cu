// The whole Hutch++ or XTrace right-hand side in one launch, for Hopper.
//
// Replaces the sketch modes of flowfusion_tpu/kernels/fused_mlp.py::_kernel
// (_sketch_chunk, fused_mlp.py:673-754, with _qr_lane :601 and _tri_inv_lane
// :649), reached through fused_drift_sketch (fused_mlp.py:1060) and
// fused_velocity_sketch (fused_mlp.py:1112), in three compute modes (the
// template's P, the wrapper's precision index, as in fused_mlp.cu):
//   float32  strict IEEE fp32 FMAs in every chain (the Pallas kernel runs its
//            float32 sketch tangent chains at a 3-pass bf16 split, for speed
//            alone; this one does not);
//   highf32  the Pallas kernel's 3-pass split mode (mm_3pass, fused_mlp.py:
//            547-552, bf16_3pass_dot_general :214-233) and its tanh-form SiLU
//            (:596-599), here as 3xTF32, as in fused_mlp.cu: every hidden
//            (H, H) product, the forward chain's and all tangent chains' at
//            once, on the tensor cores (mlp_tile.cuh dense_tf32x3), the
//            (H, D) output layer through the split in FMAs, act' from the
//            tanh-form sigmoid; the primal input projection strict up to 16
//            features (in_proj_rows :313-330) and through the split past
//            that; the probes' projection (D rows of w_in) likewise, as the
//            JAX kernel's in_proj with mm_tan (:577-593) takes a probe:
//            strict up to 16 rows, the split past that;
//   bfloat16 the JAX kernel's fast serving mode (_compute_mode :175-205,
//            mm :554-560 at Precision.DEFAULT; relax_tangents :577-582 is
//            float32's alone, so the tangents round like the drift): the
//            weights bf16 (the wrapper converts them once a call, as
//            fused_mlp.cu takes them: w_in rounded and kept fp32, the hidden
//            weights bf16 (out, in), w_out bf16 (H, D)); the activation,
//            and each tangent act'(a) t, rounded to bf16 before every
//            product, fp32 sums; every hidden (H, H) product, the forward
//            chain's and all tangent chains' at once, on the bf16 tensor
//            cores (mlp_tile.cuh dense_bf16, mma.sync m16n8k16), the (H, D)
//            output layer in FMAs on the same rounded operands
//            (dense_out_bf16); the tanh-form SiLU, act' stored fp32; the
//            primal input projection strict up to 16 features and on rounded
//            inputs past that; the probes' projection (D rows) the strict
//            rank-1 FMA loop over the rounded w_in up to 16 rows and on
//            rounded probes past that (in_proj_rows :313-331).
// In every mode the per-row QR, projections, inverse and leave-one-out
// algebra are elementwise fp32, as in the Pallas kernel.
//
// What it computes, per row, for the drift f(x) = c0 x + c1 net(t, x[, cond])
// (the caller folds t into b_eff) and the operator A v = c0 v + c1 J_net v:
//   hutchpp (S: r probes, G: m probes):
//     Y = A S;  Q = qr(Y);  U = (I - Q Q^T) G;
//     div = sum_i q_i . A q_i + (1/m) sum_k u_k . A u_k
//   xtrace (O: m probes):
//     Y = A O;  (Q, R) = qr(Y);  then A Q, the H, W and T grids, inv(R)
//     row-normalized and transposed, and the leave-one-out estimate averaged
//     over the left-out probe (flowfusion_tpu/ops/trace.py:317-359).
// qr is modified Gram--Schmidt with the JAX package's floor max(scale 1e-6,
// 1e-30) and basis completion by the canonical vector with the largest
// residual (first index among equals); inv(R) clamps near-zero diagonals to
// sign(d) floor + (d == 0) floor.  So degenerate sketches (parallel probes)
// and zero rows give bounded values, never NaN.
//
// What bounds it on this card.  Per row it runs the forward chain once and
// 2r + m (hutchpp) or 2m (xtrace) tangent chains, 2 H (D_in + (n_hidden - 1)
// H + D) flops each: ~400k flops a row for the flagship net at r = 2, m = 1,
// against ~50 bytes of input and output.  float32: fp32 FMA throughput.
// highf32: the hidden products' three TF32 passes on the tensor cores
// (495 TFLOP/s dense) plus the CUDA-core rest; bfloat16: one pass on the
// bf16 tensor cores (989 TFLOP/s dense) plus the same CUDA-core rest, the
// output layer once; mma.sync does not reach the wgmma rate.  Each layer product is a chain of barriers over a block's
// small tile, so what the SM can overlap decides the time: the blocks it
// holds at once.
//
// What the design does about it.  A block owns a tile of R rows.  The
// forward chain runs once and keeps act'(a) of every activation layer in
// shared memory (n_act x R x H floats); every Jacobian application seeds
// its tangent chains from the probe tile and multiplies them by the stored
// act' at each layer, no bias, no recomputed forward, so a sketch RHS
// touches device memory only for x, the probes, the weights, the drift and
// div.
//   - Three blocks of 256 threads an SM.  The plan
//     (kernels/fused_sketch.py::sketch_plan) counts blocks against the SM's
//     233,472 bytes with the 1 KB each block reserves, and takes the most
//     blocks (at most three) at the most rows that reach them; the launch
//     bounds hold every instantiation to the 80 registers a thread that
//     three blocks leave, without spilling (a float32 product thread owns 4
//     rows by 4 columns).  The first version's plans held one block (the
//     flagship XTrace, 32 rows) or two an SM.
//   - float32 (H, H) products: mlp_tile.cuh dense at 4 rows by 4 columns a
//     thread, each output one fmaf chain over k = 0 .. H-1 in order, the
//     weights through __ldg.  Staging the weights in shared memory (a
//     cp.async ring of K-panels, read from L2 once a block rather than once
//     a warp) measured 1.04-1.38x slower at every plan the repository
//     runs: the L2 traffic it saves is not what bounds the product, and the
//     ring costs a barrier a panel and shared memory a block.
//   - highf32 products: one (k R) by H tensor-core product for all k chains
//     of an application (dense_tf32x3, weights through __ldg).
//   - bfloat16: the act' store (fp32), one fp32 chain buffer and one bf16
//     plane of kmax chains take the place of the two fp32 chain buffers,
//     rows H + kPadBF16 apart in both (the A-fragment reads of dense_bf16
//     fall on 32 distinct banks).  An activation pass writes act' and the
//     rounded act(a) into the plane; a Jacobian application seeds its
//     chains and multiplies them by the stored act' in one pass, rounding
//     into the plane, then per layer one (k R) by H dense_bf16 product into
//     the fp32 buffer and one pass of act' and rounding back into the
//     plane; the output layer writes a compact (k R, D) tile.  A warp of a
//     product carries two m-tiles (kMTilesBF16), not fused_mlp.cu's four,
//     so that every instantiation fits 80 registers without spilling.  The
//     plane is 2 bytes a value, so these plans hold at least float32's
//     rows.
//   - Per-row algebra (QR, projections, inverse, the estimate) on one thread
//     a row, templated on MD in {2, 4, 8}, the smallest bucket >= D: every
//     register array is an MD-vector indexed by unrolled d loops (guarded by
//     the runtime D), and the first version's float[8][8] arrays in local
//     memory are gone.  The probe tile and XTrace's matrices (R of the QR,
//     A Q, inv(R), the H, W, T grids) live in element-major tiles in shared
//     memory (element e of row r at [e R + r]: a warp's rows on consecutive
//     banks); XTrace's lie over the input tile and the act' store where
//     these hold them (the drift and the last application leave them
//     free), so they seldom cost a plan rows or blocks.  Every sum is taken
//     in the order and multiply-add form of the first version; basis
//     completion recomputes the canonical residuals of the columns so far,
//     by the same updates in the same order, only on the rows that need
//     them.
//   - The wide path, MD = kMaxDim (64), for 8 < D <= 64: 64-vectors do not
//     fit the 80 registers a thread, so the row's vectors stay where the
//     narrow path stores them, in the element-major tiles of shared memory,
//     and every loop runs to the runtime D.  The QR works in place on the
//     tile's columns; a degenerate column is itself the scratch of basis
//     completion (each canonical residual is built there, its norm kept,
//     and the best one rebuilt there); Hutch++'s projections of a residual
//     probe on the Q columns go over the input tile, which the drift
//     leaves free.  So the wide path needs no shared memory beyond the
//     narrow layout, and the pop-cosmos plans (D = 16, C = 8) hold three
//     blocks an SM.  Its sums run in the narrow path's order and
//     multiply-add form.  A row's algebra stays serial on its thread: at
//     D = 64 it is a few thousand shared-memory FMAs a row against the
//     chains' ~10^5 a row.
// A row's arithmetic does not depend on R or on MD among 2, 4 and 8: any
// such plan gives bitwise the same drift and div, and the first version's.
// wgmma, the split weights staged for highf32, the bf16 weights staged in
// shared memory and the algebra spread over the block (a warp a row on the
// wide path) are later work.
// Build without --use_fast_math: sigmoid goes through expf (tanhf in
// highf32) and gelu through erff, matching the plain PyTorch path's
// transcendentals.  The build compiles this source once a compute mode
// (FF_SKETCH_PRECISION = P, kernels/_build.py VARIANTS), all three in
// parallel: each library holds that mode's four instantiations.

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

#ifndef FF_SKETCH_PRECISION
#error "build with -DFF_SKETCH_PRECISION=0|1|2, the compute mode (kernels/_build.py)"
#endif

namespace {

using namespace ffk;

enum SketchMode { kHutchpp = 0, kXtrace = 1 };
// The compute modes, the templates' P (the wrapper's precision index).
enum Precision { kFloat32 = 0, kHighF32 = 1, kBFloat16 = 2 };
constexpr int kMaxNarrow = 8;  // largest D of the register algebra (MD 2, 4, 8)
constexpr int kMaxDim = 64;    // largest D the per-row algebra takes (the wide path)
// Blocks of kThreads an SM is to hold, by registers (the launch bounds): 80
// registers a thread, which every instantiation fits without spilling.
constexpr int kMinBlocks = 3;
// Rows a thread of a float32 layer product owns.  Eight would halve the
// B-operand reads a FMA, but its 32 accumulators do not fit the 80 registers
// a thread has at three blocks of kThreads an SM.
constexpr int kRowTile = kMinRowTile;
// m-tiles a warp of a bfloat16 layer product (dense_bf16) carries at once,
// 16 accumulators a thread: fused_mlp.cu's 4 (32 accumulators) spill at
// MD = 4 and 8 under the 80 registers a thread.
constexpr int kMTilesBF16 = 2;

// One row's view of an element-major shared tile: element e at p[e * R].
struct RowView {
  float* p;
  int R;
  __device__ __forceinline__ float& operator[](int e) const { return p[e * R]; }
};

// Column j of one probe's projection, sum_d v[d R] w_in[d H + j] over the D
// rows of w_in a probe meets (v element-major, stride R).  The narrow
// buckets unroll over MD, strict.  The wide path loops to the runtime D:
// strict up to kRank1Max rows, and past that as the JAX kernel's in_proj
// takes a probe (in_proj_rows with mm_tan): through the 3xTF32 split in
// highf32, on the bf16-rounded probe in bfloat16 (w_in holds bf16 values),
// strict in float32.
template <int MD, int P>
__device__ __forceinline__ float project_probe(const float* v, int R, const float* __restrict__ w_in, int j, int H,
                                               int D) {
  float s = 0.0f;
  if constexpr (MD <= kMaxNarrow) {
#pragma unroll
    for (int d = 0; d < MD; ++d) {
      if (d < D) s = fmaf(v[d * R], __ldg(w_in + d * H + j), s);
    }
  } else {
    if (P == kHighF32 && D > kRank1Max) {
      for (int d = 0; d < D; ++d) s = fma_tf32x3(v[d * R], __ldg(w_in + d * H + j), s);
    } else if (P == kBFloat16 && D > kRank1Max) {
      for (int d = 0; d < D; ++d) s = fmaf(round_bf16(v[d * R]), __ldg(w_in + d * H + j), s);
    } else {
      for (int d = 0; d < D; ++d) s = fmaf(v[d * R], __ldg(w_in + d * H + j), s);
    }
  }
  return s;
}

// A v for `k` columns of every row of the tile: chain c is seeded with
// probe-tile column off + c (D values) through w_in[:D] (project_probe),
// passes every layer without bias, multiplied by the stored act'.  Returns
// the buffer whose chain c, row r holds (J_net v)[0..D) at
// [c * R * H + r * H].  In highf32 every layer product takes the split.
// float32 and highf32 (bfloat16 has apply_jacobian_bf16).
template <int MD, int P>
__device__ float* apply_jacobian(const float* cols, int off, int k, const float* __restrict__ w_in,
                                 const float* dh, const HiddenLayers& hidden, int n_hidden,
                                 const float* __restrict__ w_out, float* buf0, float* buf1, int R,
                                 int H, int D) {
  const int rh = R * H;
  for (int i = threadIdx.x; i < k * rh; i += blockDim.x) {
    const int c = i / rh;
    const int r = (i - c * rh) / H;
    const int j = i - c * rh - r * H;
    const float* v = cols + (off + c) * D * R + r;  // element d at v[d * R]
    buf0[i] = project_probe<MD, P>(v, R, w_in, j, H, D);
  }
  __syncthreads();
  float* cur = buf0;
  float* nxt = buf1;
  for (int l = 0; l < n_hidden; ++l) {
    scale_by_act_grad(dh + l * rh, cur, k, rh);
    __syncthreads();
    if constexpr (P == kHighF32) {
      dense_tf32x3<4>(hidden.w[l], nullptr, cur, nxt, H, H, k * R, R, H);
    } else {
      dense<kRowTile, 4>(hidden.w[l], nullptr, cur, nxt, H, H, R, H, k);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  scale_by_act_grad(dh + n_hidden * rh, cur, k, rh);
  __syncthreads();
  if constexpr (P == kHighF32) {
    dense_split_fma(w_out, nullptr, cur, nxt, H, D, R, H, k);
  } else {
    dense<kRowTile, 1>(w_out, nullptr, cur, nxt, H, D, R, H, k);
  }
  __syncthreads();
  return nxt;
}

// bfloat16: act(a) of the forward chain's pre-activations a (R rows of
// stride S) rounded into the bf16 plane (stride S), act'(a) kept in dh (R x
// H, the act' store's layout), by the tanh-form pair.
__device__ __forceinline__ void activate_keep_bf16(int act, const float* a, float* dh, __nv_bfloat16* plane,
                                                   int R, int H, int S) {
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    const int r = i / H;
    const int j = i - r * H;
    float h, d;
    act_pair_highf32(act, a[r * S + j], h, d);
    plane[r * S + j] = __float2bfloat16_rn(h);
    dh[i] = d;
  }
}

// bfloat16: plane[m] = bf16(t[m] act') for the M = chains x R tangent rows
// (stride S), act' the stored layer dh (R x H): the activation layer of a
// Jacobian application and the rounding of the next product's operand in
// one pass.
__device__ __forceinline__ void scale_round_bf16(const float* dh, const float* t, __nv_bfloat16* plane, int M,
                                                 int R, int H, int S) {
  for (int i = threadIdx.x; i < M * H; i += blockDim.x) {
    const int m = i / H;
    const int j = i - m * H;
    const int r = m % R;
    plane[m * S + j] = __float2bfloat16_rn(__fmul_rn(t[m * S + j], dh[r * H + j]));
  }
}

// bfloat16: apply_jacobian on the bf16 tensor cores.  Chain c is seeded with
// probe-tile column off + c through w_in[:D] (bf16 values in fp32:
// project_probe) and multiplied by the stored act' in the same
// pass, rounded into the plane; each hidden layer is one (k R) x H
// dense_bf16 product, no bias, into the fp32 buffer `buf`, then the next
// act' and the rounding back into the plane; the output layer
// dense_out_bf16.  Returns the compact (k R, D) tile of J_net v: chain c,
// row r at [(c R + r) D].  buf and the plane have rows of stride S.
template <int MD>
__device__ float* apply_jacobian_bf16(const float* cols, int off, int k, const float* __restrict__ w_in,
                                      const float* dh, const HiddenLayers& hidden, int n_hidden,
                                      const float* __restrict__ w_out, float* buf, __nv_bfloat16* plane, int R,
                                      int H, int D, int S) {
  const int rh = R * H;
  for (int i = threadIdx.x; i < k * rh; i += blockDim.x) {
    const int m = i / H;  // row of the k x R stack
    const int j = i - m * H;
    const int c = m / R;
    const int r = m - c * R;
    const float* v = cols + (off + c) * D * R + r;  // element d at v[d * R]
    const float s = project_probe<MD, kBFloat16>(v, R, w_in, j, H, D);
    plane[m * S + j] = __float2bfloat16_rn(__fmul_rn(s, dh[r * H + j]));
  }
  __syncthreads();
  for (int l = 0; l < n_hidden; ++l) {
    dense_bf16<kMTilesBF16>(reinterpret_cast<const __nv_bfloat16*>(hidden.w[l]), nullptr, plane, buf, H, H, k * R,
                            R, S);
    __syncthreads();
    scale_round_bf16(dh + (l + 1) * rh, buf, plane, k * R, R, H, S);
    __syncthreads();
  }
  dense_out_bf16(reinterpret_cast<const __nv_bfloat16*>(w_out), nullptr, plane, buf, H, D, k * R, R, S);
  __syncthreads();
  return buf;
}

// ---------------------------------------------------------------------------
// The per-row algebra: MD-vectors in registers, matrices in the row's views.

template <int MD>
__device__ __forceinline__ void load_col(RowView t, int off, int D, float (&v)[MD]) {
#pragma unroll
  for (int d = 0; d < MD; ++d) v[d] = d < D ? t[off + d] : 0.0f;
}

template <int MD>
__device__ __forceinline__ void store_col(RowView t, int off, int D, const float (&v)[MD]) {
#pragma unroll
  for (int d = 0; d < MD; ++d) {
    if (d < D) t[off + d] = v[d];
  }
}

template <int MD>
__device__ __forceinline__ float dot(const float (&a)[MD], const float (&b)[MD], int D) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < MD; ++d) {
    if (d < D) s += a[d] * b[d];
  }
  return s;
}

// The canonical vector e_c with the updates v -= (v . q_i) q_i of the
// columns i < j of y applied in order: its residual after j MGS steps, as
// the first version kept it incrementally.
template <int MD>
__device__ void canonical_residual(RowView y, int c, int j, int D, float (&res)[MD]) {
#pragma unroll
  for (int d = 0; d < MD; ++d) res[d] = c == d ? 1.0f : 0.0f;
  for (int i = 0; i < j; ++i) {
    float qi[MD];
    load_col(y, i * D, D, qi);
    const float proj = dot(res, qi, D);
#pragma unroll
    for (int d = 0; d < MD; ++d) {
      if (d < D) res[d] -= proj * qi[d];
    }
  }
}

// Thin MGS QR, in place, of the k columns of y (column c at y[c D + d],
// k <= D <= MD): Q replaces them, R goes to rr (rr[i k + j]; not kept when
// rr.p is null), with basis completion for degenerate columns.
template <int MD>
__device__ void qr_cols(RowView y, int k, int D, RowView rr) {
  float ss = 0.0f;
  for (int c = 0; c < k; ++c) {
    float v[MD];
    load_col(y, c * D, D, v);
    ss += dot(v, v, D);
  }
  const float floor = fmaxf(sqrtf(ss) * 1e-6f, 1e-30f);
  const bool keep = rr.p != nullptr;
  for (int i = 0; i < k && keep; ++i)
    for (int j = 0; j < k; ++j) rr[i * k + j] = 0.0f;
  for (int j = 0; j < k; ++j) {
    float v[MD];
    load_col(y, j * D, D, v);
    for (int i = 0; i < j; ++i) {
      float qi[MD];
      load_col(y, i * D, D, qi);
      const float r_ij = dot(qi, v, D);
      if (keep) rr[i * k + j] = r_ij;
#pragma unroll
      for (int d = 0; d < MD; ++d) {
        if (d < D) v[d] -= r_ij * qi[d];
      }
    }
    const float r_jj = sqrtf(dot(v, v, D));
    if (keep) rr[j * k + j] = r_jj;
    float q[MD];
    if (r_jj < floor) {
      // the canonical vector with the largest residual (first among equals)
      float best_norm = -1.0f;
      float best[MD];
#pragma unroll
      for (int d = 0; d < MD; ++d) best[d] = 0.0f;
      for (int c = 0; c < D; ++c) {
        float res[MD];
        canonical_residual(y, c, j, D, res);
        const float n = sqrtf(dot(res, res, D));
        if (n > best_norm) {
          best_norm = n;
#pragma unroll
          for (int d = 0; d < MD; ++d) best[d] = res[d];
        }
      }
      const float n = fmaxf(best_norm, 1e-30f);
#pragma unroll
      for (int d = 0; d < MD; ++d) q[d] = best[d] / n;
    } else {
      const float n = fmaxf(r_jj, floor);
#pragma unroll
      for (int d = 0; d < MD; ++d) q[d] = v[d] / n;
    }
    store_col(y, j * D, D, q);
  }
}

// ---------------------------------------------------------------------------
// The wide path's algebra (8 < D <= kMaxDim): every vector a column of the
// row's element-major tile, every loop to the runtime D, the sums in the
// order and multiply-add form of the register versions above.

// a[ao ..] . b[bo ..] over D elements.
__device__ __forceinline__ float dot_view(RowView a, int ao, RowView b, int bo, int D) {
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s += a[ao + d] * b[bo + d];
  return s;
}

// canonical_residual() written into column j of y: e_c with the updates of
// the columns i < j applied in order.
__device__ void canonical_residual_wide(RowView y, int c, int j, int D) {
  const int jo = j * D;
  for (int d = 0; d < D; ++d) y[jo + d] = c == d ? 1.0f : 0.0f;
  for (int i = 0; i < j; ++i) {
    const float proj = dot_view(y, jo, y, i * D, D);
    for (int d = 0; d < D; ++d) y[jo + d] -= proj * y[i * D + d];
  }
}

// qr_cols() in place on the tile: column j's MGS updates run in the column
// itself; a degenerate column is the scratch of basis completion, each
// canonical residual built there for its norm, the largest (first among
// equals) rebuilt there and normalized.
__device__ void qr_cols_wide(RowView y, int k, int D, RowView rr) {
  float ss = 0.0f;
  for (int c = 0; c < k; ++c) ss += dot_view(y, c * D, y, c * D, D);
  const float floor = fmaxf(sqrtf(ss) * 1e-6f, 1e-30f);
  const bool keep = rr.p != nullptr;
  for (int i = 0; i < k && keep; ++i)
    for (int j = 0; j < k; ++j) rr[i * k + j] = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int jo = j * D;
    for (int i = 0; i < j; ++i) {
      const float r_ij = dot_view(y, i * D, y, jo, D);
      if (keep) rr[i * k + j] = r_ij;
      for (int d = 0; d < D; ++d) y[jo + d] -= r_ij * y[i * D + d];
    }
    const float r_jj = sqrtf(dot_view(y, jo, y, jo, D));
    if (keep) rr[j * k + j] = r_jj;
    float n;
    if (r_jj < floor) {
      float best_norm = -1.0f;
      int best = 0;
      for (int c = 0; c < D; ++c) {
        canonical_residual_wide(y, c, j, D);
        const float nc = sqrtf(dot_view(y, jo, y, jo, D));
        if (nc > best_norm) {
          best_norm = nc;
          best = c;
        }
      }
      canonical_residual_wide(y, best, j, D);
      n = fmaxf(best_norm, 1e-30f);
    } else {
      n = fmaxf(r_jj, floor);
    }
    for (int d = 0; d < D; ++d) y[jo + d] = y[jo + d] / n;
  }
}

// Hutch++'s U = (I - Q Q^T) G in place over the n_g residual probes, which
// follow the n_s Q columns in the tile: each probe's projections on the Q
// columns first, into `coef`, then each element's updates in the order of
// the Q columns.
__device__ void project_out_wide(RowView t, int n_s, int n_g, int D, RowView coef) {
  for (int g = 0; g < n_g; ++g) {
    const int go = (n_s + g) * D;
    for (int i = 0; i < n_s; ++i) coef[i] = dot_view(t, i * D, t, go, D);
    for (int d = 0; d < D; ++d) {
      float u = t[go + d];
      for (int i = 0; i < n_s; ++i) u -= coef[i] * t[i * D + d];
      t[go + d] = u;
    }
  }
}

// inv(R) of the upper-triangular k x k rr, near-zero diagonals clamped.
template <int MD>
__device__ void tri_inv(RowView rr, int k, RowView inv) {
  float scale = 0.0f;
  for (int i = 0; i < k; ++i) scale = fmaxf(scale, fabsf(rr[i * k + i]));
  const float floor = fmaxf(scale * 1e-6f, 1e-30f);
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < k; ++j) inv[i * k + j] = 0.0f;
  for (int j = 0; j < k; ++j) {
    for (int i = j; i >= 0; --i) {
      float acc = i == j ? 1.0f : 0.0f;
      for (int l = i + 1; l <= j; ++l) acc -= rr[i * k + l] * inv[l * k + j];
      const float d = rr[i * k + i];
      const float safe = fabsf(d) < floor ? (d > 0.0f ? floor : (d < 0.0f ? -floor : floor)) : d;
      inv[i * k + j] = acc / safe;
    }
  }
}

template <int MD, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_sketch_kernel(const float* __restrict__ x, const float* __restrict__ probes,
                    const float* __restrict__ w_in, const float* __restrict__ b_eff,
                    HiddenLayers hidden, int n_hidden,
                    const float* __restrict__ w_out, const float* __restrict__ b_out,
                    const float* __restrict__ c0c1, float* __restrict__ drift,
                    float* __restrict__ div, int B, int d_in, int D, int H, int mode,
                    int act, int n_s, int n_g, int R) {
  extern __shared__ __align__(16) float smem[];
  const int n_in = n_s + n_g;                                // probe columns a row
  const int ncols = mode == kHutchpp ? n_in : 2 * n_s;       // + Q for xtrace
  const int kmax = mode == kHutchpp ? n_in : n_s;            // widest application
  // xtrace's matrices a row lie over storage that is free when they are
  // needed, where it holds them, else in the tail: R of the QR (m x m, from
  // the QR to the estimate) over the input tile, which the drift leaves
  // free; A Q (m x D; later S), inv(R) (later X) and the H, W, T grids
  // (m x m each) over the act' store, which the last application leaves free
  const int n_rr = mode == kHutchpp ? 0 : n_s * n_s;
  const int n_late = mode == kHutchpp ? 0 : 4 * n_s * n_s + n_s * D;
  const bool rr_in_xs = n_rr <= d_in;
  const bool late_in_dh = n_late <= (n_hidden + 1) * H;
  const int n_alg = (rr_in_xs ? 0 : n_rr) + (late_in_dh ? 0 : n_late);
  const int rh = R * H;
  // the chain buffers' row stride: H, or H + kPadBF16 in bfloat16, where
  // buf0 (the fp32 pre-activations) and the bf16 plane share it
  const int S = P == kBFloat16 ? H + kPadBF16 : H;
  float* dh = smem;                            // (n_hidden + 1, R, H) act'
  float* buf0 = dh + (n_hidden + 1) * rh;      // (kmax, R, S)
  float* buf1 = buf0 + kmax * rh;              // (kmax, R, H): float32, highf32
  __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(buf0 + kmax * R * S);  // (kmax, R, S): bfloat16
  float* xs = P == kBFloat16 ? buf0 + kmax * R * S + kmax * R * S / 2 : buf1 + kmax * rh;  // (R, d_in)
  float* cols = xs + R * d_in;                 // (ncols, D, R) element-major
  float* tail = cols + ncols * D * R;          // (n_alg, R) element-major
  float* rr_at = rr_in_xs ? xs : tail;                   // (n_rr, R) element-major
  float* late = late_in_dh ? dh : tail + (rr_in_xs ? 0 : n_rr) * R;  // (n_late, R)
  const int row0 = blockIdx.x * R;

  // Rows past B compute on zeros (the floors keep them finite) and are not
  // stored.
  for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
    const int row = row0 + i / d_in;
    xs[i] = row < B ? x[(size_t)row0 * d_in + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < R * n_in * D; i += blockDim.x) {
    const int r = i / (n_in * D);
    const int e = i - r * n_in * D;  // column e / D, element e % D
    cols[e * R + r] = row0 + r < B ? probes[(size_t)row0 * n_in * D + i] : 0.0f;
  }
  __syncthreads();

  // Forward chain once, keeping act' of every activation layer.  In
  // bfloat16 w_in holds bf16 values and an input of more than kRank1Max
  // features is rounded, as the JAX kernel's in_proj_rows projects it
  // through its bf16 product.
  for (int i = threadIdx.x; i < rh; i += blockDim.x) {
    const int r = i / H;
    const int j = i - r * H;
    float v = 0.0f;
    if (P == kHighF32 && d_in > kRank1Max) {
      for (int k = 0; k < d_in; ++k) v = fma_tf32x3(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
    } else if (P == kBFloat16 && d_in > kRank1Max) {
      for (int k = 0; k < d_in; ++k) v = fmaf(round_bf16(xs[r * d_in + k]), __ldg(w_in + k * H + j), v);
    } else {
      for (int k = 0; k < d_in; ++k) v = fmaf(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
    }
    buf0[r * S + j] = v + __ldg(b_eff + j);
  }
  __syncthreads();
  // the net's output: float32 and highf32 at [r H + d] of nxt, bfloat16 in
  // a compact (R, D) tile over buf0; the Jacobian applications' columns
  // likewise (row stride js)
  const int js = P == kBFloat16 ? D : H;
  float* nxt = buf1;
  if constexpr (P == kBFloat16) {
    for (int l = 0; l < n_hidden; ++l) {
      activate_keep_bf16(act, buf0, dh + l * rh, plane, R, H, S);
      __syncthreads();
      dense_bf16<kMTilesBF16>(reinterpret_cast<const __nv_bfloat16*>(hidden.w[l]), hidden.b[l], plane, buf0, H, H,
                              R, R, S);
      __syncthreads();
    }
    activate_keep_bf16(act, buf0, dh + n_hidden * rh, plane, R, H, S);
    __syncthreads();
    dense_out_bf16(reinterpret_cast<const __nv_bfloat16*>(w_out), b_out, plane, buf0, H, D, R, R, S);
    nxt = buf0;
  } else {
    float* cur = buf0;
    for (int l = 0; l < n_hidden; ++l) {
      if constexpr (P == kHighF32) {
        activate_keep_highf32(act, cur, dh + l * rh, rh);
        __syncthreads();
        dense_tf32x3<4>(hidden.w[l], hidden.b[l], cur, nxt, H, H, R, R, H);
      } else {
        activate_keep(act, cur, dh + l * rh, rh);
        __syncthreads();
        dense<kRowTile, 4>(hidden.w[l], hidden.b[l], cur, nxt, H, H, R, H, 1);
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if constexpr (P == kHighF32) {
      activate_keep_highf32(act, cur, dh + n_hidden * rh, rh);
      __syncthreads();
      dense_split_fma(w_out, b_out, cur, nxt, H, D, R, H, 1);
    } else {
      activate_keep(act, cur, dh + n_hidden * rh, rh);
      __syncthreads();
      dense<kRowTile, 1>(w_out, b_out, cur, nxt, H, D, R, H, 1);
    }
  }
  __syncthreads();

  const float c0 = c0c1[0];
  const float c1 = c0c1[1];
  const int r = threadIdx.x;  // the row this thread's algebra serves
  const int row = row0 + r;
  if (r < R && row < B) {
    for (int d = 0; d < D; ++d)
      drift[(size_t)row * D + d] = c0 * xs[r * d_in + d] + c1 * nxt[r * js + d];
  }
  __syncthreads();  // the forward output buffer is reused below

  const RowView my{cols + r, R};  // this row's probe tile (r < R only)
  const RowView rr{n_rr > 0 ? rr_at + r : nullptr, R};  // R of the QR (xtrace)

  // First application: A S (hutchpp) or A O (xtrace); Y replaces the Q
  // columns of the tile (S, or the free half for xtrace), then the QR.
  const int qoff = mode == kHutchpp ? 0 : n_s * D;  // Q's columns in the tile
  // A v of k columns from the tile's column off: J_net v of chain c, row r
  // at jv[(c R + r) js]
  auto apply = [&](int off, int k) -> const float* {
    if constexpr (P == kBFloat16) {
      return apply_jacobian_bf16<MD>(cols, off, k, w_in, dh, hidden, n_hidden, w_out, buf0, plane, R, H, D, S);
    } else {
      return apply_jacobian<MD, P>(cols, off, k, w_in, dh, hidden, n_hidden, w_out, buf0, buf1, R, H, D);
    }
  };
  const float* jv = apply(0, n_s);
  if constexpr (MD > kMaxNarrow) {
    if (r < R) {
      for (int c = 0; c < n_s; ++c)
        for (int d = 0; d < D; ++d) my[qoff + c * D + d] = c0 * my[c * D + d] + c1 * jv[(c * R + r) * js + d];
      qr_cols_wide(RowView{cols + qoff * R + r, R}, n_s, D, rr);
      // the projections over the input tile, free since the drift
      if (mode == kHutchpp) project_out_wide(my, n_s, n_g, D, RowView{xs + r, R});
    }
  } else if (r < R) {
    for (int c = 0; c < n_s; ++c) {
      float y[MD];
#pragma unroll
      for (int d = 0; d < MD; ++d) {
        if (d < D) y[d] = c0 * my[c * D + d] + c1 * jv[(c * R + r) * js + d];
      }
      store_col(my, qoff + c * D, D, y);
    }
    const RowView q{cols + qoff * R + r, R};
    qr_cols<MD>(q, n_s, D, rr);
    if (mode == kHutchpp) {
      // U = (I - Q Q^T) G, over G in the tile
      for (int g = 0; g < n_g; ++g) {
        float gv[MD], u[MD];
        load_col(my, (n_s + g) * D, D, gv);
#pragma unroll
        for (int d = 0; d < MD; ++d) u[d] = gv[d];
        for (int i = 0; i < n_s; ++i) {
          float qi[MD];
          load_col(my, i * D, D, qi);
          const float a = dot(qi, gv, D);
#pragma unroll
          for (int d = 0; d < MD; ++d) {
            if (d < D) u[d] -= a * qi[d];
          }
        }
        store_col(my, (n_s + g) * D, D, u);
      }
    }
  }
  __syncthreads();

  if (mode == kHutchpp) {
    // A [Q | U] in one application
    jv = apply(0, n_in);
    if (r < R && row < B) {
      float trace_lr = 0.0f, trace_res = 0.0f;
      for (int c = 0; c < n_in; ++c) {
        const float* j = jv + (c * R + r) * js;
        float s = 0.0f;
        if constexpr (MD > kMaxNarrow) {
          for (int d = 0; d < D; ++d) {
            const float vd = my[c * D + d];
            s += vd * (c0 * vd + c1 * j[d]);
          }
        } else {
          float v[MD];
          load_col(my, c * D, D, v);
#pragma unroll
          for (int d = 0; d < MD; ++d) {
            if (d < D) s += v[d] * (c0 * v[d] + c1 * j[d]);
          }
        }
        if (c < n_s) trace_lr += s;
        else trace_res += s;
      }
      div[row] = trace_lr + trace_res / (float)n_g;
    }
    return;
  }

  // xtrace: A Q, then the leave-one-out algebra
  jv = apply(n_s, n_s);
  if (r < R && row < B) {
    const int m = n_s;
    const int m2 = m * m;
    const RowView aq{late + r, R};                       // A Q (m x D), later S
    const RowView inv{late + m * D * R + r, R};          // inv(R), later X
    const RowView Hm{late + (m2 + m * D) * R + r, R};
    const RowView W{late + (2 * m2 + m * D) * R + r, R};
    const RowView T{late + (3 * m2 + m * D) * R + r, R};
    const RowView& S = aq;
    const RowView& X = inv;
    if constexpr (MD > kMaxNarrow) {
      for (int c = 0; c < m; ++c)
        for (int d = 0; d < D; ++d) aq[c * D + d] = c0 * my[(m + c) * D + d] + c1 * jv[(c * R + r) * js + d];
      for (int i = 0; i < m; ++i) {
        for (int j = 0; j < m; ++j) {
          Hm[i * m + j] = dot_view(my, (m + i) * D, aq, j * D, D);
          W[i * m + j] = dot_view(my, (m + i) * D, my, j * D, D);
          T[i * m + j] = dot_view(aq, i * D, my, j * D, D);
        }
      }
    } else {
      for (int c = 0; c < m; ++c) {
        float v[MD];
#pragma unroll
        for (int d = 0; d < MD; ++d) {
          if (d < D) v[d] = c0 * my[(m + c) * D + d] + c1 * jv[(c * R + r) * js + d];
        }
        store_col(aq, c * D, D, v);
      }
      for (int i = 0; i < m; ++i) {
        float qi[MD], ai[MD];
        load_col(my, (m + i) * D, D, qi);
        load_col(aq, i * D, D, ai);
        for (int j = 0; j < m; ++j) {
          float aj[MD], oj[MD];
          load_col(aq, j * D, D, aj);
          load_col(my, j * D, D, oj);
          Hm[i * m + j] = dot(qi, aj, D);
          W[i * m + j] = dot(qi, oj, D);
          T[i * m + j] = dot(ai, oj, D);
        }
      }
    }
    tri_inv<MD>(rr, m, inv);
    for (int i = 0; i < m; ++i) {
      float n = 0.0f;
      for (int j = 0; j < m; ++j) n += inv[i * m + j] * inv[i * m + j];
      n = fmaxf(sqrtf(n), 1e-30f);
      for (int j = 0; j < m; ++j) S[j * m + i] = inv[i * m + j] / n;  // S = normalized inv(R)^T
    }
    float trace_H = 0.0f;
    for (int i = 0; i < m; ++i) trace_H += Hm[i * m + i];
    for (int j = 0; j < m; ++j) {
      float csum = 0.0f;
      for (int i = 0; i < m; ++i) csum += S[i * m + j] * W[i * m + j];
      for (int i = 0; i < m; ++i) X[i * m + j] = W[i * m + j] - csum * S[i * m + j];
    }
    float est = 0.0f;
    for (int j = 0; j < m; ++j) {
      float shs = 0.0f, xhx = 0.0f, ws = 0.0f, sr = 0.0f, tx = 0.0f;
      for (int i = 0; i < m; ++i) {
        float hs = 0.0f, hx = 0.0f;
        for (int l = 0; l < m; ++l) {
          hs += Hm[i * m + l] * S[l * m + j];
          hx += Hm[i * m + l] * X[l * m + j];
        }
        shs += S[i * m + j] * hs;
        xhx += X[i * m + j] * hx;
        ws += W[i * m + j] * S[i * m + j];
        sr += S[i * m + j] * rr[i * m + j];
        tx += T[i * m + j] * X[i * m + j];
      }
      est += trace_H - shs + ws * sr - tx + xhx;
    }
    div[row] = est / (float)m;
  }
}

template <int MD, int P>
cudaError_t prepare(size_t smem) {
  return allow_smem(fused_sketch_kernel<MD, P>, smem);
}

template <int MD, int P>
cudaError_t launch(const float* x, const float* probes, const float* w_in, const float* b_eff,
                   const HiddenLayers& hidden, int n_hidden, const float* w_out,
                   const float* b_out, const float* c0c1, float* drift, float* div, int B,
                   int d_in, int D, int H, int mode, int act, int n_s, int n_g, int rows,
                   size_t smem, cudaStream_t stream) {
  const cudaError_t st = prepare<MD, P>(smem);
  if (st != cudaSuccess) return st;
  const int grid = (B + rows - 1) / rows;
  fused_sketch_kernel<MD, P><<<grid, kThreads, smem, stream>>>(
      x, probes, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in, D, H,
      mode, act, n_s, n_g, rows);
  return cudaGetLastError();
}

// Resident blocks an SM of the instantiation (md, precision) at `smem`
// bytes, and its registers and local memory a thread.
template <int MD, int P>
cudaError_t query(size_t smem, int* blocks, int* regs, int* local_bytes) {
  cudaError_t st = prepare<MD, P>(smem);
  if (st != cudaSuccess) return st;
  st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fused_sketch_kernel<MD, P>, kThreads,
                                                     smem);
  if (st != cudaSuccess) return st;
  cudaFuncAttributes attr;
  st = cudaFuncGetAttributes(&attr, fused_sketch_kernel<MD, P>);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return st;
}

// The algebra's buckets: MD 2, 4 and 8 in registers, kMaxDim the wide path.
bool valid_md(int md) { return md == 2 || md == 4 || md == kMaxNarrow || md == kMaxDim; }

// This library's compute mode.
constexpr int kPrecision = FF_SKETCH_PRECISION;

// Index of an instantiation in the tables below: the md bucket.
int instance(int md) { return md == 2 ? 0 : md == 4 ? 1 : md == kMaxNarrow ? 2 : 3; }

using LaunchFn = cudaError_t (*)(const float*, const float*, const float*, const float*,
                                 const HiddenLayers&, int, const float*, const float*, const float*,
                                 float*, float*, int, int, int, int, int, int, int, int, int, size_t,
                                 cudaStream_t);
using QueryFn = cudaError_t (*)(size_t, int*, int*, int*);

constexpr LaunchFn kLaunch[4] = {launch<2, kPrecision>, launch<4, kPrecision>, launch<kMaxNarrow, kPrecision>,
                                  launch<kMaxDim, kPrecision>};
constexpr QueryFn kQuery[4] = {query<2, kPrecision>, query<4, kPrecision>, query<kMaxNarrow, kPrecision>,
                                query<kMaxDim, kPrecision>};

}  // namespace

extern "C" {

// The per-row algebra's largest D (the wrapper checks it too).
int ff_sketch_max_dim() { return kMaxDim; }

// The blocks of kThreads an SM is to hold by the launch bounds: the wrapper
// plans with it.
int ff_sketch_min_blocks() { return kMinBlocks; }

// The compute mode this library was built for (0 float32, 1 highf32, 2
// bfloat16): the wrapper loads one library a mode.
int ff_sketch_precision() { return kPrecision; }

// Launch on `stream`; returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue where `precision` is not this library's.
// probes: (B, n_s + n_g, D), the r sketch then the m residual probes of a row
// (hutchpp, n_g >= 1, n_s <= D), or its m probes (xtrace, 1 <= n_s <= D,
// n_g = 0).  w_hidden/b_hidden are host arrays of n_hidden device pointers,
// each weight 16-byte aligned.  `precision` is the compute mode: 0 float32,
// 1 highf32, 2 bfloat16; in bfloat16 w_in holds bf16-rounded floats, each
// hidden weight is bf16 of shape (H_out, H_in) (transposed) and w_out bf16
// (H, D), as fused_mlp.cu takes them.  `md` the algebra's bucket (2, 4, 8
// or 64, the wide path; >= D), `rows` a multiple of 4 (at most kThreads), H of 4, of 8 in
// highf32, of 16 in bfloat16 (the Python wrapper checks all of them).
// `smem` is the block's shared memory in bytes, computed by the wrapper for
// the kernel's layout: (n_hidden + 1 + 2 kmax) x rows x H floats, or in
// bfloat16 (n_hidden + 1) x rows x H floats and kmax x rows x (H + 8) floats
// and as many bf16 values, then rows x (d_in + ncols D + n_alg) floats;
// kmax = n_s + n_g
// (hutchpp) or n_s (xtrace), ncols = n_s + n_g (hutchpp) or 2 n_s (xtrace),
// n_alg = 0 (hutchpp), or for xtrace n_s^2 where n_s^2 > d_in (else over
// the input tile) plus 4 n_s^2 + n_s D where that is > (n_hidden + 1) H
// (else over the act' store).
int ff_fused_sketch(const float* x, const float* probes, const float* w_in, const float* b_eff,
                    const float* const* w_hidden, const float* const* b_hidden, int n_hidden,
                    const float* w_out, const float* b_out, const float* c0c1, float* drift,
                    float* div, int B, int d_in, int D, int H, int mode, int act,
                    int precision, int n_s, int n_g, int md, int rows, size_t smem,
                    void* stream) {
  const bool counts_ok = mode == kHutchpp ? (n_g >= 1 && n_s >= 0 && n_s <= D)
                                          : (mode == kXtrace && n_g == 0 && n_s >= 1 && n_s <= D);
  if (n_hidden < 0 || n_hidden > kMaxHidden || rows % kMinRowTile != 0 || rows > kThreads ||
      H % 4 != 0 || B <= 0 || D < 1 || D > md || !valid_md(md) || !counts_ok ||
      precision != kPrecision || (precision == kHighF32 && H % 8 != 0) ||
      (precision == kBFloat16 && H % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  HiddenLayers hidden = {};
  for (int i = 0; i < n_hidden; ++i) {
    hidden.w[i] = w_hidden[i];
    hidden.b[i] = b_hidden[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)kLaunch[instance(md)](x, probes, w_in, b_eff, hidden, n_hidden, w_out,
                                               b_out, c0c1, drift, div, B, d_in, D, H, mode, act,
                                               n_s, n_g, rows, smem, st);
}

// Resident blocks an SM, registers and local-memory bytes a thread of the
// instantiation (md, precision) launched with `smem` bytes; returns the
// cudaError_t of the query.
int ff_sketch_occupancy(int md, int precision, size_t smem, int* blocks, int* regs,
                        int* local_bytes) {
  if (!valid_md(md) || precision != kPrecision) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)kQuery[instance(md)](smem, blocks, regs, local_bytes);
}

}  // extern "C"
