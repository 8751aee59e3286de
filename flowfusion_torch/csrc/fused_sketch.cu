// The whole Hutch++ or XTrace right-hand side in one launch, for Hopper.
//
// Replaces the sketch modes of flowfusion_tpu/kernels/fused_mlp.py::_kernel
// (_sketch_chunk, fused_mlp.py:673-754, with _qr_lane :601 and _tri_inv_lane
// :649), reached through fused_drift_sketch (fused_mlp.py:1060) and
// fused_velocity_sketch (fused_mlp.py:1112), in two compute modes:
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
//            that; the probes' projection (D <= 8 rows) strict.
// In both modes the per-row QR, projections, inverse and leave-one-out
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
// (495 TFLOP/s dense; 393,216 of the flagship's flops a row at r = 2, m = 1)
// plus the CUDA-core rest (the projections, 3x the output layer);
// mma.sync does not reach the wgmma rate.
//
// What the design does about it: a block owns a tile of R rows.  The forward
// chain runs once and keeps act'(a) of every activation layer in shared
// memory (n_act x R x H floats); every Jacobian application seeds its tangent
// chains from the probe tile and multiplies them by the stored act' at each
// layer, with the register-tiled products of mlp_tile.cuh (float32) or one
// (k x R) by H tensor-core product for all k chains of the application
// (highf32; the chains lie contiguous at stride H), no bias, no recomputed
// forward, so a sketch RHS touches device memory only for x, the probes, the
// drift and div.  Between applications one thread per row runs the small
// D x k algebra (QR, projections, inverse, the estimate) on local arrays of
// at most kMaxDim x kMaxDim, and writes Q (and U) back into the row's probe
// tile, where the next application reads its seeds.  R is picked by the
// caller from the shared-memory plan (act' store + a double buffer of the
// widest application's chains + the tiles), the same in both modes.  Speed
// (more rows per thread, the algebra spread over a warp, wgmma) is later
// work.
// Build without --use_fast_math: sigmoid goes through expf (tanhf in
// highf32) and gelu through erff, matching the plain PyTorch path's
// transcendentals.

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace ffk;

enum SketchMode { kHutchpp = 0, kXtrace = 1 };
constexpr int kMaxDim = 8;  // largest D the per-row algebra takes

// A v for `k` columns of every row of the tile: chain c is seeded with
// cols[r][off + c] (D values) through w_in[:D], passes every layer without
// bias, multiplied by the stored act'.  Returns the buffer whose chain c,
// row r holds (J_net v)[0..D) at [c * R * H + r * H].  The probes project
// strictly in both modes (D <= kMaxDim <= kRank1Max rows of w_in); in highf32
// every layer product takes the split.
template <int RT, bool HF>
__device__ float* apply_jacobian(const float* cols, int ncols, int off, int k,
                                 const float* __restrict__ w_in, const float* dh,
                                 const HiddenLayers& hidden, int n_hidden,
                                 const float* __restrict__ w_out, float* buf0, float* buf1,
                                 int R, int H, int D) {
  const int rh = R * H;
  for (int i = threadIdx.x; i < k * rh; i += blockDim.x) {
    const int c = i / rh;
    const int r = (i - c * rh) / H;
    const int j = i - c * rh - r * H;
    const float* v = cols + (r * ncols + off + c) * D;
    float s = 0.0f;
    for (int d = 0; d < D; ++d) s = fmaf(v[d], __ldg(w_in + d * H + j), s);
    buf0[i] = s;
  }
  __syncthreads();
  float* cur = buf0;
  float* nxt = buf1;
  for (int l = 0; l < n_hidden; ++l) {
    scale_by_act_grad(dh + l * rh, cur, k, rh);
    __syncthreads();
    if constexpr (HF) {
      dense_tf32x3<4>(hidden.w[l], nullptr, cur, nxt, H, H, k * R, R, H);
    } else {
      dense_tangents<RT, 4>(hidden.w[l], cur, nxt, H, H, R, H, k);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  scale_by_act_grad(dh + n_hidden * rh, cur, k, rh);
  __syncthreads();
  if constexpr (HF) {
    dense_split_fma(w_out, nullptr, cur, nxt, H, D, R, H, k);
  } else {
    dense_tangents<RT, 1>(w_out, cur, nxt, H, D, R, H, k);
  }
  __syncthreads();
  return nxt;
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// Thin MGS QR of the k columns y[0..k) (each D values, k <= D <= kMaxDim),
// with basis completion for degenerate columns; the residuals of the
// canonical basis are kept incrementally, as on the host path.
__device__ void qr_cols(const float (&y)[kMaxDim][kMaxDim], int k, int D,
                        float (&q)[kMaxDim][kMaxDim], float (&rr)[kMaxDim][kMaxDim]) {
  float ss = 0.0f;
  for (int c = 0; c < k; ++c) ss += dot(y[c], y[c], D);
  const float floor = fmaxf(sqrtf(ss) * 1e-6f, 1e-30f);
  float res[kMaxDim][kMaxDim];
  for (int c = 0; c < D; ++c)
    for (int d = 0; d < D; ++d) res[c][d] = c == d ? 1.0f : 0.0f;
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < k; ++j) rr[i][j] = 0.0f;
  for (int j = 0; j < k; ++j) {
    float v[kMaxDim];
    for (int d = 0; d < D; ++d) v[d] = y[j][d];
    for (int i = 0; i < j; ++i) {
      const float r_ij = dot(q[i], v, D);
      rr[i][j] = r_ij;
      for (int d = 0; d < D; ++d) v[d] -= r_ij * q[i][d];
    }
    const float r_jj = sqrtf(dot(v, v, D));
    rr[j][j] = r_jj;
    int best = 0;
    float best_norm = -1.0f;
    for (int c = 0; c < D; ++c) {
      const float n = sqrtf(dot(res[c], res[c], D));
      if (n > best_norm) {  // strict: the first index among equals
        best_norm = n;
        best = c;
      }
    }
    if (r_jj < floor) {
      const float n = fmaxf(best_norm, 1e-30f);
      for (int d = 0; d < D; ++d) q[j][d] = res[best][d] / n;
    } else {
      const float n = fmaxf(r_jj, floor);
      for (int d = 0; d < D; ++d) q[j][d] = v[d] / n;
    }
    if (j + 1 < k) {
      for (int c = 0; c < D; ++c) {
        const float proj = dot(res[c], q[j], D);
        for (int d = 0; d < D; ++d) res[c][d] -= proj * q[j][d];
      }
    }
  }
}

// inv(R) of the upper-triangular k x k rr, near-zero diagonals clamped.
__device__ void tri_inv(const float (&rr)[kMaxDim][kMaxDim], int k,
                        float (&inv)[kMaxDim][kMaxDim]) {
  float scale = 0.0f;
  for (int i = 0; i < k; ++i) scale = fmaxf(scale, fabsf(rr[i][i]));
  const float floor = fmaxf(scale * 1e-6f, 1e-30f);
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < k; ++j) inv[i][j] = 0.0f;
  for (int j = 0; j < k; ++j) {
    for (int i = j; i >= 0; --i) {
      float acc = i == j ? 1.0f : 0.0f;
      for (int l = i + 1; l <= j; ++l) acc -= rr[i][l] * inv[l][j];
      const float d = rr[i][i];
      const float safe = fabsf(d) < floor ? (d > 0.0f ? floor : (d < 0.0f ? -floor : floor)) : d;
      inv[i][j] = acc / safe;
    }
  }
}

template <int RT, bool HF>
__global__ void __launch_bounds__(kThreads, 2)
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
  const int rh = R * H;
  float* dh = smem;                            // (n_hidden + 1, R, H) act'
  float* buf0 = dh + (n_hidden + 1) * rh;      // (kmax, R, H)
  float* buf1 = buf0 + kmax * rh;              // (kmax, R, H)
  float* xs = buf1 + kmax * rh;                // (R, d_in)
  float* cols = xs + R * d_in;                 // (R, ncols, D)
  const int row0 = blockIdx.x * R;

  // Rows past B compute on zeros (the floors keep them finite) and are not
  // stored.
  for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
    const int row = row0 + i / d_in;
    xs[i] = row < B ? x[(size_t)row0 * d_in + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < R * n_in * D; i += blockDim.x) {
    const int r = i / (n_in * D);
    const int rest = i - r * n_in * D;
    cols[r * ncols * D + rest] = row0 + r < B ? probes[(size_t)row0 * n_in * D + i] : 0.0f;
  }
  __syncthreads();

  // Forward chain once, keeping act' of every activation layer.
  for (int i = threadIdx.x; i < rh; i += blockDim.x) {
    const int r = i / H;
    const int j = i - r * H;
    float v = 0.0f;
    if (HF && d_in > kRank1Max) {
      for (int k = 0; k < d_in; ++k) v = fma_tf32x3(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
    } else {
      for (int k = 0; k < d_in; ++k) v = fmaf(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
    }
    buf0[i] = v + __ldg(b_eff + j);
  }
  __syncthreads();
  float* cur = buf0;
  float* nxt = buf1;
  for (int l = 0; l < n_hidden; ++l) {
    if constexpr (HF) {
      activate_keep_highf32(act, cur, dh + l * rh, rh);
      __syncthreads();
      dense_tf32x3<4>(hidden.w[l], hidden.b[l], cur, nxt, H, H, R, R, H);
    } else {
      activate_keep(act, cur, dh + l * rh, rh);
      __syncthreads();
      dense<RT, 4>(hidden.w[l], hidden.b[l], cur, nxt, H, H, R, H, 1);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if constexpr (HF) {
    activate_keep_highf32(act, cur, dh + n_hidden * rh, rh);
    __syncthreads();
    dense_split_fma(w_out, b_out, cur, nxt, H, D, R, H, 1);
  } else {
    activate_keep(act, cur, dh + n_hidden * rh, rh);
    __syncthreads();
    dense<RT, 1>(w_out, b_out, cur, nxt, H, D, R, H, 1);
  }
  __syncthreads();

  const float c0 = c0c1[0];
  const float c1 = c0c1[1];
  const int r = threadIdx.x;  // the row this thread's algebra serves
  const int row = row0 + r;
  if (r < R && row < B) {
    for (int d = 0; d < D; ++d)
      drift[(size_t)row * D + d] = c0 * xs[r * d_in + d] + c1 * nxt[r * H + d];
  }
  __syncthreads();  // the forward output buffer is reused below

  float q[kMaxDim][kMaxDim];
  float rr[kMaxDim][kMaxDim];
  float* my = cols + r * ncols * D;  // this row's probe tile (r < R only)

  // First application: A S (hutchpp) or A O (xtrace), then the QR.
  const float* jv = apply_jacobian<RT, HF>(cols, ncols, 0, n_s, w_in, dh, hidden, n_hidden,
                                       w_out, buf0, buf1, R, H, D);
  if (r < R) {
    float y[kMaxDim][kMaxDim];
    for (int c = 0; c < n_s; ++c)
      for (int d = 0; d < D; ++d) y[c][d] = c0 * my[c * D + d] + c1 * jv[c * rh + r * H + d];
    qr_cols(y, n_s, D, q, rr);
    if (mode == kHutchpp) {
      // U = (I - Q Q^T) G, over G in the tile, then Q over S
      for (int g = 0; g < n_g; ++g) {
        float* gv = my + (n_s + g) * D;
        float u[kMaxDim];
        for (int d = 0; d < D; ++d) u[d] = gv[d];
        for (int i = 0; i < n_s; ++i) {
          const float a = dot(q[i], gv, D);
          for (int d = 0; d < D; ++d) u[d] -= a * q[i][d];
        }
        for (int d = 0; d < D; ++d) gv[d] = u[d];
      }
      for (int c = 0; c < n_s; ++c)
        for (int d = 0; d < D; ++d) my[c * D + d] = q[c][d];
    } else {
      for (int c = 0; c < n_s; ++c)
        for (int d = 0; d < D; ++d) my[(n_s + c) * D + d] = q[c][d];
    }
  }
  __syncthreads();

  if (mode == kHutchpp) {
    // A [Q | U] in one application
    jv = apply_jacobian<RT, HF>(cols, ncols, 0, n_in, w_in, dh, hidden, n_hidden, w_out, buf0,
                            buf1, R, H, D);
    if (r < R && row < B) {
      float trace_lr = 0.0f, trace_res = 0.0f;
      for (int c = 0; c < n_in; ++c) {
        const float* v = my + c * D;
        const float* j = jv + c * rh + r * H;
        float s = 0.0f;
        for (int d = 0; d < D; ++d) s += v[d] * (c0 * v[d] + c1 * j[d]);
        if (c < n_s) trace_lr += s;
        else trace_res += s;
      }
      div[row] = trace_lr + trace_res / (float)n_g;
    }
    return;
  }

  // xtrace: A Q, then the leave-one-out algebra
  jv = apply_jacobian<RT, HF>(cols, ncols, n_s, n_s, w_in, dh, hidden, n_hidden, w_out, buf0, buf1,
                          R, H, D);
  if (r < R && row < B) {
    const int m = n_s;
    float aq[kMaxDim][kMaxDim];
    for (int c = 0; c < m; ++c)
      for (int d = 0; d < D; ++d) aq[c][d] = c0 * q[c][d] + c1 * jv[c * rh + r * H + d];
    float Hm[kMaxDim][kMaxDim], W[kMaxDim][kMaxDim], T[kMaxDim][kMaxDim];
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j) {
        Hm[i][j] = dot(q[i], aq[j], D);
        W[i][j] = dot(q[i], my + j * D, D);
        T[i][j] = dot(aq[i], my + j * D, D);
      }
    float S[kMaxDim][kMaxDim];
    {
      float inv[kMaxDim][kMaxDim];
      tri_inv(rr, m, inv);
      for (int i = 0; i < m; ++i) {
        float n = 0.0f;
        for (int j = 0; j < m; ++j) n += inv[i][j] * inv[i][j];
        n = fmaxf(sqrtf(n), 1e-30f);
        for (int j = 0; j < m; ++j) S[j][i] = inv[i][j] / n;  // S = normalized inv(R)^T
      }
    }
    float trace_H = 0.0f;
    for (int i = 0; i < m; ++i) trace_H += Hm[i][i];
    float X[kMaxDim][kMaxDim];
    for (int j = 0; j < m; ++j) {
      float csum = 0.0f;
      for (int i = 0; i < m; ++i) csum += S[i][j] * W[i][j];
      for (int i = 0; i < m; ++i) X[i][j] = W[i][j] - csum * S[i][j];
    }
    float est = 0.0f;
    for (int j = 0; j < m; ++j) {
      float shs = 0.0f, xhx = 0.0f, ws = 0.0f, sr = 0.0f, tx = 0.0f;
      for (int i = 0; i < m; ++i) {
        float hs = 0.0f, hx = 0.0f;
        for (int l = 0; l < m; ++l) {
          hs += Hm[i][l] * S[l][j];
          hx += Hm[i][l] * X[l][j];
        }
        shs += S[i][j] * hs;
        xhx += X[i][j] * hx;
        ws += W[i][j] * S[i][j];
        sr += S[i][j] * rr[i][j];
        tx += T[i][j] * X[i][j];
      }
      est += trace_H - shs + ws * sr - tx + xhx;
    }
    div[row] = est / (float)m;
  }
}

template <int RT, bool HF>
cudaError_t launch(const float* x, const float* probes, const float* w_in, const float* b_eff,
                   const HiddenLayers& hidden, int n_hidden, const float* w_out,
                   const float* b_out, const float* c0c1, float* drift, float* div, int B,
                   int d_in, int D, int H, int mode, int act, int n_s, int n_g, int rows,
                   size_t smem, cudaStream_t stream) {
  const cudaError_t st = allow_smem(fused_sketch_kernel<RT, HF>, smem);
  if (st != cudaSuccess) return st;
  const int grid = (B + rows - 1) / rows;
  fused_sketch_kernel<RT, HF><<<grid, kThreads, smem, stream>>>(
      x, probes, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in, D, H,
      mode, act, n_s, n_g, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The per-row algebra's largest D (the wrapper checks it too).
int ff_sketch_max_dim() { return kMaxDim; }

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// probes: (B, n_s + n_g, D), the r sketch then the m residual probes of a row
// (hutchpp, n_g >= 1, n_s <= D), or its m probes (xtrace, 1 <= n_s <= D,
// n_g = 0).  w_hidden/b_hidden are host arrays of n_hidden device pointers,
// each weight 16-byte aligned.  `precision` is the compute mode: 0 float32,
// 1 highf32.  `rows` a multiple of 4 (at most kThreads), H of 4, of 8 in
// highf32 (the Python wrapper checks all of them).  `smem` is the block's shared memory in bytes, computed by the
// wrapper for the kernel's layout: (n_hidden + 1 + 2 kmax) x rows x H floats,
// then rows x (d_in + ncols D) floats, kmax = n_s + n_g (hutchpp) or n_s
// (xtrace) and ncols = n_s + n_g (hutchpp) or 2 n_s (xtrace).
int ff_fused_sketch(const float* x, const float* probes, const float* w_in, const float* b_eff,
                    const float* const* w_hidden, const float* const* b_hidden, int n_hidden,
                    const float* w_out, const float* b_out, const float* c0c1, float* drift,
                    float* div, int B, int d_in, int D, int H, int mode, int act,
                    int precision, int n_s, int n_g, int rows, size_t smem, void* stream) {
  const bool counts_ok = mode == kHutchpp ? (n_g >= 1 && n_s >= 0 && n_s <= D)
                                          : (mode == kXtrace && n_g == 0 && n_s >= 1 && n_s <= D);
  if (n_hidden < 0 || n_hidden > kMaxHidden || rows % kMinRowTile != 0 || rows > kThreads ||
      H % 4 != 0 || B <= 0 || D < 1 || D > kMaxDim || !counts_ok || precision < 0 ||
      precision > 1 || (precision == 1 && H % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  HiddenLayers hidden = {};
  for (int i = 0; i < n_hidden; ++i) {
    hidden.w[i] = w_hidden[i];
    hidden.b[i] = b_hidden[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel_launch) {
    return (int)kernel_launch(x, probes, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift,
                              div, B, d_in, D, H, mode, act, n_s, n_g, rows, smem, st);
  };
  // highf32 has one instantiation: its products take no row tile
  if (precision == 1) return go(launch<kMinRowTile, true>);
  return rows % 8 == 0 ? go(launch<8, false>) : go(launch<kMinRowTile, false>);
}

}  // extern "C"
