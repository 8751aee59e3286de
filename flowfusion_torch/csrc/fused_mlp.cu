// Fused score-MLP drift or flow velocity, with the Hutchinson or exact
// divergence, for Hopper.
//
// Replaces flowfusion_tpu/kernels/fused_mlp.py::_kernel (the Pallas kernel,
// pallas_call at fused_mlp.py:935) in its modes forward, hutchinson, exact and
// tangents, reached through fused_drift (fused_mlp.py:951), fused_velocity
// (fused_mlp.py:1353, (c0, c1) = (0, 1)), fused_drift_tangents and
// fused_velocity_tangents (fused_mlp.py:1020, 1148) and, two forward launches
// a call, fused_symplectic_velocity (fused_mlp.py:1182), in two compute modes:
//   float32  strict IEEE fp32 FMAs on the CUDA cores;
//   highf32  the JAX kernel's 3-pass split products (bf16_3pass_dot_general,
//            fused_mlp.py:214-233, selected at :541-560) and its tanh-form
//            SiLU (:257-279, selected at :596-599), here as 3xTF32: every
//            hidden (H, H) product on the tensor cores (mlp_tile.cuh
//            dense_tf32x3, mma.sync m16n8k8), the (H, D) output product and
//            an input projection of more than 16 features (the JAX kernel's
//            rank-1 crossover, in_proj_rows :313-330) through the split in
//            FMAs; up to 16 input features and the time fold stay strict.
// Build without --use_fast_math: sigmoid goes through expf (tanhf in
// highf32) and gelu through erff, matching the plain PyTorch path's
// transcendentals.
//
// What it computes, for a batch-global scalar time folded into b_eff by the
// caller (b_eff = b1 + temb(t) W1[:E]):
//   a    = x_in w_in + b_eff,  then per hidden layer  a = act(a) W_l + b_l
//   net  = act(a) w_out + b_out,          drift = c0 x[:, :D] + c1 net
//   hutchinson: one tangent chain seeded with e w_in[:D],
//               div = c0 |e|^2 + c1 e . (J_net e)
//   exact:      D tangent chains seeded with rows 0..D-1 of w_in,
//               div = c0 D + c1 sum_d (J_net e_d)_d
//   tangents:   K tangent chains seeded with v_k w_in[:D] (K probes a row),
//               out_k = c0 v_k + c1 J_net v_k, K x D values a row
// Each tangent chain passes the same linear layers (no bias) and is
// multiplied by act'(a) at every activation.
//
// What bounds it on this card.  float32: fp32 FMA throughput.  Per row it
// does 2 H (D_in + (n_hidden - 1) H + D) (1 + n_applies) flops (n_applies =
// 0, 1 or D; fused_mlp.py:922-934), ~133k for the flagship model's
// hutchinson mode, against B (2 D + 1) 4 bytes of input and output: over
// 6,000 flops a byte, far above the ~20 flops a byte at which fp32 FMAs and
// HBM balance.  highf32: the hidden products' three TF32 passes on the
// tensor cores (495 TFLOP/s dense; 131,072 of the flagship's flops a row)
// plus the CUDA-core rest (the input projection, 3x the output layer).
// mma.sync does not reach the wgmma rate.
//
// What the design does about it: a block owns a tile of R rows and keeps the
// whole layer chain of that tile — the activations and every tangent chain —
// in shared memory, so nothing but x, e, drift and div touches device memory
// and each weight read from L2 feeds R rows times all chains.  In a float32
// layer product (mlp_tile.cuh, shared with em_sampler.cu) a thread computes
// an 8-row by 4-column tile of one chain's next layer (4 rows for plans that
// fit only at 4 rows a block): per 4 steps of k it reads one float4 of
// activations per row from shared memory (a broadcast: the warp shares its
// rows) and one float4 of weights per k from global memory (coalesced across
// the warp), 12 loads for 128 FMAs, so the product is bound by FMA issue
// rather than loads.  A highf32 hidden product is one (chains x R) by H
// product for all chains at once, a warp to a 16 x 32 strip (dense_tf32x3).
// R (64 down to 4) is picked by the caller so that the double buffer of
// 2 x chains x R x H floats fits shared memory, two blocks to an SM where it
// can.  wgmma, weights staged in shared memory, a padded stride and a
// persistent schedule are later work.

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace ffk;

enum Mode { kForward = 0, kHutchinson = 1, kExact = 2, kTangents = 3 };

// div: (B,) in modes hutchinson and exact; in mode tangents the (n_tan, B,
// d_out) columns J v_k.  e: (B, d_out) in mode hutchinson, (B, n_tan, d_out)
// in mode tangents.
template <int RT, bool HF>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ e,
                 const float* __restrict__ w_in, const float* __restrict__ b_eff,
                 HiddenLayers hidden, int n_hidden,
                 const float* __restrict__ w_out, const float* __restrict__ b_out,
                 const float* __restrict__ c0c1, float* __restrict__ drift,
                 float* __restrict__ div, int B, int d_in, int d_out, int H,
                 int mode, int act, int n_tan, int R) {
  extern __shared__ __align__(16) float smem[];
  const int chains = mode == kForward ? 1
                     : mode == kHutchinson ? 2
                     : mode == kExact ? 1 + d_out : 1 + n_tan;
  const int pw = mode == kTangents ? n_tan * d_out : d_out;  // probe values a row
  const int rh = R * H;
  float* cur = smem;
  float* nxt = smem + chains * rh;
  float* xs = smem + 2 * chains * rh;  // (R, d_in) input tile
  float* es = xs + R * d_in;           // (R, pw) probe tile
  const int row0 = blockIdx.x * R;

  // Rows past B (the ragged last tile) compute on zeros and are not stored.
  for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
    const int row = row0 + i / d_in;
    xs[i] = row < B ? x[(size_t)row0 * d_in + i] : 0.0f;
  }
  if (mode == kHutchinson || mode == kTangents) {
    for (int i = threadIdx.x; i < R * pw; i += blockDim.x) {
      const int row = row0 + i / pw;
      es[i] = row < B ? e[(size_t)row0 * pw + i] : 0.0f;
    }
  }
  __syncthreads();

  // Input layer: the primal chain projects [x | cond]; a probe (Hutchinson,
  // or tangent k) has no conditional components and projects through rows
  // 0..D-1 only; the exact basis tangent e_d projects to row d of w_in.
  for (int i = threadIdx.x; i < chains * rh; i += blockDim.x) {
    const int c = i / rh;
    const int r = (i - c * rh) / H;
    const int j = i - c * rh - r * H;
    float v = 0.0f;
    if (c == 0) {
      if (HF && d_in > kRank1Max) {
        for (int k = 0; k < d_in; ++k) v = fma_tf32x3(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
      } else {
        for (int k = 0; k < d_in; ++k) v = fmaf(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
      }
      v += __ldg(b_eff + j);
    } else if (mode == kHutchinson || mode == kTangents) {
      const float* p = es + r * pw + (c - 1) * d_out;  // c - 1 = 0 in hutchinson
      if (HF && d_out > kRank1Max) {
        for (int k = 0; k < d_out; ++k) v = fma_tf32x3(p[k], __ldg(w_in + k * H + j), v);
      } else {
        for (int k = 0; k < d_out; ++k) v = fmaf(p[k], __ldg(w_in + k * H + j), v);
      }
    } else {
      v = __ldg(w_in + (c - 1) * H + j);
    }
    cur[i] = v;
  }
  __syncthreads();

  for (int l = 0; l < n_hidden; ++l) {
    if constexpr (HF) {
      activate_highf32(act, cur, chains, rh);
      __syncthreads();
      dense_tf32x3<4>(hidden.w[l], hidden.b[l], cur, nxt, H, H, chains * R, R, H);
    } else {
      activate(act, cur, chains, rh);
      __syncthreads();
      dense<RT, 4>(hidden.w[l], hidden.b[l], cur, nxt, H, H, R, H, chains);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if constexpr (HF) {
    activate_highf32(act, cur, chains, rh);
    __syncthreads();
    dense_split_fma(w_out, b_out, cur, nxt, H, d_out, R, H, chains);
  } else {
    activate(act, cur, chains, rh);
    __syncthreads();
    dense<RT, 1>(w_out, b_out, cur, nxt, H, d_out, R, H, chains);
  }
  __syncthreads();

  const float c0 = c0c1[0];
  const float c1 = c0c1[1];
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int row = row0 + r;
    if (row >= B) break;
    const float* net = nxt + r * H;
    for (int d = 0; d < d_out; ++d)
      drift[(size_t)row * d_out + d] = c0 * xs[r * d_in + d] + c1 * net[d];
    if (mode == kHutchinson) {
      const float* je = nxt + rh + r * H;
      float acc = 0.0f, ee = 0.0f;
      for (int d = 0; d < d_out; ++d) {
        const float ed = es[r * d_out + d];
        acc += je[d] * ed;
        ee += ed * ed;
      }
      // e^T (c0 I + c1 J_net) e: the c0 term is c0 |e|^2, not c0 D
      div[row] = c0 * ee + c1 * acc;
    } else if (mode == kExact) {
      float acc = 0.0f;
      for (int d = 0; d < d_out; ++d) acc += nxt[(1 + d) * rh + r * H + d];
      div[row] = c0 * (float)d_out + c1 * acc;
    } else if (mode == kTangents) {
      for (int k = 0; k < n_tan; ++k) {
        const float* v = es + r * pw + k * d_out;
        const float* jv = nxt + (1 + k) * rh + r * H;
        float* out = div + ((size_t)k * B + row) * d_out;
        for (int d = 0; d < d_out; ++d) out[d] = c0 * v[d] + c1 * jv[d];
      }
    }
  }
}

template <int RT, bool HF>
cudaError_t launch(const float* x, const float* e, const float* w_in, const float* b_eff,
                   const HiddenLayers& hidden, int n_hidden, const float* w_out,
                   const float* b_out, const float* c0c1, float* drift, float* div, int B,
                   int d_in, int d_out, int H, int mode, int act, int n_tan, int rows,
                   size_t smem, cudaStream_t stream) {
  const cudaError_t st = allow_smem(fused_mlp_kernel<RT, HF>, smem);
  if (st != cudaSuccess) return st;
  const int grid = (B + rows - 1) / rows;
  fused_mlp_kernel<RT, HF><<<grid, kThreads, smem, stream>>>(
      x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in,
      d_out, H, mode, act, n_tan, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// w_hidden/b_hidden are host arrays of n_hidden device pointers, each weight
// 16-byte aligned.  `precision` is the compute mode: 0 float32, 1 highf32.
// `rows` must be a multiple of 4 and H of 4, of 8 in highf32 (the Python
// wrapper checks all of them).  `n_tan` is the probe count of mode tangents
// (ignored otherwise).  `smem` is the block's shared memory in bytes,
// computed by the wrapper for the layout the kernel uses: 2 x chains x rows
// x H floats, then rows x (d_in + d_out max(1, n_tan)) floats.
int ff_fused_mlp(const float* x, const float* e, const float* w_in, const float* b_eff,
                 const float* const* w_hidden, const float* const* b_hidden, int n_hidden,
                 const float* w_out, const float* b_out, const float* c0c1,
                 float* drift, float* div, int B, int d_in, int d_out, int H, int mode,
                 int act, int precision, int n_tan, int rows, size_t smem, void* stream) {
  if (n_hidden < 0 || n_hidden > kMaxHidden || rows % kMinRowTile != 0 || H % 4 != 0 ||
      B <= 0 || mode < kForward || mode > kTangents || (mode == kTangents && n_tan < 1) ||
      precision < 0 || precision > 1 || (precision == 1 && H % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  HiddenLayers hidden = {};
  for (int i = 0; i < n_hidden; ++i) {
    hidden.w[i] = w_hidden[i];
    hidden.b[i] = b_hidden[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel_launch) {
    return (int)kernel_launch(x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift,
                              div, B, d_in, d_out, H, mode, act, n_tan, rows, smem, st);
  };
  if (precision == 1) return rows % 8 == 0 ? go(launch<8, true>) : go(launch<kMinRowTile, true>);
  return rows % 8 == 0 ? go(launch<8, false>) : go(launch<kMinRowTile, false>);
}

}  // extern "C"
