// Fused score-MLP drift, with the Hutchinson or exact divergence, for Hopper.
//
// Replaces flowfusion_tpu/kernels/fused_mlp.py::_kernel (the Pallas kernel,
// pallas_call at fused_mlp.py:935) in its modes forward, hutchinson and exact,
// compute mode float32: strict IEEE fp32 FMAs on the CUDA cores.  Build
// without --use_fast_math: sigmoid goes through expf and gelu through erff,
// matching the plain PyTorch path's transcendentals.
//
// What it computes, for a batch-global scalar time folded into b_eff by the
// caller (b_eff = b1 + temb(t) W1[:E]):
//   a    = x_in w_in + b_eff,  then per hidden layer  a = act(a) W_l + b_l
//   net  = act(a) w_out + b_out,          drift = c0 x[:, :D] + c1 net
//   hutchinson: one tangent chain seeded with e w_in[:D],
//               div = c0 |e|^2 + c1 e . (J_net e)
//   exact:      D tangent chains seeded with rows 0..D-1 of w_in,
//               div = c0 D + c1 sum_d (J_net e_d)_d
// Each tangent chain passes the same linear layers (no bias) and is
// multiplied by act'(a) at every activation.
//
// What bounds it on this card: fp32 FMA throughput.  Per row it does
// 2 H (D_in + (n_hidden - 1) H + D) (1 + n_applies) flops (n_applies = 0, 1
// or D; fused_mlp.py:922-934), ~133k for the flagship model's hutchinson
// mode, against B (2 D + 1) 4 bytes of input and output: over 6,000 flops a
// byte, far above the ~20 flops a byte at which fp32 FMAs and HBM balance.
//
// What the design does about it: a block owns a tile of R rows and keeps the
// whole layer chain of that tile — the activations and every tangent chain —
// in shared memory, so nothing but x, e, drift and div touches device memory
// and each weight read from L2 feeds R rows times all chains.  In a layer
// product a thread computes an 8-row by 4-column tile of one chain's next
// layer (4 rows for plans that fit only at 4 rows a block): per 4 steps of k
// it reads one float4 of activations per row from shared memory (a
// broadcast: the warp shares its rows) and one float4 of weights per k from
// global memory (coalesced across the warp), 12 loads for 128 FMAs, so the
// product is bound by FMA issue rather than loads.  R (64 down to 4) is
// picked by the caller so that the double buffer of 2 x chains x R x H
// floats fits shared memory, two blocks to an SM where it can.  Tensor cores
// (wgmma, 3xTF32) and a persistent schedule are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 16;  // (H, H) layers between input and output
constexpr int kThreads = 256;
// Rows per thread in a layer product: 8 when the block's row count allows,
// else 4 (the smallest tile, for plans that fit only at 4 rows a block).
constexpr int kMinRowTile = 4;

enum Mode { kForward = 0, kHutchinson = 1, kExact = 2 };
enum Act { kSilu = 0, kTanh = 1, kRelu = 2, kGelu = 3 };

struct HiddenLayers {
  const float* w[kMaxHidden];  // (H, H), row-major (in, out)
  const float* b[kMaxHidden];  // (H,)
};

__device__ __forceinline__ void act_pair(int act, float a, float& h, float& dh) {
  switch (act) {
    case kSilu: {
      const float s = 1.0f / (1.0f + expf(-a));
      h = a * s;
      dh = s * (1.0f + a * (1.0f - s));
      break;
    }
    case kTanh: {
      const float th = tanhf(a);
      h = th;
      dh = 1.0f - th * th;
      break;
    }
    case kRelu: {
      const float m = a > 0.0f ? 1.0f : 0.0f;
      h = a * m;
      dh = m;
      break;
    }
    default: {  // gelu, exact erf form: a Phi(a), Phi(a) + a phi(a)
      const float cdf = 0.5f * (1.0f + erff(a * 0.7071067811865476f));
      const float pdf = 0.3989422804014327f * expf(-0.5f * a * a);
      h = a * cdf;
      dh = cdf + a * pdf;
    }
  }
}

// cur[0] <- act(cur[0]); cur[c] *= act'(cur[0]) for every tangent chain.
__device__ void activate(int act, float* cur, int chains, int rh) {
  for (int i = threadIdx.x; i < rh; i += blockDim.x) {
    float h, dh;
    act_pair(act, cur[i], h, dh);
    cur[i] = h;
    for (int c = 1; c < chains; ++c) cur[c * rh + i] *= dh;
  }
}

// nxt[c] = cur[c] @ w (+ bias for the primal chain c = 0), for every chain.
// cur and nxt hold chains x R rows of row stride H.  A thread owns an RT-row
// by CT-column tile: per 4 k it reads RT float4 activations from shared
// memory (one address per warp: a broadcast) and 4 weight rows of CT
// columns from global memory (CT = 4: one float4, coalesced across the
// warp), for 4 RT CT FMAs.  K is a multiple of 4, R of RT and N of CT; with
// CT = 4 the weights must be 16-byte aligned.
template <int RT, int CT>
__device__ void dense(const float* __restrict__ w, const float* __restrict__ bias,
                      const float* cur, float* nxt, int K, int N, int R, int H,
                      int chains) {
  const int col_groups = N / CT;
  const int row_groups = R / RT;
  const int items = chains * row_groups * col_groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it % col_groups;
    const int rest = it / col_groups;
    const int rg = rest % row_groups;
    const int c = rest / row_groups;
    const int j0 = cg * CT;
    const float* in = cur + (size_t)(c * R + rg * RT) * H;
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < K; k += 4) {
      float4 hv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        hv[i] = *reinterpret_cast<const float4*>(in + i * H + k);
      float wv[4][CT];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wrow = w + (size_t)(k + kk) * N + j0;
        if constexpr (CT == 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(wrow));
          wv[kk][0] = v.x;
          wv[kk][1] = v.y;
          wv[kk][2] = v.z;
          wv[kk][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < CT; ++j) wv[kk][j] = __ldg(wrow + j);
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          acc[i][j] = fmaf(hv[i].x, wv[0][j], acc[i][j]);
          acc[i][j] = fmaf(hv[i].y, wv[1][j], acc[i][j]);
          acc[i][j] = fmaf(hv[i].z, wv[2][j], acc[i][j]);
          acc[i][j] = fmaf(hv[i].w, wv[3][j], acc[i][j]);
        }
    }
    float* out = nxt + (size_t)(c * R + rg * RT) * H + j0;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float b = c == 0 ? __ldg(bias + j0 + j) : 0.0f;
#pragma unroll
      for (int i = 0; i < RT; ++i) out[i * H + j] = acc[i][j] + b;
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ e,
                 const float* __restrict__ w_in, const float* __restrict__ b_eff,
                 HiddenLayers hidden, int n_hidden,
                 const float* __restrict__ w_out, const float* __restrict__ b_out,
                 const float* __restrict__ c0c1, float* __restrict__ drift,
                 float* __restrict__ div, int B, int d_in, int d_out, int H,
                 int mode, int act, int R) {
  extern __shared__ __align__(16) float smem[];
  const int chains = mode == kForward ? 1 : (mode == kHutchinson ? 2 : 1 + d_out);
  const int rh = R * H;
  float* cur = smem;
  float* nxt = smem + chains * rh;
  float* xs = smem + 2 * chains * rh;  // (R, d_in) input tile
  float* es = xs + R * d_in;           // (R, d_out) probe tile
  const int row0 = blockIdx.x * R;

  // Rows past B (the ragged last tile) compute on zeros and are not stored.
  for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
    const int row = row0 + i / d_in;
    xs[i] = row < B ? x[(size_t)row0 * d_in + i] : 0.0f;
  }
  if (mode == kHutchinson) {
    for (int i = threadIdx.x; i < R * d_out; i += blockDim.x) {
      const int row = row0 + i / d_out;
      es[i] = row < B ? e[(size_t)row0 * d_out + i] : 0.0f;
    }
  }
  __syncthreads();

  // Input layer: the primal chain projects [x | cond]; a Hutchinson probe
  // has no conditional components and projects through rows 0..D-1 only;
  // the exact basis tangent e_d projects to row d of w_in.
  for (int i = threadIdx.x; i < chains * rh; i += blockDim.x) {
    const int c = i / rh;
    const int r = (i - c * rh) / H;
    const int j = i - c * rh - r * H;
    float v = 0.0f;
    if (c == 0) {
      for (int k = 0; k < d_in; ++k) v = fmaf(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
      v += __ldg(b_eff + j);
    } else if (mode == kHutchinson) {
      for (int k = 0; k < d_out; ++k) v = fmaf(es[r * d_out + k], __ldg(w_in + k * H + j), v);
    } else {
      v = __ldg(w_in + (c - 1) * H + j);
    }
    cur[i] = v;
  }
  __syncthreads();

  for (int l = 0; l < n_hidden; ++l) {
    activate(act, cur, chains, rh);
    __syncthreads();
    dense<RT, 4>(hidden.w[l], hidden.b[l], cur, nxt, H, H, R, H, chains);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  activate(act, cur, chains, rh);
  __syncthreads();
  dense<RT, 1>(w_out, b_out, cur, nxt, H, d_out, R, H, chains);
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
    }
  }
}

template <int RT>
cudaError_t launch(const float* x, const float* e, const float* w_in, const float* b_eff,
                   const HiddenLayers& hidden, int n_hidden, const float* w_out,
                   const float* b_out, const float* c0c1, float* drift, float* div, int B,
                   int d_in, int d_out, int H, int mode, int act, int rows, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        fused_mlp_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return st;
  }
  const int grid = (B + rows - 1) / rows;
  fused_mlp_kernel<RT><<<grid, kThreads, smem, stream>>>(
      x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in,
      d_out, H, mode, act, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// w_hidden/b_hidden are host arrays of n_hidden device pointers, each weight
// 16-byte aligned.  `rows` must be a multiple of 4 and H of 4 (the Python
// wrapper checks all three).  `smem` is the block's shared memory in bytes,
// computed by the wrapper for the layout the kernel uses: 2 x chains x rows
// x H floats, then rows x (d_in + d_out) floats.
int ff_fused_mlp(const float* x, const float* e, const float* w_in, const float* b_eff,
                 const float* const* w_hidden, const float* const* b_hidden, int n_hidden,
                 const float* w_out, const float* b_out, const float* c0c1,
                 float* drift, float* div, int B, int d_in, int d_out, int H, int mode,
                 int act, int rows, size_t smem, void* stream) {
  if (n_hidden < 0 || n_hidden > kMaxHidden || rows % kMinRowTile != 0 || H % 4 != 0 ||
      B <= 0 || mode < kForward || mode > kExact) {
    return (int)cudaErrorInvalidValue;
  }
  HiddenLayers hidden = {};
  for (int i = 0; i < n_hidden; ++i) {
    hidden.w[i] = w_hidden[i];
    hidden.b[i] = b_hidden[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows % 8 == 0) {
    return (int)launch<8>(x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div,
                          B, d_in, d_out, H, mode, act, rows, smem, st);
  }
  return (int)launch<kMinRowTile>(x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1,
                                  drift, div, B, d_in, d_out, H, mode, act, rows, smem, st);
}

}  // extern "C"
