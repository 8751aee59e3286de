// A whole training epoch of a score or velocity MLP in one launch, for Hopper.
//
// Replaces flowfusion_tpu/kernels/fused_train.py::_kernel (the Pallas kernel,
// pallas_call at fused_train.py:708), reached through fused_train_epoch
// (fused_train.py:751) and, one launch a stack, fused_train_epoch_symplectic
// (fused_train.py:466), compute mode float32: strict IEEE fp32 on the CUDA
// cores.  Build without --use_fast_math: sigmoid goes through expf, gelu
// through erff, the embedding through sinf/cosf, Adam through sqrtf and the
// bias corrections through expf/logf.
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
// What bounds it on this card: fp32 FMA throughput in principle, 3 x 2 H (K +
// (n_hidden - 1) H + D) flops a row a step (fused_train.py:705-717), 105 MFLOP a
// step for the flagship net at bs 512 (1.57 us at 67 TFLOP/s), against ~35k
// parameters of state.  In practice the serial chain of a step sets the time:
// its forward layer products, the backward's delta and weight-gradient
// products, two grid barriers and the Adam pass all depend on each other, and
// a bs 512 batch gives only bs / R row tiles to spread over the card.
//
// What the design does (a simple one that is right):
//   * one persistent cooperative launch for the whole call: the grid is no
//     larger than the card holds at once, and cooperative_groups' grid barrier
//     separates the two phases of every step;
//   * phase A, rows: blocks stride over row tiles of R rows (R from the port's
//     shared row policy, fused_mlp.rows_for); a block runs forward, loss and
//     backward of its tile in shared memory and writes its weight and bias
//     gradients into its own slot of a global [slots, n_param] buffer (a block
//     with several tiles adds them in tile order) and one loss partial — no
//     float atomics, so a launch's result does not depend on scheduling;
//   * phase B, parameters: the grid's threads stride over the parameters; each
//     sums the slots in order, then runs Adam and the EMA; block 0 sums the
//     loss partials in order into loss[s];
//   * parameters, moments and the EMA live in one flat buffer each (per layer:
//     the (K_l, N_l) weight, row-major, then the bias), padded so K, H and D are
//     multiples of 4; padded rows and columns get exactly zero gradient and stay
//     zero, and rows past bs in the last tile are masked (zero loss, zero
//     delta);
//   * parameters are rewritten inside the launch, so every read of them goes
//     through __ldcg (L2, coherent across SMs), never the read-only path.
// The layer products use an 8-row by 4-column register tile per thread (4 rows
// for plans that fit only at 4 rows a block), as mlp_tile.cuh::dense does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace ffk;
namespace cg = cooperative_groups;

constexpr float kTwoPi = 6.28318548f;  // float32(2 pi), as the plain version rounds it

struct TrainArgs {
  const float* xt;
  const float* zw;
  const float* t;
  const float* beta;
  const float* cond;  // null without conditionals
  const float* wemb;  // (E2,) Fourier weights; null for velocity nets
  float* p;
  float* m;
  float* v;
  float* ema;  // null without EMA
  float* partial;    // (n_slots, n_param)
  float* loss_part;  // (n_slots,)
  float* loss;       // (steps,)
  int steps, bs, D, C, E2, K, H, n_hidden, Dp, act, R, n_slots, step0, n_tiles, n_param;
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

// out[r] = in[r] @ w + b for R rows: (K, N) weight row-major, K and N
// multiples of 4.  A thread owns RT rows by 4 columns.
template <int RT>
__device__ void fwd_dense(const float* w, const float* b, const float* in, int in_stride, float* out,
                          int out_stride, int K, int N, int R) {
  const int col_groups = N / 4;
  const int items = (R / RT) * col_groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int j0 = (it % col_groups) * 4;
    const int r0 = (it / col_groups) * RT;
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < K; k += 4) {
      float4 hv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        hv[i] = *reinterpret_cast<const float4*>(in + (r0 + i) * in_stride + k);
      float wv[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(w + (size_t)(k + kk) * N + j0));
        wv[kk][0] = q.x;
        wv[kk][1] = q.y;
        wv[kk][2] = q.z;
        wv[kk][3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(hv[i].x, wv[0][j], acc[i][j]);
          acc[i][j] = fmaf(hv[i].y, wv[1][j], acc[i][j]);
          acc[i][j] = fmaf(hv[i].z, wv[2][j], acc[i][j]);
          acc[i][j] = fmaf(hv[i].w, wv[3][j], acc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = __ldcg(b + j0 + j);
#pragma unroll
      for (int i = 0; i < RT; ++i) out[(r0 + i) * out_stride + j0 + j] = acc[i][j] + bj;
    }
  }
}

// dh[r][k] <- dh[r][k] * sum_n delta[r][n] w[k][n] for R rows: the product by
// W^T of the backward, times the stored act'.  dh has row stride K.  A thread
// owns RT rows by 4 values of k.
template <int RT>
__device__ void bwd_dense(const float* w, const float* delta, int d_stride, float* dh, int K, int N,
                          int R) {
  const int k_groups = K / 4;
  const int items = (R / RT) * k_groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int k0 = (it % k_groups) * 4;
    const int r0 = (it / k_groups) * RT;
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int n = 0; n < N; n += 4) {
      float4 dv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        dv[i] = *reinterpret_cast<const float4*>(delta + (r0 + i) * d_stride + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(w + (size_t)(k0 + j) * N + n));
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          acc[i][j] = fmaf(dv[i].x, q.x, acc[i][j]);
          acc[i][j] = fmaf(dv[i].y, q.y, acc[i][j]);
          acc[i][j] = fmaf(dv[i].z, q.z, acc[i][j]);
          acc[i][j] = fmaf(dv[i].w, q.w, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* o = dh + (r0 + i) * K + k0 + j;
        *o = acc[i][j] * *o;
      }
  }
}

// The block's weight gradient dst[k][n] (=, or += after its first tile) of
// sum_r in[r][k] delta[r][n] over R rows; a thread owns 4 k by 4 n.
__device__ void grad_dense(const float* in, int in_stride, const float* delta, int d_stride, int K,
                           int N, int R, float* dst, bool first) {
  const int n_groups = N / 4;
  const int items = (K / 4) * n_groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int n0 = (it % n_groups) * 4;
    const int k0 = (it / n_groups) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(in + r * in_stride + k0);
      const float4 d = *reinterpret_cast<const float4*>(delta + r * d_stride + n0);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(xs[i], d.x, acc[i][0]);
        acc[i][1] = fmaf(xs[i], d.y, acc[i][1]);
        acc[i][2] = fmaf(xs[i], d.z, acc[i][2]);
        acc[i][3] = fmaf(xs[i], d.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* o = reinterpret_cast<float4*>(dst + (size_t)(k0 + i) * N + n0);
      float4 val = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (!first) {
        const float4 old = *o;
        val = make_float4(old.x + val.x, old.y + val.y, old.z + val.z, old.w + val.w);
      }
      *o = val;
    }
  }
}

// The block's bias gradient dst[n] (=, or +=) of sum_r delta[r][n].
__device__ void bias_grad(const float* delta, int d_stride, int N, int R, float* dst, bool first) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s += delta[r * d_stride + n];
    dst[n] = first ? s : dst[n] + s;
  }
}

// Phase A for one row tile of step s: forward, loss partial, backward into
// the block's gradient slot.
template <int RT>
__device__ void row_tile(const TrainArgs& a, int s, int tile, int slot, bool first, float* smem) {
  const int R = a.R, K = a.K, H = a.H, Dp = a.Dp, L = a.n_hidden;
  const int rh = R * H;
  float* u = smem;            // R x K: the input features
  float* hs = u + R * K;      // L buffers of R x H: act(a_l), the input of layer l + 1
  float* dhs = hs + L * rh;   // L buffers: act'(a_l), then the backward's deltas
  float* dout = dhs + L * rh; // R x Dp: net, then dL/dnet
  float* red = dout + R * Dp; // blockDim.x: the loss reduction
  const int row0 = tile * R;

  for (int i = threadIdx.x; i < R * K; i += blockDim.x) {
    const int r = i / K;
    const int k = i - r * K;
    const int row = row0 + r;
    float val = 0.0f;
    if (row < a.bs) {
      const size_t rs = (size_t)s * a.bs + row;
      int f = k;
      if (a.E2 > 0) {  // [sin | cos | x | cond]
        if (f < 2 * a.E2) {
          const float proj = (a.t[rs] * a.wemb[f % a.E2]) * kTwoPi;
          val = f < a.E2 ? sinf(proj) : cosf(proj);
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
    u[i] = val;
  }
  __syncthreads();

  // forward, keeping every layer input and act'
  const float* in = u;
  int kin = K;
  for (int l = 0; l < L; ++l) {
    const float* w = a.p + weight_offset(a, l);
    float* h = hs + l * rh;
    fwd_dense<RT>(w, w + kin * H, in, kin, h, H, kin, H, R);
    __syncthreads();
    float* dh = dhs + l * rh;
    for (int i = threadIdx.x; i < rh; i += blockDim.x) {
      float hv, dv;
      act_pair(a.act, h[i], hv, dv);
      h[i] = hv;
      dh[i] = dv;
    }
    __syncthreads();
    in = h;
    kin = H;
  }
  {
    const float* w = a.p + weight_offset(a, L);
    fwd_dense<RT>(w, w + kin * Dp, in, kin, dout, Dp, kin, Dp, R);
  }
  __syncthreads();

  // residual, loss partial and the output delta; masked rows and padded
  // outputs get zero
  float lsum = 0.0f;
  for (int i = threadIdx.x; i < R * Dp; i += blockDim.x) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    const int row = row0 + r;
    float dl = 0.0f;
    if (row < a.bs && d < a.D) {
      const size_t rs = (size_t)s * a.bs + row;
      const float bt = a.beta[rs];
      const float res = a.zw[rs * a.D + d] + bt * dout[i];
      lsum += res * res;
      dl = (2.0f * a.inv) * bt * res;
    }
    dout[i] = dl;
  }
  red[threadIdx.x] = lsum;
  __syncthreads();
  for (int width = blockDim.x / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) a.loss_part[slot] = first ? red[0] : a.loss_part[slot] + red[0];

  // backward: gradients of layer l from its input and delta, then the delta
  // of layer l - 1 into the act' buffer it multiplies
  float* grad = a.partial + (size_t)slot * a.n_param;
  for (int l = L; l >= 0; --l) {
    const int k_l = l == 0 ? K : H;
    const int n_l = l == L ? Dp : H;
    const float* in_l = l == 0 ? u : hs + (l - 1) * rh;
    const float* delta = l == L ? dout : dhs + l * rh;
    const int off = weight_offset(a, l);
    grad_dense(in_l, k_l, delta, n_l, k_l, n_l, R, grad + off, first);
    bias_grad(delta, n_l, n_l, R, grad + off + k_l * n_l, first);
    if (l > 0) bwd_dense<RT>(a.p + off, delta, n_l, dhs + (l - 1) * rh, H, n_l, R);
    __syncthreads();
  }
}

// Phase B of step s: the summed gradient, Adam and the EMA over the grid's
// threads; block 0 sums the loss partials.
__device__ void adam_phase(const TrainArgs& a, int s) {
  const float tstep = (float)(a.step0 + s + 1);
  const float bc1 = 1.0f - expf(tstep * logf(a.beta1));
  const float bc2 = 1.0f - expf(tstep * logf(a.beta2));
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)a.n_param; i += stride) {
    float g = 0.0f;
    for (int sl = 0; sl < a.n_slots; ++sl) g += __ldcg(a.partial + (size_t)sl * a.n_param + i);
    const float mi = a.beta1 * __ldcg(a.m + i) + (1.0f - a.beta1) * g;
    const float vi = a.beta2 * __ldcg(a.v + i) + (1.0f - a.beta2) * g * g;
    const float pi = __ldcg(a.p + i) - a.lr * (mi / bc1) / (sqrtf(vi / bc2) + a.eps);
    a.m[i] = mi;
    a.v[i] = vi;
    a.p[i] = pi;
    if (a.ema != nullptr) a.ema[i] = a.ema_decay * __ldcg(a.ema + i) + (1.0f - a.ema_decay) * pi;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float total = 0.0f;
    for (int sl = 0; sl < a.n_slots; ++sl) total += __ldcg(a.loss_part + sl);
    a.loss[s] = a.inv * total;
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads) fused_train_kernel(TrainArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < a.steps; ++s) {
    bool first = true;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      row_tile<RT>(a, s, tile, blockIdx.x, first, smem);
      first = false;
    }
    grid.sync();
    adam_phase(a, s);
    grid.sync();
  }
}

void* kernel_for(int rows) {
  return rows % 8 == 0 ? reinterpret_cast<void*>(fused_train_kernel<8>)
                       : reinterpret_cast<void*>(fused_train_kernel<kMinRowTile>);
}

}  // namespace

extern "C" {

// Blocks of the `rows`-row kernel with `smem` bytes of shared memory that one
// SM holds at once, and the SM count; a cooperative grid may not exceed their
// product.  Returns a cudaError_t (cudaErrorNotSupported without cooperative
// launches).
int ff_fused_train_capacity(int rows, size_t smem, int* blocks_per_sm, int* sm_count) {
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  int coop = 0;
  st = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (st != cudaSuccess) return (int)st;
  if (!coop) return (int)cudaErrorNotSupported;
  st = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (st != cudaSuccess) return (int)st;
  const void* k = kernel_for(rows);
  if (smem > 48 * 1024) {
    st = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k, kThreads, smem);
}

// One cooperative launch of `grid` blocks on `stream` for the whole call;
// returns the cudaError_t of the launch (0 on success).  p, m, v and ema (null
// without EMA) are flat buffers of n_param floats, updated in place; partial
// is (n_slots, n_param) and loss_part (n_slots,) scratch, n_slots =
// min(grid, ceil(bs / rows)); loss is (steps,).  K_pad, H and D_pad are
// multiples of 4, rows of 4; E2 = 0 selects the velocity input [x | t | cond].
int ff_fused_train(const float* xt, const float* zw, const float* t, const float* beta,
                   const float* cond, const float* wemb, float* p, float* m, float* v, float* ema,
                   float* partial, float* loss_part, float* loss, int steps, int bs, int D, int C,
                   int E2, int K_pad, int H, int n_hidden, int D_pad, int act, int rows, int n_slots,
                   int step0, float lr, float beta1, float beta2, float eps, float ema_decay,
                   float inv, int grid, size_t smem, void* stream) {
  const int n_tiles = (bs + rows - 1) / rows;
  if (steps < 1 || bs < 1 || D < 1 || D > D_pad || K_pad % 4 || H % 4 || D_pad % 4 ||
      rows % kMinRowTile || n_hidden < 1 || grid < 1 || n_slots != (grid < n_tiles ? grid : n_tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  TrainArgs a;
  a.xt = xt;
  a.zw = zw;
  a.t = t;
  a.beta = beta;
  a.cond = cond;
  a.wemb = wemb;
  a.p = p;
  a.m = m;
  a.v = v;
  a.ema = ema;
  a.partial = partial;
  a.loss_part = loss_part;
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
  a.n_slots = n_slots;
  a.step0 = step0;
  a.n_tiles = n_tiles;
  int n_param = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    const int k_l = l == 0 ? K_pad : H;
    const int n_l = l == n_hidden ? D_pad : H;
    n_param += (k_l + 1) * n_l;
  }
  a.n_param = n_param;
  a.lr = lr;
  a.beta1 = beta1;
  a.beta2 = beta2;
  a.eps = eps;
  a.ema_decay = ema_decay;
  a.inv = inv;
  const void* k = kernel_for(rows);
  cudaError_t st = cudaSuccess;
  if (smem > 48 * 1024) {
    st = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  void* args[] = {&a};
  st = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args, smem,
                                   static_cast<cudaStream_t>(stream));
  if (st != cudaSuccess) return (int)st;
  return (int)cudaGetLastError();
}

}  // extern "C"
