// Building blocks of the port's MLP kernels, shared by fused_mlp.cu,
// em_sampler.cu and fused_sketch.cu: the activations with their
// derivatives, the in-place activation passes over a block's layer buffer
// (one that also keeps act'(a) for later Jacobian applications, and the
// multiply of tangent chains by such a stored act'), and the register-tiled
// layer product, with or without the primal chain's bias.
//
// A block keeps `chains` buffers of R rows by H columns (row stride H) in
// shared memory: the primal activations, then one buffer per tangent chain
// (none in forward-only kernels).  The layer product reads one buffer set and
// writes the other; the caller swaps them and puts a barrier between passes.
//
// Bound and design: see the header comment of fused_mlp.cu (fp32 FMA issue;
// an 8-row by 4-column register tile per thread, float4 activations from
// shared memory and float4 weights from L1/L2).

#pragma once

#include <cuda_runtime.h>

namespace ffk {

constexpr int kMaxHidden = 16;  // (H, H) layers between input and output
constexpr int kThreads = 256;
// Rows per thread in a layer product: 8 when the block's row count allows,
// else 4 (the smallest tile, for plans that fit only at 4 rows a block).
constexpr int kMinRowTile = 4;

enum Act { kSilu = 0, kTanh = 1, kRelu = 2, kGelu = 3 };

struct HiddenLayers {
  const float* w[kMaxHidden];  // (H, H), row-major (in, out)
  const float* b[kMaxHidden];  // (H,)
};

// act(a) and act'(a).  Sigmoid is the exp form 1 / (1 + exp(-a)) in every
// kernel, as in the plain PyTorch paths (F.silu).
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
__device__ __forceinline__ void activate(int act, float* cur, int chains, int rh) {
  for (int i = threadIdx.x; i < rh; i += blockDim.x) {
    float h, dh;
    act_pair(act, cur[i], h, dh);
    cur[i] = h;
    for (int c = 1; c < chains; ++c) cur[c * rh + i] *= dh;
  }
}

// cur <- act(cur) for the primal chain alone, keeping act'(cur) in dh (R x H,
// the layout of cur) for the Jacobian applications that follow.
__device__ __forceinline__ void activate_keep(int act, float* cur, float* dh, int rh) {
  for (int i = threadIdx.x; i < rh; i += blockDim.x) {
    float h, d;
    act_pair(act, cur[i], h, d);
    cur[i] = h;
    dh[i] = d;
  }
}

// cur[c] *= dh for every one of `chains` tangent chains (none primal): the
// activation layer of a Jacobian application through a stored act'.
__device__ __forceinline__ void scale_by_act_grad(const float* dh, float* cur, int chains, int rh) {
  for (int i = threadIdx.x; i < rh; i += blockDim.x) {
    const float d = dh[i];
    for (int c = 0; c < chains; ++c) cur[c * rh + i] *= d;
  }
}

// nxt[c] = cur[c] @ w (+ bias for the primal chain c = 0 when `bias` is not
// null), for every chain.
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
      const float b = (c == 0 && bias != nullptr) ? __ldg(bias + j0 + j) : 0.0f;
#pragma unroll
      for (int i = 0; i < RT; ++i) out[i * H + j] = acc[i][j] + b;
    }
  }
}

// nxt[c] = cur[c] @ w for every chain, no bias on any: the layer product of
// a set of tangent chains alone (dense adds the bias to chain 0, which here
// is a tangent too).
template <int RT, int CT>
__device__ __forceinline__ void dense_tangents(const float* __restrict__ w, const float* cur,
                                               float* nxt, int K, int N, int R, int H,
                                               int chains) {
  dense<RT, CT>(w, nullptr, cur, nxt, K, N, R, H, chains);
}

// Raise a kernel's dynamic shared-memory ceiling where a launch needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace ffk
