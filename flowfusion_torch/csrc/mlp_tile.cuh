// Building blocks of the port's MLP kernels, shared by fused_mlp.cu,
// em_sampler.cu and fused_sketch.cu: the activations with their
// derivatives, the in-place activation passes over a block's layer buffer
// (one that also keeps act'(a) for later Jacobian applications, and the
// multiply of tangent chains by such a stored act'), the register-tiled
// layer product, with or without the primal chain's bias, the 3xTF32
// products of compute mode highf32, and the bf16 tensor-core product and
// output layer of compute mode bfloat16 (fused_mlp.cu and fused_sketch.cu
// run the same ones).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ffk {

constexpr int kThreads = 256;
// Rows per thread in a layer product: 8 when the block's row count allows,
// else 4 (the smallest tile, for plans that fit only at 4 rows a block).
constexpr int kMinRowTile = 4;
// Input features up to which highf32 keeps an input projection strict (the
// JAX kernel's rank-1 crossover, in_proj_rows, kernels/fused_mlp.py:313-330).
constexpr int kRank1Max = 16;

enum Act { kSilu = 0, kTanh = 1, kRelu = 2, kGelu = 3 };

// The (H, H) layers between input and output, any number of them: views of
// the layer table, 2 n_hidden pointers in device memory, the weights then
// the biases, which the wrapper writes before the launch
// (kernels/fused_mlp.py::layer_table).  A kernel reads a layer's two
// pointers once a product.
struct HiddenLayers {
  const float* const* w;  // w[l]: (H, H), row-major (in, out)
  const float* const* b;  // b[l]: (H,)
};

inline HiddenLayers hidden_layers(const float* const* table, int n_hidden) { return {table, table + n_hidden}; }

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

// ---------------------------------------------------------------------------
// Compute mode highf32: 3xTF32 layer products.  An fp32 operand a splits into
// a_hi = tf32(a) and a_lo = tf32(a - a_hi) (cvt.rna: 10 mantissa bits, round
// to nearest, ties away from zero); a product is a_hi b_hi + a_hi b_lo +
// a_lo b_hi in fp32, the ~2^-22-relative a_lo b_lo dropped (the counterpart
// of the JAX package's bf16_3pass_dot_general, kernels/fused_mlp.py:214-233,
// with TF32 halves in place of bf16 ones; fused_train.cu splits each operand
// once as it is read and sums through fma_split).  SiLU takes the tanh-form sigmoid
// 0.5 + 0.5 tanh(a / 2) (kernels/fused_mlp.py:257-279), through tanhf: the
// ~2^-11 error of tanh.approx.f32 would use up the mode's bars.

__device__ __forceinline__ float to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The subtraction is written out in round-to-nearest: where x is a product
// formed just before, the compiler must not fuse it into x - hi.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, hi));
}

// acc + a b from halves already split: lo.hi, hi.lo, hi.hi in FMAs.
__device__ __forceinline__ float fma_split(float ah, float al, float bh, float bl, float acc) {
  return fmaf(ah, bh, fmaf(ah, bl, fmaf(al, bh, acc)));
}

// acc + a b through the split, on the CUDA cores: the TF32 halves' products
// are exact in fp32, so this is the tensor-core arithmetic up to summation
// order.
__device__ __forceinline__ float fma_tf32x3(float a, float b, float acc) {
  float ah, al, bh, bl;
  split_tf32(a, ah, al);
  split_tf32(b, bh, bl);
  return fma_split(ah, al, bh, bl, acc);
}

// act(a) and act'(a) in highf32: act_pair with SiLU's sigmoid in tanh form.
__device__ __forceinline__ void act_pair_highf32(int act, float a, float& h, float& dh) {
  if (act != kSilu) {
    act_pair(act, a, h, dh);
    return;
  }
  const float s = 0.5f + 0.5f * tanhf(0.5f * a);
  h = a * s;
  dh = s * (1.0f + a * (1.0f - s));
}

// activate_keep() with act_pair_highf32: act' from the tanh-form sigmoid,
// kept for the Jacobian applications of a highf32 sketch.
__device__ __forceinline__ void activate_keep_highf32(int act, float* cur, float* dh, int rh) {
  for (int i = threadIdx.x; i < rh; i += blockDim.x) {
    float h, d;
    act_pair_highf32(act, cur[i], h, d);
    cur[i] = h;
    dh[i] = d;
  }
}

// d += a b on the tensor cores: one m16n8k8 TF32 product, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Compute mode bfloat16, the JAX package's fast serving mode: each product's
// operands rounded to bf16 (round to nearest even, __float2bfloat16_rn, as
// the TPU's casts), the products exact in fp32, summed in fp32
// (kernels/fused_mlp.py::bf16_matmul in the port says where the JAX kernel
// rounds).  SiLU takes the tanh-form sigmoid, as highf32 does.

// x rounded to bf16, as an fp32 value.
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// d += a b on the tensor cores: one m16n8k16 bf16 product, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// nxt = cur @ w (+ bias on the primal chain's rows, row < R, when `bias` is
// not null) for the block's M = chains x R rows of stride H at once: one
// (M x K) by (K x N) product through 3xTF32 mma.sync.  A warp owns a 16-row
// by 8 NT-column strip and loops K in steps of 8; the block's warps stride
// over the strips.  A fragments come from shared memory, B fragments from
// the weights through __ldg, each split in registers and issued as lo.hi,
// hi.lo, hi.hi.  m16n8k8 .tf32 fragments (PTX ISA), g = lane / 4,
// t = lane % 4: A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B b0 (k t, n g), b1 (k t + 4, n g); C c0, c1 (g, 2t), (g, 2t + 1), c2, c3
// (g + 8, 2t), (g + 8, 2t + 1).  M is a multiple of 4 (the last m-tile
// loads zeros past M and stores nothing there), K and N multiples of 8.
// A-fragment reads at stride H = 128 meet one bank 8 ways; a padded
// stride is later work.
template <int NT>
__device__ void dense_tf32x3(const float* __restrict__ w, const float* __restrict__ bias,
                             const float* cur, float* nxt, int K, int N, int M, int R, int H) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = N >> 3;
  const int strips = (n_tiles + NT - 1) / NT;
  const int items = ((M + 15) >> 4) * strips;
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int nt0 = (it % strips) * NT;
    const int r0 = (it / strips) * 16 + g;
    const int r1 = r0 + 8;
    const bool ok0 = r0 < M;
    const bool ok1 = r1 < M;
    const float* row0 = cur + (size_t)r0 * H;
    const float* row1 = cur + (size_t)r1 * H;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int k = 0; k < K; k += 8) {
      const float av[4] = {ok0 ? row0[k + t] : 0.0f, ok1 ? row1[k + t] : 0.0f,
                           ok0 ? row0[k + t + 4] : 0.0f, ok1 ? row1[k + t + 4] : 0.0f};
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float h, l;
        split_tf32(av[i], h, l);
        ahi[i] = __float_as_uint(h);
        alo[i] = __float_as_uint(l);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (nt0 + j >= n_tiles) break;  // warp-uniform
        const int n = (nt0 + j) * 8 + g;
        unsigned bhi[2], blo[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float h, l;
          split_tf32(__ldg(w + (size_t)(k + t + 4 * i) * N + n), h, l);
          bhi[i] = __float_as_uint(h);
          blo[i] = __float_as_uint(l);
        }
        mma_tf32(acc[j], alo, bhi);
        mma_tf32(acc[j], ahi, blo);
        mma_tf32(acc[j], ahi, bhi);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (nt0 + j >= n_tiles) break;
      const int n = (nt0 + j) * 8 + 2 * t;
      const float b0 = bias != nullptr ? __ldg(bias + n) : 0.0f;
      const float b1 = bias != nullptr ? __ldg(bias + n + 1) : 0.0f;
      if (ok0) {
        const bool primal = r0 < R;
        nxt[(size_t)r0 * H + n] = acc[j][0] + (primal ? b0 : 0.0f);
        nxt[(size_t)r0 * H + n + 1] = acc[j][1] + (primal ? b1 : 0.0f);
      }
      if (ok1) {
        const bool primal = r1 < R;
        nxt[(size_t)r1 * H + n] = acc[j][2] + (primal ? b0 : 0.0f);
        nxt[(size_t)r1 * H + n + 1] = acc[j][3] + (primal ? b1 : 0.0f);
      }
    }
  }
}

// nxt[c] = cur[c] @ w (+ bias on chain 0) through fma_tf32x3: the narrow
// (H, D) output layer of highf32, on the CUDA cores, a thread to each of the
// chains x R x N outputs (N = D is too narrow for an m16n8k8 tile).
__device__ __forceinline__ void dense_split_fma(const float* __restrict__ w,
                                                const float* __restrict__ bias, const float* cur,
                                                float* nxt, int K, int N, int R, int H, int chains) {
  for (int it = threadIdx.x; it < chains * R * N; it += blockDim.x) {
    const int j = it % N;
    const int m = it / N;  // row of the chains x R stack
    const float* in = cur + (size_t)m * H;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fma_tf32x3(in[k], __ldg(w + (size_t)k * N + j), acc);
    nxt[(size_t)m * H + j] = acc + ((m < R && bias != nullptr) ? __ldg(bias + j) : 0.0f);
  }
}

// Values past H in a row of a bfloat16 kernel's layer buffers, where the
// fp32 pre-activations and the bf16 plane share the row stride H +
// kPadBF16: a plane row is (H + 8) / 2 words, 4 banks past the one before
// for H a multiple of 16, so a warp's A-fragment words fall on 32 distinct
// banks.
constexpr int kPadBF16 = 8;
// n-tiles (8 columns each) a warp of dense_bf16 owns.
constexpr int kNTilesBF16 = 2;

// bfloat16: nxt[m] = A[m] @ w (+ bias on rows m < R) through mma.sync
// m16n8k16 bf16 with fp32 accumulation, A the bf16 plane (stride S values)
// and wt the weights as bf16 transposed, (N, K), so a B fragment's k pair
// is one 32-bit load.  The warp tiling of fused_mlp.cu's dense_planes: NT
// n-tiles across up to MT m-tiles, each weight fragment loaded once a block
// a layer wherever M <= 64.  m16n8k16 .bf16 fragments (PTX ISA), g = lane / 4, t = lane % 4,
// a register a pair of consecutive k: A (g, 2t), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8); B (k 2t, n g), (k 2t + 8, n g); C as in m16n8k8.  Rows
// past M read row M - 1 and store nothing.  K is a multiple of 16, N of 8.
// MT is the m-tiles a warp carries at once (its accumulators: MT x NT x 4
// floats); an output's sum runs over k in the same order at any MT.
template <int MT = 8 / kNTilesBF16>
__device__ void dense_bf16(const __nv_bfloat16* __restrict__ wt, const float* __restrict__ bias,
                           const __nv_bfloat16* a, float* nxt, int K, int N, int M, int R, int S) {
  constexpr int NT = kNTilesBF16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = N >> 3;
  const int m_tiles = (M + 15) >> 4;
  const int strips = (n_tiles + NT - 1) / NT;
  const int groups = (m_tiles + MT - 1) / MT;
  for (int it = threadIdx.x >> 5; it < strips * groups; it += kThreads / 32) {
    const int grp = it / strips;
    const int nt0 = (it - grp * strips) * NT;
    const int mt0 = grp * MT;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    for (int k = 0; k < K; k += 16) {
      unsigned b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = min(nt0 + j, n_tiles - 1) * 8 + g;
        const unsigned* col = reinterpret_cast<const unsigned*>(wt + (size_t)n * K + k + 2 * t);
        b[j][0] = __ldg(col);
        b[j][1] = __ldg(col + 4);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (mt0 + i >= m_tiles) break;  // warp-uniform
        const unsigned* p0 =
            reinterpret_cast<const unsigned*>(a + (size_t)min((mt0 + i) * 16 + g, M - 1) * S + k + 2 * t);
        const unsigned* p1 =
            reinterpret_cast<const unsigned*>(a + (size_t)min((mt0 + i) * 16 + g + 8, M - 1) * S + k + 2 * t);
        const unsigned af[4] = {p0[0], p1[0], p0[4], p1[4]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (nt0 + j >= n_tiles) break;  // warp-uniform
          mma_bf16(acc[i][j], af, b[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (nt0 + j >= n_tiles) break;
      const int n = (nt0 + j) * 8 + 2 * t;
      const float b0 = bias != nullptr ? __ldg(bias + n) : 0.0f;
      const float b1 = bias != nullptr ? __ldg(bias + n + 1) : 0.0f;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (mt0 + i >= m_tiles) break;
        const int r0 = (mt0 + i) * 16 + g;
        const int r1 = r0 + 8;
        if (r0 < M) {
          const bool primal = r0 < R;
          float2 o;
          o.x = acc[i][j][0] + (primal ? b0 : 0.0f);
          o.y = acc[i][j][1] + (primal ? b1 : 0.0f);
          *reinterpret_cast<float2*>(nxt + (size_t)r0 * S + n) = o;
        }
        if (r1 < M) {
          const bool primal = r1 < R;
          float2 o;
          o.x = acc[i][j][2] + (primal ? b0 : 0.0f);
          o.y = acc[i][j][3] + (primal ? b1 : 0.0f);
          *reinterpret_cast<float2*>(nxt + (size_t)r1 * S + n) = o;
        }
      }
    }
  }
}

// bfloat16: out[m, j] = A[m] @ w[:, j] (+ bias[j] on rows m < R) for the
// narrow (K, N = D) output layer, a thread an output: A the bf16 plane
// (stride S values), w bf16 in its (K, N) layout, one fmaf chain over k
// from 0 (the products exact).  `out` is compact, (M, N).
__device__ void dense_out_bf16(const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                               const __nv_bfloat16* a, float* out, int K, int N, int M, int R, int S) {
  for (int it = threadIdx.x; it < M * N; it += kThreads) {
    const int m = it / N;
    const int j = it - m * N;
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(a + (size_t)m * S);
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; k += 2) {
      const float2 hv = __bfloat1622float2(in[k >> 1]);
      acc = fmaf(hv.x, __bfloat162float(w[(size_t)k * N + j]), acc);
      acc = fmaf(hv.y, __bfloat162float(w[(size_t)(k + 1) * N + j]), acc);
    }
    out[it] = acc + ((m < R && bias != nullptr) ? __ldg(bias + j) : 0.0f);
  }
}

// Raise a kernel's dynamic shared-memory ceiling where a launch needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace ffk
