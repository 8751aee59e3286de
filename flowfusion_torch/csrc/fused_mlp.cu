// Fused score-MLP drift or flow velocity, with the Hutchinson or exact
// divergence, for Hopper.
//
// Replaces flowfusion_tpu/kernels/fused_mlp.py::_kernel (the Pallas kernel,
// pallas_call at fused_mlp.py:935) in its modes forward, hutchinson, exact and
// tangents, reached through fused_drift (fused_mlp.py:951), fused_velocity
// (fused_mlp.py:1353, (c0, c1) = (0, 1)), fused_drift_tangents and
// fused_velocity_tangents (fused_mlp.py:1020, 1148) and, two forward launches
// a call, fused_symplectic_velocity (fused_mlp.py:1182), in three compute
// modes (the template's P, the wrapper's precision index):
//   float32  strict IEEE fp32 FMAs on the CUDA cores;
//   highf32  the JAX kernel's 3-pass split products (bf16_3pass_dot_general,
//            fused_mlp.py:214-233, selected at :541-560) and its tanh-form
//            SiLU (:257-279, selected at :596-599), here as 3xTF32: every
//            hidden (H, H) product on the tensor cores (dense_planes below,
//            mma.sync m16n8k8), the (H, D) output product and
//            an input projection of more than 16 features (the JAX kernel's
//            rank-1 crossover, in_proj_rows :313-330) through the split in
//            FMAs; up to 16 input features and the time fold stay strict;
//   bfloat16 the JAX kernel's fast serving mode (_compute_mode :175-201):
//            the weights bf16 (converted by the wrapper once a call), every
//            activation and tangent rounded to bf16 before its product,
//            fp32 sums, the tanh-form SiLU.  The hidden (H, H) products run
//            on the bf16 tensor cores (mlp_tile.cuh dense_bf16, mma.sync
//            m16n8k16, one pass, shared with fused_sketch.cu), the output layer in FMAs on the same rounded operands
//            (exact products), the input layer as in highf32 with bf16
//            weights (the rank-1 sum up to 16 inputs, rounded inputs past).
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
// mma.sync does not reach the wgmma rate.  bfloat16: one pass on the bf16
// tensor cores (989 TFLOP/s dense) beside the same CUDA-core rest, the
// output layer once.  Each layer is a product and an
// activation pass over a block's small tile with a barrier between, so how
// many blocks an SM holds, and what runs beside the products, decide the
// time.  The first version (measured on the H100 before this design, a
// clock64-stamped copy): float32 took 106 registers a thread, so two blocks
// an SM where shared memory held three; the input layer took 17-23% of a
// launch (a division by R H and by H a cell), the three activation passes
// 9-17%, the output layer 6% on 16 of 256 threads (10% in highf32); a
// float32 product warp streamed a 512-byte weight row a k through L1; and
// highf32 split each A value once a strip and each weight once an m-tile,
// reading A at stride H with 8-way bank conflicts.
//
// What the design does about it.  A block owns a tile of R rows and keeps
// the whole layer chain of that tile, the activations and every tangent
// chain, in shared memory, so nothing but x, e, drift and div touches device
// memory and each weight read from L2 feeds R rows times all chains.
//   - Three blocks of 256 threads an SM: every instantiation fits the 80
//     registers a thread that three blocks leave, without spilling, and the
//     plan (kernels/fused_mlp.py::_plan) counts blocks against the SM's
//     233,472 bytes with the 1 KB each block reserves, taking the most
//     blocks (at most three) at the most rows that reach them.
//   - Rows of the activation buffers are H + 4 floats apart, so consecutive
//     rows start 4 banks apart.
//   - The input layer and its activation run as one pass, two cells (r, j)
//     a thread at a time with every chain of a cell in registers; the cells
//     are walked without a division a cell.  The other activation passes
//     take two cells at a time too.
//   - float32 (H, H) products (dense_rows): a thread owns 4 rows by 4
//     columns, a warp 4 row lanes by 8 column lanes (16 rows by 32
//     columns): per 4 k a warp reads 128 bytes of weights a k row and 4
//     distinct rows of activations on distinct banks.  Eight rows a thread
//     spill at 80 registers, and at two blocks an SM were no faster; six
//     rows, a weight prefetch and 8 x 4 lanes were slower.
//   - highf32 products (dense_planes): the activation pass writes the TF32
//     hi and lo planes of act(a) and of each tangent chain, which the
//     product reads conflict-free and splits no more; a warp owns 2
//     n-tiles across up to 4 m-tiles, so each weight is loaded and split
//     once a block a layer wherever M <= 64 (every plan the main path
//     runs).  The planes are a third buffer, so these plans take half the
//     float32 rows at three blocks, and the widest H a plan fits is about
//     two thirds of float32's.
//   - bfloat16 products (mlp_tile.cuh dense_bf16): the activation pass writes one bf16
//     plane of act(a) and of each tangent chain (rows H + 8 values apart,
//     so a warp's A-fragment words fall on 32 distinct banks), which the
//     product reads as packed pairs; the wrapper hands the hidden weights
//     over transposed, (out, in), so a B fragment's two k values are one
//     32-bit load.  The plane is 2 bytes a value, so these plans hold more
//     rows than float32's.  Not yet: the weights staged in shared memory,
//     TMA, wgmma.
//   - The (H, D) output layer: a thread an output, chains x R x D of them.
// Every output keeps the first version's arithmetic: each float32 layer
// output one fmaf chain over k = 0 .. K-1 from 0, then + bias; each highf32
// k-step of 8 lo.hi, hi.lo, hi.hi into one accumulator on the same TF32
// halves; the activations as in mlp_tile.cuh.  So a row's outputs do not
// depend on the plan, and equal the first version's bitwise.  Not taken:
// wgmma (its k order is not mma.sync's), the split weights staged in shared
// memory, and the activation fused into the product's epilogue (a thread
// would have to hold every chain of a cell).

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace {

using namespace ffk;

enum Mode { kForward = 0, kHutchinson = 1, kExact = 2, kTangents = 3 };
// The compute modes, the templates' P (the wrapper's precision index).
enum Precision { kFloat32 = 0, kHighF32 = 1, kBFloat16 = 2 };

constexpr int kWarps = kThreads / 32;
// Floats past H in a row of the activation buffers: the row stride is
// H + kPad, so consecutive rows start 4 banks apart.
constexpr int kPad = 4;
// Blocks of kThreads an SM is to hold, by registers (the launch bounds):
// 80 registers a thread, which every instantiation fits without spilling.
constexpr int kMinBlocks = 3;
// The layer products' tiles: float32 rows a thread (dense_rows), highf32
// n-tiles a warp (dense_planes; bfloat16's dense_bf16, in mlp_tile.cuh,
// tiles the same way).
constexpr int kRowTile = 4;
constexpr int kNTiles = 2;

// A thread's walk over the (r, j) cells of an R x H grid, kThreads cells
// apart, with no division a cell.
struct GridWalk {
  int r, j, dr, dj, H;
  __device__ explicit GridWalk(int h) : H(h) {
    r = threadIdx.x / H;
    j = threadIdx.x - r * H;
    dr = kThreads / H;
    dj = kThreads - dr * H;
  }
  __device__ void next() {
    r += dr;
    j += dj;
    if (j >= H) {
      j -= H;
      ++r;
    }
  }
};

// nxt[m] = cur[m] @ w (+ bias on the primal rows m < R when `bias` is not
// null) for the block's M = chains x R rows of stride S, float32: each
// output one fmaf chain over k = 0 .. K-1 from 0, then + bias (+ 0 on a
// tangent row).  A thread owns RT = kRowTile rows by 4 columns; a warp is 4
// row lanes by 8 column lanes, so it covers 4 RT rows by 32 columns: per 4 k
// it reads
// 4 float4 weight rows of 128 bytes (its 8 column lanes, through L1) and,
// per row slot, 4 distinct float4 activations on 16 distinct banks.  A
// thread's rows are m0 + 4 i (i < RT), the row lanes' rows interleaved;
// rows past M read row M - 1 and store nothing.  K and N are multiples of 4.
__device__ void dense_rows(const float* __restrict__ w, const float* __restrict__ bias, const float* cur,
                           float* nxt, int K, int N, int M, int R, int S) {
  constexpr int RT = kRowTile;
  const int lane = threadIdx.x & 31;
  const int rl = lane >> 3;
  const int cl = lane & 7;
  const int row_tiles = (M + 4 * RT - 1) / (4 * RT);
  const int col_tiles = (N + 31) >> 5;
  for (int it = threadIdx.x >> 5; it < row_tiles * col_tiles; it += kWarps) {
    const int rt = it / col_tiles;
    const int j0 = (it - rt * col_tiles) * 32 + cl * 4;
    if (j0 >= N) continue;
    const int m0 = rt * 4 * RT + rl;
    int off[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) off[i] = min(m0 + 4 * i, M - 1) * S;
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    for (int k = 0; k < K; k += 4) {
      float wv[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k + kk) * N + j0));
        wv[kk][0] = v.x;
        wv[kk][1] = v.y;
        wv[kk][2] = v.z;
        wv[kk][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(cur + off[i] + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(hv.x, wv[0][j], acc[i][j]);
          acc[i][j] = fmaf(hv.y, wv[1][j], acc[i][j]);
          acc[i][j] = fmaf(hv.z, wv[2][j], acc[i][j]);
          acc[i][j] = fmaf(hv.w, wv[3][j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int m = m0 + 4 * i;
      if (m >= M) break;
      const bool primal = m < R && bias != nullptr;
      float4 o;
      o.x = acc[i][0] + (primal ? __ldg(bias + j0) : 0.0f);
      o.y = acc[i][1] + (primal ? __ldg(bias + j0 + 1) : 0.0f);
      o.z = acc[i][2] + (primal ? __ldg(bias + j0 + 2) : 0.0f);
      o.w = acc[i][3] + (primal ? __ldg(bias + j0 + 3) : 0.0f);
      *reinterpret_cast<float4*>(nxt + (size_t)m * S + j0) = o;
    }
  }
}

// highf32: nxt[m] = A[m] @ w (+ bias on rows m < R) through 3xTF32
// mma.sync m16n8k8, A given as its TF32 hi and lo planes (stride S), so no
// A value is split here.  A warp owns NT = kNTiles n-tiles (8 columns each)
// across up to MT = 8 / NT m-tiles (16 rows each; every m-tile of the block
// where M <= 16 MT): per k-step of 8 it loads and splits its NT weight fragments
// once and issues lo.hi, hi.lo, hi.hi into each of its MT x NT
// accumulators, the order of the one-strip form (mlp_tile.cuh
// dense_tf32x3), so every output is bitwise that form's.  Fragment layout
// as there (g = lane / 4, t = lane % 4); rows past M read row M - 1 and
// store nothing.  K and N are multiples of 8.
__device__ void dense_planes(const float* __restrict__ w, const float* __restrict__ bias, const float* hi,
                             const float* lo, float* nxt, int K, int N, int M, int R, int S) {
  constexpr int NT = kNTiles;
  constexpr int MT = 8 / NT;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_tiles = N >> 3;
  const int m_tiles = (M + 15) >> 4;
  const int strips = (n_tiles + NT - 1) / NT;
  const int groups = (m_tiles + MT - 1) / MT;
  for (int it = threadIdx.x >> 5; it < strips * groups; it += kWarps) {
    const int grp = it / strips;
    const int nt0 = (it - grp * strips) * NT;
    const int mt0 = grp * MT;
    float acc[MT][NT][4];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[a][j][0] = acc[a][j][1] = acc[a][j][2] = acc[a][j][3] = 0.0f;
    for (int k = 0; k < K; k += 8) {
      unsigned bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = min(nt0 + j, n_tiles - 1) * 8 + g;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float h, l;
          split_tf32(__ldg(w + (size_t)(k + t + 4 * i) * N + n), h, l);
          bhi[j][i] = __float_as_uint(h);
          blo[j][i] = __float_as_uint(l);
        }
      }
#pragma unroll
      for (int a = 0; a < MT; ++a) {
        if (mt0 + a >= m_tiles) break;  // warp-uniform
        const int r0 = min((mt0 + a) * 16 + g, M - 1) * S + k + t;
        const int r1 = min((mt0 + a) * 16 + g + 8, M - 1) * S + k + t;
        const unsigned ahi[4] = {__float_as_uint(hi[r0]), __float_as_uint(hi[r1]), __float_as_uint(hi[r0 + 4]),
                                 __float_as_uint(hi[r1 + 4])};
        const unsigned alo[4] = {__float_as_uint(lo[r0]), __float_as_uint(lo[r1]), __float_as_uint(lo[r0 + 4]),
                                 __float_as_uint(lo[r1 + 4])};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (nt0 + j >= n_tiles) break;  // warp-uniform
          mma_tf32(acc[a][j], alo, bhi[j]);
          mma_tf32(acc[a][j], ahi, blo[j]);
          mma_tf32(acc[a][j], ahi, bhi[j]);
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
      for (int a = 0; a < MT; ++a) {
        if (mt0 + a >= m_tiles) break;
        const int r0 = (mt0 + a) * 16 + g;
        const int r1 = r0 + 8;
        if (r0 < M) {
          const bool primal = r0 < R;
          float2 o;
          o.x = acc[a][j][0] + (primal ? b0 : 0.0f);
          o.y = acc[a][j][1] + (primal ? b1 : 0.0f);
          *reinterpret_cast<float2*>(nxt + (size_t)r0 * S + n) = o;
        }
        if (r1 < M) {
          const bool primal = r1 < R;
          float2 o;
          o.x = acc[a][j][2] + (primal ? b0 : 0.0f);
          o.y = acc[a][j][3] + (primal ? b1 : 0.0f);
          *reinterpret_cast<float2*>(nxt + (size_t)r1 * S + n) = o;
        }
      }
    }
  }
}

// out[m, j] = cur[m] @ w[:, j] (+ bias[j] on the primal rows m < R) for the
// narrow (K, N = D) output layer, one thread an output of the M x N: in
// float32 one fmaf chain over k from 0; in highf32 the split in FMAs
// (fma_tf32x3's arithmetic), A's halves read from the planes (bfloat16 has
// dense_out_bf16).  `out` is compact, (M, N).
template <int P>
__device__ void dense_out(const float* __restrict__ w, const float* __restrict__ bias, const float* a,
                          const float* a_lo, float* out, int K, int N, int M, int R, int S) {
  for (int it = threadIdx.x; it < M * N; it += kThreads) {
    const int m = it / N;
    const int j = it - m * N;
    const float* in = a + (size_t)m * S;
    float acc = 0.0f;
    if constexpr (P == kHighF32) {
      const float* in_lo = a_lo + (size_t)m * S;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        float bh, bl;
        split_tf32(__ldg(w + (size_t)k * N + j), bh, bl);
        acc = fmaf(in[k], bh, fmaf(in[k], bl, fmaf(in_lo[k], bh, acc)));
      }
    } else {
      for (int k = 0; k < K; k += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(in + k);
        acc = fmaf(hv.x, __ldg(w + (size_t)k * N + j), acc);
        acc = fmaf(hv.y, __ldg(w + (size_t)(k + 1) * N + j), acc);
        acc = fmaf(hv.z, __ldg(w + (size_t)(k + 2) * N + j), acc);
        acc = fmaf(hv.w, __ldg(w + (size_t)(k + 3) * N + j), acc);
      }
    }
    out[it] = acc + ((m < R && bias != nullptr) ? __ldg(bias + j) : 0.0f);
  }
}

// Pre-activation of cell (r, j) of chain c in the input layer: the primal
// chain projects [x | cond] and adds b_eff; a probe (Hutchinson, or tangent
// k) has no conditional components and projects through rows 0..D-1 only;
// the exact basis tangent e_d is row d of w_in.  In bfloat16 w_in holds
// bf16 values (the wrapper rounds it) and an input of more than kRank1Max
// features is rounded too, as the JAX kernel's in_proj_rows projects it
// through its bf16 product.
template <int P>
__device__ __forceinline__ float input_cell(int c, int r, int j, int mode, const float* xs, const float* es,
                                            const float* __restrict__ w_in, const float* __restrict__ b_eff,
                                            int d_in, int d_out, int pw, int H) {
  float v = 0.0f;
  if (c == 0) {
    if (P == kHighF32 && d_in > kRank1Max) {
      for (int k = 0; k < d_in; ++k) v = fma_tf32x3(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
    } else if (P == kBFloat16 && d_in > kRank1Max) {
      for (int k = 0; k < d_in; ++k) v = fmaf(round_bf16(xs[r * d_in + k]), __ldg(w_in + k * H + j), v);
    } else {
      for (int k = 0; k < d_in; ++k) v = fmaf(xs[r * d_in + k], __ldg(w_in + k * H + j), v);
    }
    v += __ldg(b_eff + j);
  } else if (mode == kHutchinson || mode == kTangents) {
    const float* p = es + r * pw + (c - 1) * d_out;  // c - 1 = 0 in hutchinson
    if (P == kHighF32 && d_out > kRank1Max) {
      for (int k = 0; k < d_out; ++k) v = fma_tf32x3(p[k], __ldg(w_in + k * H + j), v);
    } else if (P == kBFloat16 && d_out > kRank1Max) {
      for (int k = 0; k < d_out; ++k) v = fmaf(round_bf16(p[k]), __ldg(w_in + k * H + j), v);
    } else {
      for (int k = 0; k < d_out; ++k) v = fmaf(p[k], __ldg(w_in + k * H + j), v);
    }
  } else {
    v = __ldg(w_in + (c - 1) * H + j);
  }
  return v;
}

// act(a) and act'(a) in the compute mode: SiLU's sigmoid in tanh form in
// highf32 and bfloat16.
template <int P>
__device__ __forceinline__ void act_cell(int act, float a, float& h, float& dh) {
  if constexpr (P != kFloat32) {
    act_pair_highf32(act, a, h, dh);
  } else {
    act_pair(act, a, h, dh);
  }
}

// Store an activation value at o: float32 in cur, highf32 as its TF32 hi
// and lo halves in the planes, bfloat16 rounded into the bf16 plane (at hi).
template <int P>
__device__ __forceinline__ void store_act(float v, float* cur, float* hi, float* lo, int o) {
  if constexpr (P == kHighF32) {
    split_tf32(v, hi[o], lo[o]);
  } else if constexpr (P == kBFloat16) {
    reinterpret_cast<__nv_bfloat16*>(hi)[o] = __float2bfloat16_rn(v);
  } else {
    cur[o] = v;
  }
}

// The activation of two cells o1, o2 of every chain (o2 may repeat o1) from
// their pre-activations in cur: act(a) on the primal chain, each tangent
// chain times act'(a), stored by store_act.  Every value of a chain is
// loaded before it is stored, so the two cells' latencies overlap.
template <int P>
__device__ __forceinline__ void activate_cells(int act, float* cur, float* hi, float* lo, int o1, int o2,
                                               int chains, int rs) {
  float h1, d1, h2, d2;
  act_cell<P>(act, cur[o1], h1, d1);
  act_cell<P>(act, cur[o2], h2, d2);
  for (int c = 1; c < chains; ++c) {
    const float t1 = cur[c * rs + o1], t2 = cur[c * rs + o2];
    store_act<P>(__fmul_rn(t1, d1), cur, hi, lo, c * rs + o1);
    store_act<P>(__fmul_rn(t2, d2), cur, hi, lo, c * rs + o2);
  }
  store_act<P>(h1, cur, hi, lo, o1);
  store_act<P>(h2, cur, hi, lo, o2);
}

// div: (B,) in modes hutchinson and exact; in mode tangents the (n_tan, B,
// d_out) columns J v_k.  e: (B, d_out) in mode hutchinson, (B, n_tan, d_out)
// in mode tangents.
template <int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  const int S = H + (P == kBFloat16 ? kPadBF16 : kPad);
  const int M = chains * R;
  const int rs = R * S;
  // float32: cur and nxt, the double buffer of pre-activations and
  // activations; highf32: the pre-activations and the TF32 hi and lo planes
  // of the activations; bfloat16: the pre-activations and (at nxt) the bf16
  // plane of the activations, M S values of 2 bytes.  M rows of stride S
  // each.
  float* cur = smem;
  float* nxt = smem + M * S;
  float* lo = smem + 2 * M * S;  // highf32 only
  float* xs = smem + (P == kHighF32 ? 3 * M * S : P == kBFloat16 ? M * S + M * S / 2 : 2 * M * S);  // (R, d_in) input tile
  float* es = xs + R * d_in;                // (R, pw) probe tile
  const int row0 = blockIdx.x * R;

  // Rows past B (the ragged last tile) compute on zeros and are not stored.
  for (int i = threadIdx.x; i < R * d_in; i += kThreads) {
    xs[i] = (size_t)row0 * d_in + i < (size_t)B * d_in ? x[(size_t)row0 * d_in + i] : 0.0f;
  }
  if (mode == kHutchinson || mode == kTangents) {
    for (int i = threadIdx.x; i < R * pw; i += kThreads) {
      es[i] = (size_t)row0 * pw + i < (size_t)B * pw ? e[(size_t)row0 * pw + i] : 0.0f;
    }
  }
  __syncthreads();

  // Input layer and its activation, two cells (r, j) a thread at a time,
  // every chain of a cell, in registers: act(a) of the primal, each tangent
  // chain's projection times act'(a).
  for (GridWalk gw(H); gw.r < R;) {
    const int r1 = gw.r, j1 = gw.j;
    gw.next();
    const bool two = gw.r < R;  // else the second cell repeats the first
    const int r2 = two ? gw.r : r1, j2 = two ? gw.j : j1;
    gw.next();
    const int o1 = r1 * S + j1, o2 = r2 * S + j2;
    const float a1 = input_cell<P>(0, r1, j1, mode, xs, es, w_in, b_eff, d_in, d_out, pw, H);
    const float a2 = input_cell<P>(0, r2, j2, mode, xs, es, w_in, b_eff, d_in, d_out, pw, H);
    float h1, d1, h2, d2;
    act_cell<P>(act, a1, h1, d1);
    act_cell<P>(act, a2, h2, d2);
    for (int c = 1; c < chains; ++c) {
      const float t1 = input_cell<P>(c, r1, j1, mode, xs, es, w_in, b_eff, d_in, d_out, pw, H);
      const float t2 = input_cell<P>(c, r2, j2, mode, xs, es, w_in, b_eff, d_in, d_out, pw, H);
      store_act<P>(__fmul_rn(t1, d1), cur, nxt, lo, c * rs + o1);
      store_act<P>(__fmul_rn(t2, d2), cur, nxt, lo, c * rs + o2);
    }
    store_act<P>(h1, cur, nxt, lo, o1);
    store_act<P>(h2, cur, nxt, lo, o2);
  }
  __syncthreads();

  // Each hidden layer: the product into the next pre-activations, then the
  // activation pass.  highf32's products read the activations' TF32 hi and
  // lo planes (nxt and lo) and write cur, bfloat16's the bf16 plane (at
  // nxt, the weights bf16 (out, in)); float32 products read cur and write
  // nxt, and the pass works in place.
  for (int l = 0; l < n_hidden; ++l) {
    if constexpr (P == kHighF32) {
      dense_planes(hidden.w[l], hidden.b[l], nxt, lo, cur, H, H, M, R, S);
    } else if constexpr (P == kBFloat16) {
      dense_bf16(reinterpret_cast<const __nv_bfloat16*>(hidden.w[l]), hidden.b[l],
                 reinterpret_cast<const __nv_bfloat16*>(nxt), cur, H, H, M, R, S);
    } else {
      dense_rows(hidden.w[l], hidden.b[l], cur, nxt, H, H, M, R, S);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncthreads();
    for (GridWalk gw(H); gw.r < R;) {
      const int o1 = gw.r * S + gw.j;
      gw.next();
      const int o2 = gw.r < R ? gw.r * S + gw.j : o1;
      gw.next();
      activate_cells<P>(act, cur, nxt, lo, o1, o2, chains, rs);
    }
    __syncthreads();
  }
  // The output layer into a compact (M, d_out) tile over the buffer the
  // last product read (float32) or the pre-activations (highf32, bfloat16;
  // bfloat16's w_out bf16 (H, D)).
  float* net = P != kFloat32 ? cur : nxt;
  if constexpr (P == kHighF32) {
    dense_out<kHighF32>(w_out, b_out, nxt, lo, net, H, d_out, M, R, S);
  } else if constexpr (P == kBFloat16) {
    dense_out_bf16(reinterpret_cast<const __nv_bfloat16*>(w_out), b_out,
                   reinterpret_cast<const __nv_bfloat16*>(nxt), net, H, d_out, M, R, S);
  } else {
    dense_out<kFloat32>(w_out, b_out, cur, nullptr, net, H, d_out, M, R, S);
  }
  __syncthreads();

  const float c0 = c0c1[0];
  const float c1 = c0c1[1];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int row = row0 + r;
    if (row >= B) break;
    const float* y = net + r * d_out;
    for (int d = 0; d < d_out; ++d)
      drift[(size_t)row * d_out + d] = c0 * xs[r * d_in + d] + c1 * y[d];
    if (mode == kHutchinson) {
      const float* je = net + (R + r) * d_out;
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
      for (int d = 0; d < d_out; ++d) acc += net[((1 + d) * R + r) * d_out + d];
      div[row] = c0 * (float)d_out + c1 * acc;
    } else if (mode == kTangents) {
      for (int k = 0; k < n_tan; ++k) {
        const float* v = es + r * pw + k * d_out;
        const float* jv = net + ((1 + k) * R + r) * d_out;
        float* out = div + ((size_t)k * B + row) * d_out;
        for (int d = 0; d < d_out; ++d) out[d] = c0 * v[d] + c1 * jv[d];
      }
    }
  }
}

template <int P>
cudaError_t launch(const float* x, const float* e, const float* w_in, const float* b_eff,
                   const HiddenLayers& hidden, int n_hidden, const float* w_out,
                   const float* b_out, const float* c0c1, float* drift, float* div, int B,
                   int d_in, int d_out, int H, int mode, int act, int n_tan, int rows,
                   size_t smem, cudaStream_t stream) {
  const cudaError_t st = allow_smem(fused_mlp_kernel<P>, smem);
  if (st != cudaSuccess) return st;
  const int grid = (B + rows - 1) / rows;
  fused_mlp_kernel<P><<<grid, kThreads, smem, stream>>>(
      x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in,
      d_out, H, mode, act, n_tan, rows);
  return cudaGetLastError();
}

// Resident blocks an SM of an instantiation at `smem` bytes, and its
// registers and local memory a thread.
template <int P>
cudaError_t query(size_t smem, int* blocks, int* regs, int* local_bytes) {
  cudaError_t st = allow_smem(fused_mlp_kernel<P>, smem);
  if (st != cudaSuccess) return st;
  st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fused_mlp_kernel<P>, kThreads, smem);
  if (st != cudaSuccess) return st;
  cudaFuncAttributes attr;
  st = cudaFuncGetAttributes(&attr, fused_mlp_kernel<P>);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return st;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// w_hidden/b_hidden are host arrays of n_hidden device pointers, each weight
// 16-byte aligned.  `precision` is the compute mode: 0 float32, 1 highf32,
// 2 bfloat16; in bfloat16 w_in holds bf16-rounded floats, each hidden weight
// is bf16 of shape (H_out, H_in) (transposed) and w_out bf16 (H, d_out).
// `rows` must be a multiple of 4 and H of 4, of 8 in highf32, of 16 in
// bfloat16 (the Python wrapper checks all of them).  `n_tan` is the probe
// count of mode tangents (ignored otherwise).  `smem` is the block's shared
// memory in bytes, computed by the wrapper for the layout the kernel uses:
// 2 (float32) or 3 (highf32) x chains x rows x (H + 4) floats, or in
// bfloat16 chains x rows x (H + 8) floats and as many bf16 values, then
// rows x (d_in + d_out max(1, n_tan)) floats.
int ff_fused_mlp(const float* x, const float* e, const float* w_in, const float* b_eff,
                 const float* const* w_hidden, const float* const* b_hidden, int n_hidden,
                 const float* w_out, const float* b_out, const float* c0c1,
                 float* drift, float* div, int B, int d_in, int d_out, int H, int mode,
                 int act, int precision, int n_tan, int rows, size_t smem, void* stream) {
  if (n_hidden < 0 || n_hidden > kMaxHidden || rows % kMinRowTile != 0 || H % 4 != 0 || B <= 0 ||
      mode < kForward || mode > kTangents || (mode == kTangents && n_tan < 1) || precision < kFloat32 ||
      precision > kBFloat16 || (precision == kHighF32 && H % 8 != 0) || (precision == kBFloat16 && H % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  HiddenLayers hidden = {};
  for (int i = 0; i < n_hidden; ++i) {
    hidden.w[i] = w_hidden[i];
    hidden.b[i] = b_hidden[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precision == kHighF32) {
    return (int)launch<kHighF32>(x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in,
                                 d_out, H, mode, act, n_tan, rows, smem, st);
  }
  if (precision == kBFloat16) {
    return (int)launch<kBFloat16>(x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in,
                                  d_out, H, mode, act, n_tan, rows, smem, st);
  }
  return (int)launch<kFloat32>(x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in,
                               d_out, H, mode, act, n_tan, rows, smem, st);
}

// The blocks of kThreads an SM is to hold by the launch bounds: the wrapper
// plans with it.
int ff_fused_mlp_min_blocks() { return kMinBlocks; }

// Resident blocks an SM, registers and local-memory bytes a thread of the
// instantiation of compute mode `precision` launched with `smem` bytes;
// returns the cudaError_t of the query.
int ff_fused_mlp_occupancy(int precision, size_t smem, int* blocks, int* regs, int* local_bytes) {
  if (precision < kFloat32 || precision > kBFloat16) return (int)cudaErrorInvalidValue;
  return (int)(precision == kHighF32    ? query<kHighF32>(smem, blocks, regs, local_bytes)
               : precision == kBFloat16 ? query<kBFloat16>(smem, blocks, regs, local_bytes)
                                        : query<kFloat32>(smem, blocks, regs, local_bytes));
}

}  // extern "C"
