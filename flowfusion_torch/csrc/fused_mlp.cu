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
// What the design does about it (the shared-memory forms; the row-tiled
// form, for the widest nets, follows fused_mlp_kernel).  A block owns a
// tile of R rows and keeps
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
//     two thirds of float32's.  Where the planes do not fit, the plan drops
//     them (kPlanes false): the activation pass writes fp32 activations
//     in place, as float32 does, and the product splits each A value as it
//     loads the fragment, by the same cvt.rna hi and __fsub_rn remainder
//     the pass writes to the planes, so its operands and outputs are the
//     planes plan's bit for bit, at float32's footprint.
//   - Chain groups: a pass carries the primal and up to `group` tangent
//     chains through the layers and writes their output-layer columns,
//     then the next pass takes the next group, the primal recomputed (so
//     the footprint does not grow with depth, and no pass keeps act' of a
//     layer); a tangents pass loads its group's probes only.  The plan
//     (kernels/fused_mlp.py::_plan) takes every tangent chain in one pass
//     wherever that fits, and groups only where it does not (exact and
//     tangents at the widest nets).  A product row's sum reads no other row
//     (every row one fmaf chain, or one mma.sync row), and the exact
//     divergence is summed over d = 0 .. D-1 in order across the passes, so
//     a row's outputs do not depend on the group.
//   - The wide plans (grouped, or highf32 without its planes) fit one block
//     of 4 rows an SM by their shared memory, so they launch instantiations
//     of their own (kWide), bounded to one block an SM: the pass loop and
//     the split on load then take what registers they need without
//     spilling, and the plans that fit today launch today's
//     instantiations, one pass and no loop.
//   - bfloat16 products (mlp_tile.cuh dense_bf16): the activation pass writes one bf16
//     plane of act(a) and of each tangent chain (rows H + 8 values apart,
//     so a warp's A-fragment words fall on 32 distinct banks), which the
//     product reads as packed pairs; the wrapper hands the hidden weights
//     over transposed, (out, in), so a B fragment's two k values are one
//     32-bit load.  The plane is 2 bytes a value, so these plans hold more
//     rows than float32's.  Not here: the weights staged in shared memory
//     (the row-tiled form below stages them), TMA, wgmma.
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
// A value is split here; with kSplit, A is the fp32 activations at `hi`
// (lo unused), each value split as the fragment is loaded, into the halves
// the planes would hold.  A warp owns NT = kNTiles n-tiles (8 columns each)
// across up to MT = 8 / NT m-tiles (16 rows each; every m-tile of the block
// where M <= 16 MT): per k-step of 8 it loads and splits its NT weight fragments
// once and issues lo.hi, hi.lo, hi.hi into each of its MT x NT
// accumulators, the order of the one-strip form (mlp_tile.cuh
// dense_tf32x3), so every output is bitwise that form's.  Fragment layout
// as there (g = lane / 4, t = lane % 4); rows past M read row M - 1 and
// store nothing.  K and N are multiples of 8.
template <bool kSplit>
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
        unsigned ahi[4], alo[4];
        if constexpr (kSplit) {
          const float av[4] = {hi[r0], hi[r1], hi[r0 + 4], hi[r1 + 4]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float h, l;
            split_tf32(av[i], h, l);
            ahi[i] = __float_as_uint(h);
            alo[i] = __float_as_uint(l);
          }
        } else {
          const int o[4] = {r0, r1, r0 + 4, r1 + 4};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ahi[i] = __float_as_uint(hi[o[i]]);
            alo[i] = __float_as_uint(lo[o[i]]);
          }
        }
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
// (fma_tf32x3's arithmetic), A's halves read from the planes, or with
// kSplit split from the fp32 activations at `a` as they are read
// (bfloat16 has dense_out_bf16).  `out` is compact, (M, N).  Block `part`
// of `parts` that share the outputs (a cluster's) takes every parts-th run
// of kThreads of them.
template <int P, bool kSplit = false>
__device__ void dense_out(const float* __restrict__ w, const float* __restrict__ bias, const float* a,
                          const float* a_lo, float* out, int K, int N, int M, int R, int S, int part = 0,
                          int parts = 1) {
  for (int it = part * kThreads + threadIdx.x; it < M * N; it += parts * kThreads) {
    const int m = it / N;
    const int j = it - m * N;
    const float* in = a + (size_t)m * S;
    float acc = 0.0f;
    if constexpr (P == kHighF32 && kSplit) {
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        float ah, al, bh, bl;
        split_tf32(in[k], ah, al);
        split_tf32(__ldg(w + (size_t)k * N + j), bh, bl);
        acc = fmaf(ah, bh, fmaf(ah, bl, fmaf(al, bh, acc)));
      }
    } else if constexpr (P == kHighF32) {
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
// chain (c = 0) projects [x | cond] and adds b_eff; tangent chain c of a
// pass is tangent t0 + c - 1 of the row: a probe (Hutchinson, or tangent k;
// the pass's probes at es, pws values a row) has no conditional components
// and projects through rows 0..D-1 only; the exact basis tangent e_d is row
// d of w_in.  In bfloat16 w_in holds bf16
// values (the wrapper rounds it) and an input of more than kRank1Max
// features is rounded too, as the JAX kernel's in_proj_rows projects it
// through its bf16 product.
template <int P>
__device__ __forceinline__ float input_cell(int c, int t0, int r, int j, int mode, const float* xs, const float* es,
                                            const float* __restrict__ w_in, const float* __restrict__ b_eff,
                                            int d_in, int d_out, int pws, int H) {
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
    const float* p = es + r * pws + (c - 1) * d_out;
    if (P == kHighF32 && d_out > kRank1Max) {
      for (int k = 0; k < d_out; ++k) v = fma_tf32x3(p[k], __ldg(w_in + k * H + j), v);
    } else if (P == kBFloat16 && d_out > kRank1Max) {
      for (int k = 0; k < d_out; ++k) v = fmaf(round_bf16(p[k]), __ldg(w_in + k * H + j), v);
    } else {
      for (int k = 0; k < d_out; ++k) v = fmaf(p[k], __ldg(w_in + k * H + j), v);
    }
  } else {
    v = __ldg(w_in + (t0 + c - 1) * H + j);
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

// Where the activation pass writes an activation value: fp32 in place in
// the pre-activation buffer (float32, and highf32 without its planes), its
// TF32 hi and lo halves in the planes (highf32), or rounded into the bf16
// plane (bfloat16).
enum Store { kFp32 = 0, kTF32Planes = 1, kBF16Plane = 2 };

// Store an activation value at o: in cur, as hi and lo halves, or rounded
// into the bf16 plane (at hi), by the store kind ST.
template <int ST>
__device__ __forceinline__ void store_act(float v, float* cur, float* hi, float* lo, int o) {
  if constexpr (ST == kTF32Planes) {
    split_tf32(v, hi[o], lo[o]);
  } else if constexpr (ST == kBF16Plane) {
    reinterpret_cast<__nv_bfloat16*>(hi)[o] = __float2bfloat16_rn(v);
  } else {
    cur[o] = v;
  }
}

// The activation of two cells o1, o2 of every chain (o2 may repeat o1) from
// their pre-activations in cur: act(a) on the primal chain, each tangent
// chain times act'(a), stored by store_act.  Every value of a chain is
// loaded before it is stored, so the two cells' latencies overlap.
template <int P, int ST>
__device__ __forceinline__ void activate_cells(int act, float* cur, float* hi, float* lo, int o1, int o2,
                                               int chains, int rs) {
  float h1, d1, h2, d2;
  act_cell<P>(act, cur[o1], h1, d1);
  act_cell<P>(act, cur[o2], h2, d2);
  for (int c = 1; c < chains; ++c) {
    const float t1 = cur[c * rs + o1], t2 = cur[c * rs + o2];
    store_act<ST>(__fmul_rn(t1, d1), cur, hi, lo, c * rs + o1);
    store_act<ST>(__fmul_rn(t2, d2), cur, hi, lo, c * rs + o2);
  }
  store_act<ST>(h1, cur, hi, lo, o1);
  store_act<ST>(h2, cur, hi, lo, o2);
}

// The outputs of row r of a tile (batch row `row`) once pass `pass` has
// written the tile's compact (chains R, d_out) output layer `net`: the drift
// (first pass), the Hutchinson divergence, the exact divergence's sum over
// d = 0 .. D-1 in order across the passes (`exact_sum`, the thread's), or
// the pass's J v columns.  Both kernels' forms call it, so their rows agree.
__device__ __forceinline__ void finish_row(int r, int row, int pass, int passes, int t0, int chains, int mode,
                                           int R, int B, int d_in, int d_out, int pws, const float* net,
                                           const float* xs, const float* es, float c0, float c1, float* drift,
                                           float* div, float& exact_sum) {
  if (pass == 0) {
    const float* y = net + r * d_out;
    for (int d = 0; d < d_out; ++d) drift[(size_t)row * d_out + d] = c0 * xs[r * d_in + d] + c1 * y[d];
  }
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
    for (int d = t0; d < t0 + chains - 1; ++d) exact_sum += net[((1 + d - t0) * R + r) * d_out + d];
    if (pass == passes - 1) div[row] = c0 * (float)d_out + c1 * exact_sum;
  } else if (mode == kTangents) {
    for (int k = t0; k < t0 + chains - 1; ++k) {
      const float* v = es + r * pws + (k - t0) * d_out;
      const float* jv = net + ((1 + k - t0) * R + r) * d_out;
      float* out = div + ((size_t)k * B + row) * d_out;
      for (int d = 0; d < d_out; ++d) out[d] = c0 * v[d] + c1 * jv[d];
    }
  }
}

// div: (B,) in modes hutchinson and exact; in mode tangents the (n_tan, B,
// d_out) columns J v_k.  e: (B, d_out) in mode hutchinson, (B, n_tan, d_out)
// in mode tangents.  `group`: the tangent chains a pass carries, 0 for all
// of them in one pass (the only form of the instantiations that are not
// kWide); the passes take the tangents in order, group by group, and a
// tangents pass loads its group's probes.
template <int P, bool kPlanes, bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : kMinBlocks)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ e,
                 const float* __restrict__ w_in, const float* __restrict__ b_eff,
                 HiddenLayers hidden, int n_hidden,
                 const float* __restrict__ w_out, const float* __restrict__ b_out,
                 const float* __restrict__ c0c1, float* __restrict__ drift,
                 float* __restrict__ div, int B, int d_in, int d_out, int H,
                 int mode, int act, int n_tan, int R, int group) {
  constexpr int ST = P == kBFloat16 ? kBF16Plane : (P == kHighF32 && kPlanes) ? kTF32Planes : kFp32;
  // float32 and highf32 without planes: the products read cur and write
  // nxt, the buffers swap, and the activation pass works in place
  constexpr bool kSwap = ST == kFp32;
  extern __shared__ __align__(16) float smem[];
  const int n_t = mode == kForward ? 0 : mode == kHutchinson ? 1 : mode == kExact ? d_out : n_tan;  // tangents
  const int gsize = group > 0 ? group : n_t;                   // tangent chains a pass carries
  const int pw = mode == kTangents ? n_tan * d_out : d_out;  // probe values a row
  const int pws = mode == kTangents ? gsize * d_out : d_out;   // the probe tile's, a pass's
  const int S = H + (P == kBFloat16 ? kPadBF16 : kPad);
  const int M_max = (1 + gsize) * R;  // the widest pass's rows
  const int rs = R * S;
  // float32 and highf32 without planes: cur and nxt, the double buffer of
  // pre-activations and activations; highf32: the pre-activations and the
  // TF32 hi and lo planes of the activations; bfloat16: the pre-activations
  // and (at nxt) the bf16 plane of the activations, M S values of 2 bytes.
  // M_max rows of stride S each.
  float* const buf0 = smem;
  float* const buf1 = smem + M_max * S;
  float* lo = smem + 2 * M_max * S;  // highf32 with planes only
  // (R, d_in) input tile
  float* xs = smem + (ST == kTF32Planes ? 3 * M_max * S : P == kBFloat16 ? M_max * S + M_max * S / 2 : 2 * M_max * S);
  float* es = xs + R * d_in;                // (R, pws) probe tile
  const int row0 = blockIdx.x * R;

  // Rows past B (the ragged last tile) compute on zeros and are not stored.
  for (int i = threadIdx.x; i < R * d_in; i += kThreads) {
    xs[i] = (size_t)row0 * d_in + i < (size_t)B * d_in ? x[(size_t)row0 * d_in + i] : 0.0f;
  }

  const float c0 = c0c1[0];
  const float c1 = c0c1[1];
  // the exact divergence's sum of a row (this thread's, r = threadIdx.x <
  // R), over d = 0 .. D-1 in order across the passes
  float exact_sum = 0.0f;
  const int passes = kWide && n_t > 0 ? (n_t + gsize - 1) / gsize : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const int t0 = pass * gsize;              // the pass's first tangent
    const int chains = 1 + min(gsize, n_t - t0);
    const int M = chains * R;
    float* cur = buf0;
    float* nxt = buf1;
    if (mode == kHutchinson || mode == kTangents) {
      // the pass's probes, tangents t0 .. t0 + chains - 2 of each row
      const int gw = (chains - 1) * d_out;
      for (int i = threadIdx.x; i < R * gw; i += kThreads) {
        const int r = i / gw;
        const int q = i - r * gw;
        es[r * pws + q] = row0 + r < B ? e[(size_t)(row0 + r) * pw + t0 * d_out + q] : 0.0f;
      }
    }
    __syncthreads();

    // Input layer and its activation, two cells (r, j) a thread at a time,
    // every chain of a cell, in registers: act(a) of the primal, each
    // tangent chain's projection times act'(a).
    for (GridWalk gw(H); gw.r < R;) {
      const int r1 = gw.r, j1 = gw.j;
      gw.next();
      const bool two = gw.r < R;  // else the second cell repeats the first
      const int r2 = two ? gw.r : r1, j2 = two ? gw.j : j1;
      gw.next();
      const int o1 = r1 * S + j1, o2 = r2 * S + j2;
      const float a1 = input_cell<P>(0, t0, r1, j1, mode, xs, es, w_in, b_eff, d_in, d_out, pws, H);
      const float a2 = input_cell<P>(0, t0, r2, j2, mode, xs, es, w_in, b_eff, d_in, d_out, pws, H);
      float h1, d1, h2, d2;
      act_cell<P>(act, a1, h1, d1);
      act_cell<P>(act, a2, h2, d2);
      for (int c = 1; c < chains; ++c) {
        const float t1 = input_cell<P>(c, t0, r1, j1, mode, xs, es, w_in, b_eff, d_in, d_out, pws, H);
        const float t2 = input_cell<P>(c, t0, r2, j2, mode, xs, es, w_in, b_eff, d_in, d_out, pws, H);
        store_act<ST>(__fmul_rn(t1, d1), cur, nxt, lo, c * rs + o1);
        store_act<ST>(__fmul_rn(t2, d2), cur, nxt, lo, c * rs + o2);
      }
      store_act<ST>(h1, cur, nxt, lo, o1);
      store_act<ST>(h2, cur, nxt, lo, o2);
    }
    __syncthreads();

    // Each hidden layer: the product into the next pre-activations, then
    // the activation pass.  highf32's products read the activations' TF32
    // hi and lo planes (nxt and lo) and write cur, bfloat16's the bf16
    // plane (at nxt, the weights bf16 (out, in)); float32 products, and
    // highf32's without planes (splitting as they load), read cur and write
    // nxt, and the pass works in place.
    for (int l = 0; l < n_hidden; ++l) {
      if constexpr (ST == kTF32Planes) {
        dense_planes<false>(hidden.w[l], hidden.b[l], nxt, lo, cur, H, H, M, R, S);
      } else if constexpr (P == kBFloat16) {
        dense_bf16(reinterpret_cast<const __nv_bfloat16*>(hidden.w[l]), hidden.b[l],
                   reinterpret_cast<const __nv_bfloat16*>(nxt), cur, H, H, M, R, S);
      } else {
        if constexpr (P == kHighF32) {
          dense_planes<true>(hidden.w[l], hidden.b[l], cur, nullptr, nxt, H, H, M, R, S);
        } else {
          dense_rows(hidden.w[l], hidden.b[l], cur, nxt, H, H, M, R, S);
        }
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
        activate_cells<P, ST>(act, cur, nxt, lo, o1, o2, chains, rs);
      }
      __syncthreads();
    }
    // The output layer into a compact (M, d_out) tile over the buffer the
    // last product read (float32, highf32 without planes) or the
    // pre-activations (highf32, bfloat16; bfloat16's w_out bf16 (H, D)).
    float* net = kSwap ? nxt : cur;
    if constexpr (ST == kTF32Planes) {
      dense_out<kHighF32>(w_out, b_out, nxt, lo, net, H, d_out, M, R, S);
    } else if constexpr (P == kBFloat16) {
      dense_out_bf16(reinterpret_cast<const __nv_bfloat16*>(w_out), b_out,
                     reinterpret_cast<const __nv_bfloat16*>(nxt), net, H, d_out, M, R, S);
    } else {
      dense_out<P, true>(w_out, b_out, cur, nullptr, net, H, d_out, M, R, S);
    }
    __syncthreads();

    for (int r = threadIdx.x; r < R && row0 + r < B; r += kThreads) {
      finish_row(r, row0 + r, pass, passes, t0, chains, mode, R, B, d_in, d_out, pws, net, xs, es, c0, c1, drift,
                 div, exact_sum);
    }
    __syncthreads();  // the next pass writes the buffers this one read
  }
}

// ---------------------------------------------------------------------------
// The row-tiled form.  Where the shared-memory plans hold few rows a block
// (4 or 8 at the widest nets, one block an SM), each block reads every
// (H, H) weight again for those few rows: at H = 3,072 and 4 rows a block a
// hutchinson launch over 50,000 rows streams ~944 GB of weights.  Here a
// cluster of G blocks (1, 2, 4 or 8: the wrapper's choice by B, so that the
// card fills at 4,096 rows as at 50,000) carries a tile of kTileRows = 128
// rows, with every chain of its pass, through every layer.  The tile's
// layer buffers live in the cluster's slot of a device-memory workspace: a
// persistent grid whose clusters walk the tiles, so the workspace is one
// grid's slots whatever B.  Each layer is the product of the tile's
// (chains x 128, H) activations by the (H, H) weight, cut in 128 x 128
// output units that the cluster's blocks share; a unit stages 32-deep
// K-tiles of its activations and of the weight in shared memory with
// cp.async, three stages in flight, and all 128 of its rows read each
// staged weight value: against a shared-memory plan of R rows and `chains`
// chains the weight bytes a launch fall by 128 / (R chains), 16x for
// hutchinson at H = 3,072.
// Between a layer's products, its activation pass and the next layer, the
// cluster meets at its barrier (release and acquire at cluster scope),
// since each block reads what the others wrote.
// Every output keeps the shared-memory forms' arithmetic, so a row's
// outputs equal theirs bit for bit: each float32 output one fmaf chain over
// k = 0 .. K-1 from 0 (the accumulator kept across K-tiles), then + bias;
// highf32 each k-step of 8 the same three mma.sync (lo.hi, hi.lo, hi.hi)
// on the same TF32 halves, split as the fragment is loaded (the plane-free
// plan's); bfloat16 m16n8k16 into one accumulator in k order; the input
// layer, the activation passes, the output layer and each row's outputs
// through the same functions as the shared-memory forms.  Not taken: wgmma
// (its k order is not mma.sync's), TMA.

constexpr int kTileRows = 128;  // rows of a tile (R): chains x 128 product rows
constexpr int kBM = 128;        // a unit's rows
constexpr int kBN = 128;        // a unit's columns
constexpr int kBK = 32;         // the depth of a staged K-tile
constexpr int kStages = 3;      // staged K-tiles in flight
// Row strides of the staged tiles: fp32 activations kBK + 4 floats (rows 4
// banks apart: a warp's fragment reads fall on 32 distinct banks), fp32
// weights kBN + 8 (k rows 8 banks apart), bf16 rows kBK + 8 values (20
// words apart: the fragment words on 32 distinct banks).
constexpr int kAStride = kBK + 4;
constexpr int kWStride = kBN + 8;
constexpr int kStride16 = kBK + 8;
constexpr int kStageFloats = kBM * kAStride + kBK * kWStride;  // 35,840 bytes; bf16 uses 20,480 of them

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage K-tile k0 of unit (m0, n0): A (rows m0.., stride H; fp32, or the
// bf16 plane) and the weight (fp32 (in, out), or bf16 transposed (out,
// in)).  Past K or N the tile is zero-filled, and no stored output reads it.
template <int P>
__device__ __forceinline__ void load_stage(float* st, const void* A, const void* W, int H, int m0, int n0, int k0) {
  if constexpr (P == kBFloat16) {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(W);
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* ws = as + kBM * kStride16;
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i >> 2, ch = (i & 3) * 8;
      const bool ok = k0 + ch < H;
      cp_async16(as + r * kStride16 + ch, ok ? a + (size_t)(m0 + r) * H + k0 + ch : a, ok);
    }
    for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
      const int n = i >> 2, ch = (i & 3) * 8;
      const bool ok = n0 + n < H && k0 + ch < H;
      cp_async16(ws + n * kStride16 + ch, ok ? w + (size_t)(n0 + n) * H + k0 + ch : w, ok);
    }
  } else {
    const float* a = static_cast<const float*>(A);
    const float* w = static_cast<const float*>(W);
    float* as = st;
    float* ws = st + kBM * kAStride;
    for (int i = threadIdx.x; i < kBM * (kBK / 4); i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 4;
      const bool ok = k0 + ch < H;
      cp_async16(as + r * kAStride + ch, ok ? a + (size_t)(m0 + r) * H + k0 + ch : a, ok);
    }
    for (int i = threadIdx.x; i < kBK * (kBN / 4); i += kThreads) {
      const int k = i >> 5, ch = (i & 31) * 4;
      const bool ok = k0 + k < H && n0 + ch < H;
      cp_async16(ws + k * kWStride + ch, ok ? w + (size_t)(k0 + k) * H + n0 + ch : w, ok);
    }
  }
}

// One 128 x 128 output unit (m0, n0) of C = A W (+ bias on the primal rows
// m < R): every K-tile staged once through the ring, the accumulators kept
// across K-tiles, then stored to C (stride H).  float32: a thread owns rows
// ty + 16 i (i < 8) by columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. (ty =
// tid / 16, tx = tid % 16); highf32 and bfloat16: a warp owns 64 rows (4
// m-tiles) by 32 columns (4 n-tiles) of mma.sync fragments, laid out as
// dense_planes and dense_bf16 read theirs.
template <int P>
__device__ void product_unit(const void* A, const void* W, const float* __restrict__ bias, float* C, int H, int m0,
                             int n0, int R, float* stage) {
  constexpr int NA = P == kFloat32 ? 8 : 4;  // float32: rows; mma: m-tiles
  constexpr int NB = P == kFloat32 ? 8 : 4;  // float32: columns; mma: n-tiles
  constexpr int NC = P == kFloat32 ? 1 : 4;  // mma: a fragment's four values
  float acc[NA][NB][NC];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][j][c] = 0.0f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = (H + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<P>(stage + s * kStageFloats, A, W, H, m0, n0, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // K-tile kt is in, and every warp is done with the stage refilled next
    const int nx = kt + kStages - 1;
    if (nx < nk) load_stage<P>(stage + (nx % kStages) * kStageFloats, A, W, H, m0, n0, nx * kBK);
    cp_async_commit();
    const float* st = stage + (kt % kStages) * kStageFloats;
    const int kmax = min(kBK, H - kt * kBK);
    if constexpr (P == kFloat32) {
      const float* as = st;
      const float* ws = st + kBM * kAStride;
      for (int kk = 0; kk < kmax; kk += 4) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kAStride + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w0 = *reinterpret_cast<const float4*>(ws + (kk + q) * kWStride + 4 * tx);
          const float4 w1 = *reinterpret_cast<const float4*>(ws + (kk + q) * kWStride + 64 + 4 * tx);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j][0] = fmaf(av, wv[j], acc[i][j][0]);
          }
        }
      }
    } else if constexpr (P == kHighF32) {
      const float* as = st;
      const float* ws = st + kBM * kAStride;
      for (int ks = 0; ks < kmax; ks += 8) {
        unsigned ahi[4][4], alo[4][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const float* r0 = as + (wm * 64 + mt * 16 + g) * kAStride + ks + t;
          const float* r1 = r0 + 8 * kAStride;
          const float av[4] = {r0[0], r1[0], r0[4], r1[4]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float h, l;
            split_tf32(av[i], h, l);
            ahi[mt][i] = __float_as_uint(h);
            alo[mt][i] = __float_as_uint(l);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* c = ws + (ks + t) * kWStride + wn * 32 + nt * 8 + g;
          const float bv[2] = {c[0], c[4 * kWStride]};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float h, l;
            split_tf32(bv[i], h, l);
            bhi[nt][i] = __float_as_uint(h);
            blo[nt][i] = __float_as_uint(l);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(acc[mt][nt], alo[mt], bhi[nt]);
            mma_tf32(acc[mt][nt], ahi[mt], blo[nt]);
            mma_tf32(acc[mt][nt], ahi[mt], bhi[nt]);
          }
      }
    } else {
      const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* ws = as + kBM * kStride16;
      for (int ks = 0; ks < kmax; ks += 16) {
        unsigned af[4][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = wm * 64 + mt * 16 + g;
          const unsigned* p0 = reinterpret_cast<const unsigned*>(as + r * kStride16 + ks + 2 * t);
          const unsigned* p1 = reinterpret_cast<const unsigned*>(as + (r + 8) * kStride16 + ks + 2 * t);
          af[mt][0] = p0[0];
          af[mt][1] = p1[0];
          af[mt][2] = p0[4];
          af[mt][3] = p1[4];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const unsigned* col =
              reinterpret_cast<const unsigned*>(ws + (wn * 32 + nt * 8 + g) * kStride16 + ks + 2 * t);
          bf[nt][0] = col[0];
          bf[nt][1] = col[4];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
      }
    }
  }
  __syncthreads();  // the next unit's first stages overwrite this one's

  if constexpr (P == kFloat32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + 16 * i;
      const bool primal = m < R;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 64 * h + 4 * tx;
        if (n >= H) continue;
        float4 o;
        o.x = acc[i][4 * h][0] + (primal ? __ldg(bias + n) : 0.0f);
        o.y = acc[i][4 * h + 1][0] + (primal ? __ldg(bias + n + 1) : 0.0f);
        o.z = acc[i][4 * h + 2][0] + (primal ? __ldg(bias + n + 2) : 0.0f);
        o.w = acc[i][4 * h + 3][0] + (primal ? __ldg(bias + n + 3) : 0.0f);
        *reinterpret_cast<float4*>(C + (size_t)m * H + n) = o;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * t;
      if (n >= H) continue;
      const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r0 = m0 + wm * 64 + mt * 16 + g;
        const int r1 = r0 + 8;
        float2 o;
        o.x = acc[mt][nt][0] + (r0 < R ? b0 : 0.0f);
        o.y = acc[mt][nt][1] + (r0 < R ? b1 : 0.0f);
        *reinterpret_cast<float2*>(C + (size_t)r0 * H + n) = o;
        o.x = acc[mt][nt][2] + (r1 < R ? b0 : 0.0f);
        o.y = acc[mt][nt][3] + (r1 < R ? b1 : 0.0f);
        *reinterpret_cast<float2*>(C + (size_t)r1 * H + n) = o;
      }
    }
  }
}

// The cluster's barrier: every block of the cluster arrives (release at
// cluster scope) and waits (acquire), so what one block wrote to the
// workspace before it is visible to the others after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// The row-tiled kernel: fused_mlp_kernel's arguments and `ws`, the
// workspace, a slot a cluster of kTileRows (1 + group) (2 H + d_out) floats
// in float32 and highf32 (the two layer buffers, then the compact output
// layer) or kTileRows (1 + group) (H + H / 2 + d_out) in bfloat16 (the fp32
// pre-activations, the bf16 plane, the output layer), each of (1 + group)
// kTileRows rows.  Shared memory: the kStages K-tile ring, then the (R,
// d_in) input tile and the (R, pws) probe tile.  `group` as in
// fused_mlp_kernel (0: every tangent chain in one pass).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_tiled_kernel(const float* __restrict__ x, const float* __restrict__ e,
                       const float* __restrict__ w_in, const float* __restrict__ b_eff, HiddenLayers hidden,
                       int n_hidden, const float* __restrict__ w_out, const float* __restrict__ b_out,
                       const float* __restrict__ c0c1, float* __restrict__ drift, float* __restrict__ div,
                       float* __restrict__ ws, int B, int d_in, int d_out, int H, int mode, int act, int n_tan,
                       int group) {
  constexpr int ST = P == kBFloat16 ? kBF16Plane : kFp32;
  constexpr int R = kTileRows;
  const int G = cluster_blocks();
  const int rank = cluster_rank();
  const int cid = blockIdx.x / G;
  const int n_clusters = gridDim.x / G;
  const int n_t = mode == kForward ? 0 : mode == kHutchinson ? 1 : mode == kExact ? d_out : n_tan;
  const int gsize = group > 0 ? group : n_t;
  const int pw = mode == kTangents ? n_tan * d_out : d_out;
  const int pws = mode == kTangents ? gsize * d_out : d_out;
  const size_t plane = (size_t)(1 + gsize) * R * H;
  float* const slot = ws + (size_t)cid * R * (1 + gsize) * (P == kBFloat16 ? H + H / 2 + d_out : 2 * H + d_out);
  // float32, highf32: the two layer buffers; bfloat16: the pre-activations
  // and (at buf1) the bf16 plane of the activations
  float* const buf0 = slot;
  float* const buf1 = slot + plane;
  float* const net = P == kBFloat16 ? slot + plane + plane / 2 : slot + 2 * plane;
  extern __shared__ __align__(16) float smem[];
  float* const stage = smem;
  float* const xs = smem + kStages * kStageFloats;
  float* const es = xs + R * d_in;
  const float c0 = c0c1[0];
  const float c1 = c0c1[1];
  const int tiles = (B + R - 1) / R;
  const int passes = n_t > 0 ? (n_t + gsize - 1) / gsize : 1;
  const int RH = R * H;

  for (int tile = cid; tile < tiles; tile += n_clusters) {
    const int row0 = tile * R;
    for (int i = threadIdx.x; i < R * d_in; i += kThreads) {
      xs[i] = (size_t)row0 * d_in + i < (size_t)B * d_in ? x[(size_t)row0 * d_in + i] : 0.0f;
    }
    float exact_sum = 0.0f;
    for (int pass = 0; pass < passes; ++pass) {
      const int t0 = pass * gsize;
      const int chains = 1 + min(gsize, n_t - t0);
      const int M = chains * R;
      if (mode == kHutchinson || mode == kTangents) {
        const int gw = (chains - 1) * d_out;
        for (int i = threadIdx.x; i < R * gw; i += kThreads) {
          const int r = i / gw;
          const int q = i - r * gw;
          es[r * pws + q] = row0 + r < B ? e[(size_t)(row0 + r) * pw + t0 * d_out + q] : 0.0f;
        }
      }
      __syncthreads();

      // the input layer and its activation, the tile's cells (r, j) shared
      // out over the cluster, every chain of a cell on one thread
      float* cur = buf0;
      float* nxt = buf1;
      for (int i = rank * kThreads + threadIdx.x; i < RH; i += G * kThreads) {
        const int r = i / H, j = i - r * H;
        float h, d;
        act_cell<P>(act, input_cell<P>(0, t0, r, j, mode, xs, es, w_in, b_eff, d_in, d_out, pws, H), h, d);
        for (int c = 1; c < chains; ++c) {
          const float tc = input_cell<P>(c, t0, r, j, mode, xs, es, w_in, b_eff, d_in, d_out, pws, H);
          store_act<ST>(__fmul_rn(tc, d), cur, buf1, nullptr, c * RH + i);
        }
        store_act<ST>(h, cur, buf1, nullptr, i);
      }
      cluster_sync();

      for (int l = 0; l < n_hidden; ++l) {
        // float32, highf32: cur -> nxt, the pass in place, then a swap;
        // bfloat16: the plane -> the pre-activations, the pass back into it
        const void* A = P == kBFloat16 ? static_cast<const void*>(buf1) : static_cast<const void*>(cur);
        float* out = P == kBFloat16 ? buf0 : nxt;
        const int m_units = M / kBM, units = m_units * ((H + kBN - 1) / kBN);
        for (int u = rank; u < units; u += G) {  // a column's units in a row: they stage one weight slice
          const int nu = u / m_units;
          product_unit<P>(A, hidden.w[l], hidden.b[l], out, H, (u - nu * m_units) * kBM, nu * kBN, R, stage);
        }
        cluster_sync();
        for (int i = rank * kThreads + threadIdx.x; i < RH; i += G * kThreads) {
          float h, d;
          act_cell<P>(act, __ldcg(out + i), h, d);
          for (int c = 1; c < chains; ++c) {
            store_act<ST>(__fmul_rn(__ldcg(out + c * RH + i), d), out, buf1, nullptr, c * RH + i);
          }
          store_act<ST>(h, out, buf1, nullptr, i);
        }
        cluster_sync();
        if constexpr (P != kBFloat16) {
          float* tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
      }
      if constexpr (P == kBFloat16) {
        dense_out_bf16(reinterpret_cast<const __nv_bfloat16*>(w_out), b_out,
                       reinterpret_cast<const __nv_bfloat16*>(buf1), net, H, d_out, M, R, H, rank, G);
      } else {
        dense_out<P, true>(w_out, b_out, cur, nullptr, net, H, d_out, M, R, H, rank, G);
      }
      cluster_sync();
      if (rank == 0) {
        for (int r = threadIdx.x; r < R && row0 + r < B; r += kThreads) {
          finish_row(r, row0 + r, pass, passes, t0, chains, mode, R, B, d_in, d_out, pws, net, xs, es, c0, c1,
                     drift, div, exact_sum);
        }
      }
      cluster_sync();  // the next pass or tile writes what this one read
    }
  }
}

cudaLaunchConfig_t tiled_config(int cluster, int clusters, size_t smem, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int P>
cudaError_t launch_tiled(const float* x, const float* e, const float* w_in, const float* b_eff,
                         const HiddenLayers& hidden, int n_hidden, const float* w_out, const float* b_out,
                         const float* c0c1, float* drift, float* div, float* ws, int B, int d_in, int d_out, int H,
                         int mode, int act, int n_tan, int group, int cluster, int clusters, size_t smem,
                         cudaStream_t stream) {
  const cudaError_t st = allow_smem(fused_mlp_tiled_kernel<P>, smem);
  if (st != cudaSuccess) return st;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = tiled_config(cluster, clusters, smem, stream, attr);
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, fused_mlp_tiled_kernel<P>, x, e, w_in, b_eff, hidden,
                                                  n_hidden, w_out, b_out, c0c1, drift, div, ws, B, d_in, d_out, H,
                                                  mode, act, n_tan, group);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// Clusters of `cluster` blocks at `smem` bytes that the card holds at once,
// and the tiled instantiation's registers and local-memory bytes a thread.
template <int P>
cudaError_t query_tiled(size_t smem, int cluster, int* clusters, int* regs, int* local_bytes) {
  cudaError_t st = allow_smem(fused_mlp_tiled_kernel<P>, smem);
  if (st != cudaSuccess) return st;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = tiled_config(cluster, 1, smem, nullptr, attr);
  st = cudaOccupancyMaxActiveClusters(clusters, fused_mlp_tiled_kernel<P>, &cfg);
  if (st != cudaSuccess) return st;
  cudaFuncAttributes fa;
  st = cudaFuncGetAttributes(&fa, fused_mlp_tiled_kernel<P>);
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return st;
}

using TiledLaunchFn = cudaError_t (*)(const float*, const float*, const float*, const float*, const HiddenLayers&,
                                      int, const float*, const float*, const float*, float*, float*, float*, int, int,
                                      int, int, int, int, int, int, int, int, size_t, cudaStream_t);
using TiledQueryFn = cudaError_t (*)(size_t, int, int*, int*, int*);
constexpr TiledLaunchFn kTiledLaunch[3] = {launch_tiled<kFloat32>, launch_tiled<kHighF32>, launch_tiled<kBFloat16>};
constexpr TiledQueryFn kTiledQuery[3] = {query_tiled<kFloat32>, query_tiled<kHighF32>, query_tiled<kBFloat16>};

template <int P, bool kPlanes, bool kWide>
cudaError_t launch(const float* x, const float* e, const float* w_in, const float* b_eff,
                   const HiddenLayers& hidden, int n_hidden, const float* w_out,
                   const float* b_out, const float* c0c1, float* drift, float* div, int B,
                   int d_in, int d_out, int H, int mode, int act, int n_tan, int rows, int group,
                   size_t smem, cudaStream_t stream) {
  const cudaError_t st = allow_smem(fused_mlp_kernel<P, kPlanes, kWide>, smem);
  if (st != cudaSuccess) return st;
  const int grid = (B + rows - 1) / rows;
  fused_mlp_kernel<P, kPlanes, kWide><<<grid, kThreads, smem, stream>>>(
      x, e, w_in, b_eff, hidden, n_hidden, w_out, b_out, c0c1, drift, div, B, d_in,
      d_out, H, mode, act, n_tan, rows, group);
  return cudaGetLastError();
}

// Resident blocks an SM of an instantiation at `smem` bytes, and its
// registers and local memory a thread.
template <int P, bool kPlanes, bool kWide>
cudaError_t query(size_t smem, int* blocks, int* regs, int* local_bytes) {
  cudaError_t st = allow_smem(fused_mlp_kernel<P, kPlanes, kWide>, smem);
  if (st != cudaSuccess) return st;
  st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fused_mlp_kernel<P, kPlanes, kWide>, kThreads, smem);
  if (st != cudaSuccess) return st;
  cudaFuncAttributes attr;
  st = cudaFuncGetAttributes(&attr, fused_mlp_kernel<P, kPlanes, kWide>);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return st;
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const float*, const float*, const HiddenLayers&, int,
                                 const float*, const float*, const float*, float*, float*, int, int, int, int, int,
                                 int, int, int, int, size_t, cudaStream_t);
using QueryFn = cudaError_t (*)(size_t, int*, int*, int*);

// The instantiations by (precision, planes, wide): float32, highf32 with
// its planes and bfloat16 at one pass of every chain, three blocks an SM,
// and each of them wide; highf32 without planes, wide only.  A plan is wide
// where it groups the tangent chains (group > 0) or drops the planes.
int instance(int precision, int planes, int group) {
  const bool wide = group > 0 || (precision == kHighF32 && !planes);
  if (precision == kHighF32) return planes ? (wide ? 3 : 2) : 4;
  return (precision == kFloat32 ? 0 : 5) + (wide ? 1 : 0);
}

constexpr LaunchFn kLaunch[7] = {launch<kFloat32, false, false>, launch<kFloat32, false, true>,
                                 launch<kHighF32, true, false>,  launch<kHighF32, true, true>,
                                 launch<kHighF32, false, true>,  launch<kBFloat16, false, false>,
                                 launch<kBFloat16, false, true>};
constexpr QueryFn kQuery[7] = {query<kFloat32, false, false>, query<kFloat32, false, true>,
                               query<kHighF32, true, false>,  query<kHighF32, true, true>,
                               query<kHighF32, false, true>,  query<kBFloat16, false, false>,
                               query<kBFloat16, false, true>};

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// `layers` is the layer table in device memory: n_hidden weight pointers,
// then n_hidden bias pointers, each weight 16-byte aligned.  `precision` is
// the compute mode: 0 float32, 1 highf32, 2 bfloat16; in bfloat16 w_in holds
// bf16-rounded floats, each hidden weight is bf16 of shape (H_out, H_in)
// (transposed) and w_out bf16 (H, d_out).  `rows` must be a multiple of 4
// and H of 4, of 8 in highf32, of 16 in bfloat16 (the Python wrapper checks
// all of them).  `n_tan` is the probe count of mode tangents (ignored
// otherwise).  `group` is the tangent chains a pass carries, 0 for every
// one in a single pass (always 0 in mode forward), `planes` whether highf32
// keeps its TF32 hi and lo planes (0 in the other modes).  `smem` is the
// block's shared memory in bytes, computed by the wrapper
// (kernels/fused_mlp.py::_smem_bytes) for the layout the kernel uses, with
// chains = 1 + the tangents a pass carries: 2 (float32, highf32 without planes) or 3 (highf32)
// x chains x rows x (H + 4) floats, or in bfloat16 chains x rows x (H + 8)
// floats and as many bf16 values, then rows x (d_in + d_out) floats, or in
// mode tangents rows x (d_in + d_out group) floats.
int ff_fused_mlp(const float* x, const float* e, const float* w_in, const float* b_eff,
                 const float* const* layers, int n_hidden, const float* w_out, const float* b_out,
                 const float* c0c1, float* drift, float* div, int B, int d_in, int d_out, int H, int mode,
                 int act, int precision, int n_tan, int rows, int group, int planes, size_t smem, void* stream) {
  const int n_t = mode == kForward ? 0 : mode == kHutchinson ? 1 : mode == kExact ? d_out : n_tan;
  if (n_hidden < 0 || (n_hidden > 0 && layers == nullptr) || rows % kMinRowTile != 0 || H % 4 != 0 || B <= 0 ||
      mode < kForward || mode > kTangents || (mode == kTangents && n_tan < 1) || precision < kFloat32 ||
      precision > kBFloat16 || (precision == kHighF32 && H % 8 != 0) || (precision == kBFloat16 && H % 16 != 0) ||
      group < 0 || group > n_t || (planes != 0 && precision != kHighF32)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)kLaunch[instance(precision, planes, group)](x, e, w_in, b_eff, hidden_layers(layers, n_hidden), n_hidden,
                                                   w_out, b_out, c0c1, drift, div, B, d_in, d_out, H, mode, act,
                                                   n_tan, rows, group, smem, static_cast<cudaStream_t>(stream));
}

// Launch the row-tiled form on `stream` (the arguments of ff_fused_mlp but
// `rows` and `planes`): `clusters` clusters of `cluster` blocks (1, 2, 4 or
// 8) walk the tiles of kTileRows rows, `ws` the workspace of a slot a
// cluster (kernels/fused_mlp.py::tiled_launch sizes both).  `group` is the
// tangent chains a pass carries, 0 for all of them.  `smem`: the kStages
// K-tile ring (kStages x 35,840 bytes), then kTileRows x (d_in + d_out)
// floats, or in mode tangents kTileRows x (d_in + d_out group) floats.
int ff_fused_mlp_tiled(const float* x, const float* e, const float* w_in, const float* b_eff,
                       const float* const* layers, int n_hidden, const float* w_out, const float* b_out,
                       const float* c0c1, float* drift, float* div, float* ws, int B, int d_in, int d_out, int H,
                       int mode, int act, int precision, int n_tan, int group, int cluster, int clusters, size_t smem,
                       void* stream) {
  const int n_t = mode == kForward ? 0 : mode == kHutchinson ? 1 : mode == kExact ? d_out : n_tan;
  if (n_hidden < 0 || (n_hidden > 0 && layers == nullptr) || H % 4 != 0 || B <= 0 || ws == nullptr ||
      mode < kForward || mode > kTangents || (mode == kTangents && n_tan < 1) || precision < kFloat32 ||
      precision > kBFloat16 || (precision == kHighF32 && H % 8 != 0) || (precision == kBFloat16 && H % 16 != 0) ||
      group < 0 || group > n_t || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || clusters < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)kTiledLaunch[precision](x, e, w_in, b_eff, hidden_layers(layers, n_hidden), n_hidden, w_out, b_out,
                                      c0c1, drift, div, ws, B, d_in, d_out, H, mode, act, n_tan, group, cluster,
                                      clusters, smem, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` blocks of the tiled form in compute mode
// `precision` at `smem` bytes that the card holds at once, and the
// instantiation's registers and local-memory bytes a thread; returns the
// cudaError_t of the query.
int ff_fused_mlp_tiled_occupancy(int precision, int cluster, size_t smem, int* clusters, int* regs,
                                 int* local_bytes) {
  if (precision < kFloat32 || precision > kBFloat16 || cluster < 1 || cluster > 8) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)kTiledQuery[precision](smem, cluster, clusters, regs, local_bytes);
}

// The row-tiled form's rows a tile and its K-tile ring's bytes: the wrapper
// plans with them.
int ff_fused_mlp_tile_rows() { return kTileRows; }
int ff_fused_mlp_tile_ring_bytes() { return kStages * kStageFloats * (int)sizeof(float); }

// The blocks of kThreads an SM is to hold by the launch bounds: the wrapper
// plans with it.
int ff_fused_mlp_min_blocks() { return kMinBlocks; }

// Resident blocks an SM, registers and local-memory bytes a thread of the
// instantiation a plan of compute mode `precision`, `planes` and `group`
// launches with `smem` bytes; returns the cudaError_t of the query.
int ff_fused_mlp_occupancy(int precision, int planes, int group, size_t smem, int* blocks, int* regs,
                           int* local_bytes) {
  if (precision < kFloat32 || precision > kBFloat16 || (planes != 0 && precision != kHighF32) || group < 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)kQuery[instance(precision, planes, group)](smem, blocks, regs, local_bytes);
}

}  // extern "C"
