// Forward Clenshaw-Curtis integral of the UMNN integrand MLP, one row per
// quadrature sum:
//
//   z_r = x_r/2 * sum_n w_n * ELU+1( MLP([x_r * s_n, h_r]) ),  s_n = (t_n+1)/2
//
// with LeakyReLU(neg_slope) between layers.
//
// Replaces the TPU kernel `_fwd_kernel` of umnn_tpu/ops/integrand_kernel.py
// (:106-153, launched by `_run_fwd` :920). Like it, the node-invariant part of
// the first layer, ph = [0, h] W1^T + b1, is computed once per row, and each
// node adds the rank-1 term x*s_n*W1[:, 0]; the node axis folds into the rows
// of every later matrix product. The TPU's 128-lane padding of features and
// weights is not carried over: the kernel reads x as [R], h as [R, e] and the
// real-size weights.
//
// Bound on an H100: operations. At the MNIST block shape (R = 78,400 rows,
// 51 nodes, widths 31-100-50-50-50-50-1) one sweep is about 101 GFLOP of
// useful float32 work with the once-per-row first layer, against about 10 MB
// of input and output: 1.5 ms at the 67 TFLOP/s float32 peak, 3 us at
// 3.35 TB/s.
//
// What the design does about that bound: plain float32 FMA on the CUDA cores
// (no TF32, no tensor cores), in a persistent grid of one 256-thread block per
// SM (8 warps, up to 255 registers each).
//   - Each block stages the hidden weights in shared memory once, then walks
//     row tiles of TR rows in a fixed order; each row is written by the one
//     block that owns its tile. TR*K (row, node) pairs go through the MLP in
//     pair tiles of MT; TR is chosen so that TR*K nearly fills a whole number
//     of pair tiles (MNIST: 20 rows, 1,020 pairs in 4 tiles of 256).
//   - Hidden products are shared-memory matrix products on register tiles of
//     8 pairs x TN outputs. At MT = 256 a warp owns one column group for all
//     256 pairs: its weight loads are broadcasts, its activation loads 16-byte
//     rows that a quarter warp reads side by side. A layer's columns are cut
//     into 8 groups of TN and TN - 1 with no padding (50 = 2 x 7 + 6 x 6, so
//     each scheduler's two warps take 13 or 12 columns), each group's weights
//     a [din][width] block, so that one 16-byte load brings 4 of its weights
//     and a thread loads 4 k's weights in TN loads before their FMAs.
//   - Layer 1 is built once per pair tile from ph, each thread 8 units of one
//     pair at a time, with 16-byte loads; each pair's (row, node) once per
//     tile.
//   - The output layer is fused into the last hidden product's epilogue: each
//     thread dots its columns with wout, and one thread per pair sums the
//     column groups' partials in a fixed order, then applies ELU+1 and w_n.
//     With one hidden layer, layer 1's build does this.
//   - Activation buffers are sized by the widths they hold (100 and 50 wide
//     at MNIST widths); the pair tile shrinks (256, 128, 64, 32) until the
//     layout fits 227 KB, so hidden widths up to 128 fit (31-128-128-1 at
//     256, 31-128-128-76-1 at 64).
//   - Each row's sum over the nodes is taken in one thread, in node order: no
//     atomics, no carry between blocks, so reruns are bit-identical.
// What is left (ops/fwd_phase_clock.py, MNIST block): the products take about
// 83% of the time and issue about one FMA every other cycle per scheduler
// however the tiles are shaped; one block of 8 warps per SM (the weights and
// two 256-pair buffers take 226,272 bytes at MNIST widths), five barriers per
// pair tile, and the once-per-row first layer read from global memory (about
// 6%).

#include "common.cuh"

namespace {

// Threads per block, and pairs per thread of a product's register tile.
constexpr int NTHREADS = 256;
constexpr int TM = 8;
constexpr int MAX_TN = 16;       // outputs per thread in a product
constexpr int MAX_MT = 256;      // pairs per tile, at most (NTHREADS: one thread per pair)
constexpr int MAX_TR = 64;       // rows per row tile, at most
constexpr int MAX_WIDTH = 128;   // hidden width
constexpr int MAX_FIRST = 1 << 30;  // 1 + e: h and W1's h part are read from global memory
constexpr long long SMEM_LIMIT = 232448;  // an H100 block's opt-in shared memory
static_assert(MAX_MT <= NTHREADS && MAX_MT % TM == 0, "a thread per pair in layer 1");

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes), and
// the tile sizes chosen for these widths and K.
struct Layout {
  int MT, TR, npart;  // pairs per tile, rows per row tile, partial rows of the output layer
  int w1x, b1, wout, bout, ph, ldph, xs, fw, s, ccw, part, buf[2], total;
  // per hidden layer: weights, bias, columns with padding, and its column
  // groups: ngroups of which the first nbig are tn wide and the rest tn - 1
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], ncol[MAX_LAYERS], tn[MAX_LAYERS];
  int ngroups[MAX_LAYERS], nbig[MAX_LAYERS];
};

inline Layout layout_for(const Dims& d, int K, int MT, int TR) {
  Layout L;
  const int nl = d.n_layers, H1 = d.w[1];
  const int ncg = NTHREADS * TM / MT;  // column groups when each thread takes one tile
  L.MT = MT;
  L.TR = TR;
  int off = 0;
  L.w1x = off;  off += round_up(H1, 4);  // W1[:, 0], x's column
  L.b1 = off;   off += round_up(H1, 4);
  int wout_len = H1, bufw[2] = {0, 0};
  for (int l = 1; l < nl - 1; ++l) {  // hidden: W^T by column group, b [ncol], zero-padded
    const int dout = d.w[l + 1];
    int tn = (dout + ncg - 1) / ncg;
    tn = tn < MAX_TN ? tn : MAX_TN;
    const int ng = (dout + tn - 1) / tn, nbig = dout - ng * (tn - 1);
    L.tn[l] = tn;
    L.ngroups[l] = ng;
    // groups of tn and tn - 1 columns that make up dout exactly (50: 2 x 7
    // and 6 x 6), else ng groups of tn over padded columns
    const bool exact = nbig > 0 && nbig <= ng;
    L.nbig[l] = exact ? nbig : ng;
    L.ncol[l] = exact ? dout : ng * tn;
    L.hid_w[l] = off;  off += L.nbig[l] * round_up(d.w[l] * tn, 4) +
                              (ng - L.nbig[l]) * round_up(d.w[l] * (tn - 1), 4);
    L.hid_b[l] = off;  off += round_up(L.ncol[l], 4);
    wout_len = L.ncol[l];
  }
  for (int l = 0; l < nl - 2; ++l) {  // layer l's output goes to buffer l % 2
    const int v = d.w[l + 1];
    bufw[l % 2] = v > bufw[l % 2] ? v : bufw[l % 2];
  }
  // partial sums of the output layer, one row per column group of the last
  // product (or per thread of a pair in layer 1's build when it is the last)
  L.npart = nl > 2 ? L.ngroups[nl - 2] : NTHREADS / MT;
  L.wout = off;  off += round_up(wout_len, 4);  // zero-padded
  L.bout = off;  off += 4;
  // an odd number of 16-byte chunks: rows read side by side fall in
  // different banks
  L.ldph = round_up(H1, 4) / 4 % 2 ? round_up(H1, 4) : round_up(H1, 4) + 4;
  L.ph = off;    off += round_up(TR * L.ldph, 4);
  L.xs = off;    off += round_up(TR, 4);
  L.fw = off;    off += round_up(TR * K, 4);
  L.s = off;     off += round_up(K, 4);
  L.ccw = off;   off += round_up(K, 4);
  L.part = off;  off += L.npart * MT;
  L.buf[0] = off;  off += bufw[0] * MT;  // activations, transposed: [width][MT]
  L.buf[1] = off;  off += bufw[1] * MT;
  L.total = off;
  return L;
}

// The largest pair tile whose layout fits, with the row tile whose pairs
// fill 4 pair tiles as nearly as possible (fewer rows where that does not
// fit); past every size, the smallest layout, which the launcher refuses.
inline Layout make_layout(const Dims& d, int K) {
  for (int MT = MAX_MT; MT >= 32; MT /= 2) {
    int tr0 = 4 * MT / K;
    tr0 = tr0 < 1 ? 1 : tr0 > MAX_TR ? MAX_TR : tr0;
    for (int TR = tr0; TR >= 1 && 2 * TR >= tr0; --TR) {
      const Layout L = layout_for(d, K, MT, TR);
      if ((long long)L.total * sizeof(float) <= SMEM_LIMIT) return L;
    }
  }
  return layout_for(d, K, 32, 1);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

template <int TN>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN], const float4 (&a)[TM / 4],
                                         const float (&b)[TN]) {
#pragma unroll
  for (int u = 0; u < TM / 4; ++u) {
    const float av[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[4 * u + i][j] = fmaf(av[i], b[j], acc[4 * u + i][j]);
  }
}

// One register tile of a hidden product: pairs pg*4 .. +3 and the same 4
// pairs 4*(MT/TM), 8*(MT/TM), ... further on, and the TN columns from c0 of
// column group cg, whose weights w are a block [din][TN]; out[j][m] =
// leaky(sum_k in[k][m] w[k][j] + bias[j]). The weights of 4 k come in TN
// 16-byte loads (one per 4 weights, not one per weight), then the 4 k's
// FMAs. With `last`, the layer's outputs are not stored: each pair's dot
// product of its TN outputs with wout, in column order, goes to row cg of
// the partial sums in `out`.
template <int TN>
__device__ __forceinline__ void product_tile(const float* __restrict__ in,
                                             float* __restrict__ out,
                                             const float* __restrict__ w,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ wout, int din, int dout,
                                             int MT, int pg, int c0, int cg, bool last,
                                             float neg_slope) {
  constexpr int TA = TM / 4;  // 16-byte loads of a thread's pairs
  const int pgn = MT / TM;
  const float* pa = in + 4 * pg;
  const float* pw = w;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int k = 0;
  for (; k + 4 <= din; k += 4) {
    float4 a[4][TA];
    float4 bq[TN];  // 4 k x TN weights, k-major
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int u = 0; u < TA; ++u) a[kk][u] = ld4(pa + kk * MT + u * 4 * pgn);
#pragma unroll
    for (int v = 0; v < TN; ++v) bq[v] = ld4(pw + 4 * v);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 v = bq[(kk * TN + j) / 4];
        const int e = (kk * TN + j) % 4;
        b[j] = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
      }
      fma_tile<TN>(acc, a[kk], b);
    }
    pa += 4 * MT;
    pw += 4 * TN;
  }
  for (; k < din; ++k) {
    float4 a[TA];
    float b[TN];
#pragma unroll
    for (int u = 0; u < TA; ++u) a[u] = ld4(pa + u * 4 * pgn);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = pw[j];
    fma_tile<TN>(acc, a, b);
    pa += MT;
    pw += TN;
  }
  if (last) {
    // padded columns have zero weights, bias and wout: they add 0
    float z[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) z[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float bj = bias[c0 + j], wj = wout[c0 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) z[i] = fmaf(leaky(acc[i][j] + bj, neg_slope), wj, z[i]);
    }
    float* pp = out + cg * MT + 4 * pg;
#pragma unroll
    for (int u = 0; u < TA; ++u)
      st4(pp + u * 4 * pgn, z[4 * u], z[4 * u + 1], z[4 * u + 2], z[4 * u + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (c0 + j < dout) {
        const float bj = bias[c0 + j];
        float* po = out + (c0 + j) * MT + 4 * pg;
#pragma unroll
        for (int u = 0; u < TA; ++u)
          st4(po + u * 4 * pgn, leaky(acc[4 * u][j] + bj, neg_slope),
              leaky(acc[4 * u + 1][j] + bj, neg_slope), leaky(acc[4 * u + 2][j] + bj, neg_slope),
              leaky(acc[4 * u + 3][j] + bj, neg_slope));
      }
    }
  }
}

// A hidden product over all its register tiles, at most one per thread
// (MT/TM pair groups x at most NTHREADS*TM/MT column groups): thread t takes
// the pairs of pg = t % (MT/TM) and column group cg = t / (MT/TM), the first
// nbig groups TN wide, the rest TN - 1. At MT = 256 a warp owns one column
// group, so its weight loads are broadcasts. Only TN <= MAX_TN is built.
template <int TN>
__device__ __forceinline__ void product(const float* in, float* out, const float* w,
                                        const float* bias, const float* wout, int din, int dout,
                                        int ngroups, int nbig, int MT, bool last,
                                        float neg_slope) {
  if constexpr (TN <= MAX_TN) {
    const int pgn = MT / TM, t = threadIdx.x;
    if (t < pgn * ngroups) {
      const int pg = t % pgn, cg = t / pgn;
      if (cg < nbig) {
        product_tile<TN>(in, out, w + cg * round_up(din * TN, 4), bias, wout, din, dout, MT, pg,
                         cg * TN, cg, last, neg_slope);
      } else if constexpr (TN > 1) {
        product_tile<TN - 1>(in, out,
                             w + nbig * round_up(din * TN, 4) +
                                 (cg - nbig) * round_up(din * (TN - 1), 4),
                             bias, wout, din, dout, MT, pg, cg * (TN - 1) + nbig, cg, last,
                             neg_slope);
      }
    }
  }
}

#define UMNN_FWD_PRODUCT_CASE(TN) \
  case TN:                        \
    product<TN>(in, out, w, bias, wout, din, dout, ngroups, nbig, MT, last, neg_slope); \
    break;

__device__ __forceinline__ void product_tn(int tn, const float* in, float* out, const float* w,
                                           const float* bias, const float* wout, int din,
                                           int dout, int ngroups, int nbig, int MT,
                                           bool last, float neg_slope) {
  switch (tn) {
    UMNN_FWD_PRODUCT_CASE(1)  UMNN_FWD_PRODUCT_CASE(2)  UMNN_FWD_PRODUCT_CASE(3)
    UMNN_FWD_PRODUCT_CASE(4)  UMNN_FWD_PRODUCT_CASE(5)  UMNN_FWD_PRODUCT_CASE(6)
    UMNN_FWD_PRODUCT_CASE(7)  UMNN_FWD_PRODUCT_CASE(8)  UMNN_FWD_PRODUCT_CASE(9)
    UMNN_FWD_PRODUCT_CASE(10) UMNN_FWD_PRODUCT_CASE(11) UMNN_FWD_PRODUCT_CASE(12)
    UMNN_FWD_PRODUCT_CASE(13) UMNN_FWD_PRODUCT_CASE(14) UMNN_FWD_PRODUCT_CASE(15)
    UMNN_FWD_PRODUCT_CASE(16)
  }
}
static_assert(MAX_TN <= 16, "product_tn has a case for each TN up to MAX_TN");

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]]. L: make_layout(d, K), computed on the host, so that the
// kernel reads it from the constant bank of its parameters.
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ params, const float* __restrict__ nodes,
                     const float* __restrict__ ccw, float* __restrict__ out, int R, int K,
                     Dims d, Layout L, float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1];
  const int MT = L.MT, TR = L.TR, ldph = L.ldph;

  // Stage the weights once, hidden ones zero-padded to ncol columns; W1's h
  // part stays in global memory (read once per row tile).
  const float* p = params;
  const float* w1h = params + H1;  // W1^T rows 1 .. e: [e][H1]
  for (int j = tid; j < H1; j += NTHREADS) sm[L.w1x + j] = p[j];
  p += F * H1;
  for (int j = tid; j < H1; j += NTHREADS) sm[L.b1 + j] = p[j];
  p += H1;
  int ldl = H1;  // wout's padded length
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1], ncol = L.ncol[l];
    // column group by column group, each [din][its width] from a 16-byte
    // boundary; padded columns zero
    const int tn = L.tn[l], nbig = L.nbig[l], big = round_up(din * tn, 4);
    const int small = round_up(din * (tn - 1), 4);
    for (int i = tid; i < din * ncol; i += NTHREADS) {
      const int k = i / ncol, c = i - k * ncol;
      const int g = c < nbig * tn ? c / tn : nbig + (c - nbig * tn) / (tn - 1);
      const int width = g < nbig ? tn : tn - 1;
      const int j = g < nbig ? c - g * tn : c - nbig * tn - (g - nbig) * (tn - 1);
      const int base = g < nbig ? g * big : nbig * big + (g - nbig) * small;
      sm[L.hid_w[l] + base + k * width + j] = c < dout ? p[k * dout + c] : 0.f;
    }
    p += dout * din;
    for (int j = tid; j < ncol; j += NTHREADS) sm[L.hid_b[l] + j] = j < dout ? p[j] : 0.f;
    p += dout;
    ldl = ncol;
  }
  const int dl = d.w[nl - 1];
  for (int k = tid; k < ldl; k += NTHREADS) sm[L.wout + k] = k < dl ? p[k] : 0.f;
  if (tid == 0) sm[L.bout] = p[dl];
  for (int n = tid; n < K; n += NTHREADS) {
    sm[L.s + n] = (nodes[n] + 1.f) * 0.5f;
    sm[L.ccw + n] = ccw[n];
  }
  __syncthreads();

  const float* w1x = sm + L.w1x;
  const float* wout = sm + L.wout;
  float* ph = sm + L.ph;
  float* xs = sm + L.xs;
  float* fw = sm + L.fw;
  float* part = sm + L.part;
  const int n_tiles = (R + TR - 1) / TR;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const int rows = min(TR, R - row0);
    // Node-invariant first layer, once per row: ph = h W1[:, 1:]^T + b1,
    // each thread 4 outputs at a time so that their loads overlap.
    for (int r = tid; r < TR; r += NTHREADS) xs[r] = r < rows ? x[row0 + r] : 0.f;
    for (int i0 = tid; i0 < TR * H1; i0 += 4 * NTHREADS) {
      const float* hr[4];
      const float* wc[4];
      float acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(i0 + u * NTHREADS, TR * H1 - 1), r = i / H1;
        hr[u] = h + (size_t)(row0 + min(r, rows - 1)) * e;
        wc[u] = w1h + (i - r * H1);
        acc[u] = 0.f;
      }
#pragma unroll 4
      for (int k = 0; k < e; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fmaf(__ldg(hr[u] + k), __ldg(wc[u] + k * H1), acc[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NTHREADS, r = i / H1, j = i - r * H1;
        if (i < TR * H1) ph[r * ldph + j] = (r < rows ? acc[u] : 0.f) + sm[L.b1 + j];
      }
    }
    __syncthreads();

    const int PQ = rows * K;  // pair q = r*K + n of the row tile
    const int G = NTHREADS / MT;  // threads per pair in layer 1
    for (int p0 = 0; p0 < PQ; p0 += MT) {
      // Layer 1 from ph, each thread pair m = tid % MT and the groups of 8
      // units from 8 * (tid / MT) in steps of 8 G, its loads 16 bytes wide
      // and before its stores; with no hidden product it is the last layer,
      // and each thread's dot product with wout goes to the partial sums.
      // Pairs past the row tile take row 0 and x = 0: finite values that
      // nothing reads.
      {
        const int m = tid % MT, q = p0 + m, j0 = tid / MT;
        const bool ok = q < PQ;
        const int r = ok ? q / K : 0, n = ok ? q - r * K : 0;
        const float sx = ok ? sm[L.s + n] * xs[r] : 0.f;
        const float* phr = ph + r * ldph;
        if (nl == 2) {
          float z = 0.f;
          for (int j = j0; j < H1; j += G)
            z = fmaf(leaky(fmaf(sx, w1x[j], phr[j]), neg_slope), wout[j], z);
          part[j0 * MT + m] = z;
        } else {
          float* a0 = sm + L.buf[0] + m;
          for (int j = 8 * j0; j < H1; j += 8 * G) {
            if (j + 8 <= H1) {
              const float4 w0 = ld4(w1x + j), w1 = ld4(w1x + j + 4);
              const float4 h0 = ld4(phr + j), h1 = ld4(phr + j + 4);
              const float v[8] = {fmaf(sx, w0.x, h0.x), fmaf(sx, w0.y, h0.y),
                                  fmaf(sx, w0.z, h0.z), fmaf(sx, w0.w, h0.w),
                                  fmaf(sx, w1.x, h1.x), fmaf(sx, w1.y, h1.y),
                                  fmaf(sx, w1.z, h1.z), fmaf(sx, w1.w, h1.w)};
#pragma unroll
              for (int u = 0; u < 8; ++u) a0[(j + u) * MT] = leaky(v[u], neg_slope);
            } else {
              for (int u = j; u < H1; ++u) a0[u * MT] = leaky(fmaf(sx, w1x[u], phr[u]), neg_slope);
            }
          }
        }
      }
      __syncthreads();
      // Hidden products, the last one fused with the output layer.
      for (int l = 1; l < nl - 1; ++l) {
        const bool last = l == nl - 2;
        product_tn(L.tn[l], sm + L.buf[(l - 1) % 2], last ? part : sm + L.buf[l % 2],
                   sm + L.hid_w[l], sm + L.hid_b[l], wout, d.w[l], d.w[l + 1], L.ngroups[l],
                   L.nbig[l], MT, last, neg_slope);
        __syncthreads();
      }
      // Output layer: each pair's partial sums in a fixed order, ELU + 1 and
      // its quadrature weight.
      if (tid < MT && p0 + tid < PQ) {
        const int m = tid, q = p0 + m, n = q - q / K * K;
        float z = part[m];
        for (int c = 1; c < L.npart; ++c) z += part[c * MT + m];
        z += sm[L.bout];
        const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
        fw[q] = sm[L.ccw + n] * f;
      }
      if (nl == 2) __syncthreads();  // the next build writes the partial sums
    }
    // The last pair tile's terms are in fw.
    __syncthreads();

    // Each row's node sum in node order (beside the next row tile's ph).
    for (int r = tid; r < rows; r += NTHREADS) {
      float acc = 0.f;
      for (int n = 0; n < K; ++n) acc += fw[r * K + n];
      out[row0 + r] = acc * x[row0 + r] * 0.5f;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these widths and node count, in bytes;
// -1 if the widths are outside what the kernel takes.
long long umnn_integrand_fwd_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_FIRST, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// The sweep's launch shape for these widths, for reports: out[0] threads per
// block, out[1] shared bytes, out[2] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] registers per
// thread, out[4] pairs per tile, out[5] rows per row tile. Returns a CUDA
// error code (cudaErrorInvalidValue for widths the kernel cannot take).
int umnn_integrand_fwd_occupancy(int K, const int* widths, int n_layers, int* out) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_FIRST, &d)) return cudaErrorInvalidValue;
  const Layout L = make_layout(d, K);
  const long long bytes = (long long)L.total * sizeof(float);
  cudaError_t err = set_smem(integrand_fwd_kernel, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, integrand_fwd_kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrand_fwd_kernel, NTHREADS,
                                                        (size_t)bytes);
  if (err != cudaSuccess) return err;
  out[0] = NTHREADS;
  out[1] = (int)bytes;
  out[2] = per_sm;
  out[3] = attr.numRegs;
  out[4] = L.MT;
  out[5] = L.TR;
  return cudaSuccess;
}

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths or shared memory the kernel cannot take).
// The grid: as many blocks as the card holds at once, at most one per row
// tile.
int umnn_integrand_fwd(const float* x, const float* h, const float* params,
                       const float* nodes, const float* ccw, float* out, int R, int K,
                       const int* widths, int n_layers, float neg_slope, void* stream) {
  Dims d;
  if (K < 1 || R < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_FIRST, &d))
    return cudaErrorInvalidValue;
  const Layout L = make_layout(d, K);
  const long long bytes = (long long)L.total * sizeof(float);
  cudaError_t err = set_smem(integrand_fwd_kernel, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrand_fwd_kernel, NTHREADS,
                                                        (size_t)bytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (R + L.TR - 1) / L.TR, slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < slots ? tiles : slots);
  integrand_fwd_kernel<<<grid, NTHREADS, (size_t)bytes, (cudaStream_t)stream>>>(
      x, h, params, nodes, ccw, out, R, K, d, L, neg_slope);
  return cudaGetLastError();
}

const char* umnn_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
