// Forward Clenshaw-Curtis integral of the UMNN integrand MLP for integrands
// whose every layer is at most 64 wide, two quadrature nodes at a time:
//
//   z_r = x_r/2 * sum_n w_n * ELU+1( MLP([x_r * s_n, h_r]) ),  s_n = (t_n+1)/2
//
// with LeakyReLU(neg_slope) between layers. It computes the same function as
// integrand_fwd.cu; only the grouping of nodes and the order of the sums in
// each layer differ.
//
// Replaces the TPU kernel `_fwd_kernel_p2` of umnn_tpu/ops/integrand_kernel.py
// (:333-381, launched by `_run_fwd_p2` :1003). There two nodes ride one matmul
// row through block-diagonal weights diag(W, W) and [x, h, x, h] feature rows,
// which fills the MXU's 128 lanes with 64-wide layers. None of that is carried
// over: the kernel reads x as [R], h as [R, e] and the real-size weights. What
// the node pair becomes here: the unit of work is one row's pair of nodes
// (2j, 2j+1) (an odd K gets one padding node at t = -1 with weight 0, as
// `_pack2_nodes` does), and every weight value a thread reads from shared
// memory feeds the FMAs of both nodes of its pairs, which is what diag(W, W)
// buys on the MXU.
//
// Bound on an H100: operations. At the calibration block (R = 3,000 rows,
// 51 nodes, widths 31-50-50-50-50-1) one sweep is 2.335 GFLOP of useful
// float32 work (chip_smoke.py::kernel_flops), 34.9 us at the 66.9 TFLOP/s
// float32 peak, against 0.42 MB of input and output (0.13 us at 3.35 TB/s).
//
// What the design does about it: plain float32 FMA on the CUDA cores (no
// TF32, no tensor cores), in a persistent grid of one 256-thread block per SM.
//   - Each block stages every weight once (asynchronous copies, all of a
//     thread's in flight at once), then walks row tiles of TR rows in a fixed order;
//     each row is written by the one block that owns its tile. TR is chosen
//     on the host from R, K and the card's SM count, so that the slowest SM
//     runs as few pair tiles as it can (3,000 rows at K = 51: 23 rows, 598
//     pairs in 5 tiles of 128, one row tile for each of 131 SMs).
//   - Hidden products are shared-memory matrix products on register tiles of
//     4 pairs x 2 nodes x TN columns: at 128 pairs a tile (256 node slots) a
//     warp owns one column group for all pairs, so its weight loads are
//     broadcasts and its activation loads 16-byte rows read side by side.
//     Columns are cut into 8 groups of two widths with no padding (50 =
//     2 x 7 + 6 x 6), each group's weights a [din][width] block from a
//     16-byte boundary, so one 16-byte load brings 4 of them.
//   - ph = h W1[:, 1:]^T + b1 is computed once per row from h staged in
//     shared memory; layer 1 is built from it once per pair tile without
//     branches, each node slot adding the rank-1 term x s_n W1[:, 0].
//   - The output layer is fused into the last hidden product's epilogue:
//     each thread dots its columns with wout, and one thread per node slot
//     sums the column groups' partials in a fixed order, then applies ELU+1
//     and w_n. With one hidden layer, layer 1's build does this.
//   - The layout is computed on the host and read from the constant bank of
//     the kernel's parameters. Widths are not padded; the pair tile shrinks
//     (128, 64, 32 pairs) until the layout fits 227 KB.
//   - Each row's sum over its nodes is taken in one thread, in node order: no
//     atomics, no carry between blocks, so reruns are bit-identical.
// What is left (ops/fwd_phase_clock.py --kernel fwd_p2, calibration block):
// the products take about 82% of the cycles and issue about one FMA every
// other cycle per scheduler, as in integrand_fwd.cu; layer 1's build and the
// output layer about 10%; the last pair tile of a row tile is 86 of 128
// pairs full at 3,000 rows.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int TM = 8;           // node slots of a thread's register tile: 4 pairs x 2 nodes
constexpr int MAX_TN = 8;       // its columns (64 over 8 groups)
constexpr int MAX_MP = 128;     // node pairs per tile, at most
constexpr int MAX_TR = 64;      // rows per row tile, at most
constexpr int MAX_WIDTH = 64;   // 1 + e and every hidden width
constexpr long long SMEM_LIMIT = 232448;  // an H100 block's opt-in shared memory
static_assert(2 * MAX_MP <= NTHREADS, "layer 1 and the output layer: a thread per node slot");

// `cols` columns cut into at most `groups` groups: nbig of width tn, the
// other ng - nbig of width tn - 1, which make up cols exactly.
struct Split {
  int tn, ng, nbig;
};

__host__ __device__ inline Split split(int cols, int groups) {
  Split s;
  s.tn = (cols + groups - 1) / groups;
  s.ng = (cols + s.tn - 1) / s.tn;
  s.nbig = cols - s.ng * (s.tn - 1);
  return s;
}

__host__ __device__ inline int first_col(const Split& s, int g) {
  return g < s.nbig ? g * s.tn : s.nbig * s.tn + (g - s.nbig) * (s.tn - 1);
}

// Offset of group g's weight block, [rows][its width], each block from a
// 16-byte boundary; g = ng gives the blocks' floats.
__host__ __device__ inline int block_at(const Split& s, int g, int rows) {
  const int big = round_up(rows * s.tn, 4), small = round_up(rows * (s.tn - 1), 4);
  return g < s.nbig ? g * big : s.nbig * big + (g - s.nbig) * small;
}

// Offsets into shared memory, in floats, a multiple of 4 (16 bytes) for all
// but w1h, b1 and bout (read a float at a time), and the tile sizes chosen
// for these widths, K and R. A pair tile holds MP
// node pairs in 2 MP node slots: slot u is node 2j + u / MP of pair u % MP,
// and pair q = r K2 + j of the row tile holds nodes 2j, 2j + 1 of row r.
// Activations are kept transposed, [width][2 MP]. poff: each layer's offset
// in the flat parameters (W^T, then b); sp: each hidden layer's column groups.
struct Layout {
  int MP, TR, K2, ldph, ldfw, npart;
  int w1x, b1, w1h, wout, bout, hs, ph, xs, fw, s, ccw, part, buf[2], total;
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], poff[MAX_LAYERS];
  Split sp[MAX_LAYERS];
};

inline Layout layout_for(const Dims& d, int K, int MP, int TR) {
  Layout L;
  const int nl = d.n_layers, F = d.w[0], e = F - 1, H1 = d.w[1], dl = d.w[nl - 1];
  const int MS = 2 * MP, ncg = NTHREADS * TM / MS;  // node slots; column groups of a product
  L.MP = MP;
  L.TR = TR;
  L.K2 = (K + 1) / 2;
  for (int l = 0, at = 0; l < nl; ++l) {
    L.poff[l] = at;
    at += (d.w[l] + 1) * d.w[l + 1];
  }
  // layer 1 as in params: W1[:, 0] (x's column), W1[:, 1:]^T [e][H1], b1
  L.w1x = 0;
  L.w1h = H1;
  L.b1 = (e + 1) * H1;
  int off = round_up((e + 2) * H1, 4);
  for (int l = 1; l < nl - 1; ++l) {  // hidden: W^T by column group, then b
    L.sp[l] = split(d.w[l + 1], ncg);
    L.hid_w[l] = off;  off += block_at(L.sp[l], L.sp[l].ng, d.w[l]);
    L.hid_b[l] = off;  off += round_up(d.w[l + 1], 4);
  }
  L.wout = off;  // then its bias
  L.bout = off + dl;
  off += round_up(dl + 1, 4);
  // an odd number of 16-byte chunks: rows read side by side fall in
  // different banks; the node sums' rows likewise
  L.ldph = round_up(H1, 4) / 4 % 2 ? round_up(H1, 4) : round_up(H1, 4) + 4;
  L.ldfw = 2 * L.K2 + 1;
  L.hs = off;  off += round_up(TR * e, 4);
  L.ph = off;  off += round_up(TR * L.ldph, 4);
  L.xs = off;  off += round_up(TR, 4);
  L.fw = off;  off += round_up(TR * L.ldfw, 4);
  L.s = off;   off += round_up(2 * L.K2, 4);
  L.ccw = off; off += round_up(2 * L.K2, 4);
  // partial sums of the output layer: one row per column group of the last
  // product, or per thread of a slot in layer 1's build when it is the last
  L.npart = nl > 2 ? L.sp[nl - 2].ng : NTHREADS / MS;
  L.part = off;  off += L.npart * MS;
  int bufw[2] = {0, 0};
  for (int l = 0; l < nl - 2; ++l)  // layer l's output goes to buffer l % 2
    bufw[l % 2] = d.w[l + 1] > bufw[l % 2] ? d.w[l + 1] : bufw[l % 2];
  L.buf[0] = off;  off += bufw[0] * MS;
  L.buf[1] = off;  off += bufw[1] * MS;
  L.total = off;
  return L;
}

// The largest pair tile whose layout fits with the most rows a row tile may
// take (about 8 pair tiles; fewer where that does not fit): the shared memory
// reported and checked for these widths and K. Past every size, the smallest
// layout, which the launcher refuses.
inline Layout make_layout(const Dims& d, int K) {
  const int K2 = (K + 1) / 2;
  for (int MP = MAX_MP; MP >= 32; MP /= 2) {
    int tr0 = 8 * MP / K2;
    tr0 = tr0 < 1 ? 1 : tr0 > MAX_TR ? MAX_TR : tr0;
    for (int TR = tr0; TR >= 1 && 2 * TR >= tr0; --TR) {
      const Layout L = layout_for(d, K, MP, TR);
      if ((long long)L.total * sizeof(float) <= SMEM_LIMIT) return L;
    }
  }
  return layout_for(d, K, 32, 1);
}

// Rows per row tile for R rows on `slots` resident blocks: the fewest pair
// tiles on the busiest block, counting a fifth of a pair tile for each row
// tile's set-up (h, ph, the node sums); the fewest rows among equals.
inline int rows_per_tile(int R, int K2, int MP, int tr_max, int slots) {
  int best_tr = 1;
  long long best = -1;
  for (int tr = 1; tr <= tr_max; ++tr) {
    const long long tiles = (R + tr - 1) / tr, rounds = (tiles + slots - 1) / slots;
    const long long cost = rounds * (5LL * ((tr * K2 + MP - 1) / MP) + 1);
    if (best < 0 || cost < best) {
      best = cost;
      best_tr = tr;
    }
  }
  return best_tr;
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

// One register tile of a hidden product: pairs 4pg .. 4pg+3, both nodes (slots
// 4pg.. and MP + 4pg..), and the TN columns from c0 of column group cg, whose
// weights w are a block [din][TN]; out[c][u] = leaky(sum_k in[k][u] w[k][c] +
// bias[c]), each sum one FMA chain in k order. The weights of 4 k come in TN
// 16-byte loads, then the 4 k's FMAs. With `last`, the layer's outputs are
// not stored: each slot's dot product of its TN outputs with wout, in column
// order, goes to row cg of the partial sums in `out`.
template <int TN>
__device__ __forceinline__ void product_tile(const float* __restrict__ in,
                                             float* __restrict__ out,
                                             const float* __restrict__ w,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ wout, int din, int MP,
                                             int pg, int c0, int cg, bool last,
                                             float neg_slope) {
  constexpr int TA = TM / 4;  // 16-byte loads of a thread's slots: one per node
  const int MS = 2 * MP;
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
      for (int u = 0; u < TA; ++u) a[kk][u] = ld4(pa + kk * MS + u * MP);
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
    pa += 4 * MS;
    pw += 4 * TN;
  }
  for (; k < din; ++k) {
    float4 a[TA];
    float b[TN];
#pragma unroll
    for (int u = 0; u < TA; ++u) a[u] = ld4(pa + u * MP);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = pw[j];
    fma_tile<TN>(acc, a, b);
    pa += MS;
    pw += TN;
  }
  if (last) {
    float z[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) z[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float bj = bias[c0 + j], wj = wout[c0 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) z[i] = fmaf(leaky(acc[i][j] + bj, neg_slope), wj, z[i]);
    }
    float* pp = out + cg * MS + 4 * pg;
#pragma unroll
    for (int u = 0; u < TA; ++u)
      st4(pp + u * MP, z[4 * u], z[4 * u + 1], z[4 * u + 2], z[4 * u + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float bj = bias[c0 + j];
      float* po = out + (c0 + j) * MS + 4 * pg;
#pragma unroll
      for (int u = 0; u < TA; ++u)
        st4(po + u * MP, leaky(acc[4 * u][j] + bj, neg_slope),
            leaky(acc[4 * u + 1][j] + bj, neg_slope), leaky(acc[4 * u + 2][j] + bj, neg_slope),
            leaky(acc[4 * u + 3][j] + bj, neg_slope));
    }
  }
}

// A hidden product over its register tiles, at most one per thread (MP/4
// pair groups x the ng column groups of s): thread t takes the pairs of pg =
// t % (MP/4) and column group cg = t / (MP/4), the first nbig groups TN wide,
// the rest TN - 1. At 128 pairs a warp owns one column group. Only TN <=
// MAX_TN is built.
template <int TN>
__device__ __forceinline__ void product(const float* in, float* out, const float* w,
                                        const float* bias, const float* wout, int din,
                                        Split s, int MP, bool last, float neg_slope) {
  if constexpr (TN <= MAX_TN) {
    const int pgn = MP / 4, t = threadIdx.x;
    if (t < pgn * s.ng) {
      const int pg = t % pgn, cg = t / pgn;
      const float* wg = w + block_at(s, cg, din);
      if (cg < s.nbig)
        product_tile<TN>(in, out, wg, bias, wout, din, MP, pg, cg * TN, cg, last, neg_slope);
      else if constexpr (TN > 1)
        product_tile<TN - 1>(in, out, wg, bias, wout, din, MP, pg, first_col(s, cg), cg, last,
                             neg_slope);
    }
  }
}

__device__ __forceinline__ void product_tn(const float* in, float* out, const float* w,
                                           const float* bias, const float* wout, int din,
                                           Split s, int MP, bool last, float neg_slope) {
  switch (s.tn) {
    case 1: product<1>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
    case 2: product<2>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
    case 3: product<3>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
    case 4: product<4>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
    case 5: product<5>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
    case 6: product<6>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
    case 7: product<7>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
    case 8: product<8>(in, out, w, bias, wout, din, s, MP, last, neg_slope); break;
  }
}
static_assert(MAX_TN == 8, "product_tn has a case for each TN up to MAX_TN");

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]] (the layout of integrand_fwd.cu). L: layout_for(d, K, MP, TR),
// computed on the host, so that the kernel reads it from the constant bank.
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_fwd_p2_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        const float* __restrict__ params, const float* __restrict__ nodes,
                        const float* __restrict__ ccw, float* __restrict__ out, int R, int K,
                        const __grid_constant__ Dims d, const __grid_constant__ Layout L,
                        float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int e = d.w[0] - 1, H1 = d.w[1];
  const int MP = L.MP, MS = 2 * MP, TR = L.TR, K2 = L.K2, ldph = L.ldph, ldfw = L.ldfw;

  // Stage the weights once, every copy of a thread in flight at once: layer 1
  // and the output layer as they are in params, each hidden layer's W^T by
  // column group (thread: column tid % 64 of every 4th row); the nodes, an
  // odd K's padding node at t = -1 (s = 0) with weight 0.
  for (int i = tid; i < (e + 2) * H1; i += NTHREADS) cp_async4(sm + L.w1x + i, params + i);
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1], c = tid % 64;
    const float* p = params + L.poff[l];
    if (c < dout) {
      const Split s = L.sp[l];
      const int g = c < s.nbig * s.tn ? c / s.tn : s.nbig + (c - s.nbig * s.tn) / (s.tn - 1);
      const int width = g < s.nbig ? s.tn : s.tn - 1;
      float* dst = sm + L.hid_w[l] + block_at(s, g, din) + c - first_col(s, g);
      for (int k = tid / 64; k < din; k += NTHREADS / 64)
        cp_async4(dst + k * width, p + k * dout + c);
    }
    for (int j = tid; j < dout; j += NTHREADS) cp_async4(sm + L.hid_b[l] + j, p + din * dout + j);
  }
  for (int k = tid; k <= d.w[nl - 1]; k += NTHREADS)
    cp_async4(sm + L.wout + k, params + L.poff[nl - 1] + k);
  for (int n = tid; n < 2 * K2; n += NTHREADS) {
    sm[L.s + n] = n < K ? (nodes[n] + 1.f) * 0.5f : 0.f;
    sm[L.ccw + n] = n < K ? ccw[n] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const float* w1x = sm + L.w1x;
  const float* w1h = sm + L.w1h;
  const float* b1 = sm + L.b1;
  const float* wout = sm + L.wout;
  const float* sn = sm + L.s;
  const float* cw = sm + L.ccw;
  float* hs = sm + L.hs;
  float* ph = sm + L.ph;
  float* xs = sm + L.xs;
  float* fw = sm + L.fw;
  float* part = sm + L.part;
  const int n_tiles = (R + TR - 1) / TR;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const int rows = min(TR, R - row0);
    // The row tile's x and h (rows past R: 0), then ph once per row.
    for (int r = tid; r < TR; r += NTHREADS) xs[r] = r < rows ? x[row0 + r] : 0.f;
    const float* hg = h + (size_t)row0 * e;
    for (int i = tid; i < TR * e; i += NTHREADS) {
      if (i < rows * e) cp_async4(hs + i, hg + i);
      else hs[i] = 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    // Node-invariant first layer, once per row: ph = h W1[:, 1:]^T + b1, one
    // FMA chain per output.
    for (int i = tid; i < TR * H1; i += NTHREADS) {
      const int r = i / H1, j = i - r * H1;
      const float* hr = hs + r * e;
      float acc = 0.f;
#pragma unroll 4
      for (int k = 0; k < e; ++k) acc = fmaf(hr[k], w1h[k * H1 + j], acc);
      ph[r * ldph + j] = acc + b1[j];
    }
    __syncthreads();

    const int PQ = rows * K2;
    const int G = NTHREADS / MS;  // threads per node slot in layer 1
    for (int p0 = 0; p0 < PQ; p0 += MP) {
      // Layer 1 from ph, each thread node slot u = tid % MS and the groups
      // of 8 units from 8 * (tid / MS) in steps of 8 G, its loads 16 bytes
      // wide and before its stores; with no hidden product it is the last
      // layer, and each thread's dot product with wout goes to the partial
      // sums. Pairs past the row tile take row 0 and x = 0: finite values
      // that nothing reads.
      {
        const int u = tid % MS, j0 = tid / MS, slot = u >= MP, q = p0 + u - slot * MP;
        const bool ok = q < PQ;
        const int r = ok ? q / K2 : 0, n = ok ? 2 * (q - r * K2) + slot : 0;
        const float sx = ok ? sn[n] * xs[r] : 0.f;
        const float* phr = ph + r * ldph;
        if (nl == 2) {
          float z = 0.f;
          for (int j = j0; j < H1; j += G)
            z = fmaf(leaky(fmaf(sx, w1x[j], phr[j]), neg_slope), wout[j], z);
          part[j0 * MS + u] = z;
        } else {
          float* a0 = sm + L.buf[0] + u;
          for (int j = 8 * j0; j < H1; j += 8 * G) {
            if (j + 8 <= H1) {
              const float4 w0 = ld4(w1x + j), w1 = ld4(w1x + j + 4);
              const float4 h0 = ld4(phr + j), h1 = ld4(phr + j + 4);
              const float v[8] = {fmaf(sx, w0.x, h0.x), fmaf(sx, w0.y, h0.y),
                                  fmaf(sx, w0.z, h0.z), fmaf(sx, w0.w, h0.w),
                                  fmaf(sx, w1.x, h1.x), fmaf(sx, w1.y, h1.y),
                                  fmaf(sx, w1.z, h1.z), fmaf(sx, w1.w, h1.w)};
#pragma unroll
              for (int c = 0; c < 8; ++c) a0[(j + c) * MS] = leaky(v[c], neg_slope);
            } else {
              for (int c = j; c < H1; ++c) a0[c * MS] = leaky(fmaf(sx, w1x[c], phr[c]), neg_slope);
            }
          }
        }
      }
      __syncthreads();
      // Hidden products, the last one fused with the output layer.
      for (int l = 1; l < nl - 1; ++l) {
        const bool last = l == nl - 2;
        product_tn(sm + L.buf[(l - 1) % 2], last ? part : sm + L.buf[l % 2], sm + L.hid_w[l],
                   sm + L.hid_b[l], wout, d.w[l], L.sp[l], MP, last, neg_slope);
        __syncthreads();
      }
      // Output layer: each node slot's partial sums in a fixed order, ELU + 1
      // and its quadrature weight.
      if (tid < MS) {
        const int u = tid, slot = u >= MP, q = p0 + u - slot * MP;
        if (q < PQ) {
          const int r = q / K2, n = 2 * (q - r * K2) + slot;
          float z = part[u];
          for (int c = 1; c < L.npart; ++c) z += part[c * MS + u];
          z += sm[L.bout];
          const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
          fw[r * ldfw + n] = cw[n] * f;
        }
      }
      if (nl == 2) __syncthreads();  // the next build writes the partial sums
    }
    // The last pair tile's terms are in fw.
    __syncthreads();

    // Each row's node sum in node order (beside the next row tile's x and h).
    for (int r = tid; r < rows; r += NTHREADS) {
      float acc = 0.f;
#pragma unroll 8
      for (int n = 0; n < K; ++n) acc += fw[r * ldfw + n];
      out[row0 + r] = acc * x[row0 + r] * 0.5f;
    }
  }
}

// Checks the widths and the shared memory against the card, sets the
// kernel's dynamic shared memory for the largest row tile and picks the row
// tile and grid for R rows: as many blocks as the card holds at once, at
// most one per row tile.
cudaError_t prepare(int R, int K, const int* widths, int n_layers, Dims* d, Layout* L,
                    int* grid, int* per_sm) {
  if (K < 1 || R < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, d))
    return cudaErrorInvalidValue;
  const Layout big = make_layout(*d, K);
  const long long bytes = (long long)big.total * sizeof(float);
  cudaError_t err = set_smem(integrand_fwd_p2_kernel, bytes);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, integrand_fwd_p2_kernel,
                                                        NTHREADS, (size_t)bytes);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  const int slots = sms * *per_sm;
  *L = layout_for(*d, K, big.MP, rows_per_tile(R, big.K2, big.MP, big.TR, slots));
  const int tiles = (R + L->TR - 1) / L->TR;
  *grid = tiles < slots ? tiles : slots;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs at most for these widths and node count,
// in bytes (a launch's row tile may take less); -1 if the widths are outside
// what the kernel takes (1 + e and every hidden width at most 64, 2 to
// MAX_LAYERS layers, one output).
long long umnn_integrand_fwd_p2_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// The sweep's launch shape for R rows at these widths, for reports: out[0]
// threads per block, out[1] shared bytes, out[2] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] registers per
// thread, out[4] pairs per tile, out[5] rows per row tile, out[6] blocks.
// Returns a CUDA error code (cudaErrorInvalidValue for widths the kernel
// cannot take).
int umnn_integrand_fwd_p2_occupancy(int R, int K, const int* widths, int n_layers, int* out) {
  Dims d;
  Layout L;
  int grid = 0, per_sm = 0;
  cudaError_t err = prepare(R, K, widths, n_layers, &d, &L, &grid, &per_sm);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, integrand_fwd_p2_kernel);
  if (err != cudaSuccess) return err;
  out[0] = NTHREADS;
  out[1] = L.total * (int)sizeof(float);
  out[2] = per_sm;
  out[3] = attr.numRegs;
  out[4] = L.MP;
  out[5] = L.TR;
  out[6] = grid;
  return cudaSuccess;
}

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths or shared memory the kernel cannot take).
int umnn_integrand_fwd_p2(const float* x, const float* h, const float* params,
                          const float* nodes, const float* ccw, float* out, int R, int K,
                          const int* widths, int n_layers, float neg_slope, void* stream) {
  Dims d;
  Layout L;
  int grid = 0, per_sm = 0;
  const cudaError_t err = prepare(R, K, widths, n_layers, &d, &L, &grid, &per_sm);
  if (err != cudaSuccess) return err;
  integrand_fwd_p2_kernel<<<grid, NTHREADS, (size_t)L.total * sizeof(float),
                            (cudaStream_t)stream>>>(x, h, params, nodes, ccw, out, R, K, d, L,
                                                    neg_slope);
  return cudaGetLastError();
}

}  // extern "C"
