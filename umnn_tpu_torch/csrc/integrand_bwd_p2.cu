// Backward of the Clenshaw-Curtis integral of the UMNN integrand MLP for
// integrands whose every layer is at most 64 wide (the pack-2 route):
//
//   z_r = x_r/2 * sum_n w_n * f_{r,n},  f_{r,n} = ELU+1( MLP([x_r * s_n, h_r]) ),
//   s_n = (t_n+1)/2, LeakyReLU(neg_slope) between layers,
//
// for an upstream cotangent g_r: the exact derivative of this K-node sum with
// respect to every weight and bias, h_r and x_r (node path and product rule).
// It computes the same function as integrand_bwd.cu; only the grouping of the
// (row, node) pairs and the order of the sums differ.
//
// Replaces the TPU kernel `_bwd_kernel_p2` of umnn_tpu/ops/integrand_kernel.py
// (:384-506, launched by `_run_bwd_p2` :1033) together with its host fold in
// `_fused_vjp_bwd_p2` (:1201-1239). There two nodes share a 128-lane matmul
// row through diag(W, W); the kernel then forms the cross-block gradients
// too, the host drops them and sums the two diagonal blocks, and h's gradient
// arrives in two feature slots. Here a (row, node) pair is the unit of work,
// every pair of a tile accumulates into one dW, the cross-block gradients are
// never formed, and there is one h per row, so the fold becomes nothing. Per
// pair it computes
//   - the forward chain again (nothing of the forward is saved); the
//     LeakyReLU derivative comes from a > 0 and the ELU+1 derivative from
//     min(f, 1);
//   - the cotangent ct = w_n g_r x_r/2 and the MLP's VJP down to layer 2;
//   - in layer 1 the node axis collapses before any contraction:
//     dz_sum_r = sum_n dz1_{r,n}, dW1[:, 1:] += dz_sum^T h, db1 += sum dz_sum,
//     dW1[:, 0] += sum_{r,n} x_r s_n dz1_{r,n}, dh_r = dz_sum_r W1[:, 1:],
//     dx_nodes_r = sum_n s_n (dz1_{r,n} . W1[:, 0]);
//   - S_r = sum_n w_n f_{r,n}, written out, and dx_r = dx_nodes_r + g_r S_r/2
//     (never z/x, which is singular at x = 0).
// dW comes out in nn.Linear's [dout, din] layout.
//
// Bound on an H100: operations. At the calibration block (R = 3,000 rows,
// 51 nodes, widths 31-50-50-50-50-1) one sweep is 7.011 GFLOP of useful
// float32 work (chip_smoke.py::bwd_kernel_flops), 104.8 us at the 66.9
// TFLOP/s float32 peak, against about 0.1 MB of input and output.
//
// What the design does about it: plain float32 FMA on the CUDA cores, in a
// persistent grid of one 256-thread block per SM. The block stages the
// weights once, keeps its dW/db sums in shared memory for its whole walk
// (in the flat gradient's layout) and writes them to its own slice of the
// partial-sum workspace at the end; a second launch sums the slices in block
// order. No atomics: every sum has one owner thread, so reruns on one card are
// bit-identical. It walks row tiles of TR rows (5 at K = 51: 255 pairs, two
// pair tiles of MT = 128), each row's nodes in one block, so dz_sum, dh, dx
// and S need no sum across blocks.
//   - The hidden products (the forward again and the dz of each layer below)
//     run on register tiles of 4 pairs x TN columns: at MT = 128 a warp owns
//     one column group for all 128 pairs, so its weight loads are broadcasts
//     and its activation loads 16-byte rows side by side. Columns are cut into
//     8 groups of two widths with no padding (50 = 2 x 7 + 6 x 6), each
//     group's weights a block [contraction][width] from a 16-byte boundary,
//     so one 16-byte load brings 4 of them: the forward's blocks by output
//     column, the dz product's (a second copy) by input column.
//   - The dW product: warp w holds rows 7w .. 7w + 6 (at width 50) and lane l
//     columns l and l + 32 (db as the column of a row of ones) in
//     registers for the whole walk; the warp's loads of dz rows are the
//     same for all its lanes. Of the 64 x 56 sums computed, 51 x 50 are
//     kept, yet it took 18% fewer cycles than 5 x 7 tiles on 240 threads
//     whose pairs were cut in three ranges meeting by shuffles, which kept
//     every thread busy, and half those of 2 x 6 tiles on 250 threads
//     (bwd_phase_clock.py on an H100 80GB HBM3 at 700 W, PERF.md §6).
//   - The node-invariant first layer is built from h staged in shared memory,
//     one FMA chain a thread; layer 1 is built from it without branches. The
//     layer-1 collapse sums each row's run of pairs without a branch, from
//     s_n x_r kept per pair by the output layer's step.
//   - Widths are not padded; the pair tile shrinks (128, 64, 32) until the
//     layout fits 227 KB. The layout is computed on the host and read from
//     the constant bank of the kernel's parameters.
// What is left (bwd_phase_clock.py --kernel bwd_p2): the three products take
// about 76% of the cycles, the dW product the most; the tiles hold 4 pairs
// (128 pairs on 256 threads); a pair tile takes 13 barriers at the
// calibration widths; 600 row tiles over 132 blocks leave the last wave
// ragged.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TM = 4;           // pairs of a thread's tile in the hidden products
constexpr int MAX_TN = 8;       // its columns (64 over 8 groups)
constexpr int MAX_MT = 128;     // pairs per tile, at most
constexpr int MAX_TR = 64;      // rows per row tile, at most
constexpr int MAX_WIDTH = 64;   // 1 + e and every hidden width
constexpr long long SMEM_LIMIT = 232448;  // an H100 block's opt-in shared memory
static_assert(MAX_MT + MAX_WIDTH <= NTHREADS, "the collapse gives a thread to each pair and unit");

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

// dW tile shapes (columns a lane, rows a warp): a lane takes columns lane +
// 32c, c < TK, of TJ rows, the block's 8 warps one row group each; a layer
// takes the first shape that covers its din + 1 columns and dout rows.
constexpr int DW_SHAPES[][2] = {{1, 1}, {1, 2}, {1, 4}, {2, 4}, {2, 7}, {2, 8}, {3, 8}};
constexpr int N_DW_SHAPES = sizeof(DW_SHAPES) / sizeof(DW_SHAPES[0]);

inline int dw_shape(int din, int dout) {
  for (int i = 0; i < N_DW_SHAPES; ++i)
    if (32 * DW_SHAPES[i][0] >= din + 1 && NWARPS * DW_SHAPES[i][1] >= dout) return i;
  return N_DW_SHAPES - 1;
}

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes), and
// the tile sizes chosen for these widths and K. Per hidden layer l (W_l maps
// w[l] inputs to w[l+1] outputs): wf, its weights in blocks by output column
// (fs); wb, the same weights in blocks by input column for the dz product
// (bsp); its bias; dws, the shape of its dW tiles (dw_shape). act[l]:
// layer l's output, [w[l+1]][LDA]. sums: the block's dW/db sums, at the flat
// gradient's offsets pw, pb.
struct Layout {
  int MT, TR, LDA, P;
  int w1x, b1, w1h, wout, sums, xs, gs, hs, ph, dzsum, s, ccw, fw, vx, dzl, sx, ones, total;
  int wf[MAX_LAYERS], wb[MAX_LAYERS], bias[MAX_LAYERS], act[MAX_LAYERS], dws[MAX_LAYERS];
  Split fs[MAX_LAYERS], bsp[MAX_LAYERS];
  int pw[MAX_LAYERS], pb[MAX_LAYERS];
};

inline Layout layout_for(const Dims& d, int K, int MT, int TR) {
  Layout L;
  const int nl = d.n_layers, F = d.w[0], e = F - 1, H1 = d.w[1], dl = d.w[nl - 1];
  const int ncg = NTHREADS / (MT / TM);  // column groups of a hidden product
  L.MT = MT;
  L.TR = TR;
  L.LDA = MT + 4;  // rows read side by side fall in other banks
  int off = 0;
  L.w1x = off;  off += round_up(H1, 4);  // W1[:, 0]
  L.b1 = off;   off += round_up(H1, 4);
  L.w1h = off;  off += round_up(e * H1, 4);  // W1[:, 1:]^T, [e][H1]
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1];
    L.fs[l] = split(dout, ncg);
    L.wf[l] = off;    off += block_at(L.fs[l], L.fs[l].ng, din);
    L.bsp[l] = split(din, ncg);
    L.wb[l] = off;    off += block_at(L.bsp[l], L.bsp[l].ng, dout);
    L.bias[l] = off;  off += round_up(dout, 4);
    L.dws[l] = dw_shape(din, dout);
  }
  L.wout = off;  off += round_up(dl + 1, 4);  // then its bias at wout + dl
  L.P = param_offsets(d, L.pw, L.pb);
  L.sums = off;  off += round_up(L.P, 4);
  L.xs = off;    off += round_up(TR, 4);
  L.gs = off;    off += round_up(TR, 4);
  L.hs = off;    off += round_up(TR * e, 4);
  L.ph = off;    off += round_up(TR * H1, 4);
  L.dzsum = off; off += round_up(TR * H1, 4);
  L.s = off;     off += round_up(K, 4);
  L.ccw = off;   off += round_up(K, 4);
  L.fw = off;    off += round_up(TR * K, 4);
  L.vx = off;    off += round_up(TR * K, 4);
  L.dzl = off;   off += MT;
  L.sx = off;    off += MT;
  L.ones = off;  off += MT;
  for (int l = 0; l < nl - 1; ++l) {
    L.act[l] = off;
    off += d.w[l + 1] * L.LDA;
  }
  L.total = off;
  return L;
}

// The largest pair tile whose layout fits, with the row tile whose pairs
// fill 1 to 4 pair tiles most nearly (fewer rows where that does not fit);
// past every size, the smallest layout, which the launcher refuses.
inline Layout make_layout(const Dims& d, int K) {
  for (int MT = MAX_MT; MT >= 32; MT /= 2) {
    int tr0 = 1;
    float best = 0.f;
    for (int t = 1; t <= 4; ++t) {
      int tr = t * MT / K;
      tr = tr < 1 ? 1 : tr > MAX_TR ? MAX_TR : tr;
      const int tiles = (tr * K + MT - 1) / MT;
      const float fill = (float)(tr * K) / (float)(tiles * MT);
      if (fill > best + 1e-3f) {
        best = fill;
        tr0 = tr;
      }
    }
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

// One register tile of a hidden product: pairs 4ig .. 4ig+3 and the TN
// columns from c0, whose weights w are a block [din][TN]:
//   forward: out[c][m] = leaky(sum_k in[k][m] w[k][c] + bias[c]);
//   dz (DZ): out[c][m] = (sum_k in[k][m] w[k][c]) * leaky'(out[c][m]), in place.
// Each sum is one FMA chain in k order. The weights of 4 k come in TN
// 16-byte loads, then the 4 k's FMAs.
template <int TN, bool DZ>
__device__ __forceinline__ void product_tile(const float* __restrict__ in, float* out,
                                             const float* __restrict__ w,
                                             const float* __restrict__ bias, int din, int LDA,
                                             int ig, int c0, float neg_slope) {
  const float* pa = in + 4 * ig;
  const float* pw = w;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int k = 0;
  for (; k + 4 <= din; k += 4) {
    float4 a[4], bq[TN];  // bq: 4 k x TN weights, k-major
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a[kk] = ld4(pa + kk * LDA);
#pragma unroll
    for (int v = 0; v < TN; ++v) bq[v] = ld4(pw + 4 * v);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float av[4] = {a[kk].x, a[kk].y, a[kk].z, a[kk].w};
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 v = bq[(kk * TN + j) / 4];
        const int u = (kk * TN + j) % 4;
        const float b = u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
      }
    }
    pa += 4 * LDA;
    pw += 4 * TN;
  }
  for (; k < din; ++k) {
    const float4 a = ld4(pa);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float b = pw[j];
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
    }
    pa += LDA;
    pw += TN;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float* po = out + (c0 + j) * LDA + 4 * ig;
    if constexpr (DZ) {
      const float4 o = ld4(po);
      st4(po, acc[0][j] * (o.x > 0.f ? 1.f : neg_slope), acc[1][j] * (o.y > 0.f ? 1.f : neg_slope),
          acc[2][j] * (o.z > 0.f ? 1.f : neg_slope), acc[3][j] * (o.w > 0.f ? 1.f : neg_slope));
    } else {
      const float bj = bias[c0 + j];
      st4(po, leaky(acc[0][j] + bj, neg_slope), leaky(acc[1][j] + bj, neg_slope),
          leaky(acc[2][j] + bj, neg_slope), leaky(acc[3][j] + bj, neg_slope));
    }
  }
}

// A hidden product over its register tiles, one per thread: thread t takes
// pairs of ig = t % (MT/4) and column group cg = t / (MT/4) of s, whose
// weights are the block of cg in w ([rows][width] blocks, rows the
// contraction). Only TN <= MAX_TN is built.
template <int TN, bool DZ>
__device__ __forceinline__ void product(const float* in, float* out, const float* w,
                                        const float* bias, const Split& s, int rows, int MT,
                                        int LDA, float neg_slope) {
  if constexpr (TN <= MAX_TN) {
    const int pgn = MT / TM, t = threadIdx.x;
    if (t < pgn * s.ng) {
      const int ig = t % pgn, cg = t / pgn;
      const float* wg = w + block_at(s, cg, rows);
      if (cg < s.nbig)
        product_tile<TN, DZ>(in, out, wg, bias, rows, LDA, ig, cg * TN, neg_slope);
      else if constexpr (TN > 1)
        product_tile<TN - 1, DZ>(in, out, wg, bias, rows, LDA, ig, first_col(s, cg), neg_slope);
    }
  }
}

template <bool DZ>
__device__ __forceinline__ void product_tn(const float* in, float* out, const float* w,
                                           const float* bias, const Split& s, int rows, int MT,
                                           int LDA, float neg_slope) {
  switch (s.tn) {
    case 1: product<1, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
    case 2: product<2, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
    case 3: product<3, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
    case 4: product<4, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
    case 5: product<5, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
    case 6: product<6, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
    case 7: product<7, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
    case 8: product<8, DZ>(in, out, w, bias, s, rows, MT, LDA, neg_slope); break;
  }
}
static_assert(MAX_TN == 8, "product_tn has a case for each TN up to MAX_TN");

// A layer's dW product, dW[j][k] += sum_m dz[j][m] a[k][m] (k = din: db[j],
// against the row of ones), over the tile's MT pairs. Warp w takes rows
// w*TJ .. w*TJ + TJ - 1 and lane l columns l + 32c, c < TK, in registers,
// the same sums in every pair tile; a lane reads its TK rows of a, and the
// warp's TJ rows of dz, 4 pairs a 16-byte load. Columns past din and rows
// past dout read the ones and the last row, and are not written.
template <int TK, int TJ>
__device__ __forceinline__ void dw_product(const float* __restrict__ a,
                                           const float* __restrict__ dz,
                                           const float* __restrict__ ones, float* dw, float* db,
                                           int din, int dout, int MT, int LDA) {
  const int lane = threadIdx.x & 31, j0 = (threadIdx.x >> 5) * TJ;
  const float* ar[TK];
#pragma unroll
  for (int c = 0; c < TK; ++c) ar[c] = lane + 32 * c < din ? a + (lane + 32 * c) * LDA : ones;
  const float* dr[TJ];
#pragma unroll
  for (int i = 0; i < TJ; ++i) dr[i] = dz + min(j0 + i, dout - 1) * LDA;
  float acc[TJ][TK];
#pragma unroll
  for (int i = 0; i < TJ; ++i)
#pragma unroll
    for (int c = 0; c < TK; ++c) acc[i][c] = 0.f;
  for (int m = 0; m < MT; m += 4) {
    float4 v[TK];
#pragma unroll
    for (int c = 0; c < TK; ++c) v[c] = ld4(ar[c] + m);
#pragma unroll
    for (int i = 0; i < TJ; ++i) {
      const float4 u = ld4(dr[i] + m);
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        acc[i][c] = fmaf(u.x, v[c].x, acc[i][c]);
        acc[i][c] = fmaf(u.y, v[c].y, acc[i][c]);
        acc[i][c] = fmaf(u.z, v[c].z, acc[i][c]);
        acc[i][c] = fmaf(u.w, v[c].w, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TJ; ++i) {
    const int j = j0 + i;
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const int k = lane + 32 * c;
      if (j < dout && k < din) dw[j * din + k] += acc[i][c];
      else if (j < dout && k == din) db[j] += acc[i][c];
    }
  }
}

__device__ __forceinline__ void dw_by_shape(int shape, const float* a, const float* dz,
                                            const float* ones, float* dw, float* db, int din,
                                            int dout, int MT, int LDA) {
  switch (shape) {
    case 0: dw_product<1, 1>(a, dz, ones, dw, db, din, dout, MT, LDA); break;
    case 1: dw_product<1, 2>(a, dz, ones, dw, db, din, dout, MT, LDA); break;
    case 2: dw_product<1, 4>(a, dz, ones, dw, db, din, dout, MT, LDA); break;
    case 3: dw_product<2, 4>(a, dz, ones, dw, db, din, dout, MT, LDA); break;
    case 4: dw_product<2, 7>(a, dz, ones, dw, db, din, dout, MT, LDA); break;
    case 5: dw_product<2, 8>(a, dz, ones, dw, db, din, dout, MT, LDA); break;
    case 6: dw_product<3, 8>(a, dz, ones, dw, db, din, dout, MT, LDA); break;
  }
}
static_assert(N_DW_SHAPES == 7, "dw_by_shape has a case for each shape");

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]] (the forward kernels' layout). partial: gridDim.x slices of
// the flat gradient (per layer dW [dout][din], then db). L: make_layout(d, K),
// computed on the host, so that the kernel reads it from the constant bank.
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_bwd_p2_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        const float* __restrict__ params, const float* __restrict__ nodes,
                        const float* __restrict__ ccw, const float* __restrict__ g,
                        float* __restrict__ dx, float* __restrict__ dh, float* __restrict__ S,
                        float* __restrict__ partial, int R, int K, Dims d, Layout L,
                        float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1], dl = d.w[nl - 1];
  const int MT = L.MT, TR = L.TR, LDA = L.LDA;

  // Stage the weights: the hidden layers' W^T first copied as they are into
  // the activation buffers (free until the first pair tile, coalesced, every
  // load in flight), then laid out twice from there, by output and by input
  // column; zero the dW/db sums.
  const float* p = params;
  for (int j = tid; j < H1; j += NTHREADS) {
    sm[L.w1x + j] = p[j];
    sm[L.b1 + j] = p[F * H1 + j];
  }
  for (int i = tid; i < e * H1; i += NTHREADS) sm[L.w1h + i] = p[H1 + i];
  p += F * H1 + H1;
  float* raw = sm + L.act[0];
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1];
    for (int i = tid; i < din * dout; i += NTHREADS) raw[i] = p[i];
    __syncthreads();
    // W_l[c][k] = raw[k*dout + c]; block g of the forward copy is
    // [din][width] over output columns, of the dz product's [dout][width]
    // over input columns
    for (int copy = 0; copy < 2; ++copy) {
      const Split& sp = copy == 0 ? L.fs[l] : L.bsp[l];
      const int rows = copy == 0 ? din : dout;
      float* dst = sm + (copy == 0 ? L.wf[l] : L.wb[l]);
      for (int g = 0; g < sp.ng; ++g) {
        const int width = g < sp.nbig ? sp.tn : sp.tn - 1, c0 = first_col(sp, g);
        float* blk = dst + block_at(sp, g, rows);
        for (int i = tid; i < rows * width; i += NTHREADS) {
          const int r = i / width, c = c0 + i - r * width;
          blk[i] = copy == 0 ? raw[r * dout + c] : raw[c * dout + r];
        }
      }
    }
    p += din * dout;
    for (int j = tid; j < dout; j += NTHREADS) sm[L.bias[l] + j] = p[j];
    p += dout;
    __syncthreads();
  }
  for (int k = tid; k <= dl; k += NTHREADS) sm[L.wout + k] = p[k];  // then the bias
  for (int i = tid; i < L.P; i += NTHREADS) sm[L.sums + i] = 0.f;
  for (int n = tid; n < K; n += NTHREADS) {
    sm[L.s + n] = (nodes[n] + 1.f) * 0.5f;
    sm[L.ccw + n] = ccw[n];
  }
  for (int m = tid; m < MT; m += NTHREADS) sm[L.ones + m] = 1.f;
  __syncthreads();

  const float* w1x = sm + L.w1x;
  const float* w1h = sm + L.w1h;
  const float* wout = sm + L.wout;
  const float* sn = sm + L.s;
  const float* cw = sm + L.ccw;
  float* sums = sm + L.sums;
  float* xs = sm + L.xs;
  float* gs = sm + L.gs;
  float* hs = sm + L.hs;
  float* ph = sm + L.ph;
  float* dzsum = sm + L.dzsum;
  float* fw = sm + L.fw;
  float* vx = sm + L.vx;
  float* dzl = sm + L.dzl;
  const int PQ = TR * K;  // pair q = r*K + n of the row tile
  const int n_tiles = (R + TR - 1) / TR;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const int rows = min(TR, R - row0);
    // The row tile's x, g and h; rows past R get 0, so every cotangent of
    // theirs is 0.
    for (int r = tid; r < TR; r += NTHREADS) {
      xs[r] = r < rows ? x[row0 + r] : 0.f;
      gs[r] = r < rows ? g[row0 + r] : 0.f;
    }
    for (int i = tid; i < TR * e; i += NTHREADS)
      hs[i] = i < rows * e ? h[(size_t)row0 * e + i] : 0.f;
    for (int i = tid; i < TR * H1; i += NTHREADS) dzsum[i] = 0.f;
    __syncthreads();
    // Node-invariant first layer, once per row: ph = h W1[:, 1:]^T + b1, one
    // FMA chain a thread.
    for (int i = tid; i < TR * H1; i += NTHREADS) {
      const int r = i / H1, j = i - r * H1;
      const float* hr = hs + r * e;
      float acc = 0.f;
      for (int k = 0; k < e; ++k) acc = fmaf(hr[k], w1h[k * H1 + j], acc);
      ph[i] = acc + sm[L.b1 + j];
    }
    __syncthreads();

    for (int p0 = 0; p0 < PQ; p0 += MT) {
      // Forward again: layer 1 for pair m = tid % MT and every
      // (NTHREADS/MT)th unit from ph and the rank-1 node term. Pairs past
      // the row tile take row 0 and node 0: finite values whose cotangent
      // is 0.
      {
        const int m = tid % MT, q = p0 + m;
        const int qq = q < PQ ? q : 0, r = qq / K, n = qq - r * K;
        const float sv = sn[n], xr = xs[r];
        const float* phr = ph + r * H1;
        float* a0 = sm + L.act[0] + m;
        for (int j = tid / MT; j < H1; j += NTHREADS / MT)
          a0[j * LDA] = leaky(fmaf(sv, xr * w1x[j], phr[j]), neg_slope);
      }
      __syncthreads();
      // The hidden layers.
      for (int l = 1; l < nl - 1; ++l) {
        product_tn<false>(sm + L.act[l - 1], sm + L.act[l], sm + L.wf[l], sm + L.bias[l], L.fs[l],
                          d.w[l], MT, LDA, neg_slope);
        __syncthreads();
      }
      // Output layer: f, its quadrature term, and the pair's cotangent
      // dzL = w_n g_r x_r/2 min(f, 1) (0 past the row tile).
      const float* aL = sm + L.act[nl - 2];
      if (tid < MT) {
        const int m = tid, q = p0 + m;
        float dz = 0.f;
        float sxm = 0.f;
        if (q < PQ) {
          const int r = q / K, n = q - r * K;
          sxm = sn[n] * xs[r];
          float z = 0.f;
          for (int k = 0; k < dl; ++k) z = fmaf(aL[k * LDA + m], wout[k], z);
          z += wout[dl];
          const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
          fw[q] = cw[n] * f;
          dz = cw[n] * gs[r] * xs[r] * 0.5f * fminf(f, 1.f);
        }
        dzl[m] = dz;
        sm[L.sx + m] = sxm;  // for the layer-1 collapse
      }
      __syncthreads();
      // Four threads per unit k of the last hidden layer: the output layer's
      // dW row (k = dl: its db, the sum of dzL) and the rank-1 dz of that
      // layer, in place; each thread every 4th group of 4 pairs, the four
      // sums meeting by two shuffles.
      for (int k0 = 0; k0 <= dl; k0 += NTHREADS / 4) {
        const int k = k0 + (tid >> 2), part = tid & 3;
        float c = 0.f;
        if (k < dl) {
          float* pa = sm + L.act[nl - 2] + k * LDA;
          const float wk = wout[k];
          for (int m = 4 * part; m < MT; m += 16) {
            const float4 a = ld4(pa + m), z = ld4(dzl + m);
            c = fmaf(a.x, z.x, c);
            c = fmaf(a.y, z.y, c);
            c = fmaf(a.z, z.z, c);
            c = fmaf(a.w, z.w, c);
            st4(pa + m, z.x * wk * (a.x > 0.f ? 1.f : neg_slope),
                z.y * wk * (a.y > 0.f ? 1.f : neg_slope), z.z * wk * (a.z > 0.f ? 1.f : neg_slope),
                z.w * wk * (a.w > 0.f ? 1.f : neg_slope));
          }
        } else if (k == dl) {
          for (int m = 4 * part; m < MT; m += 16) {
            const float4 z = ld4(dzl + m);
            c += z.x + z.y + z.z + z.w;
          }
        }
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        if (part == 0 && k <= dl) sums[k < dl ? L.pw[nl - 1] + k : L.pb[nl - 1]] += c;
      }
      __syncthreads();
      // Each hidden layer from the last down: its dW and db, then the dz of
      // the layer below in place of that layer's activations.
      for (int l = nl - 2; l >= 1; --l) {
        const int din = d.w[l], dout = d.w[l + 1];
        dw_by_shape(L.dws[l], sm + L.act[l - 1], sm + L.act[l], sm + L.ones, sums + L.pw[l],
                    sums + L.pb[l], din, dout, MT, LDA);
        __syncthreads();
        product_tn<true>(sm + L.act[l], sm + L.act[l - 1], sm + L.wb[l], nullptr, L.bsp[l], dout,
                         MT, LDA, neg_slope);
        __syncthreads();
      }
      // Layer 1: act[0] now holds dz1 and the node axis collapses. A thread
      // per pair: x's node path s_n (dz1 . W1[:, 0]); a thread per unit j: its
      // sums over the tile's pairs in order, dz_sum by row and dW1's x column.
      {
        const float* dz1 = sm + L.act[0];
        if (tid < MT) {
          const int m = tid, q = p0 + m;
          if (q < PQ) {
            float acc = 0.f;
            for (int j = 0; j < H1; ++j) acc = fmaf(dz1[j * LDA + m], w1x[j], acc);
            vx[q] = sn[q % K] * acc;
          }
        } else if (tid - MT < H1) {
          const int j = tid - MT, mend = min(MT, PQ - p0);
          const float* v = dz1 + j * LDA;
          const float* sx = sm + L.sx;
          float accx = 0.f;
          // one row's pairs at a time: r's run ends at the tile's end or K
          for (int m = 0, r = p0 / K, n0 = p0 - r * K; m < mend; ++r, n0 = 0) {
            const int m_end = min(mend, m + K - n0);
            float run = 0.f;
#pragma unroll 4
            for (; m < m_end; ++m) {
              run += v[m];
              accx = fmaf(sx[m], v[m], accx);
            }
            dzsum[r * H1 + j] += run;
          }
          sums[L.pw[0] + j * F] += accx;
        }
      }
      __syncthreads();
    }

    // The row tile's node sums, in node order, on the last threads (dh
    // keeps the first ones busy).
    for (int r = NTHREADS - 1 - tid; r < rows; r += NTHREADS) {
      float s_r = 0.f, dxn = 0.f;
#pragma unroll 8
      for (int n = 0; n < K; ++n) {
        s_r += fw[r * K + n];
        dxn += vx[r * K + n];
      }
      S[row0 + r] = s_r;
      dx[row0 + r] = dxn + gs[r] * s_r * 0.5f;  // + the product-rule term
    }
    // dh = dz_sum W1[:, 1:].
    for (int i = tid; i < rows * e; i += NTHREADS) {
      const int r = i / e, k = i - r * e;
      float acc = 0.f;
#pragma unroll 4
      for (int j = 0; j < H1; ++j) acc = fmaf(dzsum[r * H1 + j], w1h[k * H1 + j], acc);
      dh[(size_t)row0 * e + i] = acc;
    }
    // dW1[:, 1:] += dz_sum^T h; the slot k = 0 (x's column, summed per pair
    // tile) takes db1 += sum_r dz_sum instead.
    for (int i = tid; i < H1 * F; i += NTHREADS) {
      const int j = i / F, k = i - j * F;
      float acc = 0.f;
      if (k == 0) {
        for (int r = 0; r < rows; ++r) acc += dzsum[r * H1 + j];
        sums[L.pb[0] + j] += acc;
      } else {
        for (int r = 0; r < rows; ++r) acc = fmaf(hs[r * e + k - 1], dzsum[r * H1 + j], acc);
        sums[L.pw[0] + i] += acc;
      }
    }
    __syncthreads();
  }

  // This block's dW/db sums into its slice.
  float* part = partial + (size_t)blockIdx.x * L.P;
  for (int i = tid; i < L.P; i += NTHREADS) part[i] = sums[i];
}

// out[p] = sum over the grid's blocks, in block order, of partial[b][p].
__global__ void integrand_bwd_p2_reduce(const float* __restrict__ partial,
                                        float* __restrict__ out, int P, int blocks) {
  sum_partials(partial, out, P, blocks);
}

// Checks the widths and the shared memory against the card and sets the
// kernel's dynamic shared memory.
cudaError_t prepare(int K, const int* widths, int n_layers, Dims* d, Layout* L) {
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, d)) return cudaErrorInvalidValue;
  *L = make_layout(*d, K);
  return set_smem(integrand_bwd_p2_kernel, (long long)L->total * sizeof(float));
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these widths and node count, in bytes;
// -1 if the widths are outside what the kernel takes (1 + e and every hidden
// width at most 64, 2 to MAX_LAYERS layers, one output).
long long umnn_integrand_bwd_p2_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// Blocks of the persistent grid for R rows: as many as are resident on the
// card at once (one per SM), at most one per row tile. It is also the number
// of partial-sum slices the caller allocates. A negative CUDA error code on
// failure.
int umnn_integrand_bwd_p2_grid(int R, int K, const int* widths, int n_layers) {
  Dims d;
  Layout L;
  int dev = 0, sms = 0, per_sm = 0;
  if (R < 1) return -(int)cudaErrorInvalidValue;
  cudaError_t err = prepare(K, widths, n_layers, &d, &L);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrand_bwd_p2_kernel,
                                                        NTHREADS, (size_t)L.total * sizeof(float));
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int tiles = (R + L.TR - 1) / L.TR;
  return tiles < per_sm * sms ? tiles : per_sm * sms;
}

// The sweep's launch shape for these widths, for reports: out[0] threads per
// block, out[1] shared bytes, out[2] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] registers per
// thread, out[4] pairs per tile, out[5] rows per row tile. Returns a CUDA
// error code (cudaErrorInvalidValue for widths the kernel cannot take).
int umnn_integrand_bwd_p2_occupancy(int K, const int* widths, int n_layers, int* out) {
  Dims d;
  Layout L;
  cudaError_t err = prepare(K, widths, n_layers, &d, &L);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, integrand_bwd_p2_kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrand_bwd_p2_kernel, NTHREADS,
                                                        (size_t)L.total * sizeof(float));
  if (err != cudaSuccess) return err;
  out[0] = NTHREADS;
  out[1] = L.total * (int)sizeof(float);
  out[2] = per_sm;
  out[3] = attr.numRegs;
  out[4] = L.MT;
  out[5] = L.TR;
  return cudaSuccess;
}

// Launches the sweep and the partial-sum reduction on `stream`; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for widths, shared
// memory or a grid the kernel cannot take). partial holds blocks x P floats,
// dparams P, with P the integrand's parameter count.
int umnn_integrand_bwd_p2(const float* x, const float* h, const float* params,
                          const float* nodes, const float* ccw, const float* g, float* dx,
                          float* dh, float* S, float* partial, float* dparams, int R, int K,
                          int blocks, const int* widths, int n_layers, float neg_slope,
                          void* stream) {
  Dims d;
  Layout L;
  if (R < 1 || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err = prepare(K, widths, n_layers, &d, &L);
  if (err != cudaSuccess) return err;
  cudaStream_t st = (cudaStream_t)stream;
  integrand_bwd_p2_kernel<<<blocks, NTHREADS, (size_t)L.total * sizeof(float), st>>>(
      x, h, params, nodes, ccw, g, dx, dh, S, partial, R, K, d, L, neg_slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  integrand_bwd_p2_reduce<<<(L.P + 255) / 256, 256, 0, st>>>(partial, dparams, L.P, blocks);
  return cudaGetLastError();
}

}  // extern "C"
