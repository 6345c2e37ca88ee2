// Backward of the Clenshaw-Curtis integral of the UMNN integrand MLP,
//
//   z_r = x_r/2 * sum_n w_n * f_{r,n},  f_{r,n} = ELU+1( MLP([x_r * s_n, h_r]) ),
//   s_n = (t_n+1)/2, LeakyReLU(neg_slope) between layers,
//
// for an upstream cotangent g_r: the exact derivative of this K-node sum with
// respect to every weight and bias, h_r and x_r (node path and product rule).
//
// Replaces the TPU kernel `_bwd_kernel` of umnn_tpu/ops/integrand_kernel.py
// (:156-317, launched by `_run_bwd` :981) together with its host fold in
// `_fused_vjp_bwd` (:1157-1198). What it computes, per (row, node) pair:
//   - the forward chain again (nothing of the forward is saved); the
//     LeakyReLU derivative comes from a > 0 and the ELU+1 derivative from
//     min(f, 1), so no pre-activation is kept;
//   - the cotangent ct = w_n g_r x_r/2 and the MLP's VJP down to layer 2;
//   - in layer 1 the node axis collapses before any contraction:
//     dz_sum_r = sum_n dz1_{r,n}, dW1[:, 1:] += dz_sum^T h, db1 += sum dz_sum,
//     dW1[:, 0] += sum_{r,n} x_r s_n dz1_{r,n}, dh_r = dz_sum_r W1[:, 1:],
//     dx_nodes_r = sum_n s_n (dz1_{r,n} . W1[:, 0]);
//   - S_r = sum_n w_n f_{r,n}, written out, and dx_r = dx_nodes_r + g_r S_r/2,
//     the product-rule term added here in the kernel (never z/x, which is
//     singular at x = 0).
// dW is written in nn.Linear's [dout, din] layout; the TPU kernel's
// transposed output row (a lane trick) is not carried over.
//
// The TPU grid ran in order and carried dW/db from one row tile to the next.
// Here the blocks run at once: a persistent grid of at most one block per SM
// walks the row tiles, each block accumulates dW/db into its own slice of a
// partial-sum workspace (allocated by the caller), and a second launch sums
// the slices in block order. No atomics: every partial element has one owner
// thread, so reruns on one card are bit-identical. Each row's nodes stay in
// one block, so dz_sum, dh, dx and S need no sum across blocks.
//
// Bound on an H100: operations. At the MNIST block shape (R = 78,400 rows,
// 51 nodes, widths 31-100-50-50-50-50-1) one sweep is 305 GFLOP of useful
// float32 work (forward again, the dz chain, the dW products; counted by
// chip_smoke.py::bwd_kernel_flops), against 20 MB of inputs and outputs:
// 4.6 ms at the 66.9 TFLOP/s float32 peak, 6 us at 3.35 TB/s.
//
// What the design does about that bound: plain float32 FMA on the CUDA cores
// (no TF32, no tensor cores), in one block of 16 warps per SM (512 threads, at
// most 128 registers each) that holds in shared memory the weights, every
// hidden activation of a tile of MT = 64 (row, node) pairs (the dz of a layer
// overwrites that layer's activations in place) and the block's dW/db sums:
// 213 KB at MNIST widths, K = 51 or 101.
//   - dW/db sums stay on chip for the block's whole walk over its row tiles.
//     Each element has one owner thread, the one whose register tile covers
//     it in every pair tile, so no barrier guards it; the block writes its
//     slice of the workspace once, at the end, with coalesced stores. When
//     the sums of every layer do not fit (e.g. 31-128-128-1), the layers
//     from the last one down that fit stay on chip and the rest are
//     read-modified-written in the slice once per pair tile, by the same
//     code through a generic pointer. dW1 and db1 (the h part, summed per
//     row tile) go to the slice once per 16-row tile, coalesced; dW1's x
//     column stays on chip.
//   - Weights are stored at their real width rounded up to 4 floats, plus 4
//     when that is an even number of 16-byte chunks (52 for 50, 100 for 100);
//     activation rows are MT + 4 = 68 floats apart, an odd number of chunks
//     too, so that rows read side by side fall in different banks.
//   - Register tiles fit 50 and 100: the forward gives a thread 4 pairs x 4
//     outputs (8 warps at width 50); the dz product 8 pairs x 4 inputs, in
//     registers, on ceil(din/16) warps while the other warps run the dW
//     product (2 dz rows x 4 input columns a thread, 4 rows where the dz
//     warps leave too few threads, db as the column of a row of ones),
//     after which the dz overwrites the activations. At MNIST widths that
//     pads 50 to 52 at most (4%). The block's layout comes in as a kernel
//     parameter, read from the constant bank, so that the 128 registers go
//     to the tiles and to loading each product's next operands before its
//     current FMAs: ptxas reports no spills.
//   - No serial tail: the output layer's dot product, its dW row, the
//     layer-1 collapse (dW1's x column, dz_sum by row, x's node path) and the
//     node sums of S and dx by row are spread over warps and reduced with
//     warp shuffles in a fixed order; the row sums of a pair tile run on a
//     warp that the next phase leaves idle. A pair tile takes 16 barriers at
//     MNIST widths (17 before).
// What is left (per-phase clocks of ops/bwd_phase_clock.py, MNIST block):
// the three products take about 83% of the time; counting the floats their
// register tiles load, they keep shared memory (128 bytes a clock) about
// 70% busy, and larger tiles need more registers than 512 threads leave.
// The row tile's last pair tile is part empty (816 pairs in 13 tiles of 64
// at K = 51).

#include "common.cuh"

namespace {

constexpr int TR = 16;          // rows per row tile
constexpr int MT = 64;          // (row, node) pairs per pair tile
constexpr int LDA = MT + 4;     // row stride of an activation buffer (an odd count of 16 B)
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_WIDTH = 128;  // hidden width
constexpr int MAX_FIRST = 1 << 30;  // 1 + e: bounded by shared memory alone
constexpr long long SMEM_LIMIT = 232448;  // an H100 block's opt-in shared memory
static_assert(MT == 4 * NWARPS, "the output layer gives each warp 4 pairs");
static_assert(TR <= 32, "a row tile's S and dx are written by the lanes of one warp");

// Row stride of a weight matrix with `dout` columns: an odd number of
// 16-byte chunks, so that rows read side by side fall in different banks.
inline int ldw_for(int dout) {
  const int v = round_up(dout, 4);
  return (v / 4) % 2 ? v : v + 4;
}

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes).
struct Layout {
  int w1t, b1, wout, ph, dzsum, xs, gs, sacc, dxacc, s, ccw, fwl, dzl, xsum, sums, total;
  int sums_from;  // first layer whose dW/db sums are on chip; n_layers: none
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], ldw[MAX_LAYERS];
  int P, pw[MAX_LAYERS], pb[MAX_LAYERS];  // the flat gradient (param_offsets)
  int act[MAX_LAYERS];  // output of layer l, [w[l+1]][LDA], l = 0 .. n_layers-2
};

inline Layout make_layout(const Dims& d, int K) {
  Layout L;
  const int nl = d.n_layers, F = d.w[0], H1 = d.w[1], dl = d.w[nl - 1];
  int off = 0;
  L.w1t = off;  off += round_up(F * H1, 4);  // W1 transposed: [1+e][H1]
  L.b1 = off;   off += round_up(H1, 4);
  for (int l = 1; l < nl - 1; ++l) {          // hidden: W^T [din][ldw], b [ldw]
    L.ldw[l] = ldw_for(d.w[l + 1]);
    L.hid_w[l] = off;  off += d.w[l] * L.ldw[l];
    L.hid_b[l] = off;  off += L.ldw[l];
  }
  L.wout = off;  off += round_up(dl + 1, 4);  // output row, then its bias
  L.ph = off;    off += TR * H1;
  L.dzsum = off; off += TR * H1;
  L.xs = off;    off += TR;
  L.gs = off;    off += TR;
  L.s = off;     off += round_up(K, 4);
  L.ccw = off;   off += round_up(K, 4);
  L.sacc = off;  off += TR;  // S and x's node path of the row tile's rows
  L.dxacc = off; off += TR;
  L.fwl = off;   off += MT;  // per pair: w_n f, ones for the db column, x's node path
  L.dzl = off;   off += MT;  // per pair: dzL
  for (int l = 0; l < nl - 1; ++l) {
    L.act[l] = off;
    off += d.w[l + 1] * LDA;
  }
  // On chip, as far as the block's shared memory holds them: dW1's x column,
  // then the dW/db sums of layers sums_from .. nl-1 in the flat gradient's
  // order, as many layers from the output down as fit.
  const int P = L.P = param_offsets(d, L.pw, L.pb);
  const int* pw = L.pw;
  L.xsum = off;
  L.sums = off + round_up(H1, 4);
  L.sums_from = nl;
  for (int l = 1; l < nl; ++l)
    if ((long long)(L.sums + round_up(P - pw[l], 4)) * 4 <= SMEM_LIMIT) {
      L.sums_from = l;
      break;
    }
  L.total = L.sums_from < nl ? L.sums + round_up(P - pw[L.sums_from], 4) : off;
  return L;
}

// Forward of one hidden layer: out[n][m] = leaky(sum_k in[k][m] w[k][n] + b[n]).
// A thread computes 4 pairs x 4 outputs; a warp 32 pairs x 16 outputs: lane
// l takes pairs from m0 = 32 (w % 2) + 4 (l >> 2) and outputs from
// n0 = 16 (w / 2) + 4 (l & 3). Lanes past the last output load nothing. The
// next k's operands are loaded before this k's FMAs.
__device__ __forceinline__ void fwd_layer(const float* __restrict__ in, float* __restrict__ out,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, int din, int dout,
                                          int ldw, float neg_slope) {
  const int lane = threadIdx.x & 31;
  const int nwt = 2 * (((dout + 3) / 4 + 3) / 4);
  for (int wt = threadIdx.x >> 5; wt < nwt; wt += NWARPS) {
    const int m0 = 32 * (wt % 2) + (lane >> 2) * 4;
    const int n0 = ((wt / 2) * 4 + (lane & 3)) * 4;
    if (n0 >= dout) continue;
    const float* pa = in + m0;
    const float* pw = w + n0;
    float acc[4][4] = {};
    float4 a = ld4(pa), b = ld4(pw);
#pragma unroll 4
    for (int k = 0; k < din; ++k) {
      const int kn = min(k + 1, din - 1);
      const float4 an = ld4(pa + kn * LDA), bn = ld4(pw + kn * ldw);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      a = an;
      b = bn;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n0 + c < dout) {
        const float bc = bias[n0 + c];
        float4 o;
        o.x = leaky(acc[0][c] + bc, neg_slope);
        o.y = leaky(acc[1][c] + bc, neg_slope);
        o.z = leaky(acc[2][c] + bc, neg_slope);
        o.w = leaky(acc[3][c] + bc, neg_slope);
        *reinterpret_cast<float4*>(out + (n0 + c) * LDA + m0) = o;
      }
    }
  }
}

// Warps that the dz product of a layer with `din` inputs takes: a warp
// computes 64 pairs x 16 consecutive k, a thread 8 pairs x 4 k, once.
__device__ __forceinline__ int da_warps(int din) { return (din + 15) / 16; }

// The dz product of the layer below, sum_j W[j][k] dz[j][m], into registers:
// a thread takes pairs m0 .. m0+3, m0+32 .. m0+35 (m0 = 4 (lane >> 2)) and
// k = k0 .. k0+3 (k0 = 16 warp + 4 (lane & 3)), reading W from its
// transpose wt [din][ldw] 4 j at a time. For warps below da_warps(din).
__device__ __forceinline__ void bwd_da(const float* __restrict__ dz, const float* __restrict__ wt,
                                       int din, int dout, int ldw, float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int m0 = (lane >> 2) * 4, k0 = (threadIdx.x >> 5) * 16 + (lane & 3) * 4;
  const float* wr[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wr[c] = wt + min(k0 + c, din - 1) * ldw;
  const float* pz = dz + m0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  if (k0 >= din) return;  // lanes past the last k load nothing
  const int j4 = dout & ~3;
#pragma unroll 2
  for (int j0 = 0; j0 < j4; j0 += 4) {
    float4 bw[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) bw[c] = ld4(wr[c] + j0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 a = ld4(pz + (j0 + jj) * LDA), a2 = ld4(pz + (j0 + jj) * LDA + 32);
      const float av[8] = {a.x, a.y, a.z, a.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = jj == 0 ? bw[c].x : jj == 1 ? bw[c].y : jj == 2 ? bw[c].z : bw[c].w;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][c] = fmaf(av[i], b, acc[i][c]);
      }
    }
  }
  for (int j = j4; j < dout; ++j) {  // the last dout % 4 rows of dz
    const float4 a = ld4(pz + j * LDA), a2 = ld4(pz + j * LDA + 32);
    const float av[8] = {a.x, a.y, a.z, a.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float b = wr[c][j];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][c] = fmaf(av[i], b, acc[i][c]);
    }
  }
}

// act[k][m] := acc * leaky'(act[k][m]): bwd_da's result, in place of the
// activations it is the dz of (once every warp is past reading them).
__device__ __forceinline__ void bwd_da_store(float* __restrict__ act, int din, float neg_slope,
                                             const float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int m0 = (lane >> 2) * 4, k0 = (threadIdx.x >> 5) * 16 + (lane & 3) * 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (k0 + c < din) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = act + (k0 + c) * LDA + m0 + 32 * h;
        const float4 a = ld4(p);
        float4 o;
        o.x = acc[4 * h + 0][c] * (a.x > 0.f ? 1.f : neg_slope);
        o.y = acc[4 * h + 1][c] * (a.y > 0.f ? 1.f : neg_slope);
        o.z = acc[4 * h + 2][c] * (a.z > 0.f ? 1.f : neg_slope);
        o.w = acc[4 * h + 3][c] * (a.w > 0.f ? 1.f : neg_slope);
        *reinterpret_cast<float4*>(p) = o;
      }
    }
  }
}

// dW[j][k] += sum_m a[k][m] dz[j][m] and db[j] += sum_m dz[j][m], into the
// block's sums (on chip or in its slice): db is column k = din, against a
// row of ones. Run by the threads from `first` on. A thread owns TJ rows
// j = h + i*ngj and 4 columns k = g + c*nkg, the same in every pair tile;
// thread t (counted from `first`) takes g = (t/4) % nkg and
// h = 4 (t/4 / nkg) + t % 4, so a quarter warp reads 2 rows of a (the warp
// 8, side by side) and 4 of dz. The next 4 pairs' operands are loaded before
// this 4's FMAs.
template <int TJ>
__device__ __forceinline__ void bwd_dw(const float* __restrict__ a, const float* __restrict__ dz,
                                       const float* __restrict__ ones, float* dw, float* db,
                                       int din, int dout, int first) {
  constexpr int TK = 4;
  const int nkg = (din + 1 + TK - 1) / TK, ngj = (dout + TJ - 1) / TJ;
  const int ntiles = nkg * round_up(ngj, 4);
  for (int t = threadIdx.x - first; t < ntiles; t += NTHREADS - first) {
    const int g = (t >> 2) % nkg, hj = (t >> 2) / nkg * 4 + (t & 3);
    if (hj >= ngj) continue;  // a padding lane of the last group of 4
    const float* ar[TK];
    const float* dr[TJ];
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const int k = g + c * nkg;
      ar[c] = k < din ? a + k * LDA : ones;
    }
#pragma unroll
    for (int i = 0; i < TJ; ++i) dr[i] = dz + min(hj + i * ngj, dout - 1) * LDA;
    float acc[TJ][TK] = {};
    float4 av[TK], dv[TJ];
#pragma unroll
    for (int c = 0; c < TK; ++c) av[c] = ld4(ar[c]);
#pragma unroll
    for (int i = 0; i < TJ; ++i) dv[i] = ld4(dr[i]);
#pragma unroll 4
    for (int m = 0; m < MT; m += 4) {
      const int mn = min(m + 4, MT - 4);
      float4 an[TK], dn[TJ];
#pragma unroll
      for (int c = 0; c < TK; ++c) an[c] = ld4(ar[c] + mn);
#pragma unroll
      for (int i = 0; i < TJ; ++i) dn[i] = ld4(dr[i] + mn);
      // pair by pair, so that consecutive FMAs are independent
#pragma unroll
      for (int i = 0; i < TJ; ++i)
#pragma unroll
        for (int c = 0; c < TK; ++c) acc[i][c] = fmaf(av[c].x, dv[i].x, acc[i][c]);
#pragma unroll
      for (int i = 0; i < TJ; ++i)
#pragma unroll
        for (int c = 0; c < TK; ++c) acc[i][c] = fmaf(av[c].y, dv[i].y, acc[i][c]);
#pragma unroll
      for (int i = 0; i < TJ; ++i)
#pragma unroll
        for (int c = 0; c < TK; ++c) acc[i][c] = fmaf(av[c].z, dv[i].z, acc[i][c]);
#pragma unroll
      for (int i = 0; i < TJ; ++i)
#pragma unroll
        for (int c = 0; c < TK; ++c) acc[i][c] = fmaf(av[c].w, dv[i].w, acc[i][c]);
#pragma unroll
      for (int c = 0; c < TK; ++c) av[c] = an[c];
#pragma unroll
      for (int i = 0; i < TJ; ++i) dv[i] = dn[i];
    }
#pragma unroll
    for (int i = 0; i < TJ; ++i) {
      const int j = hj + i * ngj;
      if (j < dout) {
#pragma unroll
        for (int c = 0; c < TK; ++c) {
          const int k = g + c * nkg;
          if (k < din) dw[j * din + k] += acc[i][c];
          else if (k == din) db[j] += acc[i][c];
        }
      }
    }
  }
}

// __syncthreads() for code that warps reach by different paths (each warp
// as a whole): the barrier without .aligned.
__device__ __forceinline__ void sync_block() { asm volatile("barrier.sync 0;" ::: "memory"); }

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums v over each run of lanes with equal r (r is nondecreasing over the
// warp); the run's first lane gets the total and `head`, lanes with r < 0
// never do. The order of the additions is fixed.
__device__ __forceinline__ float run_sum(float v, int r, bool* head) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    const int ru = __shfl_down_sync(0xffffffffu, r, o);
    if (lane + o < 32 && ru == r) v += u;
  }
  const int rp = __shfl_up_sync(0xffffffffu, r, 1);
  *head = r >= 0 && (lane == 0 || rp != r);
  return v;
}

// Adds a pair tile's per-pair values v[m] (pair q = p0 + m) into acc[row],
// by runs of pairs of one row; for one warp.
__device__ __forceinline__ void add_by_row(const float* v, float* acc, int p0, int PQ, int K) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = p0 + half * 32 + lane;
    bool head;
    const float t = run_sum(v[half * 32 + lane], q < PQ ? q / K : -1, &head);
    if (head) acc[q / K] += t;
    __syncwarp();
  }
}

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]] (the forward kernel's layout). partial: gridDim.x slices of
// the flat gradient (per layer dW [dout][din], then db). L: make_layout(d, K),
// computed on the host, so that the kernel reads it from the constant bank
// of its parameters instead of holding it in registers.
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_bwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ params, const float* __restrict__ nodes,
                     const float* __restrict__ ccw, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ dh, float* __restrict__ S,
                     float* __restrict__ partial, int R, int K, Dims d, Layout L,
                     float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1], dl = d.w[nl - 1];
  const int* pw = L.pw;
  const int* pb = L.pb;
  const int P = L.P;
  const int lo = L.sums_from, n_on_chip = lo < nl ? P - pw[lo] : 0;
  float* part = partial + (size_t)blockIdx.x * P;
  float* sums = sm + L.sums;
  // Where layer l's dW (then its db) and dW1's x column accumulate.
  auto dw_of = [&](int l) { return l >= lo ? sums + (pw[l] - pw[lo]) : part + pw[l]; };
  float* xcol = lo < nl ? sm + L.xsum : part + pw[0];
  const int xstride = lo < nl ? 1 : F;
  for (int i = tid; i < (lo < nl ? pw[lo] : P); i += NTHREADS) part[i] = 0.f;
  for (int i = tid; i < n_on_chip; i += NTHREADS) sums[i] = 0.f;

  // Stage the weights, hidden ones zero-padded to ldw columns.
  const float* p = params;
  for (int i = tid; i < F * H1; i += NTHREADS) sm[L.w1t + i] = p[i];
  p += F * H1;
  for (int j = tid; j < H1; j += NTHREADS) {
    sm[L.b1 + j] = p[j];
    if (lo < nl) sm[L.xsum + j] = 0.f;
  }
  p += H1;
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1], ldw = L.ldw[l];
    for (int i = tid; i < din * ldw; i += NTHREADS) {
      const int k = i / ldw, j = i % ldw;
      sm[L.hid_w[l] + i] = j < dout ? p[k * dout + j] : 0.f;
    }
    p += dout * din;
    for (int j = tid; j < ldw; j += NTHREADS) sm[L.hid_b[l] + j] = j < dout ? p[j] : 0.f;
    p += dout;
  }
  for (int k = tid; k <= dl; k += NTHREADS) sm[L.wout + k] = p[k];
  for (int n = tid; n < K; n += NTHREADS) {
    sm[L.s + n] = (nodes[n] + 1.f) * 0.5f;
    sm[L.ccw + n] = ccw[n];
  }
  __syncthreads();

  const float* w1t = sm + L.w1t;
  const float* wout = sm + L.wout;
  const float* sn = sm + L.s;
  const float* cw = sm + L.ccw;
  float* ph = sm + L.ph;
  float* dzsum = sm + L.dzsum;
  float* xs = sm + L.xs;
  float* gs = sm + L.gs;
  float* sacc = sm + L.sacc;
  float* dxacc = sm + L.dxacc;
  float* fwl = sm + L.fwl;
  float* dzl = sm + L.dzl;
  const int PQ = TR * K;  // pair q = r*K + n of the row tile
  const int n_tiles = (R + TR - 1) / TR;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    const int rows = min(TR, R - row0);
    const float* ht = h + (size_t)row0 * e;
    // Rows past R get x = g = 0 and h = 0: every cotangent of theirs is 0.
    for (int r = tid; r < TR; r += NTHREADS) {
      xs[r] = r < rows ? x[row0 + r] : 0.f;
      gs[r] = r < rows ? g[row0 + r] : 0.f;
      sacc[r] = 0.f;
      dxacc[r] = 0.f;
    }
    // Node-invariant first layer, once per row: ph = h W1[:, 1:]^T + b1.
    for (int i = tid; i < TR * H1; i += NTHREADS) {
      const int r = i / H1, j = i % H1;
      float acc = 0.f;
      if (r < rows)
        for (int k = 0; k < e; ++k) acc = fmaf(ht[r * e + k], w1t[(k + 1) * H1 + j], acc);
      ph[i] = acc + sm[L.b1 + j];
      dzsum[i] = 0.f;
    }
    __syncthreads();

    for (int p0 = 0; p0 < PQ; p0 += MT) {
      // Layer 1 forward; each thread one pair m and every 8th unit. With no
      // hidden layer, the last warp first adds the previous pair tile's node
      // paths into dx by row (else it does so in the first forward product,
      // where it is idle).
      {
        if (warp == NWARPS - 1 && p0 > 0 && nl == 2) add_by_row(fwl, dxacc, p0 - MT, PQ, K);
        const int m = tid % MT, q = p0 + m;
        const bool ok = q < PQ;
        const int r = ok ? q / K : 0, n = q - r * K;
        const float sx = ok ? sn[n] * xs[r] : 0.f;
        float* a0 = sm + L.act[0];
        for (int j = tid / MT; j < H1; j += NTHREADS / MT)
          a0[j * LDA + m] = ok ? leaky(fmaf(sx, w1t[j], ph[r * H1 + j]), neg_slope) : 0.f;
      }
      __syncthreads();
      // Forward again, keeping every hidden activation.
      for (int l = 1; l < nl - 1; ++l) {
        const int din = d.w[l], dout = d.w[l + 1];
        if (l == 1 && warp == NWARPS - 1 && p0 > 0) add_by_row(fwl, dxacc, p0 - MT, PQ, K);
        fwd_layer(sm + L.act[l - 1], sm + L.act[l], sm + L.hid_w[l], sm + L.hid_b[l], din, dout,
                  L.ldw[l], neg_slope);
        __syncthreads();
      }
      // Output layer, 4 pairs per warp and 8 lanes per pair: f, its
      // quadrature term and the pair's cotangent dzL = w_n g_r x_r/2 min(f, 1)
      // (0 past the row tile).
      float* aL = sm + L.act[nl - 2];
      {
        const int m = warp * 4 + (lane >> 3), kl = lane & 7;
        float z = 0.f;
        for (int k = kl; k < dl; k += 8) z = fmaf(aL[k * LDA + m], wout[k], z);
        z = warp_sum(z, 8) + wout[dl];
        if (kl == 0) {
          const int q = p0 + m, r = q / K, n = q - r * K;
          float dz = 0.f, fq = 0.f;
          if (q < PQ) {
            const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
            dz = cw[n] * gs[r] * xs[r] * 0.5f * fminf(f, 1.f);
            fq = cw[n] * f;
          }
          dzl[m] = dz;
          fwl[m] = fq;
        }
      }
      __syncthreads();
      // A warp per unit k of the last hidden layer: the output layer's dW row
      // (k = dl: its db) and the rank-1 dz of that layer, in place. The last
      // warp instead adds the quadrature terms into S by row, then leaves
      // ones in their place for the dW products' db column.
      {
        if (warp == NWARPS - 1) {
          add_by_row(fwl, sacc, p0, PQ, K);
          fwl[lane] = 1.f;
          fwl[32 + lane] = 1.f;
        }
        float* dwo = dw_of(nl - 1);
        const float z0 = dzl[lane], z1 = dzl[32 + lane];
        for (int k0 = 0; k0 <= dl && warp < NWARPS - 1; k0 += NWARPS - 1) {
          const int k = k0 + warp;
          if (k > dl) break;
          float c;
          if (k < dl) {
            float* pa = aL + k * LDA;
            const float a0 = pa[lane], a1 = pa[32 + lane];
            c = fmaf(a1, z1, a0 * z0);
            const float wk = wout[k];
            pa[lane] = z0 * wk * (a0 > 0.f ? 1.f : neg_slope);
            pa[32 + lane] = z1 * wk * (a1 > 0.f ? 1.f : neg_slope);
          } else {
            c = z0 + z1;
          }
          c = warp_sum(c, 32);
          if (lane == 0) dwo[k] += c;
        }
      }
      __syncthreads();
      // Each hidden layer's dW product on some warps while the others form
      // the dz of the layer below in registers; that dz then overwrites the
      // activations it is the dz of.
      for (int l = nl - 2; l >= 1; --l) {
        const int din = d.w[l], dout = d.w[l + 1];
        float* dwl = dw_of(l);
        const int nda = da_warps(din), first = nda * 32;
        if (warp < nda) {
          float dacc[8][4];
          bwd_da(sm + L.act[l], sm + L.hid_w[l], din, dout, L.ldw[l], dacc);
          sync_block();
          bwd_da_store(sm + L.act[l - 1], din, neg_slope, dacc);
        } else {
          if ((din + 4) / 4 * round_up((dout + 1) / 2, 4) <= NTHREADS - first)
            bwd_dw<2>(sm + L.act[l - 1], sm + L.act[l], fwl, dwl, dwl + dout * din, din, dout,
                      first);
          else
            bwd_dw<4>(sm + L.act[l - 1], sm + L.act[l], fwl, dwl, dwl + dout * din, din, dout,
                      first);
          sync_block();
        }
        __syncthreads();
      }
      // Layer 1: act[0] now holds dz1 and the node axis collapses.
      {
        const float* dz1 = sm + L.act[0];
        // dW1's x column and dz_sum by row. When the tile's pairs span at
        // most three rows (K >= 32), 8 lanes take a unit j, each lane 8
        // pairs in order, and their sums meet in 3 shuffle steps; else a
        // warp takes a unit and sums each run of one row's pairs.
        const int r_lo = p0 / K, r_hi = (min(p0 + MT, PQ) - 1) / K;
        if (r_hi - r_lo <= 2) {
          const int o8 = lane & 7, m0 = o8 * 8;
          float sxv[8];  // s_n x_r of this lane's 8 pairs (0 past the row tile)
          int rv[8];     // their rows, from r_lo
          {
            int r = (p0 + m0) / K, n = p0 + m0 - r * K;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              sxv[i] = p0 + m0 + i < PQ ? sn[n] * xs[r] : 0.f;
              rv[i] = r - r_lo;
              if (++n == K) {
                n = 0;
                ++r;
              }
            }
          }
          for (int j0 = 0; j0 < H1; j0 += 4 * NWARPS) {
            const int j = min(j0 + 4 * warp + (lane >> 3), H1 - 1);
            const float4 va = ld4(dz1 + j * LDA + m0), vb = ld4(dz1 + j * LDA + m0 + 4);
            const float v[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
            float t[4] = {};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              t[0] = fmaf(sxv[i], v[i], t[0]);
              t[1] += rv[i] == 0 ? v[i] : 0.f;
              t[2] += rv[i] == 1 ? v[i] : 0.f;
              t[3] += rv[i] == 2 ? v[i] : 0.f;
            }
#pragma unroll
            for (int o = 1; o < 8; o *= 2)
#pragma unroll
              for (int i = 0; i < 4; ++i) t[i] += __shfl_xor_sync(0xffffffffu, t[i], o);
            if (o8 == 0 && j0 + 4 * warp + (lane >> 3) < H1) {
              xcol[j * xstride] += t[0];
              for (int i = 0; i <= r_hi - r_lo; ++i) dzsum[(r_lo + i) * H1 + j] += t[1 + i];
            }
          }
        } else {
          int rr[2];  // row of this lane's pair in each half warp, -1 past the row tile
          float sx[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = p0 + half * 32 + lane, r = q / K;
            rr[half] = q < PQ ? r : -1;
            sx[half] = q < PQ ? sn[q - r * K] * xs[r] : 0.f;
          }
          for (int j0 = 0; j0 < H1; j0 += NWARPS) {
            const int j = j0 + warp;
            if (j >= H1) break;
            const float v0 = dz1[j * LDA + lane], v1 = dz1[j * LDA + 32 + lane];
            const float c = warp_sum(fmaf(sx[1], v1, sx[0] * v0), 32);
            if (lane == 0) xcol[j * xstride] += c;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              bool head;
              const float t = run_sum(half ? v1 : v0, rr[half], &head);
              if (head) dzsum[rr[half] * H1 + j] += t;
              __syncwarp();
            }
          }
        }
        // 4 pairs per warp, 8 lanes per pair: x's node path s_n (dz1 . W1[:, 0]).
        const int m = warp * 4 + (lane >> 3), jl = lane & 7;
        float acc = 0.f;
        for (int j = jl; j < H1; j += 8) acc = fmaf(dz1[j * LDA + m], w1t[j], acc);
        acc = warp_sum(acc, 8);
        if (jl == 0) {
          const int q = p0 + m;
          fwl[m] = q < PQ ? sn[q - q / K * K] * acc : 0.f;
        }
      }
      __syncthreads();
    }

    // The row tile's S and dx, by the last warp after it adds the last
    // pair tile's node paths.
    if (warp == NWARPS - 1) {
      add_by_row(fwl, dxacc, (PQ - 1) / MT * MT, PQ, K);
      if (lane < rows) {
        S[row0 + lane] = sacc[lane];
        dx[row0 + lane] = dxacc[lane] + gs[lane] * sacc[lane] * 0.5f;  // + the product-rule term
      }
    }
    // dh = dz_sum W1[:, 1:].
    for (int i = tid; i < rows * e; i += NTHREADS) {
      const int r = i / e, k = i % e;
      float acc = 0.f;
      for (int j = 0; j < H1; ++j) acc = fmaf(dzsum[r * H1 + j], w1t[(k + 1) * H1 + j], acc);
      dh[(size_t)row0 * e + i] = acc;
    }
    // dW1[:, 1:] += dz_sum^T h in the slice, coalesced; the slot k = 0 (x's
    // column, summed per pair tile) takes db1 += sum_r dz_sum instead.
    for (int i = tid; i < H1 * F; i += NTHREADS) {
      const int j = i / F, k = i % F;
      float acc = 0.f;
      if (k == 0) {
        for (int r = 0; r < TR; ++r) acc += dzsum[r * H1 + j];
        part[pb[0] + j] += acc;
      } else {
        for (int r = 0; r < rows; ++r) acc = fmaf(ht[r * e + k - 1], dzsum[r * H1 + j], acc);
        part[pw[0] + i] += acc;
      }
    }
    __syncthreads();
  }

  // What stayed on chip, once, into this block's slice.
  for (int i = tid; i < n_on_chip; i += NTHREADS) part[pw[lo] + i] = sums[i];
  if (lo < nl)
    for (int j = tid; j < H1; j += NTHREADS) part[pw[0] + j * F] = sm[L.xsum + j];
}

// out[p] = sum over the grid's blocks, in block order, of partial[b][p].
__global__ void integrand_bwd_reduce(const float* __restrict__ partial,
                                     float* __restrict__ out, int P, int blocks) {
  sum_partials(partial, out, P, blocks);
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these widths and node count, in bytes;
// -1 if the widths are outside what the kernel takes.
long long umnn_integrand_bwd_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_FIRST, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// Blocks of the persistent grid for R rows (at most one per SM), which is
// also the number of partial-sum slices the caller allocates; a negative
// CUDA error code on failure.
int umnn_integrand_bwd_grid(int R) {
  if (R < 1) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (R + TR - 1) / TR;
  return tiles < sms ? tiles : sms;
}

// The sweep's launch shape for these widths, for reports: out[0] threads per
// block, out[1] shared bytes, out[2] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] registers per
// thread, out[4] the first layer whose dW/db sums stay on chip. Returns a
// CUDA error code (cudaErrorInvalidValue for widths the kernel cannot take).
int umnn_integrand_bwd_occupancy(int K, const int* widths, int n_layers, int* out) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_FIRST, &d)) return cudaErrorInvalidValue;
  const Layout L = make_layout(d, K);
  const long long bytes = (long long)L.total * sizeof(float);
  cudaError_t err = set_smem(integrand_bwd_kernel, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, integrand_bwd_kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrand_bwd_kernel, NTHREADS,
                                                        (size_t)bytes);
  if (err != cudaSuccess) return err;
  out[0] = NTHREADS;
  out[1] = (int)bytes;
  out[2] = per_sm;
  out[3] = attr.numRegs;
  out[4] = L.sums_from;
  return cudaSuccess;
}

// Launches the sweep and the partial-sum reduction on `stream`; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for widths, shared
// memory or a grid the kernel cannot take). partial holds blocks x P floats,
// dparams P, with P the integrand's parameter count.
int umnn_integrand_bwd(const float* x, const float* h, const float* params,
                       const float* nodes, const float* ccw, const float* g, float* dx,
                       float* dh, float* S, float* partial, float* dparams, int R, int K,
                       int blocks, const int* widths, int n_layers, float neg_slope,
                       void* stream) {
  Dims d;
  if (K < 1 || R < 1 || blocks < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_FIRST, &d))
    return cudaErrorInvalidValue;
  const Layout L = make_layout(d, K);
  const long long bytes = (long long)L.total * sizeof(float);
  cudaError_t err = set_smem(integrand_bwd_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int P = L.P;
  cudaStream_t st = (cudaStream_t)stream;
  integrand_bwd_kernel<<<blocks, NTHREADS, (size_t)bytes, st>>>(
      x, h, params, nodes, ccw, g, dx, dh, S, partial, R, K, d, L, neg_slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  integrand_bwd_reduce<<<(P + 255) / 256, 256, 0, st>>>(partial, dparams, P, blocks);
  return cudaGetLastError();
}

}  // extern "C"
