// Backward of the Clenshaw-Curtis integral of the UMNN integrand MLP for
// integrands whose every layer is at most 32 wide (the pack-4 route):
//
//   z_r = x_r/2 * sum_n w_n * f_{r,n},  f_{r,n} = ELU+1( MLP([x_r * s_n, h_r]) ),
//   s_n = (t_n+1)/2, LeakyReLU(neg_slope) between layers,
//
// for an upstream cotangent g_r: the exact derivative of this K-node sum with
// respect to every weight and bias, h_r and x_r (node path and product rule).
// It computes the same function as integrand_bwd.cu; only the grouping of
// the (row, node) items and the order of the sums differ.
//
// Replaces the TPU kernel `_bwd_kernel_pn` of umnn_tpu/ops/integrand_kernel.py
// (:573-700, launched by `_run_bwd_pn` :829) together with its host fold in
// `_fused_vjp_bwd_pn` (:1242-1284). There four nodes share a matmul row
// through diag(W, W, W, W), K padded to a multiple of 4; the kernel forms the
// cross-block gradients too, the host drops them, sums the four diagonal
// blocks and gathers h's gradient from four feature slots. Here the unit of
// work is a (row, node) item with no padding: every item of a tile adds into
// one dW and one db, and there is one h per row, so the fold becomes
// nothing; the weight float4 that feeds 4 items x 4 columns of a register
// tile is what diag(W, W, W, W) buys on the MXU. Per item it computes
//   - the forward chain again (nothing of the forward is saved), in the
//     order integrand_fwd_p4.cu takes it (layer 1: an in-order FMA chain
//     over h plus the bias, x w1x rounded once and one FMA with s_n; later
//     layers an in-order FMA chain, then the bias); the LeakyReLU derivative
//     comes from a > 0 and the ELU+1 derivative from min(f, 1);
//   - the cotangent ct = w_n g_r x_r/2 and the MLP's VJP down to layer 2;
//   - in layer 1 the node axis collapses before any contraction:
//     dz_sum_r = sum_n dz1_{r,n}, dW1[:, 1:] += dz_sum^T h, db1 += sum dz_sum,
//     dW1[:, 0] += sum_{r,n} x_r s_n dz1_{r,n}, dh_r = dz_sum_r W1[:, 1:],
//     dx_nodes_r = sum_n s_n (dz1_{r,n} . W1[:, 0]);
//   - S_r = sum_n w_n f_{r,n}, written out, and dx_r = dx_nodes_r + g_r S_r/2
//     (never z/x, which is singular at x = 0).
// dW comes out in nn.Linear's [dout, din] layout.
//
// Bound on an H100: operations, but below a launch at the shapes that use
// it: the toy flow's block (R = 512 rows, 17 nodes, widths 11-32-32-1) is
// 58.08 MFLOP (chip_smoke.py::bwd_kernel_flops), 0.87 us at the 66.9 TFLOP/s
// float32 peak; a 4,096-row block 6.92 us. Two empty launches at its shape
// take about 1.8 us on the card (chip_smoke.py::launch_floor_ms), so its time
// is set by how soon each SM gets through its share: staging, a chain of
// barriers, and the products.
//
// What the design does about it: plain float32 FMA on the CUDA cores, in a
// persistent grid of at most one 256-thread block per resident slot (one per
// SM at these widths).
//   - The host picks the rows per row tile from R and the slots, the fewest
//     waves first: the toy block's 512 rows are 128 tiles of 4 rows (68
//     items), 4,096 rows 128 tiles of 32 (544 items), one per block.
//   - Each block stages the weights once, straight from each layer's own
//     tensor (their addresses a __grid_constant__ argument, so nothing is
//     repacked on the host), every copy a cp.async in flight at once, lane a
//     column and warp a row: no division, no bank conflict. Each weight is
//     kept once, as nn.Linear keeps it; the forward and dz products read it
//     along and across its rows.
//   - A row tile's items go through the MLP in one item tile where it fits
//     in shared memory (else in tiles of MT items), on 4 x 4 register tiles:
//     the forward again and the dz products in the same function.
//   - dW: warp w rows 4w .. 4w + 3, lane a column, the warp's dz loads alike
//     for all lanes; db 8 threads a row meeting by shuffles. The block keeps
//     its dW/db sums in shared memory for its whole walk, in the flat
//     gradient's layout, and writes them to its own slice once, so there
//     are as many slices as blocks; a second launch of (P + 31)/32 blocks
//     sums them, lanes over parameters and warps over slices, in a fixed
//     order. No atomics: reruns on one card are bit-identical.
//   - Each row's nodes stay in one block, so dz_sum, dh, dx and S need no
//     sum across blocks; each node sum is taken by one thread in node order.
//   - The layout is computed on the host and read from the constant bank.

#include "pack4.cuh"

namespace {

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes),
// and the tile sizes: TR rows a row tile, MT items an item tile (MTp rounded
// up to 4). ld[l]: layer l+1's width rounded up to 4, the rows of act[l],
// its output; LDA: an activation row's stride, 4 past a multiple of 32 so
// that the dW product's lanes, a row each, read other banks. Layer 1: w1
// (W1 as it is, [ld0][ldw1]), b1. Hidden layer l: wn (W as it is,
// [ld[l]][ld[l-1]]), bias. Per row of the row tile (stride ldr): ph, xw (x w1x), dzsum and xpart (dW1[:, 0]'s part);
// fw and vx per (row, node), stride ldfw (odd). sums: the block's dW/db sums
// at the flat gradient's offsets pw, pb.
struct Layout {
  int TR, MT, MTp, LDA, ldr, ldfw, ldw1, P;
  int w1, b1, wout, bout, sums, s, ccw, xs, gs, hs, ph, xw, dzsum, xpart, fw, vx,
      dzl, total;
  int ld[MAX_LAYERS], wn[MAX_LAYERS], bias[MAX_LAYERS], act[MAX_LAYERS];
  int pw[MAX_LAYERS], pb[MAX_LAYERS];
};

inline Layout layout_for(const Dims& d, int K, int TR, int MT) {
  Layout L;
  const int nl = d.n_layers, F = d.w[0], e = F - 1, H1 = d.w[1];
  L.TR = TR;
  L.MT = MT;
  L.MTp = round_up(MT, 4);
  L.LDA = L.MTp + (36 - L.MTp % 32) % 32;
  for (int l = 0; l < nl - 1; ++l) L.ld[l] = round_up(d.w[l + 1], 4);
  const int ld0 = L.ld[0];
  L.ldr = ld0 % 8 == 0 ? ld0 + 4 : ld0;  // rows of ph read side by side: other banks
  L.ldfw = K | 1;
  L.ldw1 = F | 1;
  L.P = param_offsets(d, L.pw, L.pb);
  int off = 0;
  L.w1 = off;   off += round_up(ld0 * L.ldw1, 4);
  L.b1 = off;   off += ld0;
  for (int l = 1; l < nl - 1; ++l) {
    L.wn[l] = off;    off += L.ld[l] * L.ld[l - 1];
    L.bias[l] = off;  off += L.ld[l];
  }
  L.wout = off;  off += L.ld[nl - 2];
  L.bout = off;  off += 4;
  L.sums = off;  off += round_up(L.P, 4);
  L.s = off;     off += round_up(K, 4);
  L.ccw = off;   off += round_up(K, 4);
  L.xs = off;    off += round_up(TR, 4);
  L.gs = off;    off += round_up(TR, 4);
  L.hs = off;    off += round_up(TR * e, 4);
  L.ph = off;    off += TR * L.ldr;
  L.xw = off;    off += TR * L.ldr;
  L.dzsum = off; off += TR * L.ldr;
  L.xpart = off; off += TR * L.ldr;
  L.fw = off;    off += round_up(TR * L.ldfw, 4);
  L.vx = off;    off += round_up(TR * L.ldfw, 4);
  L.dzl = off;   off += L.MTp;
  for (int l = 0; l < nl - 1; ++l) {
    L.act[l] = off;
    off += L.ld[l] * L.LDA;
  }
  L.total = off;
  return L;
}

inline Fit fit_for(const Dims& d, int K) {
  return fit([&](int TR, int MT) { return (long long)layout_for(d, K, TR, MT).total * 4; }, K);
}

// The largest layout a launch may take, for the shared memory reported and
// set: TR rows of whole item tiles where one row's items fit, else one row in
// item tiles of MT; past every size, the smallest, which the launcher refuses.
inline Layout make_layout(const Dims& d, int K) {
  const Fit f = fit_for(d, K);
  return f.tr > 0 ? layout_for(d, K, f.tr, f.tr * K) : layout_for(d, K, 1, f.mt > 0 ? f.mt : 4);
}

// The layout and grid of a launch for R rows on `slots` resident blocks.
inline Layout launch_layout(const Dims& d, int K, int R, int slots, int* grid) {
  const Fit f = fit_for(d, K);
  const int TR = f.tr > 0 ? rows_per_tile(R, slots, f.tr) : 1;
  const int tiles = (R + TR - 1) / TR;
  *grid = tiles < slots ? tiles : slots;
  return f.tr > 0 ? layout_for(d, K, TR, TR * K) : layout_for(d, K, 1, f.mt > 0 ? f.mt : 4);
}

// A hidden layer's dW and db over the item tile: dW[j][k] += sum_m dz[j][m]
// a[k][m] (dW in nn.Linear's layout, [dout][din]), db[j] += sum_m dz[j][m].
// dW: warp w rows 4w .. 4w + 3 (clamped to the last row, not written), lane
// k a column (lanes past din read the last one), 4 items a 16-byte load.
// db: 8 threads a row, every 8th group of 4 items, meeting by shuffles.
__device__ __forceinline__ void dw_product(const float* __restrict__ a,
                                           const float* __restrict__ dz, float* dw, float* db,
                                           int din, int dout, int MTp, int LDA) {
  const int lane = threadIdx.x & 31, j0 = 4 * (threadIdx.x >> 5);
  if (j0 < dout) {
    const float* ar = a + min(lane, din - 1) * LDA;
    const float* dr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dr[i] = dz + min(j0 + i, dout - 1) * LDA;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int m = 0; m < MTp; m += 4) {
      const float4 v = ld4(ar + m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 u = ld4(dr[i] + m);
        acc[i] = fmaf(u.x, v.x, acc[i]);
        acc[i] = fmaf(u.y, v.y, acc[i]);
        acc[i] = fmaf(u.z, v.z, acc[i]);
        acc[i] = fmaf(u.w, v.w, acc[i]);
      }
    }
    if (lane < din)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j0 + i < dout) dw[(j0 + i) * din + lane] += acc[i];
  }
  const int j = threadIdx.x >> 3, part = threadIdx.x & 7;
  float c = 0.f;
  if (j < dout)
    for (int m = 4 * part; m < MTp; m += 32) {
      const float4 u = ld4(dz + j * LDA + m);
      c += u.x + u.y + u.z + u.w;
    }
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  c += __shfl_xor_sync(0xffffffffu, c, 4);
  if (part == 0 && j < dout) db[j] += c;
}

// partial: gridDim.x slices of the flat gradient (per layer dW [dout][din],
// then db). W: the layers' own tensors. L: launch_layout(...), computed on
// the host, so that the kernel reads it from the constant bank.
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_bwd_p4_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        const __grid_constant__ Weights W, const float* __restrict__ nodes,
                        const float* __restrict__ ccw, const float* __restrict__ g,
                        float* __restrict__ dx, float* __restrict__ dh, float* __restrict__ S,
                        float* __restrict__ partial, int R, int K,
                        const __grid_constant__ Dims d, const __grid_constant__ Layout L,
                        float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int nl = d.n_layers, F = d.w[0], e = F - 1, H1 = d.w[1], dl = d.w[nl - 1];
  const int TR = L.TR, MTp = L.MTp, LDA = L.LDA, ldr = L.ldr, ldfw = L.ldfw;
  const int ld0 = L.ld[0];

  // Stage the weights once, from the layers' own tensors, and the first row
  // tile's x, g and h, every copy in flight (cp.async); zero the dW/db sums.
  float* xs = sm + L.xs;
  float* gs = sm + L.gs;
  float* hs = sm + L.hs;
  auto stage_rows = [&](int tile) {  // a row tile's x, g and h
    const int row0 = tile * TR, rows = min(TR, R - row0);
    for (int r = tid; r < rows; r += NTHREADS) {
      cp_async4(xs + r, x + row0 + r);
      cp_async4(gs + r, g + row0 + r);
    }
    const float* hg = h + (size_t)row0 * e;
    for (int i = tid; i < rows * e; i += NTHREADS) cp_async4(hs + i, hg + i);
  };

  stage_layer1(sm + L.w1, sm + L.b1, W.w[0], W.b[0], F, H1, ld0, L.ldw1);
  for (int l = 1; l < nl - 1; ++l)
    stage_hidden(sm + L.wn[l], sm + L.bias[l], W.w[l], W.b[l], d.w[l], d.w[l + 1], L.ld[l - 1],
                 L.ld[l]);
  stage_output_and_nodes(sm + L.wout, sm + L.bout, sm + L.s, sm + L.ccw, W.w[nl - 1],
                         W.b[nl - 1], dl, L.ld[nl - 2], nodes, ccw, K);
  stage_rows(blockIdx.x);
  for (int i = tid; i < L.P; i += NTHREADS) sm[L.sums + i] = 0.f;

  const float* w1 = sm + L.w1;
  const int ldw1 = L.ldw1;
  const float* wout = sm + L.wout;
  const float* sn = sm + L.s;
  const float* cw = sm + L.ccw;
  float* sums = sm + L.sums;
  float* ph = sm + L.ph;
  float* xw = sm + L.xw;
  float* dzsum = sm + L.dzsum;
  float* xpart = sm + L.xpart;
  float* fw = sm + L.fw;
  float* vx = sm + L.vx;
  float* dzl = sm + L.dzl;
  float* aL = sm + L.act[nl - 2];
  const int n_tiles = (R + TR - 1) / TR;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR, rows = min(TR, R - row0);
    // The row tile's x, g and h (the first's are in flight already); zero
    // its node sums of dz1.
    if (tile != (int)blockIdx.x) stage_rows(tile);
    for (int i = tid; i < TR * ldr; i += NTHREADS) dzsum[i] = xpart[i] = 0.f;
    cp_async_wait_all();
    if (tile == (int)blockIdx.x) nodes_to_s(sm + L.s, K);
    __syncthreads();
    // Node-invariant first layer, once per row.
    first_layer_rows(ph, xw, hs, xs, w1, sm + L.b1, rows, e, ld0, ldw1, ldr);
    __syncthreads();

    const int PQ = rows * K;
    for (int p0 = 0; p0 < PQ; p0 += L.MT) {
      const int mt = min(L.MT, PQ - p0);
      // Forward again, keeping every hidden activation: layer 1 from ph and
      // the rank-1 node term (items past the row tile: 0).
      layer1(sm + L.act[0], ph, xw, sn, p0, mt, MTp, LDA, K, ld0, ldr, neg_slope);
      __syncthreads();
      // Hidden layers.
      for (int l = 1; l < nl - 1; ++l) {
        product<false>(sm + L.act[l - 1], sm + L.act[l], sm + L.wn[l], sm + L.bias[l],
                       L.ld[l - 1], L.ld[l], MTp, LDA, neg_slope);
        __syncthreads();
      }
      // Output layer: f, its quadrature term, and the item's cotangent
      // dzL = w_n g_r x_r/2 * min(f, 1) (items past the row tile get 0).
      const float bout = sm[L.bout];
      for (int m = tid; m < MTp; m += NTHREADS) {
        float dz = 0.f;
        if (m < mt) {
          const int q = p0 + m, r = q / K, n = q - r * K;
          const float z = output_z(aL + m, wout, bout, dl, LDA);
          const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
          fw[r * ldfw + n] = cw[n] * f;
          dz = cw[n] * gs[r] * xs[r] * 0.5f * fminf(f, 1.f);
        }
        dzl[m] = dz;
      }
      __syncthreads();
      // Four threads per unit k of the last hidden layer: the output layer's
      // dW row (k = dl: its db, the sum of dzL) and the rank-1 dz of that
      // layer in place (padded units keep their 0); each thread every 4th
      // group of 4 items, the four sums meeting by two shuffles.
      {
        const int k = tid >> 2, part = tid & 3;
        float c = 0.f;
        if (k < dl) {
          float* pa = aL + k * LDA;
          const float wk = wout[k];
          for (int m = 4 * part; m < MTp; m += 16) {
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
          for (int m = 4 * part; m < MTp; m += 16) {
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
        dw_product(sm + L.act[l - 1], sm + L.act[l], sums + L.pw[l], sums + L.pb[l], d.w[l],
                   d.w[l + 1], MTp, LDA);
        __syncthreads();
        // The dz of the layer below, in place.
        product<true>(sm + L.act[l], sm + L.act[l - 1], sm + L.wn[l], nullptr, L.ld[l],
                      L.ld[l - 1], MTp, LDA, neg_slope);
        __syncthreads();
      }
      // Layer 1: act[0] now holds dz1, and the node axis collapses. A thread
      // per item: x's node path s_n (dz1 . W1[:, 0]). A thread per (row,
      // unit): the row's items of this tile in node order, into dz_sum and
      // dW1[:, 0]'s part of the row.
      {
        const float* dz1 = sm + L.act[0];
        for (int m = tid; m < mt; m += NTHREADS) {
          const int q = p0 + m, r = q / K, n = q - r * K;
          float acc = 0.f;
          for (int j = 0; j < H1; ++j) acc = fmaf(dz1[j * LDA + m], w1[j * ldw1], acc);
          vx[r * ldfw + n] = sn[n] * acc;
        }
        const int r0 = p0 / K, nr = (p0 + mt - 1) / K - r0 + 1;
        for (int i = tid; i < nr * H1; i += NTHREADS) {
          const int j = i / nr, r = r0 + i - j * nr;
          const int q0 = max(r * K, p0), q1 = min(r * K + K, p0 + mt);
          const float* v = dz1 + j * LDA - p0;
          const float* sr = sn - r * K;
          const float xr = xs[r];
          float run = 0.f, accx = 0.f;
          for (int q = q0; q < q1; ++q) {
            run += v[q];
            accx = fmaf(sr[q] * xr, v[q], accx);
          }
          dzsum[r * ldr + j] += run;
          xpart[r * ldr + j] += accx;
        }
      }
      __syncthreads();
    }

    // The row tile's node sums, in node order, on the last threads (dh
    // keeps the first ones busy).
    for (int r = NTHREADS - 1 - tid; r < rows; r += NTHREADS) {
      float s_r = 0.f, dxn = 0.f;
#pragma unroll 4
      for (int n = 0; n < K; ++n) {
        s_r += fw[r * ldfw + n];
        dxn += vx[r * ldfw + n];
      }
      S[row0 + r] = s_r;
      dx[row0 + r] = dxn + gs[r] * s_r * 0.5f;  // + the product-rule term
    }
    // dh = dz_sum W1[:, 1:], a thread per (row, input).
    for (int i = tid; i < rows * e; i += NTHREADS) {
      const int r = i / e, k = i - r * e;
      const float* dzr = dzsum + r * ldr;
      float acc = 0.f;
      for (int j = 0; j < H1; ++j) acc = fmaf(dzr[j], w1[j * ldw1 + 1 + k], acc);
      dh[(size_t)row0 * e + i] = acc;
    }
    // dW1 += [x's part | dz_sum^T h], a thread per (unit, column); db1 +=
    // sum_r dz_sum on the last threads.
    for (int i = tid; i < H1 * F; i += NTHREADS) {
      const int j = i / F, k = i - j * F;
      float acc = 0.f;
      if (k == 0) {
#pragma unroll 4
        for (int r = 0; r < rows; ++r) acc += xpart[r * ldr + j];
      } else {
#pragma unroll 4
        for (int r = 0; r < rows; ++r) acc = fmaf(hs[r * e + k - 1], dzsum[r * ldr + j], acc);
      }
      sums[L.pw[0] + i] += acc;
    }
    for (int j = NTHREADS - 1 - tid; j < H1; j += NTHREADS) {
      float acc = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) acc += dzsum[r * ldr + j];
      sums[L.pb[0] + j] += acc;
    }
    __syncthreads();
  }

  // This block's dW/db sums into its slice.
  float* part = partial + (size_t)blockIdx.x * L.P;
  for (int i = tid; i < L.P; i += NTHREADS) part[i] = sums[i];
}

// out[p] = sum over the grid's blocks of partial[b][p] in a fixed order:
// block i takes parameters 32i .. 32i + 31, a lane each; warp w sums the
// slices w, w + 8, ... in order, then lane p of warp 0 the 8 warps' sums.
__global__ void __launch_bounds__(NTHREADS)
integrand_bwd_p4_reduce(const float* __restrict__ partial, float* __restrict__ out, int P,
                        int blocks) {
  __shared__ float warp_sums[NWARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, p = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (p < P)
    for (int b = warp; b < blocks; b += NWARPS) acc += partial[(size_t)b * P + p];
  warp_sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && p < P) {
    float s = warp_sums[0][lane];
    for (int w = 1; w < NWARPS; ++w) s += warp_sums[w][lane];
    out[p] = s;
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs at most for these widths and node count,
// in bytes (a launch's row tile may take less); -1 if the widths are outside
// what the kernel takes (1 + e and every hidden width at most 32, 2 to
// MAX_LAYERS layers, one output).
long long umnn_integrand_bwd_p4_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// Once per widths, K and device: checks them, lets the kernel take the
// card's opt-in shared memory and returns the blocks resident on the card
// at once with the largest layout of these widths and K (blocks per SM,
// times the SMs): the `slots` of the launcher, and the partial-sum slices
// the caller allocates. A negative CUDA error code on failure.
int umnn_integrand_bwd_p4_slots(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d))
    return -(int)cudaErrorInvalidValue;
  return resident_blocks(integrand_bwd_p4_kernel,
                         (long long)make_layout(d, K).total * sizeof(float));
}

// The sweep's launch shape for R rows, for reports: out[0] threads per block,
// out[1] shared bytes of the launch, out[2] resident blocks per SM, out[3]
// registers per thread, out[4] items per item tile, out[5] rows per row
// tile, out[6] blocks, out[7] slices summed by the reduction (one per
// block). Returns a CUDA error code (cudaErrorInvalidValue for widths the
// kernel cannot take).
int umnn_integrand_bwd_p4_occupancy(int R, int K, const int* widths, int n_layers, int* out) {
  Dims d;
  const int slots = umnn_integrand_bwd_p4_slots(K, widths, n_layers);
  if (slots < 1) return -slots;
  if (R < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return cudaErrorInvalidValue;
  int grid = 0, per_sm = 0;
  const Layout L = launch_layout(d, K, R, slots, &grid);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, integrand_bwd_p4_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, integrand_bwd_p4_kernel, NTHREADS,
        (size_t)make_layout(d, K).total * sizeof(float));
  if (err != cudaSuccess) return err;
  out[0] = NTHREADS;
  out[1] = L.total * (int)sizeof(float);
  out[2] = per_sm;
  out[3] = attr.numRegs;
  out[4] = L.MT;
  out[5] = L.TR;
  out[6] = grid;
  out[7] = grid;
  return cudaSuccess;
}

// Launches the sweep and the partial-sum reduction on `stream`; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for widths, shared
// memory or slots the kernel cannot take). layers: the device addresses
// of each layer's weight ([dout][din], nn.Linear's layout) and bias, w0, b0,
// w1, b1, ...; slots: umnn_integrand_bwd_p4_slots's count for these widths
// and K on this device; partial holds slots x P floats, dparams P, with P
// the integrand's parameter count, and every element of dparams is written.
int umnn_integrand_bwd_p4(const float* x, const float* h, const float* const* layers,
                          const float* nodes, const float* ccw, const float* g, float* dx,
                          float* dh, float* S, float* partial, float* dparams, int R, int K,
                          int slots, const int* widths, int n_layers, float neg_slope,
                          void* stream) {
  Dims d;
  if (R < 1 || K < 1 || slots < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d))
    return cudaErrorInvalidValue;
  int grid = 0;
  const Layout L = launch_layout(d, K, R, slots, &grid);
  if ((long long)L.total * sizeof(float) > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  integrand_bwd_p4_kernel<<<grid, NTHREADS, (size_t)L.total * sizeof(float), st>>>(
      x, h, weights_at(layers, n_layers), nodes, ccw, g, dx, dh, S, partial, R, K, d, L,
      neg_slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  integrand_bwd_p4_reduce<<<(L.P + 31) / 32, NTHREADS, 0, st>>>(partial, dparams, L.P, grid);
  return cudaGetLastError();
}

}  // extern "C"
