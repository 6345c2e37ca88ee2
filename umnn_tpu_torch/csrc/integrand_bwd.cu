// Backward of the Clenshaw-Curtis integral of the UMNN integrand MLP,
//
//   z_r = x_r/2 * sum_n w_n * f_{r,n},  f_{r,n} = ELU+1( MLP([x_r * s_n, h_r]) ),
//   s_n = (t_n+1)/2, LeakyReLU(neg_slope) between layers,
//
// for an upstream cotangent g_r: the exact derivative of this K-node sum with
// respect to every weight and bias, h_r and x_r (node path and product rule).
//
// Replaces the TPU kernel `_bwd_kernel` of umnn_tpu/ops/integrand_kernel.py
// (:156-317, launched by `_run_bwd` :954) together with its host fold in
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
// What this simple design does about that bound: plain float32 FMA on the
// CUDA cores (no TF32, no tensor cores). All weights, the per-row first-layer
// part and every hidden activation of a tile of MT (row, node) pairs live in
// shared memory; the dz of a layer overwrites that layer's activations in
// place. Each product is a shared-memory tile with a 4x4 register tile per
// thread. The per-block dW/db partials are read-modified-written in device
// memory once per pair tile; at 64 KB per block they stay in L2. Known waste,
// left to later work: warp tiles of 16 x 32 (dW) and 32 x 16 (dz) cover a
// 50 x 50 product as 64 x 64, so 39% of those lanes are masked; one block
// of 8 warps per SM is all the shared memory fits.

#include "common.cuh"

namespace {

constexpr int TR = 16;          // rows per row tile
constexpr int MT = 64;          // (row, node) pairs per pair tile
constexpr int LDA = MT + 4;     // row stride of an activation buffer
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_WIDTH = 128;  // hidden width
constexpr int MAX_FIRST = 1 << 30;  // 1 + e: bounded by shared memory alone

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes).
struct Layout {
  int w1t, b1, wout, ph, dzsum, xs, gs, s, ccw, fw, vx, dzl, total;
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], ldw[MAX_LAYERS];
  int act[MAX_LAYERS];  // output of layer l, [w[l+1]][LDA], l = 0 .. n_layers-2
};

__host__ __device__ inline Layout make_layout(const Dims& d, int K) {
  Layout L;
  const int H1 = d.w[1];
  int off = 0;
  L.w1t = off;  off += round_up(d.w[0] * H1, 4);  // W1 transposed: [1+e][H1]
  L.b1 = off;   off += round_up(H1, 4);
  for (int l = 1; l < d.n_layers - 1; ++l) {      // hidden: W^T [din][ldw], b [ldw]
    // +4: rows 4 apart fall in other banks when read by column (bwd_da)
    L.ldw[l] = round_up(d.w[l + 1], 16) + 4;
    L.hid_w[l] = off;  off += d.w[l] * L.ldw[l];
    L.hid_b[l] = off;  off += L.ldw[l];
  }
  L.wout = off;  off += round_up(d.w[d.n_layers - 1] + 1, 4);  // output row, then its bias
  L.ph = off;    off += TR * H1;
  L.dzsum = off; off += TR * H1;
  L.xs = off;    off += TR;
  L.gs = off;    off += TR;
  L.s = off;     off += round_up(K, 4);
  L.ccw = off;   off += round_up(K, 4);
  L.fw = off;    off += round_up(TR * K, 4);
  L.vx = off;    off += round_up(TR * K, 4);
  L.dzl = off;   off += MT;
  for (int l = 0; l < d.n_layers - 1; ++l) {
    L.act[l] = off;
    off += d.w[l + 1] * LDA;
  }
  L.total = off;
  return L;
}

// Forward of one hidden layer: out[j][m] = leaky(sum_k in[k][m] w[k][j] + b[j]).
// A warp computes 32 pairs x 16 outputs; each lane a 4x4 register tile.
__device__ void fwd_layer(const float* __restrict__ in, float* __restrict__ out,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          int din, int dout, int ldw, float neg_slope) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int mtiles = MT / 32;
  const int ntiles = mtiles * ((dout + 15) / 16);
  for (int t = warp; t < ntiles; t += NWARPS) {
    const int m0 = (t % mtiles) * 32 + (lane & 7) * 4;
    const int j0 = (t / mtiles) * 16 + (lane >> 3) * 4;
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < din; ++k) {
      const float4 a = ld4(in + k * LDA + m0);
      const float4 b = ld4(w + k * ldw + j0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j0 + j < dout) {
        const float bj = bias[j0 + j];
        float4 o;
        o.x = leaky(acc[0][j] + bj, neg_slope);
        o.y = leaky(acc[1][j] + bj, neg_slope);
        o.z = leaky(acc[2][j] + bj, neg_slope);
        o.w = leaky(acc[3][j] + bj, neg_slope);
        *reinterpret_cast<float4*>(out + (j0 + j) * LDA + m0) = o;
      }
    }
  }
}

// dz of the layer below, in place of its activations:
// act[k][m] := (sum_j W[j][k] dz[j][m]) * leaky'(act[k][m]), with W read from
// its transpose wt [din][ldw]. A lane's 4 k rows are 4 apart, so the four
// lane groups of a warp read consecutive rows of wt (different banks).
__device__ void bwd_da(const float* __restrict__ dz, float* __restrict__ act,
                       const float* __restrict__ wt, int din, int dout, int ldw,
                       float neg_slope) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int mtiles = MT / 32;
  const int ntiles = mtiles * ((din + 15) / 16);
  for (int t = warp; t < ntiles; t += NWARPS) {
    const int m0 = (t % mtiles) * 32 + (lane & 7) * 4;
    const int kb = (t / mtiles) * 16 + (lane >> 3);  // rows kb + 4*kk
    const float* wr[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wr[kk] = wt + min(kb + 4 * kk, din - 1) * ldw;
    float acc[4][4] = {};  // [pair][k]
#pragma unroll 4
    for (int j = 0; j < dout; ++j) {
      const float4 a = ld4(dz + j * LDA + m0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bv[kk] = wr[kk][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[i][kk] = fmaf(av[i], bv[kk], acc[i][kk]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kb + 4 * kk;
      if (k < din) {
        float* p = act + k * LDA + m0;
        const float4 a = ld4(p);
        float4 o;
        o.x = acc[0][kk] * (a.x > 0.f ? 1.f : neg_slope);
        o.y = acc[1][kk] * (a.y > 0.f ? 1.f : neg_slope);
        o.z = acc[2][kk] * (a.z > 0.f ? 1.f : neg_slope);
        o.w = acc[3][kk] * (a.w > 0.f ? 1.f : neg_slope);
        *reinterpret_cast<float4*>(p) = o;
      }
    }
  }
}

// dW[j][k] += sum_m a[k][m] dz[j][m] and db[j] += sum_m dz[j][m], into this
// block's partial sums. A warp covers 16 k x 32 j; a lane 4 consecutive k and
// 4 j rows 8 apart (the 8 lanes of a quarter warp read 8 consecutive dz rows).
__device__ void bwd_dw(const float* __restrict__ a, const float* __restrict__ dz,
                       float* __restrict__ dw, float* __restrict__ db, int din, int dout) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ktiles = (din + 15) / 16;
  const int ntiles = ktiles * ((dout + 31) / 32);
  for (int t = warp; t < ntiles; t += NWARPS) {
    const int k0 = (t % ktiles) * 16 + (lane >> 3) * 4;
    const int jb = (t / ktiles) * 32 + (lane & 7);
    const float* ar[4];
    const float* dr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ar[i] = a + min(k0 + i, din - 1) * LDA;
      dr[i] = dz + min(jb + 8 * i, dout - 1) * LDA;
    }
    float acc[4][4] = {};  // [k][j]
#pragma unroll 2
    for (int m = 0; m < MT; m += 4) {
      float4 av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = ld4(ar[i] + m);
        dv[i] = ld4(dr[i] + m);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float s = acc[i][jj];
          s = fmaf(av[i].x, dv[jj].x, s);
          s = fmaf(av[i].y, dv[jj].y, s);
          s = fmaf(av[i].z, dv[jj].z, s);
          s = fmaf(av[i].w, dv[jj].w, s);
          acc[i][jj] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = k0 + i, j = jb + 8 * jj;
        if (k < din && j < dout) dw[j * din + k] += acc[i][jj];
      }
  }
  for (int j = threadIdx.x; j < dout; j += NTHREADS) {
    float acc = 0.f;
    for (int m = 0; m < MT; ++m) acc += dz[j * LDA + m];
    db[j] += acc;
  }
}

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]] (the forward kernel's layout). partial: gridDim.x slices of
// the flat gradient (per layer dW [dout][din], then db).
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_bwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ params, const float* __restrict__ nodes,
                     const float* __restrict__ ccw, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ dh, float* __restrict__ S,
                     float* __restrict__ partial, int R, int K, Dims d, float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = make_layout(d, K);
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1], dl = d.w[nl - 1];
  int pw[MAX_LAYERS], pb[MAX_LAYERS];
  const int P = param_offsets(d, pw, pb);
  float* part = partial + (size_t)blockIdx.x * P;
  for (int i = tid; i < P; i += NTHREADS) part[i] = 0.f;

  // Stage the weights, zero-padded to ldw columns.
  const float* p = params;
  for (int i = tid; i < F * H1; i += NTHREADS) sm[L.w1t + i] = p[i];
  p += F * H1;
  for (int j = tid; j < H1; j += NTHREADS) sm[L.b1 + j] = p[j];
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
  float* fw = sm + L.fw;
  float* vx = sm + L.vx;
  float* dzl = sm + L.dzl;
  const int PQ = TR * K;  // pair q = r*K + n of the row tile
  const int n_tiles = (R + TR - 1) / TR;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR;
    // Rows past R get x = g = 0 and h = 0: every cotangent of theirs is 0.
    for (int r = tid; r < TR; r += NTHREADS) {
      const bool ok = row0 + r < R;
      xs[r] = ok ? x[row0 + r] : 0.f;
      gs[r] = ok ? g[row0 + r] : 0.f;
    }
    // Node-invariant first layer, once per row: ph = h W1[:, 1:]^T + b1.
    for (int i = tid; i < TR * H1; i += NTHREADS) {
      const int r = i / H1, j = i % H1;
      float acc = 0.f;
      if (row0 + r < R) {
        const float* hr = h + (size_t)(row0 + r) * e;
        for (int k = 0; k < e; ++k) acc = fmaf(hr[k], w1t[(k + 1) * H1 + j], acc);
      }
      ph[i] = acc + sm[L.b1 + j];
      dzsum[i] = 0.f;
    }
    __syncthreads();

    for (int p0 = 0; p0 < PQ; p0 += MT) {
      // Forward again, keeping every hidden activation.
      float* a0 = sm + L.act[0];
      for (int i = tid; i < H1 * MT; i += NTHREADS) {
        const int j = i / MT, m = i % MT, q = p0 + m;
        float v = 0.f;
        if (q < PQ) {
          const int r = q / K, n = q - r * K;
          v = leaky(ph[r * H1 + j] + sn[n] * xs[r] * w1t[j], neg_slope);
        }
        a0[j * LDA + m] = v;
      }
      __syncthreads();
      for (int l = 1; l < nl - 1; ++l) {
        fwd_layer(sm + L.act[l - 1], sm + L.act[l], sm + L.hid_w[l], sm + L.hid_b[l],
                  d.w[l], d.w[l + 1], L.ldw[l], neg_slope);
        __syncthreads();
      }
      // Output layer: f, its quadrature term, and the pair's cotangent
      // dzL = w_n g_r x_r/2 * min(f, 1) (pairs past the tile get 0).
      float* aL = sm + L.act[nl - 2];
      for (int m = tid; m < MT; m += NTHREADS) {
        const int q = p0 + m;
        float dz = 0.f;
        if (q < PQ) {
          const int r = q / K, n = q - r * K;
          float z = 0.f;
          for (int k = 0; k < dl; ++k) z = fmaf(aL[k * LDA + m], wout[k], z);
          z += wout[dl];
          const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
          fw[q] = cw[n] * f;
          dz = cw[n] * gs[r] * xs[r] * 0.5f * fminf(f, 1.f);
        }
        dzl[m] = dz;
      }
      __syncthreads();
      // The output layer's dW (one row) and db.
      for (int k = tid; k <= dl; k += NTHREADS) {
        float acc = 0.f;
        if (k < dl) {
          for (int m = 0; m < MT; ++m) acc = fmaf(aL[k * LDA + m], dzl[m], acc);
          part[pw[nl - 1] + k] += acc;
        } else {
          for (int m = 0; m < MT; ++m) acc += dzl[m];
          part[pb[nl - 1]] += acc;
        }
      }
      __syncthreads();
      // dz of the last hidden layer, in place of its activations.
      for (int i = tid; i < dl * MT; i += NTHREADS) {
        const int k = i / MT, m = i % MT;
        const float a = aL[k * LDA + m];
        aL[k * LDA + m] = dzl[m] * wout[k] * (a > 0.f ? 1.f : neg_slope);
      }
      __syncthreads();
      for (int l = nl - 2; l >= 1; --l) {
        bwd_dw(sm + L.act[l - 1], sm + L.act[l], part + pw[l], part + pb[l], d.w[l],
               d.w[l + 1]);
        __syncthreads();
        bwd_da(sm + L.act[l], sm + L.act[l - 1], sm + L.hid_w[l], d.w[l], d.w[l + 1],
               L.ldw[l], neg_slope);
        __syncthreads();
      }
      // Layer 1: act[0] now holds dz1. The node axis collapses here, each
      // sum taken by one thread in pair order.
      const float* dz1 = sm + L.act[0];
      for (int i = tid; i < H1 + MT; i += NTHREADS) {
        if (i < H1) {  // column j: dW1[j][0] and dz_sum[:, j]
          const int j = i;
          float accx = 0.f;
          for (int m = 0; m < MT && p0 + m < PQ; ++m) {
            const int q = p0 + m, r = q / K, n = q - r * K;
            const float v = dz1[j * LDA + m];
            accx = fmaf(sn[n] * xs[r], v, accx);
            dzsum[r * H1 + j] += v;
          }
          part[pw[0] + j * F] += accx;
        } else {  // pair m: s_n (dz1 . W1[:, 0]), x's node path
          const int m = i - H1, q = p0 + m;
          if (q < PQ) {
            const int n = q % K;
            float acc = 0.f;
            for (int j = 0; j < H1; ++j) acc = fmaf(dz1[j * LDA + m], w1t[j], acc);
            vx[q] = sn[n] * acc;
          }
        }
      }
      __syncthreads();
    }

    // The row tile's node sums, in node order.
    for (int r = tid; r < TR; r += NTHREADS) {
      if (row0 + r < R) {
        float s_r = 0.f, dxn = 0.f;
        for (int n = 0; n < K; ++n) {
          s_r += fw[r * K + n];
          dxn += vx[r * K + n];
        }
        S[row0 + r] = s_r;
        dx[row0 + r] = dxn + gs[r] * s_r * 0.5f;  // + the product-rule term
      }
    }
    // dh = dz_sum W1[:, 1:].
    for (int i = tid; i < TR * e; i += NTHREADS) {
      const int r = i / e, k = i % e;
      if (row0 + r < R) {
        float acc = 0.f;
        for (int j = 0; j < H1; ++j) acc = fmaf(dzsum[r * H1 + j], w1t[(k + 1) * H1 + j], acc);
        dh[(size_t)(row0 + r) * e + k] = acc;
      }
    }
    // dW1[:, 1:] += dz_sum^T h; the slot k = 0 (x's column, summed per pair
    // tile above) takes db1 += sum_r dz_sum instead.
    for (int i = tid; i < H1 * F; i += NTHREADS) {
      const int j = i / F, k = i % F;
      float acc = 0.f;
      if (k == 0) {
        for (int r = 0; r < TR; ++r) acc += dzsum[r * H1 + j];
        part[pb[0] + j] += acc;
      } else {
        for (int r = 0; r < TR && row0 + r < R; ++r)
          acc = fmaf(h[(size_t)(row0 + r) * e + k - 1], dzsum[r * H1 + j], acc);
        part[pw[0] + j * F + k] += acc;
      }
    }
    __syncthreads();
  }
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
  const long long bytes = (long long)make_layout(d, K).total * sizeof(float);
  cudaError_t err = set_smem(integrand_bwd_kernel, bytes);
  if (err != cudaSuccess) return err;
  int pw[MAX_LAYERS], pb[MAX_LAYERS];
  const int P = param_offsets(d, pw, pb);
  cudaStream_t st = (cudaStream_t)stream;
  integrand_bwd_kernel<<<blocks, NTHREADS, (size_t)bytes, st>>>(
      x, h, params, nodes, ccw, g, dx, dh, S, partial, R, K, d, neg_slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  integrand_bwd_reduce<<<(P + 255) / 256, 256, 0, st>>>(partial, dparams, P, blocks);
  return cudaGetLastError();
}

}  // extern "C"
