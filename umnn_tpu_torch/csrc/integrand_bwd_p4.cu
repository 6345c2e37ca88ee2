// Backward of the Clenshaw-Curtis integral of the UMNN integrand MLP for
// integrands whose every layer is at most 32 wide, four quadrature nodes at a
// time:
//
//   z_r = x_r/2 * sum_n w_n * f_{r,n},  f_{r,n} = ELU+1( MLP([x_r * s_n, h_r]) ),
//   s_n = (t_n+1)/2, LeakyReLU(neg_slope) between layers,
//
// for an upstream cotangent g_r: the exact derivative of this K-node sum with
// respect to every weight and bias, h_r and x_r (node path and product rule).
// It computes the same function as integrand_bwd.cu; only the grouping of
// nodes and the order of the sums differ.
//
// Replaces the TPU kernel `_bwd_kernel_pn` of umnn_tpu/ops/integrand_kernel.py
// (:573-700, launched by `_run_bwd_pn` :829) together with its host fold in
// `_fused_vjp_bwd_pn` (:1242-1284). There four nodes share a matmul row
// through diag(W, W, W, W); the kernel forms the cross-block gradients too
// and writes the output layer's dW transposed (:646-657), the host drops the
// cross blocks, sums the four diagonal ones, and gathers h's gradient from
// four feature slots. Here the unit of work is one row's group of nodes
// (4j, ..., 4j+3), K padded to a multiple of 4 with nodes at t = -1 and
// weight 0 (no output changes for them): the four nodes of a group add into
// one dW and one db, and there is one h per row, so the fold becomes nothing.
// Per (row, node) it computes
//   - the forward chain again (nothing of the forward is saved), in the
//     order integrand_fwd_p4.cu takes it; the LeakyReLU derivative comes
//     from a > 0 and the ELU+1 derivative from min(f, 1);
//   - the cotangent ct = w_n g_r x_r/2 and the MLP's VJP down to layer 2;
//   - in layer 1 the node axis collapses before any contraction:
//     dz_sum_r = sum_n dz1_{r,n}, dW1[:, 1:] += dz_sum^T h, db1 += sum dz_sum,
//     dW1[:, 0] += sum_{r,n} x_r s_n dz1_{r,n}, dh_r = dz_sum_r W1[:, 1:],
//     dx_nodes_r = sum_n s_n (dz1_{r,n} . W1[:, 0]);
//   - S_r = sum_n w_n f_{r,n}, written out, and dx_r = dx_nodes_r + g_r S_r/2
//     (never z/x, which is singular at x = 0).
// dW comes out in nn.Linear's [dout, din] layout.
//
// Bound on an H100: operations, but below a launch's latency at the shapes
// that use it: the toy flow's block (R = 512 rows, 17 nodes, widths
// 11-32-32-1) is 58.08 MFLOP (chip_smoke.py::bwd_kernel_flops), 0.87 us at
// the 66.9 TFLOP/s float32 peak; a 4,096-row block 6.92 us.
//
// What the design does about it: plain float32 FMA on the CUDA cores. A block
// of 128 threads keeps the weights and its own dW/db sums (about 6 KB each at
// the toy widths, under 30 KB at MAX_LAYERS) in shared memory, beside every
// hidden activation of a tile of MP = 16 (row, group) units, so several
// blocks share an SM. A persistent grid of as many blocks as fit on the card
// at once, and at most one per row tile, walks row tiles of TR = 2 rows: the
// toy block's 512 rows are 256 tiles, a block each. dW/db partial sums stay
// in shared memory for the whole walk and go to device memory once per block,
// each block into its own slice; a second launch sums the slices in block
// order. No atomics: every element has one owner thread, so reruns on one
// card are bit-identical. Each row's nodes stay in one block, so dz_sum, dh,
// dx and S need no sum across blocks. In the forward and dz products a
// thread keeps a register tile in which a weight value feeds all four nodes
// of its unit. Known waste, left to later work: a row tile's 10 units (at
// K = 17) in a 16-unit tile, three padding nodes in its last group, widths
// padded to multiples of 4, no tensor cores.

#include "common.cuh"

namespace {

constexpr int NODES = 4;          // nodes per unit
constexpr int TR = 2;             // rows per row tile
constexpr int MP = 16;            // (row, node group) units per unit tile
constexpr int NI = NODES * MP;    // (row, node) items per unit tile: node slot s at s * MP
constexpr int LDA = NI + 4;       // row stride of an activation tile (rows 4 apart: other banks)
constexpr int NTHREADS = 128;
constexpr int MAX_WIDTH = 32;     // 1 + e and every hidden width

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes).
// Weights: layer 0 as W1^T [1+e][ldw[0]]; hidden layer l as W^T
// [w[l]][ldw[l]]; the output row with its bias at index ldw[n_layers-2].
// ldw[l] = round_up(w[l+1], 4), zero-padded. The dW/db sums use the same
// layout from `grad` on. Activations of layer l: [ldw[l]][LDA], padded rows 0.
struct Layout {
  int w1t, b1, wout, nweights, grad, ph, dzsum, xs, gs, s, ccw, fw, vx, dzl, total;
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], ldw[MAX_LAYERS], act[MAX_LAYERS];
};

__host__ __device__ inline Layout make_layout(const Dims& d, int K) {
  Layout L;
  const int Kp = round_up(K, NODES);
  for (int l = 0; l < d.n_layers - 1; ++l) L.ldw[l] = round_up(d.w[l + 1], 4);
  int off = 0;
  L.w1t = off;  off += d.w[0] * L.ldw[0];
  L.b1 = off;   off += L.ldw[0];
  for (int l = 1; l < d.n_layers - 1; ++l) {
    L.hid_w[l] = off;  off += d.w[l] * L.ldw[l];
    L.hid_b[l] = off;  off += L.ldw[l];
  }
  L.wout = off;  off += round_up(L.ldw[d.n_layers - 2] + 1, 4);
  L.nweights = off;
  L.grad = off;  off += L.nweights;
  L.ph = off;    off += TR * L.ldw[0];
  L.dzsum = off; off += TR * L.ldw[0];
  L.xs = off;    off += 4;
  L.gs = off;    off += 4;
  L.s = off;     off += Kp;
  L.ccw = off;   off += Kp;
  L.fw = off;    off += TR * Kp;
  L.vx = off;    off += TR * Kp;
  L.dzl = off;   off += NI;
  for (int l = 0; l < d.n_layers - 1; ++l) {
    L.act[l] = off;
    off += L.ldw[l] * LDA;
  }
  L.total = off;
  return L;
}

// Forward of one hidden layer: out[j][i] = leaky(sum_k in[k][i] w[k][j] + b[j])
// for j < ldo (padded outputs come out 0), an in-order FMA chain over k < din.
// Thread: unit u (all four nodes) x outputs 4og..4og+3.
__device__ void fwd_layer(const float* __restrict__ in, float* __restrict__ out,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          int din, int ldo, float neg_slope) {
  const int u = threadIdx.x & 15, og = threadIdx.x >> 4;
  if (4 * og >= ldo) return;
  const int j0 = 4 * og;
  float acc[NODES][4] = {};  // [node][output]
#pragma unroll
  for (int k0 = 0; k0 < MAX_WIDTH; k0 += 4) {
    if (k0 >= din) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      if (k < din) {
        const float4 c = ld4(w + k * ldo + j0);
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int s = 0; s < NODES; ++s) {
          const float a = in[k * LDA + s * MP + u];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][j] = fmaf(a, cv[j], acc[s][j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float bj = bias[j0 + j];
#pragma unroll
    for (int s = 0; s < NODES; ++s)
      out[(j0 + j) * LDA + s * MP + u] = leaky(acc[s][j] + bj, neg_slope);
  }
}

// dz of the layer below, in place of its activations, rows k < din:
// act[k][i] := (sum_j dz[j][i] W[j][k]) * leaky'(act[k][i]), W read from its
// transpose wt [din][ldo] four columns at a time. Thread: unit u (all four
// nodes) x rows 4kg..4kg+3.
__device__ void bwd_da(const float* __restrict__ dz, float* __restrict__ act,
                       const float* __restrict__ wt, int din, int ldo, float neg_slope) {
  const int u = threadIdx.x & 15, kg = threadIdx.x >> 4;
  if (4 * kg >= din) return;
  const int k0 = 4 * kg;
  const float* wr[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wr[kk] = wt + min(k0 + kk, din - 1) * ldo;
  float acc[NODES][4] = {};  // [node][k]
#pragma unroll
  for (int j0 = 0; j0 < MAX_WIDTH; j0 += 4) {
    if (j0 >= ldo) break;
    float wv[4][4];  // [k][j]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 c = ld4(wr[kk] + j0);
      wv[kk][0] = c.x; wv[kk][1] = c.y; wv[kk][2] = c.z; wv[kk][3] = c.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int s = 0; s < NODES; ++s) {
        const float dv = dz[(j0 + jj) * LDA + s * MP + u];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[s][kk] = fmaf(dv, wv[kk][jj], acc[s][kk]);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = k0 + kk;
    if (k < din) {
#pragma unroll
      for (int s = 0; s < NODES; ++s) {
        float* p = act + k * LDA + s * MP + u;
        *p = acc[s][kk] * (*p > 0.f ? 1.f : neg_slope);
      }
    }
  }
}

// dW[k][j] += sum_i a[k][i] dz[j][i] (k < din, j < dout, dW kept as W^T
// [din][ldo]) and db[j] += sum_i dz[j][i], over the tile's NI items. A
// thread owns rows kb + ks*{0,1,2,3} (consecutive lanes, consecutive rows:
// other banks) and columns 2jt, 2jt+1.
__device__ void bwd_dw(const float* __restrict__ a, const float* __restrict__ dz,
                       float* __restrict__ dw, float* __restrict__ db, int din, int dout,
                       int ldo) {
  const int ks = (din + 3) / 4;
  const int ntiles = ks * ((dout + 1) / 2);
  for (int t = threadIdx.x; t < ntiles; t += NTHREADS) {
    const int kb = t % ks, j0 = 2 * (t / ks);
    const float* ar[4];
    const float* dr[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ar[i] = a + min(kb + ks * i, din - 1) * LDA;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) dr[jj] = dz + min(j0 + jj, dout - 1) * LDA;
    float acc[4][2] = {};
#pragma unroll 4
    for (int m = 0; m < NI; m += 4) {
      float4 av[4], dv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = ld4(ar[i] + m);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) dv[jj] = ld4(dr[jj] + m);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
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
      for (int jj = 0; jj < 2; ++jj) {
        const int k = kb + ks * i, j = j0 + jj;
        if (k < din && j < dout) dw[k * ldo + j] += acc[i][jj];
      }
  }
  for (int j = threadIdx.x; j < dout; j += NTHREADS) {
    float acc = 0.f;
    for (int m = 0; m < NI; ++m) acc += dz[j * LDA + m];
    db[j] += acc;
  }
}

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]] (the forward kernels' layout). partial: gridDim.x slices of
// the flat gradient (per layer dW [dout][din], then db).
__global__ void __launch_bounds__(NTHREADS, 3)
integrand_bwd_p4_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        const float* __restrict__ params, const float* __restrict__ nodes,
                        const float* __restrict__ ccw, const float* __restrict__ g,
                        float* __restrict__ dx, float* __restrict__ dh, float* __restrict__ S,
                        float* __restrict__ partial, int R, int K, Dims d, float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = make_layout(d, K);
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1], ld0 = L.ldw[0];
  const int dl = d.w[nl - 1], ldl = L.ldw[nl - 2];
  const int K4 = (K + NODES - 1) / NODES, Kp = NODES * K4;

  // Stage the weights, zero-padded to ldw columns; zero the dW/db sums.
  const float* p = params;
  for (int i = tid; i < F * ld0; i += NTHREADS) {
    const int k = i / ld0, j = i % ld0;
    sm[L.w1t + i] = j < H1 ? p[k * H1 + j] : 0.f;
  }
  p += F * H1;
  for (int j = tid; j < ld0; j += NTHREADS) sm[L.b1 + j] = j < H1 ? p[j] : 0.f;
  p += H1;
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1], ldo = L.ldw[l];
    for (int i = tid; i < din * ldo; i += NTHREADS) {
      const int k = i / ldo, j = i % ldo;
      sm[L.hid_w[l] + i] = j < dout ? p[k * dout + j] : 0.f;
    }
    p += dout * din;
    for (int j = tid; j < ldo; j += NTHREADS) sm[L.hid_b[l] + j] = j < dout ? p[j] : 0.f;
    p += dout;
  }
  for (int k = tid; k <= ldl; k += NTHREADS)
    sm[L.wout + k] = k < dl ? p[k] : (k == ldl ? p[dl] : 0.f);  // the bias at ldl
  for (int i = tid; i < L.nweights; i += NTHREADS) sm[L.grad + i] = 0.f;
  for (int n = tid; n < Kp; n += NTHREADS) {
    // padding nodes up to a multiple of 4: t = -1 (s = 0), weight 0
    sm[L.s + n] = n < K ? (nodes[n] + 1.f) * 0.5f : 0.f;
    sm[L.ccw + n] = n < K ? ccw[n] : 0.f;
  }
  __syncthreads();

  const float* w1t = sm + L.w1t;
  const float* wout = sm + L.wout;
  const float* sn = sm + L.s;
  const float* cw = sm + L.ccw;
  float* gw = sm + L.grad;  // dW/db sums, at the weights' offsets
  float* ph = sm + L.ph;
  float* dzsum = sm + L.dzsum;
  float* xs = sm + L.xs;
  float* gs = sm + L.gs;
  float* fw = sm + L.fw;
  float* vx = sm + L.vx;
  float* dzl = sm + L.dzl;
  const int PQ = TR * K4;  // unit q = r*K4 + jg of the row tile: nodes 4jg..4jg+3
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
    for (int i = tid; i < TR * ld0; i += NTHREADS) {
      const int r = i / ld0, j = i % ld0;
      float acc = 0.f;
      if (row0 + r < R) {
        const float* hr = h + (size_t)(row0 + r) * e;
        for (int k = 0; k < e; ++k) acc = fmaf(hr[k], w1t[(k + 1) * ld0 + j], acc);
      }
      ph[i] = acc + sm[L.b1 + j];
      dzsum[i] = 0.f;
    }
    __syncthreads();

    for (int q0 = 0; q0 < PQ; q0 += MP) {
      // Forward again, keeping every hidden activation; layer 1 for the four
      // nodes of each unit from ph and the rank-1 node term.
      float* a0 = sm + L.act[0];
      for (int i = tid; i < ld0 * MP; i += NTHREADS) {
        const int j = i / MP, m = i % MP, q = q0 + m;
        float v[NODES] = {};
        if (q < PQ) {
          const int r = q / K4, n = NODES * (q - r * K4);
          const float phr = ph[r * ld0 + j], xw = xs[r] * w1t[j];
#pragma unroll
          for (int s = 0; s < NODES; ++s) v[s] = leaky(fmaf(sn[n + s], xw, phr), neg_slope);
        }
#pragma unroll
        for (int s = 0; s < NODES; ++s) a0[j * LDA + s * MP + m] = v[s];
      }
      __syncthreads();
      for (int l = 1; l < nl - 1; ++l) {
        fwd_layer(sm + L.act[l - 1], sm + L.act[l], sm + L.hid_w[l], sm + L.hid_b[l], d.w[l],
                  L.ldw[l], neg_slope);
        __syncthreads();
      }
      // Output layer: f, its quadrature term, and the item's cotangent
      // dzL = w_n g_r x_r/2 * min(f, 1) (items past the row tile get 0).
      float* aL = sm + L.act[nl - 2];
      for (int i = tid; i < NI; i += NTHREADS) {
        const int slot = i / MP, m = i % MP, q = q0 + m;
        float dz = 0.f;
        if (q < PQ) {
          const int r = q / K4, n = NODES * (q - r * K4) + slot;
          float z = 0.f;
          for (int k = 0; k < dl; ++k) z = fmaf(aL[k * LDA + i], wout[k], z);
          z += wout[ldl];
          const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
          fw[r * Kp + n] = cw[n] * f;
          dz = cw[n] * gs[r] * xs[r] * 0.5f * fminf(f, 1.f);
        }
        dzl[i] = dz;
      }
      __syncthreads();
      // The output layer's dW (one row) and db.
      for (int k = tid; k <= dl; k += NTHREADS) {
        float acc = 0.f;
        if (k < dl) {
          for (int i = 0; i < NI; ++i) acc = fmaf(aL[k * LDA + i], dzl[i], acc);
          gw[L.wout + k] += acc;
        } else {
          for (int i = 0; i < NI; ++i) acc += dzl[i];
          gw[L.wout + ldl] += acc;
        }
      }
      __syncthreads();
      // dz of the last hidden layer, in place of its activations (padded rows
      // have wout = 0 and stay 0).
      for (int i = tid; i < ldl * NI; i += NTHREADS) {
        const int k = i / NI, m = i % NI;
        const float a = aL[k * LDA + m];
        aL[k * LDA + m] = dzl[m] * wout[k] * (a > 0.f ? 1.f : neg_slope);
      }
      __syncthreads();
      for (int l = nl - 2; l >= 1; --l) {
        bwd_dw(sm + L.act[l - 1], sm + L.act[l], gw + L.hid_w[l], gw + L.hid_b[l], d.w[l],
               d.w[l + 1], L.ldw[l]);
        __syncthreads();
        bwd_da(sm + L.act[l], sm + L.act[l - 1], sm + L.hid_w[l], d.w[l], L.ldw[l], neg_slope);
        __syncthreads();
      }
      // Layer 1: act[0] now holds dz1. The node axis collapses here, each
      // sum taken by one thread in (unit, node) order.
      const float* dz1 = sm + L.act[0];
      for (int i = tid; i < H1 + NI; i += NTHREADS) {
        if (i < H1) {  // column j: dW1[j][0] and dz_sum[:, j]
          const int j = i;
          float accx = 0.f;
          for (int m = 0; m < MP && q0 + m < PQ; ++m) {
            const int q = q0 + m, r = q / K4, n = NODES * (q - r * K4);
            float sum = 0.f;
#pragma unroll
            for (int s = 0; s < NODES; ++s) {
              const float v = dz1[j * LDA + s * MP + m];
              accx = fmaf(sn[n + s] * xs[r], v, accx);
              sum += v;
            }
            dzsum[r * ld0 + j] += sum;
          }
          gw[L.w1t + j] += accx;
        } else {  // item: s_n (dz1 . W1[:, 0]), x's node path
          const int it = i - H1, slot = it / MP, m = it % MP, q = q0 + m;
          if (q < PQ) {
            const int r = q / K4, n = NODES * (q - r * K4) + slot;
            float acc = 0.f;
            for (int j = 0; j < H1; ++j) acc = fmaf(dz1[j * LDA + it], w1t[j], acc);
            vx[r * Kp + n] = sn[n] * acc;
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
          s_r += fw[r * Kp + n];
          dxn += vx[r * Kp + n];
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
        for (int j = 0; j < H1; ++j) acc = fmaf(dzsum[r * ld0 + j], w1t[(k + 1) * ld0 + j], acc);
        dh[(size_t)(row0 + r) * e + k] = acc;
      }
    }
    // dW1[:, 1:] += dz_sum^T h; db1 += sum_r dz_sum.
    for (int i = tid; i < F * H1; i += NTHREADS) {
      const int k = i / H1, j = i % H1;
      float acc = 0.f;
      if (k == 0) {
        for (int r = 0; r < TR; ++r) acc += dzsum[r * ld0 + j];
        gw[L.b1 + j] += acc;
      } else {
        for (int r = 0; r < TR && row0 + r < R; ++r)
          acc = fmaf(h[(size_t)(row0 + r) * e + k - 1], dzsum[r * ld0 + j], acc);
        gw[L.w1t + k * ld0 + j] += acc;
      }
    }
    __syncthreads();
  }

  // This block's dW/db sums into its slice, in nn.Linear's layout.
  int pw[MAX_LAYERS], pb[MAX_LAYERS];
  const int P = param_offsets(d, pw, pb);
  float* part = partial + (size_t)blockIdx.x * P;
  for (int i = tid; i < H1 * F; i += NTHREADS) {
    const int j = i / F, k = i % F;
    part[pw[0] + i] = gw[L.w1t + k * ld0 + j];
  }
  for (int j = tid; j < H1; j += NTHREADS) part[pb[0] + j] = gw[L.b1 + j];
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1], ldo = L.ldw[l];
    for (int i = tid; i < dout * din; i += NTHREADS) {
      const int j = i / din, k = i % din;
      part[pw[l] + i] = gw[L.hid_w[l] + k * ldo + j];
    }
    for (int j = tid; j < dout; j += NTHREADS) part[pb[l] + j] = gw[L.hid_b[l] + j];
  }
  for (int k = tid; k < dl; k += NTHREADS) part[pw[nl - 1] + k] = gw[L.wout + k];
  if (tid == 0) part[pb[nl - 1]] = gw[L.wout + ldl];
}

// out[p] = sum over the grid's blocks, in block order, of partial[b][p].
__global__ void integrand_bwd_p4_reduce(const float* __restrict__ partial,
                                        float* __restrict__ out, int P, int blocks) {
  sum_partials(partial, out, P, blocks);
}

// Checks the widths and the shared memory against the card and sets the
// kernel's dynamic shared memory; the byte count on success.
cudaError_t prepare(int K, const int* widths, int n_layers, Dims* d, int* bytes) {
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, d))
    return cudaErrorInvalidValue;
  *bytes = make_layout(*d, K).total * (int)sizeof(float);
  return set_smem(integrand_bwd_p4_kernel, *bytes);
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these widths and node count, in bytes;
// -1 if the widths are outside what the kernel takes (1 + e and every hidden
// width at most 32, one output).
long long umnn_integrand_bwd_p4_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// Blocks of the persistent grid for R rows: as many as are resident on the
// card at once (blocks per SM for this shared memory, times the SMs), at
// most one per row tile, so no block is left without a tile. It is also the
// number of partial-sum slices the caller allocates. A negative CUDA error
// code on failure.
int umnn_integrand_bwd_p4_grid(int R, int K, const int* widths, int n_layers) {
  Dims d;
  int bytes = 0, dev = 0, sms = 0, per_sm = 0;
  if (R < 1) return -(int)cudaErrorInvalidValue;
  cudaError_t err = prepare(K, widths, n_layers, &d, &bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrand_bwd_p4_kernel,
                                                        NTHREADS, bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int tiles = (R + TR - 1) / TR;
  return tiles < per_sm * sms ? tiles : per_sm * sms;
}

// Launches the sweep and the partial-sum reduction on `stream`; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for widths, shared
// memory or a grid the kernel cannot take). partial holds blocks x P floats,
// dparams P, with P the integrand's parameter count.
int umnn_integrand_bwd_p4(const float* x, const float* h, const float* params,
                          const float* nodes, const float* ccw, const float* g, float* dx,
                          float* dh, float* S, float* partial, float* dparams, int R, int K,
                          int blocks, const int* widths, int n_layers, float neg_slope,
                          void* stream) {
  Dims d;
  int bytes = 0;
  if (R < 1 || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err = prepare(K, widths, n_layers, &d, &bytes);
  if (err != cudaSuccess) return err;
  int pw[MAX_LAYERS], pb[MAX_LAYERS];
  const int P = param_offsets(d, pw, pb);
  cudaStream_t st = (cudaStream_t)stream;
  integrand_bwd_p4_kernel<<<blocks, NTHREADS, (size_t)bytes, st>>>(
      x, h, params, nodes, ccw, g, dx, dh, S, partial, R, K, d, neg_slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  integrand_bwd_p4_reduce<<<(P + 255) / 256, 256, 0, st>>>(partial, dparams, P, blocks);
  return cudaGetLastError();
}

}  // extern "C"
