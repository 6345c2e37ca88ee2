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
// At that size the practical limits are filling 132 SMs and launch latency.
//
// What the design does about it: plain float32 FMA on the CUDA cores. A block
// of 128 threads owns TR = 8 rows, so 3,000 rows give 375 blocks; with widths
// of at most 64 the weights (36 KB at the calibration widths, padded to
// multiples of 4 columns) and two activation tiles fit in about 70 KB, so
// three blocks share an SM and all 375 run in one wave. The (row, pair) units
// of a block go through the MLP in tiles of MP = 32 pairs; each hidden layer is
// a shared-memory product in which a thread keeps 4 pairs x 2 nodes x 4
// outputs in registers (32 FMAs per three 16-byte shared loads). Loops over a
// layer's inputs run to the compile-time bound of 64 and unroll. Each row's sum
// over its nodes is taken in one thread, in node order: no atomics, no carry
// between blocks, deterministic results. Known waste, left to later work:
// output widths are padded to a multiple of 4 (50 -> 52) and only 13 of 16
// output groups have work at width 50; a block's last pair tile is half empty
// at K = 51; no tensor cores.

#include "common.cuh"

namespace {

constexpr int TR = 8;           // rows per block
constexpr int MP = 32;          // (row, node pair) units per tile
constexpr int LDA = 2 * MP;     // row stride of an activation tile: node A, then node B
constexpr int NTHREADS = 128;
constexpr int MAX_WIDTH = 64;   // 1 + e and every hidden width

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes).
// Layer l's weights are kept transposed, [w[l]][ldw[l]] with ldw[l] =
// round_up(w[l+1], 4), zero-padded; activations of layer l have ldw[l] rows,
// the padded ones exactly 0.
struct Layout {
  int w1t, b1, wout, ph, xs, fw, s, ccw, buf0, buf1, total;
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], ldw[MAX_LAYERS];
};

__host__ __device__ inline Layout make_layout(const Dims& d, int K) {
  Layout L;
  const int Kp = round_up(K, 2);
  int off = 0, maxw = 0;
  for (int l = 0; l < d.n_layers - 1; ++l) {
    L.ldw[l] = round_up(d.w[l + 1], 4);
    maxw = L.ldw[l] > maxw ? L.ldw[l] : maxw;
  }
  L.w1t = off;  off += round_up(d.w[0] * L.ldw[0], 4);  // W1^T: [1+e][ldw0]
  L.b1 = off;   off += L.ldw[0];
  for (int l = 1; l < d.n_layers - 1; ++l) {  // hidden: W^T [ldw[l-1]][ldw[l]], b
    L.hid_w[l] = off;  off += L.ldw[l - 1] * L.ldw[l];
    L.hid_b[l] = off;  off += L.ldw[l];
  }
  L.wout = off; off += round_up(L.ldw[d.n_layers - 2] + 1, 4);  // output row, then its bias
  L.ph = off;   off += TR * L.ldw[0];
  L.xs = off;   off += round_up(TR, 4);
  L.fw = off;   off += round_up(TR * Kp, 4);
  L.s = off;    off += round_up(Kp, 4);
  L.ccw = off;  off += round_up(Kp, 4);
  L.buf0 = off; off += maxw * LDA;  // activations: [width][node A: MP | node B: MP]
  L.buf1 = off; off += maxw * LDA;
  L.total = off;
  return L;
}

// out[j][slot][p] = leaky(sum_k in[k][slot][p] * w[k][j] + bias[j]) for
// j < ldo, p < MP, both slots. Thread: pairs 4pg..4pg+3 (both nodes) x
// outputs 4og..4og+3; each weight float4 feeds 32 FMAs.
__device__ void hidden_layer(const float* __restrict__ in, float* __restrict__ out,
                             const float* __restrict__ w, const float* __restrict__ bias,
                             int ldi, int ldo, float neg_slope) {
  const int pg = threadIdx.x & 7, og = threadIdx.x >> 3;
  if (4 * og >= ldo) return;
  const int p0 = 4 * pg, j0 = 4 * og;
  float acc[2][4][4] = {};  // [node][pair][output]
#pragma unroll
  for (int k0 = 0; k0 < MAX_WIDTH; k0 += 4) {
    if (k0 >= ldi) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      const float4 a = ld4(in + k * LDA + p0);
      const float4 b = ld4(in + k * LDA + MP + p0);
      const float4 c = ld4(w + k * ldo + j0);
      const float av[2][4] = {{a.x, a.y, a.z, a.w}, {b.x, b.y, b.z, b.w}};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][i][j] = fmaf(av[s][i], cv[j], acc[s][i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float bj = bias[j0 + j];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float4 o;
      o.x = leaky(acc[s][0][j] + bj, neg_slope);
      o.y = leaky(acc[s][1][j] + bj, neg_slope);
      o.z = leaky(acc[s][2][j] + bj, neg_slope);
      o.w = leaky(acc[s][3][j] + bj, neg_slope);
      *reinterpret_cast<float4*>(out + (j0 + j) * LDA + s * MP + p0) = o;
    }
  }
}

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]] (the layout of integrand_fwd.cu).
__global__ void __launch_bounds__(NTHREADS, 3)
integrand_fwd_p2_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        const float* __restrict__ params, const float* __restrict__ nodes,
                        const float* __restrict__ ccw, float* __restrict__ out,
                        int R, int K, Dims d, float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = make_layout(d, K);
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1], ld0 = L.ldw[0];
  const int K2 = (K + 1) / 2, Kp = 2 * K2;
  const int row0 = blockIdx.x * TR;

  // Stage the weights, zero-padded to ldw columns (and ldw rows for hidden layers).
  const float* p = params;
  for (int i = tid; i < F * ld0; i += NTHREADS) {
    const int k = i / ld0, j = i % ld0;
    sm[L.w1t + i] = j < H1 ? p[k * H1 + j] : 0.f;
  }
  p += F * H1;
  for (int j = tid; j < ld0; j += NTHREADS) sm[L.b1 + j] = j < H1 ? p[j] : 0.f;
  p += H1;
  for (int l = 1; l < nl - 1; ++l) {
    const int din = d.w[l], dout = d.w[l + 1], ldi = L.ldw[l - 1], ldo = L.ldw[l];
    for (int i = tid; i < ldi * ldo; i += NTHREADS) {
      const int k = i / ldo, j = i % ldo;
      sm[L.hid_w[l] + i] = k < din && j < dout ? p[k * dout + j] : 0.f;
    }
    p += dout * din;
    for (int j = tid; j < ldo; j += NTHREADS) sm[L.hid_b[l] + j] = j < dout ? p[j] : 0.f;
    p += dout;
  }
  const int dl = d.w[nl - 1], ldl = L.ldw[nl - 2];
  for (int k = tid; k <= ldl; k += NTHREADS)
    sm[L.wout + k] = k < dl ? p[k] : (k == ldl ? p[dl] : 0.f);  // the bias at ldl
  for (int r = tid; r < TR; r += NTHREADS) sm[L.xs + r] = row0 + r < R ? x[row0 + r] : 0.f;
  for (int n = tid; n < Kp; n += NTHREADS) {
    // an odd K's padding node: t = -1 (s = 0), weight 0
    sm[L.s + n] = n < K ? (nodes[n] + 1.f) * 0.5f : 0.f;
    sm[L.ccw + n] = n < K ? ccw[n] : 0.f;
  }
  __syncthreads();

  // Node-invariant first layer, once per row: ph = h W1[:, 1:]^T + b1.
  for (int i = tid; i < TR * ld0; i += NTHREADS) {
    const int r = i / ld0, j = i % ld0;
    float acc = 0.f;
    if (row0 + r < R) {
      const float* hr = h + (size_t)(row0 + r) * e;
      for (int k = 0; k < e; ++k) acc = fmaf(hr[k], sm[L.w1t + (k + 1) * ld0 + j], acc);
    }
    sm[L.ph + i] = acc + sm[L.b1 + j];
  }
  __syncthreads();

  const int PQ = TR * K2;  // pair q = r*K2 + jp: nodes 2jp and 2jp+1 of row r
  for (int q0 = 0; q0 < PQ; q0 += MP) {
    float* a = sm + L.buf0;
    float* b = sm + L.buf1;
    // Layer 1 for both nodes of each pair: ph plus the rank-1 node term.
    for (int i = tid; i < ld0 * MP; i += NTHREADS) {
      const int j = i / MP, m = i % MP, q = q0 + m;
      float va = 0.f, vb = 0.f;
      if (q < PQ) {
        const int r = q / K2, n = 2 * (q - r * K2);
        const float ph = sm[L.ph + r * ld0 + j], xw = sm[L.xs + r] * sm[L.w1t + j];
        va = leaky(ph + sm[L.s + n] * xw, neg_slope);
        vb = leaky(ph + sm[L.s + n + 1] * xw, neg_slope);
      }
      a[j * LDA + m] = va;
      a[j * LDA + MP + m] = vb;
    }
    __syncthreads();
    for (int l = 1; l < nl - 1; ++l) {
      hidden_layer(a, b, sm + L.hid_w[l], sm + L.hid_b[l], L.ldw[l - 1], L.ldw[l], neg_slope);
      __syncthreads();
      float* t = a; a = b; b = t;
    }
    // Output layer: f at every node of the tile, times its quadrature weight.
    for (int i = tid; i < 2 * MP; i += NTHREADS) {
      const int slot = i / MP, m = i % MP, q = q0 + m;
      if (q < PQ) {
        float z = 0.f;
#pragma unroll 4
        for (int k = 0; k < dl; ++k) z = fmaf(a[k * LDA + slot * MP + m], sm[L.wout + k], z);
        z += sm[L.wout + ldl];
        const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
        const int r = q / K2, n = 2 * (q - r * K2) + slot;
        sm[L.fw + r * Kp + n] = sm[L.ccw + n] * f;
      }
    }
    __syncthreads();
  }

  for (int r = tid; r < TR; r += NTHREADS) {
    if (row0 + r < R) {
      float acc = 0.f;
      for (int n = 0; n < K; ++n) acc += sm[L.fw + r * Kp + n];
      out[row0 + r] = acc * sm[L.xs + r] * 0.5f;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for these widths and node count, in bytes;
// -1 if the widths are outside what the kernel takes (1 + e and every hidden
// width at most 64, one output).
long long umnn_integrand_fwd_p2_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths or shared memory the kernel cannot take).
int umnn_integrand_fwd_p2(const float* x, const float* h, const float* params,
                          const float* nodes, const float* ccw, float* out, int R, int K,
                          const int* widths, int n_layers, float neg_slope, void* stream) {
  Dims d;
  if (K < 1 || R < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d))
    return cudaErrorInvalidValue;
  const long long bytes = (long long)make_layout(d, K).total * sizeof(float);
  const cudaError_t err = set_smem(integrand_fwd_p2_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int grid = (R + TR - 1) / TR;
  integrand_fwd_p2_kernel<<<grid, NTHREADS, (size_t)bytes, (cudaStream_t)stream>>>(
      x, h, params, nodes, ccw, out, R, K, d, neg_slope);
  return cudaGetLastError();
}

}  // extern "C"
