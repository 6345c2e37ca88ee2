// Forward Clenshaw-Curtis integral of the UMNN integrand MLP for integrands
// whose every layer is at most 32 wide, four quadrature nodes at a time:
//
//   z_r = x_r/2 * sum_n w_n * ELU+1( MLP([x_r * s_n, h_r]) ),  s_n = (t_n+1)/2
//
// with LeakyReLU(neg_slope) between layers. It computes the same function as
// integrand_fwd.cu; only the grouping of nodes and the order of the sums in
// each layer differ.
//
// Replaces the TPU kernel `_fwd_kernel_pn` of umnn_tpu/ops/integrand_kernel.py
// (:522-570, launched by `_run_fwd_pn` :786). There four nodes ride one
// matmul row through block-diagonal weights diag(W, W, W, W) and [x, h] x 4
// feature rows (`_prep_pn` :756, `_packn_params` :702), which fills the MXU's
// 128 lanes with 32-wide layers. None of that is carried over: the kernel
// reads x as [R], h as [R, e] and the real-size weights. What the node group
// becomes here: the unit of work is one row's group of nodes (4j, ..., 4j+3),
// as `_packn_nodes` (:723) groups them (K is padded to a multiple of 4 with
// nodes at t = -1 and weight 0, which change no output), and every weight
// value a thread reads from shared memory feeds the FMAs of all four nodes of
// its groups, which is what diag(W, W, W, W) buys on the MXU.
//
// Bound on an H100: operations, but at the shapes that use this kernel the
// bound is below a launch's latency. The toy flow's block (R = 512 rows,
// 17 nodes, widths 11-32-32-1) is 19.27 MFLOP of useful float32 work
// (chip_smoke.py::kernel_flops), 0.29 us at the 66.9 TFLOP/s float32 peak;
// a 4,096-row block 2.30 us. So what sets its time is how many SMs it fills
// and how long a block takes from launch to its last store.
//
// What the design does about it: plain float32 FMA on the CUDA cores, small
// blocks and many of them. A block of 64 threads owns TR = 2 rows, so the toy
// block's 512 rows give 256 blocks, enough for every one of the 132 SMs. With
// widths of at most 32 (a compile-time bound, so the inner loops unroll) the
// weights and two activation tiles take under 50 KB even at MAX_LAYERS, so
// many blocks share an SM. The (row, group) units of a block go through the
// MLP in tiles of MP = 16 units; each hidden layer is a shared-memory product
// in which a thread keeps 2 units x 4 nodes x 4 outputs in registers (32 FMAs
// per five shared loads). Each row's sum over its nodes is taken in one
// thread, in node order: no atomics, no carry between blocks, deterministic
// results. Per (row, node) the float32 operations come in the order of
// integrand_bwd_p4.cu's forward (layer 1: an in-order FMA chain over h, the
// bias added, x w1x rounded once and one FMA with s_n; later layers: an
// in-order FMA chain, then the bias). Known waste, left to later work: at
// K = 17 a block has 10 units for a 16-unit tile, and 3 of the last group's 4
// nodes are padding; widths are padded to multiples of 4; no tensor cores.

#include "common.cuh"

namespace {

constexpr int NODES = 4;          // nodes per unit
constexpr int TR = 2;             // rows per block
constexpr int MP = 16;            // (row, node group) units per tile
constexpr int LDA = NODES * MP;   // row stride of an activation tile: node slot s at s * MP
constexpr int NTHREADS = 64;
constexpr int MAX_WIDTH = 32;     // 1 + e and every hidden width

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes).
// Layer l's weights are kept transposed, [w[l]][ldw[l]] with ldw[l] =
// round_up(w[l+1], 4), zero-padded (hidden layers also to ldw[l-1] rows);
// activations of layer l have ldw[l] rows, the padded ones exactly 0.
struct Layout {
  int w1t, b1, wout, ph, xs, fw, s, ccw, buf0, buf1, total;
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], ldw[MAX_LAYERS];
};

__host__ __device__ inline Layout make_layout(const Dims& d, int K) {
  Layout L;
  const int Kp = round_up(K, NODES);
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
  L.fw = off;   off += TR * Kp;
  L.s = off;    off += Kp;
  L.ccw = off;  off += Kp;
  L.buf0 = off; off += maxw * LDA;  // activations: [width][slot 0: MP | ... | slot 3: MP]
  L.buf1 = off; off += maxw * LDA;
  L.total = off;
  return L;
}

// out[j][slot][u] = leaky(sum_k in[k][slot][u] * w[k][j] + bias[j]) for
// j < ldo, u < MP, all four slots. Thread: units 2pg, 2pg+1 (all four nodes)
// x outputs 4og..4og+3; each weight float4 feeds 32 FMAs.
__device__ void hidden_layer(const float* __restrict__ in, float* __restrict__ out,
                             const float* __restrict__ w, const float* __restrict__ bias,
                             int ldi, int ldo, float neg_slope) {
  const int pg = threadIdx.x & 7, og = threadIdx.x >> 3;
  if (4 * og >= ldo) return;
  const int u0 = 2 * pg, j0 = 4 * og;
  float acc[NODES][2][4] = {};  // [node][unit][output]
#pragma unroll
  for (int k0 = 0; k0 < MAX_WIDTH; k0 += 4) {
    if (k0 >= ldi) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      const float4 c = ld4(w + k * ldo + j0);
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int s = 0; s < NODES; ++s) {
        const float2 a = ld2(in + k * LDA + s * MP + u0);
        const float av[2] = {a.x, a.y};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[s][i][j] = fmaf(av[i], cv[j], acc[s][i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float bj = bias[j0 + j];
#pragma unroll
    for (int s = 0; s < NODES; ++s) {
      float2 o;
      o.x = leaky(acc[s][0][j] + bj, neg_slope);
      o.y = leaky(acc[s][1][j] + bj, neg_slope);
      *reinterpret_cast<float2*>(out + (j0 + j) * LDA + s * MP + u0) = o;
    }
  }
}

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]] (the layout of integrand_fwd.cu).
__global__ void __launch_bounds__(NTHREADS, 8)
integrand_fwd_p4_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        const float* __restrict__ params, const float* __restrict__ nodes,
                        const float* __restrict__ ccw, float* __restrict__ out,
                        int R, int K, Dims d, float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = make_layout(d, K);
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1], ld0 = L.ldw[0];
  const int K4 = (K + NODES - 1) / NODES, Kp = NODES * K4;
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
    // padding nodes up to a multiple of 4: t = -1 (s = 0), weight 0
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

  const int PQ = TR * K4;  // unit q = r*K4 + jg: nodes 4jg..4jg+3 of row r
  for (int q0 = 0; q0 < PQ; q0 += MP) {
    float* a = sm + L.buf0;
    float* b = sm + L.buf1;
    // Layer 1 for the four nodes of each unit: ph plus the rank-1 node term.
    for (int i = tid; i < ld0 * MP; i += NTHREADS) {
      const int j = i / MP, m = i % MP, q = q0 + m;
      float v[NODES] = {};
      if (q < PQ) {
        const int r = q / K4, n = NODES * (q - r * K4);
        const float ph = sm[L.ph + r * ld0 + j], xw = sm[L.xs + r] * sm[L.w1t + j];
#pragma unroll
        for (int s = 0; s < NODES; ++s) v[s] = leaky(fmaf(sm[L.s + n + s], xw, ph), neg_slope);
      }
#pragma unroll
      for (int s = 0; s < NODES; ++s) a[j * LDA + s * MP + m] = v[s];
    }
    __syncthreads();
    for (int l = 1; l < nl - 1; ++l) {
      hidden_layer(a, b, sm + L.hid_w[l], sm + L.hid_b[l], L.ldw[l - 1], L.ldw[l], neg_slope);
      __syncthreads();
      float* t = a; a = b; b = t;
    }
    // Output layer: f at every node of the tile, times its quadrature weight.
    for (int i = tid; i < LDA; i += NTHREADS) {
      const int slot = i / MP, m = i % MP, q = q0 + m;
      if (q < PQ) {
        float z = 0.f;
#pragma unroll 4
        for (int k = 0; k < dl; ++k) z = fmaf(a[k * LDA + i], sm[L.wout + k], z);
        z += sm[L.wout + ldl];
        const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
        const int r = q / K4, n = NODES * (q - r * K4) + slot;
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
// width at most 32, one output).
long long umnn_integrand_fwd_p4_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths or shared memory the kernel cannot take).
int umnn_integrand_fwd_p4(const float* x, const float* h, const float* params,
                          const float* nodes, const float* ccw, float* out, int R, int K,
                          const int* widths, int n_layers, float neg_slope, void* stream) {
  Dims d;
  if (K < 1 || R < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d))
    return cudaErrorInvalidValue;
  const long long bytes = (long long)make_layout(d, K).total * sizeof(float);
  const cudaError_t err = set_smem(integrand_fwd_p4_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int grid = (R + TR - 1) / TR;
  integrand_fwd_p4_kernel<<<grid, NTHREADS, (size_t)bytes, (cudaStream_t)stream>>>(
      x, h, params, nodes, ccw, out, R, K, d, neg_slope);
  return cudaGetLastError();
}

}  // extern "C"
