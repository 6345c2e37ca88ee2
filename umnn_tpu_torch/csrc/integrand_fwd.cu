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
// useful float32 work with the once-per-row first layer (125 GFLOP if the
// first layer is counted per node), against about 10 MB of input and output:
// 1.5 ms at the 67 TFLOP/s float32 peak, 3 us at 3.35 TB/s.
//
// What this simple design does about that bound: everything is float32 FMA on
// the CUDA cores (no TF32, no tensor cores). A block owns TR rows. All
// weights, the per-row first-layer part, and two activation buffers live in
// shared memory, so device memory is touched once per input and output. The
// TR*K (row, node) pairs run through the MLP in tiles of MT pairs; each hidden
// layer is a shared-memory matrix product in which every thread keeps a 4x4
// register tile (16 FMAs per two 16-byte shared loads). Each row's sum over
// the nodes is taken in one thread, in node order: no atomics, no carry
// between blocks, so the result is deterministic. Known waste, left to later
// work: output widths are padded to 16 (50 -> 64), one block per SM fits the
// shared memory, and wgmma over node-folded tiles is not used.

#include "common.cuh"

namespace {

constexpr int TR = 32;          // rows per block
constexpr int MT = 128;         // (row, node) pairs per tile
constexpr int NTHREADS = 512;
constexpr int MAX_WIDTH = 128;  // hidden width
constexpr int MAX_FIRST = 1 << 30;  // 1 + e: bounded by shared memory alone

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes).
struct Layout {
  int w1t, b1, wout, ph, xs, fw, s, ccw, buf0, buf1, total;
  int hid_w[MAX_LAYERS], hid_b[MAX_LAYERS], ldw[MAX_LAYERS];
};

__host__ __device__ inline Layout make_layout(const Dims& d, int K) {
  Layout L;
  const int H1 = d.w[1];
  int off = 0, maxh = H1;
  L.w1t = off;  off += round_up(d.w[0] * H1, 4);  // W1 transposed: [1+e][H1]
  L.b1 = off;   off += round_up(H1, 4);
  for (int l = 1; l < d.n_layers - 1; ++l) {      // hidden: W^T [din][ldw], b [ldw]
    L.ldw[l] = round_up(d.w[l + 1], 16);
    L.hid_w[l] = off;  off += d.w[l] * L.ldw[l];
    L.hid_b[l] = off;  off += L.ldw[l];
    maxh = d.w[l + 1] > maxh ? d.w[l + 1] : maxh;
  }
  L.wout = off; off += round_up(d.w[d.n_layers - 1] + 1, 4);  // output row, then its bias
  L.ph = off;   off += TR * H1;
  L.xs = off;   off += TR;
  L.fw = off;   off += round_up(TR * K, 4);
  L.s = off;    off += round_up(K, 4);
  L.ccw = off;  off += round_up(K, 4);
  L.buf0 = off; off += maxh * MT;  // activations, transposed: [width][MT]
  L.buf1 = off; off += maxh * MT;
  L.total = off;
  return L;
}

// out[j][m] = leaky(sum_k in[k][m] * w[k][j] + bias[j]) for j < dout, m < MT.
// A warp computes a 32 (pairs) x 16 (outputs) tile; lane = 8 pair groups x
// 4 output groups, each a 4x4 register tile.
__device__ void hidden_layer(const float* __restrict__ in, float* __restrict__ out,
                             const float* __restrict__ w, const float* __restrict__ bias,
                             int din, int dout, int ldw, float neg_slope) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mtiles = MT / 32;
  const int ntiles = mtiles * ((dout + 15) / 16);
  for (int t = warp; t < ntiles; t += NTHREADS / 32) {
    const int m0 = (t % mtiles) * 32 + (lane & 7) * 4;
    const int j0 = (t / mtiles) * 16 + (lane >> 3) * 4;
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < din; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(in + k * MT + m0);
      const float4 b = *reinterpret_cast<const float4*>(w + k * ldw + j0);
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
        *reinterpret_cast<float4*>(out + (j0 + j) * MT + m0) = o;
      }
    }
  }
}

// params: for each layer l, W_l transposed, [w[l]][w[l+1]] row-major, then
// b_l [w[l+1]].
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_fwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ params, const float* __restrict__ nodes,
                     const float* __restrict__ ccw, float* __restrict__ out,
                     int R, int K, Dims d, float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = make_layout(d, K);
  const int tid = threadIdx.x;
  const int nl = d.n_layers;
  const int F = d.w[0], e = F - 1, H1 = d.w[1];
  const int row0 = blockIdx.x * TR;

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
  const int dl = d.w[nl - 1];
  for (int k = tid; k <= dl; k += NTHREADS) sm[L.wout + k] = p[k];
  for (int r = tid; r < TR; r += NTHREADS) sm[L.xs + r] = row0 + r < R ? x[row0 + r] : 0.f;
  for (int n = tid; n < K; n += NTHREADS) {
    sm[L.s + n] = (nodes[n] + 1.f) * 0.5f;
    sm[L.ccw + n] = ccw[n];
  }
  __syncthreads();

  // Node-invariant first layer, once per row: ph = h W1[:, 1:]^T + b1.
  for (int i = tid; i < TR * H1; i += NTHREADS) {
    const int r = i / H1, j = i % H1;
    float acc = 0.f;
    if (row0 + r < R) {
      const float* hr = h + (size_t)(row0 + r) * e;
      for (int k = 0; k < e; ++k) acc = fmaf(hr[k], sm[L.w1t + (k + 1) * H1 + j], acc);
    }
    sm[L.ph + i] = acc + sm[L.b1 + j];
  }
  __syncthreads();

  const int P = TR * K;  // pair q = r*K + n
  for (int p0 = 0; p0 < P; p0 += MT) {
    float* a = sm + L.buf0;
    float* b = sm + L.buf1;
    for (int i = tid; i < H1 * MT; i += NTHREADS) {
      const int j = i / MT, m = i % MT, q = p0 + m;
      float v = 0.f;
      if (q < P) {
        const int r = q / K, n = q - r * K;
        const float xs = sm[L.s + n] * sm[L.xs + r];
        v = leaky(sm[L.ph + r * H1 + j] + xs * sm[L.w1t + j], neg_slope);
      }
      a[j * MT + m] = v;
    }
    __syncthreads();
    for (int l = 1; l < nl - 1; ++l) {
      hidden_layer(a, b, sm + L.hid_w[l], sm + L.hid_b[l], d.w[l], d.w[l + 1], L.ldw[l],
                   neg_slope);
      __syncthreads();
      float* t = a; a = b; b = t;
    }
    for (int m = tid; m < MT; m += NTHREADS) {
      const int q = p0 + m;
      if (q < P) {
        float z = 0.f;
        for (int k = 0; k < dl; ++k) z = fmaf(a[k * MT + m], sm[L.wout + k], z);
        z += sm[L.wout + dl];
        const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
        sm[L.fw + q] = sm[L.ccw + q % K] * f;
      }
    }
    __syncthreads();
  }

  for (int r = tid; r < TR; r += NTHREADS) {
    if (row0 + r < R) {
      float acc = 0.f;
      for (int n = 0; n < K; ++n) acc += sm[L.fw + r * K + n];
      out[row0 + r] = acc * sm[L.xs + r] * 0.5f;
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

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths or shared memory the kernel cannot take).
int umnn_integrand_fwd(const float* x, const float* h, const float* params,
                       const float* nodes, const float* ccw, float* out, int R, int K,
                       const int* widths, int n_layers, float neg_slope, void* stream) {
  Dims d;
  if (K < 1 || R < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_FIRST, &d))
    return cudaErrorInvalidValue;
  const long long bytes = (long long)make_layout(d, K).total * sizeof(float);
  const cudaError_t err = set_smem(integrand_fwd_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int grid = (R + TR - 1) / TR;
  integrand_fwd_kernel<<<grid, NTHREADS, (size_t)bytes, (cudaStream_t)stream>>>(
      x, h, params, nodes, ccw, out, R, K, d, neg_slope);
  return cudaGetLastError();
}

const char* umnn_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
