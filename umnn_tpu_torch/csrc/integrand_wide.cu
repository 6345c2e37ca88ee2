// The streamed pair: forward and backward of the Clenshaw-Curtis integral of
// the UMNN integrand MLP for integrands that the staged kernels of this
// directory refuse (any hidden width, any number of layers from 2 on, any K,
// any shared-memory size):
//
//   z_r = x_r/2 * sum_n w_n * f_{r,n},  f_{r,n} = ELU+1( MLP([x_r * s_n, h_r]) ),
//   s_n = (t_n+1)/2, LeakyReLU(neg_slope) between layers,
//
// and, for an upstream cotangent g_r, the exact derivative of this K-node sum
// with respect to every weight and bias, h_r and x_r (node path and product
// rule), with S_r = sum_n w_n f_{r,n} written out and dx_r = dx_nodes_r +
// g_r S_r/2 (never z/x).
//
// Replaces, for those widths, the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// of umnn_tpu/ops/integrand_kernel.py (:106-153 and :156-317, launched by
// `_run_fwd` :920 and `_run_bwd` :954), which take any width because the
// JAX package pads every layer to 128-lane multiples (`_pad_params`, :59-70)
// and gives each kernel 100 MiB of VMEM. A Hopper block has 227 KB of shared
// memory, so here nothing has to fit on chip at once: the weights stay in
// device memory (read through L2), and the caller cuts the rows into chunks
// whose activations, n_hidden x rows x K x max_width floats, stay within a
// fixed budget (`_wide_chunks` in ops/integrand_kernel.py). One call of
// umnn_integrand_fwd_wide or umnn_integrand_bwd_wide computes one chunk as
// a fixed sequence of launches on one stream:
//   - one tiled float32 product with a fused epilogue,
//     `integrand_wide_gemm_kernel`, for every matrix product whatever its
//     width (64 x 64 output tiles, a k-step of 16 through shared memory,
//     4 x 4 outputs a thread, operands read through strides, so transposes
//     cost nothing): the node-invariant
//     first layer ph = h W1[:, 1:]^T + b1, the hidden layers, the dz of each
//     layer below, every dW and db, dh;
//   - small kernels: the layer-1 build leaky(ph_r + s_n (x_r W1[:, 0])), the
//     head (f, S_r, z_r or the head's cotangent, one warp per row, nodes in
//     order), the rank-1 dz of the last hidden layer, the layer-1 collapse
//     (dz_sum_r = sum_n dz1, sum_n s_n dz1, node order) and dx.
// The backward recomputes the chunk's forward (nothing of the forward is
// saved). LeakyReLU's derivative comes from a > 0, ELU+1's from min(f, 1).
// Each product's sum over k is one in-order FMA chain per output (the bias
// added after it), as in the staged kernels. No atomics: a dW product sums
// its long item axis in a fixed number of slices, written apart, and a
// second launch adds the slices in order to dW; chunks run in order. Reruns
// on one card are bit-identical.
//
// Bound on an H100: operations, as for the staged pairs (chip_smoke.py's
// kernel_flops and bwd_kernel_flops over 66.9 TFLOP/s). The design aims to be
// right and simple first: the products run at a small share of that peak,
// and every activation goes through device memory.

#include <vector>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;  // output tile and k-step of the product kernel
constexpr int GEMM_THREADS = 256;         // 16 x 16 threads, 4 x 4 outputs each
constexpr int SMALL_THREADS = 256;
constexpr long long SPLIT_ITEMS = 512;    // least items of a dW slice
constexpr long long SPLIT_BLOCKS = 256;   // blocks a split dW product aims at
constexpr long long PARTIAL_FLOATS = 1 << 22;  // a split product's slices, at most

enum Epilogue { STORE = 0, LEAKY = 1, DLEAKY = 2 };

// C[m][n] = epilogue(sum_k A[m][k] B[k][n] over k in slice z), with
// A[m][k] = A[m*sam + k*sak], B[k][n] = B[k*sbk + n*sbn] (1 where B is
// null: a sum over k, as for db), C[m][n] =
// C[z*slice + m*ldc + n]. STORE: acc (+ bias[n]); LEAKY: leaky(acc + bias[n]);
// DLEAKY: acc * leaky'(C[m][n]), in place. Slice z covers k in
// [z*kper, min(Kd, (z+1)*kper)); every output's sum is one FMA chain in k
// order from 0 (padding k add 0 * 0).
__global__ void __launch_bounds__(GEMM_THREADS)
integrand_wide_gemm_kernel(const float* __restrict__ A, long long sam, long long sak,
                           const float* __restrict__ B, long long sbk, long long sbn, float* C,
                           long long ldc, long long slice, const float* __restrict__ bias, int M,
                           int N, int Kd, int kper, int mode, float neg_slope) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  const int k_lo = z * kper, k_hi = min(Kd, k_lo + kper);
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
      const int mm = i % BM, kk = i / BM;
      const long long m = m0 + mm;
      const int k = k0 + kk;
      As[kk][mm] = m < M && k < k_hi ? A[m * sam + k * sak] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += GEMM_THREADS) {
      const int nn = i % BN, kk = i / BN;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = n < N && k < k_hi ? (B ? B[k * sbk + n * sbn] : 1.f) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* Cz = C + z * slice;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float* c = Cz + m * ldc + n;
      float v = acc[i][j];
      if (mode == DLEAKY) {
        v *= *c > 0.f ? 1.f : neg_slope;
      } else {
        if (bias) v += bias[n];
        if (mode == LEAKY) v = leaky(v, neg_slope);
      }
      *c = v;
    }
  }
}

// C[m*ldc + n] += sum over s < slices, in order, of part[s][m][n] ([M][N]).
__global__ void integrand_wide_add_kernel(float* C, long long ldc, const float* __restrict__ part,
                                          int slices, int M, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  const long long m = i / N, n = i % N;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[s * (long long)M * N + i];
  C[m * ldc + n] += acc;
}

// Layer 1 from ph: act[q][j] = leaky(ph[r][j] + s_n (x_r W1[j][0])), q = r*K + n.
__global__ void integrand_wide_build_kernel(const float* __restrict__ ph,
                                            const float* __restrict__ x,
                                            const float* __restrict__ nodes,
                                            const float* __restrict__ w1x,
                                            float* __restrict__ act, int rows, int K, int H1,
                                            float neg_slope) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * K * H1) return;
  const long long q = i / H1;
  const int j = (int)(i % H1), r = (int)(q / K), n = (int)(q % K);
  const float s = (nodes[n] + 1.f) * 0.5f;
  const float xw = x[r] * w1x[j];
  act[i] = leaky(fmaf(s, xw, ph[(long long)r * H1 + j]), neg_slope);
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same sum (a + b == b + a)
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The head, one warp per row, its nodes in order: f = ELU+1(act[q] . wout +
// bout), S_r = sum_n w_n f. Forward (g null): out[r] = S_r x_r/2. Backward:
// out[r] = S_r and dzo[q] = w_n g_r x_r/2 min(f, 1).
__global__ void integrand_wide_head_kernel(const float* __restrict__ act,
                                           const float* __restrict__ wout,
                                           const float* __restrict__ x, const float* __restrict__ g,
                                           const float* __restrict__ ccw, float* __restrict__ out,
                                           float* __restrict__ dzo, int rows, int K, int dl) {
  const int lane = threadIdx.x & 31;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= rows) return;
  const float xr = x[r], bout = wout[dl];
  float s_r = 0.f;
  for (int n = 0; n < K; ++n) {
    const long long q = r * K + n;
    const float* a = act + q * dl;
    float z = 0.f;
    for (int k = lane; k < dl; k += 32) z = fmaf(a[k], wout[k], z);
    z = warp_sum(z) + bout;
    const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
    s_r += ccw[n] * f;
    if (g && lane == 0) dzo[q] = ccw[n] * g[r] * xr * 0.5f * fminf(f, 1.f);
  }
  if (lane == 0) out[r] = g ? s_r : s_r * xr * 0.5f;
}

// dz of the last hidden layer, in place: act[q][k] = dzo[q] wout[k] leaky'(act[q][k]).
__global__ void integrand_wide_rank1_kernel(float* __restrict__ act, const float* __restrict__ dzo,
                                            const float* __restrict__ wout, long long M, int dl,
                                            float neg_slope) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * dl) return;
  const float a = act[i];
  act[i] = dzo[i / dl] * wout[i % dl] * (a > 0.f ? 1.f : neg_slope);
}

// The layer-1 collapse, one thread per (row, unit), nodes in order:
// dzsum[r][j] = sum_n dz1[q][j], xsum[r][j] = sum_n s_n dz1[q][j].
__global__ void integrand_wide_collapse_kernel(const float* __restrict__ dz1,
                                               const float* __restrict__ nodes,
                                               float* __restrict__ dzsum, float* __restrict__ xsum,
                                               int rows, int K, int H1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * H1) return;
  const long long r = i / H1;
  const int j = (int)(i % H1);
  float a = 0.f, b = 0.f;
  for (int n = 0; n < K; ++n) {
    const float v = dz1[(r * K + n) * H1 + j];
    a += v;
    b = fmaf((nodes[n] + 1.f) * 0.5f, v, b);
  }
  dzsum[i] = a;
  xsum[i] = b;
}

// dx_r = sum_j W1[j][0] xsum[r][j] (x's node path) + g_r S_r/2.
__global__ void integrand_wide_dx_kernel(const float* __restrict__ xsum,
                                         const float* __restrict__ w1x, const float* __restrict__ g,
                                         const float* __restrict__ S, float* __restrict__ dx,
                                         int rows, int H1) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.f;
  for (int j = 0; j < H1; ++j) acc = fmaf(w1x[j], xsum[r * H1 + j], acc);
  dx[r] = acc + g[r] * S[r] * 0.5f;
}

inline unsigned blocks_for(long long n, int threads = SMALL_THREADS) {
  return (unsigned)((n + threads - 1) / threads);
}

// Slices of a dW product with an [M][N] output over Kd items: at least
// SPLIT_ITEMS items each, about SPLIT_BLOCKS blocks in all, the slices'
// floats within PARTIAL_FLOATS (or one slice).
inline int split_count(long long M, long long N, long long Kd) {
  if (M * N == 0) return 1;
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  long long s = (SPLIT_BLOCKS + tiles - 1) / tiles;
  const long long by_items = (Kd + SPLIT_ITEMS - 1) / SPLIT_ITEMS;
  if (s > by_items) s = by_items;
  if (s * M * N > PARTIAL_FLOATS) s = PARTIAL_FLOATS / (M * N);
  return s < 1 ? 1 : (int)s;
}

// The widths: 1 + e >= 1, every hidden width >= 1, one output, >= 2 layers.
inline bool takes(const int* w, int n_layers) {
  if (n_layers < 2 || w[n_layers] != 1) return false;
  for (int i = 0; i < n_layers; ++i)
    if (w[i] < 1) return false;
  return true;
}

// Offsets of the scratch of a chunk of `rows` rows, in floats.
struct Scratch {
  long long ph, dzo, dzsum, xsum, part, total;
  std::vector<long long> act;  // act[i]: layer i's output, [rows*K][w[i+1]]
};

inline Scratch scratch_for(int rows, int K, const int* w, int nl) {
  Scratch s;
  const long long M = (long long)rows * K, H1 = w[1];
  long long off = 0;
  s.ph = off;   off += rows * H1;
  for (int i = 0; i < nl - 1; ++i) {
    s.act.push_back(off);
    off += M * w[i + 1];
  }
  s.dzo = off;   off += M;
  s.dzsum = off; off += rows * H1;
  s.xsum = off;  off += rows * H1;
  long long part = 0;
  auto need = [&](long long m, long long n, long long kd) {
    const long long v = split_count(m, n, kd) * m * n;
    part = v > part ? v : part;
  };
  need(1, w[nl - 1], M);  // the output layer's dW row
  need(1, 1, M);          // and its db
  for (int i = 1; i < nl - 1; ++i) {
    need(w[i + 1], w[i], M);
    need(w[i + 1], 1, M);
  }
  need(H1, 1, rows);  // dW1[:, 0], db1
  need(H1, w[0] - 1, rows);
  s.part = off;  off += part;
  s.total = off;
  return s;
}

struct Ctx {
  cudaStream_t st;
  float neg_slope;
  cudaError_t err = cudaSuccess;

  void gemm(const float* A, long long sam, long long sak, const float* B, long long sbk,
            long long sbn, float* C, long long ldc, const float* bias, long long M, int N, int Kd,
            int mode, int slices = 1, long long slice = 0) {
    if (err != cudaSuccess || M == 0 || N == 0) return;
    const int kper = slices > 1 ? (Kd + slices - 1) / slices : Kd;
    const dim3 grid(blocks_for(M, BM), blocks_for(N, BN), slices);
    integrand_wide_gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(
        A, sam, sak, B, sbk, sbn, C, ldc, slice, bias, (int)M, N, Kd, kper, mode, neg_slope);
    err = cudaGetLastError();
  }

  // C[m*ldc + n] += sum_k A[m][k] B[k][n], the k axis split in slices
  // written to `part` and then added in order.
  void gemm_add(const float* A, long long sam, long long sak, const float* B, long long sbk,
                long long sbn, float* C, long long ldc, int M, int N, int Kd, float* part) {
    if (err != cudaSuccess || M == 0 || N == 0) return;
    const int slices = split_count(M, N, Kd);
    gemm(A, sam, sak, B, sbk, sbn, part, N, nullptr, M, N, Kd, STORE, slices, (long long)M * N);
    if (err != cudaSuccess) return;
    integrand_wide_add_kernel<<<blocks_for((long long)M * N), SMALL_THREADS, 0, st>>>(
        C, ldc, part, slices, M, N);
    err = cudaGetLastError();
  }
};

// The chunk's forward down to the last hidden layer's activations: ph, layer
// 1, the hidden layers. params: per layer W^T [w[i]][w[i+1]], then b.
void forward_chunk(Ctx& c, const float* x, const float* h, const float* params,
                   const float* nodes, const int* w, int nl, int rows, int K, float* sc,
                   const Scratch& s) {
  const long long M = (long long)rows * K;
  const int F = w[0], e = F - 1, H1 = w[1];
  const float* w1 = params;  // W1^T [F][H1]: row 0 is W1[:, 0]
  const float* b1 = params + (long long)F * H1;
  float* ph = sc + s.ph;
  // ph = h W1[:, 1:]^T + b1
  c.gemm(h, e, 1, w1 + H1, H1, 1, ph, H1, b1, rows, H1, e, STORE);
  if (c.err != cudaSuccess) return;
  integrand_wide_build_kernel<<<blocks_for(M * H1), SMALL_THREADS, 0, c.st>>>(
      ph, x, nodes, w1, sc + s.act[0], rows, K, H1, c.neg_slope);
  c.err = cudaGetLastError();
  const float* p = b1 + H1;
  for (int i = 1; i < nl - 1; ++i) {
    const int din = w[i], dout = w[i + 1];
    c.gemm(sc + s.act[i - 1], din, 1, p, dout, 1, sc + s.act[i], dout,
           p + (long long)din * dout, M, dout, din, LEAKY);
    p += (long long)din * dout + dout;
  }
}

}  // namespace

extern "C" {

// Floats of scratch one call needs for a chunk of `rows` rows; -1 for widths
// the pair cannot take (fewer than 2 layers, an output other than 1 wide, a
// width below 1).
long long umnn_integrand_wide_scratch_floats(int rows, int K, const int* widths, int n_layers) {
  if (rows < 1 || K < 1 || !takes(widths, n_layers)) return -1;
  return scratch_for(rows, K, widths, n_layers).total;
}

// The forward of one chunk of R rows: out[r] = z_r. scratch holds
// umnn_integrand_wide_scratch_floats(R, ...) floats. Returns the first
// launch error (cudaErrorInvalidValue for what the pair cannot take).
int umnn_integrand_fwd_wide(const float* x, const float* h, const float* params,
                            const float* nodes, const float* ccw, float* out, int R, int K,
                            const int* widths, int n_layers, float neg_slope, float* scratch,
                            void* stream) {
  if (R < 1 || K < 1 || !takes(widths, n_layers)) return cudaErrorInvalidValue;
  const int nl = n_layers, dl = widths[nl - 1];
  const Scratch s = scratch_for(R, K, widths, nl);
  Ctx c{(cudaStream_t)stream, neg_slope};
  forward_chunk(c, x, h, params, nodes, widths, nl, R, K, scratch, s);
  if (c.err != cudaSuccess) return c.err;
  long long off = 0;  // the output layer's W^T [dl][1], then its bias
  for (int i = 0; i < nl - 1; ++i) off += (long long)widths[i] * widths[i + 1] + widths[i + 1];
  const long long M = (long long)R * K;
  integrand_wide_head_kernel<<<blocks_for(32LL * R), SMALL_THREADS, 0, c.st>>>(
      scratch + s.act[nl - 2], params + off, x, nullptr, ccw, out, nullptr, R, K,
      dl);
  return cudaGetLastError();
}

// The backward of one chunk of R rows: dx, dh and S of its rows, and its dW/db
// added to dparams (per layer dW [dout][din], then db). scratch as for the
// forward. Returns the first launch error.
int umnn_integrand_bwd_wide(const float* x, const float* h, const float* params,
                            const float* nodes, const float* ccw, const float* g, float* dx,
                            float* dh, float* S, float* dparams, int R, int K,
                            const int* widths, int n_layers, float neg_slope, float* scratch,
                            void* stream) {
  if (R < 1 || K < 1 || !takes(widths, n_layers)) return cudaErrorInvalidValue;
  const int nl = n_layers, F = widths[0], e = F - 1, H1 = widths[1], dl = widths[nl - 1];
  const long long M = (long long)R * K;
  const Scratch s = scratch_for(R, K, widths, nl);
  Ctx c{(cudaStream_t)stream, neg_slope};
  forward_chunk(c, x, h, params, nodes, widths, nl, R, K, scratch, s);
  if (c.err != cudaSuccess) return c.err;
  // where each layer's W^T and b sit in params, and its dW and db in dparams
  std::vector<long long> pp(nl), pw(nl), pb(nl);
  long long off = 0, goff = 0;
  for (int i = 0; i < nl; ++i) {
    pp[i] = off;
    off += (long long)widths[i] * widths[i + 1] + widths[i + 1];
    pw[i] = goff;
    goff += (long long)widths[i] * widths[i + 1];
    pb[i] = goff;
    goff += widths[i + 1];
  }
  float* part = scratch + s.part;
  float* dzo = scratch + s.dzo;
  const float* wout = params + pp[nl - 1];
  float* aL = scratch + s.act[nl - 2];
  // The head: S and the head's cotangent.
  integrand_wide_head_kernel<<<blocks_for(32LL * R), SMALL_THREADS, 0, c.st>>>(
      aL, wout, x, g, ccw, S, dzo, R, K, dl);
  c.err = cudaGetLastError();
  // The output layer's dW row and db; then the last hidden layer's dz, in place.
  c.gemm_add(dzo, 0, 1, aL, dl, 1, dparams + pw[nl - 1], dl, 1, dl, (int)M, part);
  c.gemm_add(dzo, 0, 1, nullptr, 0, 0, dparams + pb[nl - 1], 1, 1, 1, (int)M, part);
  if (c.err != cudaSuccess) return c.err;
  integrand_wide_rank1_kernel<<<blocks_for(M * dl), SMALL_THREADS, 0, c.st>>>(aL, dzo, wout, M, dl,
                                                                             neg_slope);
  c.err = cudaGetLastError();
  // Hidden layers, from the last down: dW, db, then the dz of the layer
  // below in place of its activations.
  for (int i = nl - 2; i >= 1; --i) {
    const int din = widths[i], dout = widths[i + 1];
    const float* dz = scratch + s.act[i];
    float* below = scratch + s.act[i - 1];
    c.gemm_add(dz, 1, dout, below, din, 1, dparams + pw[i], din, dout, din, (int)M, part);
    c.gemm_add(dz, 1, dout, nullptr, 0, 0, dparams + pb[i], 1, dout, 1, (int)M, part);
    c.gemm(dz, dout, 1, params + pp[i], 1, dout, below, din, nullptr, M, din, dout, DLEAKY);
  }
  if (c.err != cudaSuccess) return c.err;
  // Layer 1: the node axis collapses, then dW1, db1, dh and dx by row.
  float* dzsum = scratch + s.dzsum;
  float* xsum = scratch + s.xsum;
  integrand_wide_collapse_kernel<<<blocks_for((long long)R * H1), SMALL_THREADS, 0, c.st>>>(
      scratch + s.act[0], nodes, dzsum, xsum, R, K, H1);
  c.err = cudaGetLastError();
  c.gemm_add(xsum, 1, H1, x, 1, 0, dparams + pw[0], F, H1, 1, R, part);             // dW1[:, 0]
  c.gemm_add(dzsum, 1, H1, h, e, 1, dparams + pw[0] + 1, F, H1, e, R, part);        // dW1[:, 1:]
  c.gemm_add(dzsum, 1, H1, nullptr, 0, 0, dparams + pb[0], 1, H1, 1, R, part);      // db1
  c.gemm(dzsum, H1, 1, params + H1, 1, H1, dh, e, nullptr, R, e, H1, STORE);        // dh
  if (c.err != cudaSuccess) return c.err;
  integrand_wide_dx_kernel<<<blocks_for(R), SMALL_THREADS, 0, c.st>>>(xsum, params, g, S, dx, R,
                                                                    H1);
  return cudaGetLastError();
}

}  // extern "C"
