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
//   - one float32 product kernel, `integrand_wide_gemm_kernel`, for every
//     matrix product: the node-invariant first layer ph = h W1[:, 1:]^T + b1,
//     the hidden layers (from W^T, packed with the biases), the dz of each
//     layer below and dh (from W in nn.Linear's layout), every hidden dW
//     (with its db as the row sums of the staged dz tiles) and dW1[:, 1:];
//   - small kernels: the layer-1 build leaky(ph_r + s_n (x_r W1[:, 0])), the
//     head (f, S_r, z_r or the head's cotangent, one warp per row, nodes in
//     order), the output layer's pass over the last activations (its dW row
//     and db, and the last hidden layer's rank-1 dz in place), the layer-1
//     collapse (dz_sum_r = sum_n dz1, sum_n s_n dz1, node order, with
//     dW1[:, 0] and db1), the ordered sum of split partials, and dx.
// The backward recomputes the chunk's forward (nothing of the forward is
// saved). LeakyReLU's derivative comes from a > 0, ELU+1's from min(f, 1).
// Each product's sum over k is one in-order FMA chain per output (the bias
// added after it), as in the staged kernels. No atomics: a reduction over the
// long item axis (every dW and db) runs in a fixed number of slices, written
// apart, and a second launch adds the slices in order; chunks run in order.
// Reruns on one card are bit-identical.
//
// Bound on an H100: operations, as for the staged pairs (chip_smoke.py's
// kernel_flops and bwd_kernel_flops over 66.9 TFLOP/s); nearly all of them
// are in the products. The product kernel is therefore built for the CUDA
// cores' FMA rate (float32 FMA, no TF32 or tensor cores: the flows' ll is
// held in float32): 128 x 128 output tiles on 256 threads, each thread 8 x 8
// outputs as four 4 x 4 sub-tiles, so that a k costs 4 sixteen-byte shared
// loads for 64 FMAs; operands staged k-major in shared memory, two stages and
// one barrier per k-step, the next step's copies in flight during this
// step's FMAs. An operand contiguous along its tile's m or n axis is copied
// with 16-byte cp.async; one contiguous along k is read with 16-byte loads
// into registers and stored transposed. The host picks these vector
// instances from each operand's address, leading dimension and extent
// (every 16-byte access aligned), else a scalar instance of the same
// pipeline. Every activation still goes through device memory.

#include <algorithm>
#include <cstdint>
#include <vector>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16;  // output tile and k-step of the product kernel
constexpr int PAD = 4;                      // floats after each staged row of 128
constexpr int GEMM_THREADS = 256;           // 16 x 16 threads, 8 x 8 outputs each
constexpr int SMALL_THREADS = 256;
constexpr int COLS = 32;                    // columns a block of the slice kernels, 8 lanes each
constexpr long long SPLIT_ITEMS = 512;      // least items of a slice
constexpr long long SPLIT_BLOCKS = 256;     // blocks a split reduction aims at
constexpr long long PARTIAL_FLOATS = 1 << 22;  // a split reduction's slices, at most
constexpr long long ALIGN = 32;             // scratch offsets and slice strides, in floats

enum Epilogue { STORE = 0, LEAKY = 1, DLEAKY = 2 };
// How an operand lies in memory. Its element (x, k), x the tile's m (for A)
// or n (for B) axis: XC, at p[k*ld + x] (contiguous along x); KC, at
// p[x*ld + k] (contiguous along k).
enum Layout { XC = 0, KC = 1 };

struct Operand {
  const float* p;
  long long ld;
};

// A 16-byte asynchronous copy from global to shared memory (cp.async, past
// L1), `bytes` of 16 or 0 (then zeros); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
#else
  *reinterpret_cast<float4*>(dst) =
      bytes ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
#endif
}

// One operand's k-step into a staged tile S[BK][BM + PAD] (S[k][x]): x in
// [x0, x0 + 128) of `extent`, k in [k0, k0 + BK) of [.., k_hi), zeros
// outside. With VEC, XC copies 16 bytes a thread by cp.async at once
// (`fetch`), KC reads 16 bytes a thread into registers (`fetch`) and stores
// them transposed after the FMAs (`put`); without VEC both read one float at a
// time into registers.
template <int L, bool VEC>
struct Stage {
  static constexpr bool ASYNC = L == XC && VEC;
  float r[8];

  __device__ __forceinline__ void fetch(const Operand& o, float (*S)[BM + PAD], long long x0,
                                        long long extent, int k0, int k_hi) {
    const int tid = threadIdx.x;
    if constexpr (ASYNC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + GEMM_THREADS * i, k = idx / 32, x = 4 * (idx % 32);
        const bool in = k0 + k < k_hi && x0 + x < extent;
        cp_async16(&S[k][x], in ? o.p + (long long)(k0 + k) * o.ld + x0 + x : o.p, in ? 16 : 0);
      }
    } else if constexpr (VEC) {  // KC: 128 x and 4 groups of 4 k
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + GEMM_THREADS * i, x = idx % BM, k = 4 * (idx / BM);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + k < k_hi && x0 + x < extent) v = ld4(o.p + (x0 + x) * o.ld + k0 + k);
        r[4 * i] = v.x; r[4 * i + 1] = v.y; r[4 * i + 2] = v.z; r[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = tid + GEMM_THREADS * i;
        // neighbouring threads on neighbouring addresses
        const int x = L == XC ? idx % BM : idx / BK, k = L == XC ? idx / BM : idx % BK;
        const bool in = k0 + k < k_hi && x0 + x < extent;
        r[i] = in ? (L == XC ? o.p[(long long)(k0 + k) * o.ld + x0 + x]
                             : o.p[(x0 + x) * o.ld + k0 + k])
                  : 0.f;
      }
    }
  }

  __device__ __forceinline__ void put(float (*S)[BM + PAD]) const {
    const int tid = threadIdx.x;
    if constexpr (ASYNC) {
      return;
    } else if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + GEMM_THREADS * i, x = idx % BM, k = 4 * (idx / BM);
#pragma unroll
        for (int c = 0; c < 4; ++c) S[k + c][x] = r[4 * i + c];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = tid + GEMM_THREADS * i;
        const int x = L == XC ? idx % BM : idx / BK, k = L == XC ? idx / BM : idx % BK;
        S[k][x] = r[i];
      }
    }
  }
};

// C[m][n] = epilogue(sum_k A[m][k] B[k][n] over k in slice z), A of `LA`, B
// of `LB` (x = m in [0, M), n in [0, N)), C[z*slice + m*ldc + n]. STORE: acc
// (+ bias[n]); LEAKY: leaky(acc + bias[n]); DLEAKY: acc * leaky'(C[m][n]), in
// place. Slice z covers k in [z*kper, min(Kd, (z+1)*kper)); every output's
// sum is one FMA chain in k order from 0 (padding k add 0 * 0). ROWSUM: the
// blocks of the first column of tiles also write the slice's row sums of A,
// sum_k A[m][k] in k order, to C[z*slice + rs_off + m] (a hidden layer's db
// beside its dW).
template <int LA, int LB, bool VEC, bool ROWSUM>
__global__ void __launch_bounds__(GEMM_THREADS, VEC ? 2 : 1)
integrand_wide_gemm_kernel(const Operand A, const Operand B, float* C, long long ldc,
                           long long slice, long long rs_off, const float* __restrict__ bias,
                           long long M, int N, int Kd, int kper, int mode, float neg_slope) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  const int k_lo = z * kper, k_hi = min(Kd, k_lo + kper);
  const int steps = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const bool rowsum = ROWSUM && blockIdx.y == 0 && tid < BM;
  Stage<LA, VEC> sa;
  Stage<LB, VEC> sb;
  float acc[8][8] = {};
  float rs = 0.f;
  if (steps > 0) {
    sa.fetch(A, As[0], m0, M, k_lo, k_hi);
    sb.fetch(B, Bs[0], n0, N, k_lo, k_hi);
    sa.put(As[0]);
    sb.put(Bs[0]);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    const bool next = t + 1 < steps;
    if (next) {  // the next k-step's copies are in flight during this one's FMAs
      sa.fetch(A, As[cur ^ 1], m0, M, k_lo + (t + 1) * BK, k_hi);
      sb.fetch(B, Bs[cur ^ 1], n0, N, k_lo + (t + 1) * BK, k_hi);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = ld4(&As[cur][kk][4 * ty]), a1 = ld4(&As[cur][kk][64 + 4 * ty]);
      const float4 b0 = ld4(&Bs[cur][kk][4 * tx]), b1 = ld4(&Bs[cur][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (rowsum) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) rs += As[cur][kk][tid];
    }
    if (next) {
      sa.put(As[cur ^ 1]);
      sb.put(Bs[cur ^ 1]);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  float* Cz = C + z * slice;
  if (rowsum && m0 + tid < M) Cz[rs_off + m0 + tid] = rs;
  const bool vec_c = ldc % 4 == 0 && reinterpret_cast<uintptr_t>(Cz) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + 4 * tx;
      if (n >= N) continue;
      float* c = Cz + m * ldc + n;
      float v[4];
      const bool whole = vec_c && n + 4 <= N;
      if (mode == DLEAKY && whole) {
        const float4 o = ld4(c);
        v[0] = o.x; v[1] = o.y; v[2] = o.z; v[3] = o.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!whole && n + j >= N) break;
        float a = acc[i][4 * h + j];
        if (mode == DLEAKY) {
          a *= (whole ? v[j] : c[j]) > 0.f ? 1.f : neg_slope;
        } else {
          if (bias) a += bias[n + j];
          if (mode == LEAKY) a = leaky(a, neg_slope);
        }
        v[j] = a;
        if (!whole) c[j] = a;
      }
      if (whole) *reinterpret_cast<float4*>(c) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// C[i] += sum over s < slices, in order, of part[s*stride + i], i < len.
__global__ void integrand_wide_add_kernel(float* C, const float* __restrict__ part,
                                          long long stride, int slices, long long len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += part[s * stride + i];
  C[i] += acc;
}

// Layer 1 from ph: act[q][j] = leaky(ph[r][j] + s_n (x_r W1[j][0])), q = r*K + n;
// V units a thread (V = 4: H1 a multiple of 4, ph and act 16-byte aligned).
template <int V>
__global__ void integrand_wide_build_kernel(const float* __restrict__ ph,
                                            const float* __restrict__ x,
                                            const float* __restrict__ nodes,
                                            const float* __restrict__ w1x,
                                            float* __restrict__ act, int rows, int K, int H1,
                                            float neg_slope) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x, per = H1 / V;
  if (i >= (long long)rows * K * per) return;
  const long long q = i / per;
  const int j = V * (int)(i - q * per), r = (int)(q / K), n = (int)(q - (long long)r * K);
  const float s = (nodes[n] + 1.f) * 0.5f, xr = x[r];
  float v[V];
#pragma unroll
  for (int u = 0; u < V; ++u)
    v[u] = leaky(fmaf(s, xr * w1x[j + u], ph[(long long)r * H1 + j + u]), neg_slope);
  float* out = act + q * H1 + j;
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  else
    out[0] = v[0];
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same sum (a + b == b + a)
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The head, one warp per row, its nodes in order (four dot products in
// flight at once): f = ELU+1(act[q] . wout + bout), S_r = sum_n w_n f.
// Forward (g null): out[r] = S_r x_r/2. Backward: out[r] = S_r and dzo[q] =
// w_n g_r x_r/2 min(f, 1).
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
  for (int n0 = 0; n0 < K; n0 += 4) {
    float z[4] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (n0 + u >= K) break;
      const float* a = act + (r * K + n0 + u) * dl;
      for (int k = lane; k < dl; k += 32) z[u] = fmaf(a[k], wout[k], z[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = n0 + u;
      if (n >= K) break;
      const float zn = warp_sum(z[u]) + bout;
      const float f = zn > 0.f ? zn + 1.f : expf(zn);  // ELU + 1
      s_r += ccw[n] * f;
      if (g && lane == 0) dzo[r * K + n] = ccw[n] * g[r] * xr * 0.5f * fminf(f, 1.f);
    }
  }
  if (lane == 0) out[r] = g ? s_r : s_r * xr * 0.5f;
}

// The output layer's backward over the last hidden activations aL [M][dl],
// items in slices of kper, COLS columns x 8 item lanes a block (grid: slices
// x column groups): part[z*stride + j] = the slice's sum of dzo[q] aL[q][j]
// (the dW row), part[z*stride + dl] = its sum of dzo[q] (db), each lane's
// items in order and the lanes in order; and, in place, the last hidden
// layer's dz: aL[q][j] = dzo[q] wout[j] leaky'(aL[q][j]).
__global__ void integrand_wide_out_kernel(float* aL, const float* __restrict__ dzo,
                                          const float* __restrict__ wout, float* __restrict__ part,
                                          long long stride, long long M, int dl, int kper,
                                          float neg_slope) {
  __shared__ float s_w[8][COLS], s_b[8];
  const int lane = threadIdx.x % COLS, il = threadIdx.x / COLS, z = blockIdx.x;
  const int j = blockIdx.y * COLS + lane;
  const long long q_lo = (long long)z * kper, q_hi = min(M, q_lo + kper);
  const float wj = j < dl ? wout[j] : 0.f;
  float w = 0.f, b = 0.f;
  for (long long q0 = q_lo + il; q0 < q_hi; q0 += 32) {  // a lane's items 8 apart, 4 at once
    float d[4], v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long q = q0 + 8 * u;
      d[u] = q < q_hi ? dzo[q] : 0.f;
      v[u] = q < q_hi && j < dl ? aL[q * dl + j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long q = q0 + 8 * u;
      if (q >= q_hi) break;
      if (j < dl) {
        w = fmaf(d[u], v[u], w);
        aL[q * dl + j] = d[u] * wj * (v[u] > 0.f ? 1.f : neg_slope);
      }
      b += d[u];
    }
  }
  s_w[il][lane] = w;
  if (lane == 0) s_b[il] = b;
  __syncthreads();
  if (il != 0) return;
  float* pz = part + z * stride;
  float sw = 0.f;
  for (int i = 0; i < 8; ++i) sw += s_w[i][lane];
  if (j < dl) pz[j] = sw;
  if (blockIdx.y == 0 && lane == 0) {
    float sb = 0.f;
    for (int i = 0; i < 8; ++i) sb += s_b[i];
    pz[dl] = sb;
  }
}

// The layer-1 collapse, rows in slices of kper, COLS units x 8 row lanes a
// block (grid: slices x unit groups), nodes in order: dzsum[r][j] = sum_n
// dz1[q][j], xsum[r][j] = sum_n s_n dz1[q][j]; and into slice z of layer 1's
// partials (dW1 [H1][F], then db1): part[z*stride + j*F] = the slice's sum of
// x_r xsum[r][j] (dW1[:, 0]), part[z*stride + H1*F + j] = its sum of
// dzsum[r][j] (db1), each lane's rows in order and the lanes in order.
__global__ void integrand_wide_collapse_kernel(const float* __restrict__ dz1,
                                               const float* __restrict__ nodes,
                                               const float* __restrict__ x,
                                               float* __restrict__ dzsum, float* __restrict__ xsum,
                                               float* __restrict__ part, long long stride,
                                               int rows, int K, int H1, int F, int kper) {
  __shared__ float s_x[8][COLS], s_b[8][COLS];
  const int lane = threadIdx.x % COLS, il = threadIdx.x / COLS, z = blockIdx.x;
  const int j = blockIdx.y * COLS + lane;
  const int r_lo = z * kper, r_hi = min(rows, r_lo + kper);
  float cx = 0.f, cb = 0.f;
  if (j < H1) {
    for (int r = r_lo + il; r < r_hi; r += 8) {
      float a = 0.f, b = 0.f;
      for (int n = 0; n < K; ++n) {
        const float v = dz1[((long long)r * K + n) * H1 + j];
        a += v;
        b = fmaf((nodes[n] + 1.f) * 0.5f, v, b);
      }
      dzsum[(long long)r * H1 + j] = a;
      xsum[(long long)r * H1 + j] = b;
      cx = fmaf(x[r], b, cx);
      cb += a;
    }
  }
  s_x[il][lane] = cx;
  s_b[il][lane] = cb;
  __syncthreads();
  if (il != 0 || j >= H1) return;
  float sx = 0.f, sb = 0.f;
  for (int i = 0; i < 8; ++i) {
    sx += s_x[i][lane];
    sb += s_b[i][lane];
  }
  part[z * stride + (long long)j * F] = sx;
  part[z * stride + (long long)H1 * F + j] = sb;
}

// dx_r = sum_j W1[j][0] xsum[r][j] (x's node path) + g_r S_r/2, one warp
// per row: each lane's units in order, then the lanes' butterfly.
__global__ void integrand_wide_dx_kernel(const float* __restrict__ xsum,
                                         const float* __restrict__ w1x, const float* __restrict__ g,
                                         const float* __restrict__ S, float* __restrict__ dx,
                                         int rows, int H1) {
  const int lane = threadIdx.x & 31;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= rows) return;
  float acc = 0.f;
  for (int j = lane; j < H1; j += 32) acc = fmaf(w1x[j], xsum[r * H1 + j], acc);
  acc = warp_sum(acc);
  if (lane == 0) dx[r] = acc + g[r] * S[r] * 0.5f;
}

inline unsigned blocks_for(long long n, int per = SMALL_THREADS) {
  return (unsigned)((n + per - 1) / per);
}

inline long long aligned(long long floats) { return (floats + ALIGN - 1) / ALIGN * ALIGN; }

// A reduction over `items` cut into slices of kper (a multiple of BK) for
// about `blocks_per_slice` blocks a slice: at least `least` items a slice,
// about SPLIT_BLOCKS blocks in all, the slices' `stride` floats each within
// PARTIAL_FLOATS (or one slice).
struct Split {
  int slices, kper;
};

inline Split split_for(long long items, long long blocks_per_slice, long long stride,
                       long long least = SPLIT_ITEMS) {
  long long s = (SPLIT_BLOCKS + blocks_per_slice - 1) / blocks_per_slice;
  const long long by_items = (items + least - 1) / least;
  if (s > by_items) s = by_items;
  if (s * stride > PARTIAL_FLOATS) s = PARTIAL_FLOATS / stride;
  if (s < 1) s = 1;
  const long long kper = ((items + s - 1) / s + BK - 1) / BK * BK;
  return {(int)((items + kper - 1) / kper), (int)kper};
}

inline long long tiles(long long M, long long N) { return ((M + BM - 1) / BM) * ((N + BN - 1) / BN); }

// The widths: 1 + e >= 1, every hidden width >= 1, one output, >= 2 layers.
inline bool takes(const int* w, int n_layers) {
  if (n_layers < 2 || w[n_layers] != 1) return false;
  for (int i = 0; i < n_layers; ++i)
    if (w[i] < 1) return false;
  return true;
}

// The backward's reductions of a chunk: the output layer's (dW row and db),
// each hidden layer's (dW and db; index i of hidden[i] = layer i), layer 1's
// (dW1 and db1); slice strides in floats.
struct Plan {
  Split out, first;
  long long out_stride, first_stride;
  std::vector<Split> hidden;
  std::vector<long long> hidden_stride;
};

inline Plan plan_for(int rows, int K, const int* w, int nl) {
  Plan p;
  const long long M = (long long)rows * K, F = w[0], H1 = w[1], dl = w[nl - 1];
  p.out_stride = aligned(dl + 1);
  p.out = split_for(M, (dl + COLS - 1) / COLS, p.out_stride);
  p.hidden.resize(nl - 1);
  p.hidden_stride.resize(nl - 1);
  for (int i = 1; i < nl - 1; ++i) {
    const long long din = w[i], dout = w[i + 1];
    p.hidden_stride[i] = aligned(dout * din + dout);
    p.hidden[i] = split_for(M, tiles(dout, din), p.hidden_stride[i]);
  }
  p.first_stride = aligned(H1 * F + H1);
  // layer 1 by rows, each row K items of the collapse
  p.first = split_for(rows, (H1 + COLS - 1) / COLS, p.first_stride, (SPLIT_ITEMS + K - 1) / K);
  return p;
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
  s.ph = off;   off += aligned(rows * H1);
  for (int i = 0; i < nl - 1; ++i) {
    s.act.push_back(off);
    off += aligned(M * w[i + 1]);
  }
  s.dzo = off;   off += aligned(M);
  s.dzsum = off; off += aligned(rows * H1);
  s.xsum = off;  off += aligned(rows * H1);
  const Plan p = plan_for(rows, K, w, nl);
  long long part = std::max(p.out.slices * p.out_stride, p.first.slices * p.first_stride);
  for (int i = 1; i < nl - 1; ++i) part = std::max(part, p.hidden[i].slices * p.hidden_stride[i]);
  s.part = off;  off += part;
  s.total = off;
  return s;
}

// Whether 16-byte accesses of operand `o` (layout L, x in [0, extent), k in
// [0, Kd)) are all aligned and never cross an edge.
template <int L>
inline bool vec_ok(const Operand& o, long long extent, int Kd) {
  if (reinterpret_cast<uintptr_t>(o.p) % 16 != 0 || o.ld % 4 != 0) return false;
  return L == XC ? extent % 4 == 0 : Kd % 4 == 0;
}

struct Ctx {
  cudaStream_t st;
  float neg_slope;
  cudaError_t err = cudaSuccess;

  // C = A B, with A and B laid out as LA and LB, through the vector
  // instance where both operands take it; `sp` cuts k in slices.
  template <int LA, int LB, bool ROWSUM = false>
  void gemm(Operand A, Operand B, float* C, long long ldc, const float* bias, long long M, int N,
            int Kd, int mode, Split sp = {1, 0}, long long slice = 0, long long rs_off = 0) {
    if (err != cudaSuccess || M == 0 || N == 0) return;
    if (sp.slices == 1) sp.kper = Kd;
    const dim3 grid(blocks_for(M, BM), blocks_for(N, BN), sp.slices);
    const bool vec = vec_ok<LA>(A, M, Kd) && vec_ok<LB>(B, N, Kd);
    auto kernel = vec ? integrand_wide_gemm_kernel<LA, LB, true, ROWSUM>
                      : integrand_wide_gemm_kernel<LA, LB, false, ROWSUM>;
    kernel<<<grid, GEMM_THREADS, 0, st>>>(A, B, C, ldc, slice, rs_off, bias, M, N, Kd, sp.kper,
                                          mode, neg_slope);
    err = cudaGetLastError();
  }

  // C[i] += the slices of part added in order, i < len.
  void add(float* C, const float* part, long long stride, int slices, long long len) {
    if (err != cudaSuccess) return;
    integrand_wide_add_kernel<<<blocks_for(len), SMALL_THREADS, 0, st>>>(C, part, stride, slices,
                                                                        len);
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
  c.gemm<KC, XC>({h, e}, {w1 + H1, H1}, ph, H1, b1, rows, H1, e, STORE);
  if (c.err != cudaSuccess) return;
  // s.ph and s.act[0] are ALIGN-aligned in the 16-byte aligned scratch
  if (H1 % 4 == 0 && reinterpret_cast<uintptr_t>(sc) % 16 == 0)
    integrand_wide_build_kernel<4><<<blocks_for(M * H1 / 4), SMALL_THREADS, 0, c.st>>>(
        ph, x, nodes, w1, sc + s.act[0], rows, K, H1, c.neg_slope);
  else
    integrand_wide_build_kernel<1><<<blocks_for(M * H1), SMALL_THREADS, 0, c.st>>>(
        ph, x, nodes, w1, sc + s.act[0], rows, K, H1, c.neg_slope);
  c.err = cudaGetLastError();
  const float* p = b1 + H1;
  for (int i = 1; i < nl - 1; ++i) {
    const int din = w[i], dout = w[i + 1];
    c.gemm<KC, XC>({sc + s.act[i - 1], din}, {p, dout}, sc + s.act[i], dout,
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
  integrand_wide_head_kernel<<<blocks_for(32LL * R), SMALL_THREADS, 0, c.st>>>(
      scratch + s.act[nl - 2], params + off, x, nullptr, ccw, out, nullptr, R, K, dl);
  return cudaGetLastError();
}

// The backward of one chunk of R rows: dx, dh and S of its rows, and its dW/db
// added to dparams (per layer dW [dout][din], then db). weights: a host
// array of each layer's W address, [dout][din] (nn.Linear's layout), read in
// place. scratch as for the forward. Returns the first launch error.
int umnn_integrand_bwd_wide(const float* x, const float* h, const float* params,
                            const float* const* weights, const float* nodes, const float* ccw,
                            const float* g, float* dx,
                            float* dh, float* S, float* dparams, int R, int K,
                            const int* widths, int n_layers, float neg_slope, float* scratch,
                            void* stream) {
  if (R < 1 || K < 1 || !takes(widths, n_layers)) return cudaErrorInvalidValue;
  const int nl = n_layers, F = widths[0], e = F - 1, H1 = widths[1], dl = widths[nl - 1];
  const long long M = (long long)R * K;
  const Scratch s = scratch_for(R, K, widths, nl);
  const Plan plan = plan_for(R, K, widths, nl);
  Ctx c{(cudaStream_t)stream, neg_slope};
  forward_chunk(c, x, h, params, nodes, widths, nl, R, K, scratch, s);
  if (c.err != cudaSuccess) return c.err;
  // where each layer's W^T and b sit in params (and its dW, then db, in
  // dparams)
  std::vector<long long> pp(nl);
  long long off = 0;
  for (int i = 0; i < nl; ++i) {
    pp[i] = off;
    off += (long long)widths[i] * widths[i + 1] + widths[i + 1];
  }
  float* part = scratch + s.part;
  float* dzo = scratch + s.dzo;
  const float* wout = params + pp[nl - 1];
  float* aL = scratch + s.act[nl - 2];
  // The head: S and the head's cotangent.
  integrand_wide_head_kernel<<<blocks_for(32LL * R), SMALL_THREADS, 0, c.st>>>(
      aL, wout, x, g, ccw, S, dzo, R, K, dl);
  c.err = cudaGetLastError();
  if (c.err != cudaSuccess) return c.err;
  // The output layer's dW row and db, and the last hidden layer's dz in place.
  integrand_wide_out_kernel<<<dim3(plan.out.slices, blocks_for(dl, COLS)), SMALL_THREADS, 0,
                              c.st>>>(aL, dzo, wout, part, plan.out_stride, M, dl,
                                      plan.out.kper, neg_slope);
  c.err = cudaGetLastError();
  c.add(dparams + pp[nl - 1], part, plan.out_stride, plan.out.slices, dl + 1);
  // Hidden layers, from the last down: dW with db beside it, then the dz of
  // the layer below in place of its activations.
  for (int i = nl - 2; i >= 1; --i) {
    const int din = widths[i], dout = widths[i + 1];
    const float* dz = scratch + s.act[i];
    float* below = scratch + s.act[i - 1];
    const long long stride = plan.hidden_stride[i];
    c.gemm<XC, XC, true>({dz, dout}, {below, din}, part, din, nullptr, dout, din, (int)M, STORE,
                         plan.hidden[i], stride, (long long)dout * din);
    c.add(dparams + pp[i], part, stride, plan.hidden[i].slices, (long long)dout * din + dout);
    c.gemm<KC, XC>({dz, dout}, {weights[i], din}, below, din, nullptr, M, din, dout, DLEAKY);
  }
  if (c.err != cudaSuccess) return c.err;
  // Layer 1: the node axis collapses (with dW1[:, 0] and db1), then dW1[:, 1:]
  // into the same slices, their sum, dh and dx by row.
  float* dzsum = scratch + s.dzsum;
  float* xsum = scratch + s.xsum;
  integrand_wide_collapse_kernel<<<dim3(plan.first.slices, blocks_for(H1, COLS)),
                                   SMALL_THREADS, 0, c.st>>>(
      scratch + s.act[0], nodes, x, dzsum, xsum, part, plan.first_stride, R, K, H1, F,
      plan.first.kper);
  c.err = cudaGetLastError();
  c.gemm<XC, XC>({dzsum, H1}, {h, e}, part + 1, F, nullptr, H1, e, R, STORE, plan.first,
                 plan.first_stride);
  c.add(dparams + pp[0], part, plan.first_stride, plan.first.slices, (long long)H1 * F + H1);
  c.gemm<KC, XC>({dzsum, H1}, {weights[0] + 1, F}, dh, e, nullptr, R, e, H1, STORE);  // dh
  if (c.err != cudaSuccess) return c.err;
  integrand_wide_dx_kernel<<<blocks_for(32LL * R), SMALL_THREADS, 0, c.st>>>(xsum, params, g, S,
                                                                          dx, R, H1);
  return cudaGetLastError();
}

}  // extern "C"
