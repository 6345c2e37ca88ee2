// What the pack-4 pair, integrand_fwd_p4.cu and integrand_bwd_p4.cu, shares:
// the block and its limits, the layers' own tensors the weights are read
// from, the staging of the weights into shared memory, the hidden layers'
// register tiles, and the choice of row tiles for a launch.
//
// Both kernels walk (row, node) items: a row tile of TR rows holds TR x K
// items, item q = r K + n for node n of row r, processed in item tiles of at
// most MT items (the whole row tile where it fits). Activations are kept
// transposed, [width][LDA] with item m of the tile at column m. Widths are
// padded to multiples of 4 with zero weights and biases, so that padded
// activations are exactly 0.

#pragma once

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_WIDTH = 32;             // 1 + e and every hidden width: at most a lane each
constexpr int MAX_TR = 64;                // rows per row tile, at most
constexpr long long SMEM_LIMIT = 232448;  // an H100 block's opt-in shared memory

// Each layer's weight, [dout][din] (nn.Linear's layout), and bias in device
// memory, read in place.
struct Weights {
  const float* w[MAX_LAYERS];
  const float* b[MAX_LAYERS];
};

// The addresses of the C interface, w0, b0, w1, b1, ..., as a kernel argument.
inline Weights weights_at(const float* const* layers, int n_layers) {
  Weights W = {};
  for (int l = 0; l < n_layers; ++l) {
    W.w[l] = layers[2 * l];
    W.b[l] = layers[2 * l + 1];
  }
  return W;
}

// Stages layer 1 (W1 [H1][F]) into shared memory as it is, rows padded to
// ld0 with 0 and of stride ldw1 (odd, so that a warp's lanes, a unit each,
// read other banks), and b1 [ld0]: lane k a column, warp j a row, each copy a
// cp.async, coalesced and without bank conflicts.
__device__ __forceinline__ void stage_layer1(float* w1, float* b1, const float* __restrict__ w,
                                             const float* __restrict__ b, int F, int H1, int ld0,
                                             int ldw1) {
  const int k = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < ld0; j += NWARPS) {
    if (k < F) {
      if (j < H1) cp_async4(w1 + j * ldw1 + k, w + j * F + k);
      else w1[j * ldw1 + k] = 0.f;
    }
    if (k == 31) {
      if (j < H1) cp_async4(b1 + j, b + j);
      else b1[j] = 0.f;
    }
  }
}

// Stages a hidden layer (W [dout][din]) the same way, as wn [ldo][ldi]
// zero-padded, and its bias [ldo].
__device__ __forceinline__ void stage_hidden(float* wn, float* bias, const float* __restrict__ w,
                                             const float* __restrict__ b, int din, int dout,
                                             int ldi, int ldo) {
  const int k = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < ldo; j += NWARPS) {
    if (k < ldi) {
      if (j < dout && k < din) cp_async4(wn + j * ldi + k, w + j * din + k);
      else wn[j * ldi + k] = 0.f;
    }
    if (k == 31) {
      if (j < dout) cp_async4(bias + j, b + j);
      else bias[j] = 0.f;
    }
  }
}

// Stages the output layer's row (W [1][dL]) as wout [ldL], zero past dL,
// and its bias; the nodes t_n (made s_n = (t_n + 1)/2 in place by
// nodes_to_s once they have arrived) and their weights.
__device__ __forceinline__ void stage_output_and_nodes(float* wout, float* bout, float* sn,
                                                       float* cw, const float* __restrict__ w,
                                                       const float* __restrict__ b, int dL,
                                                       int ldL, const float* __restrict__ nodes,
                                                       const float* __restrict__ ccw, int K) {
  for (int k = threadIdx.x; k < ldL; k += NTHREADS) {
    if (k < dL) cp_async4(wout + k, w + k);
    else wout[k] = 0.f;
  }
  if (threadIdx.x == 0) cp_async4(bout, b);
  for (int n = threadIdx.x; n < K; n += NTHREADS) {
    cp_async4(sn + n, nodes + n);
    cp_async4(cw + n, ccw + n);
  }
}

// s_n = (t_n + 1)/2 in place of the staged nodes, each by the thread that
// copied it (so after its own cp.async wait, before the next barrier).
__device__ __forceinline__ void nodes_to_s(float* sn, int K) {
  for (int n = threadIdx.x; n < K; n += NTHREADS) sn[n] = (sn[n] + 1.f) * 0.5f;
}

// Component i of v (i known at compile time).
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

// A product over the item tile's MTp items (a multiple of 4), on register
// tiles of 4 items x 4 columns, with W as nn.Linear keeps it, [dout][din]
// (padded to multiples of 4 with 0); in is [rows][LDA], out [cols][LDA]:
//   forward: out[c][m] = leaky(sum_k in[k][m] W[c][k] + bias[c]), rows = din;
//   DZ:      out[c][m] = (sum_k in[k][m] W[k][c]) * leaky'(out[c][m]), in
//            place, rows = dout.
// Each sum is one FMA chain in k order. Per 4 k a thread loads 4 item
// float4s and 4 weight float4s (the forward's along W's rows, 4 k of each of
// its 4 columns; the dz product's across them) for 64 FMAs. Thread t takes
// the tiles t, t + NTHREADS, ..., items first, so that a warp's item loads
// lie side by side and its weight loads are one or two broadcasts.
template <bool DZ>
__device__ __forceinline__ void product(const float* __restrict__ in, float* out,
                                        const float* __restrict__ w,
                                        const float* __restrict__ bias, int rows, int cols,
                                        int MTp, int LDA, float neg_slope) {
  const int nig = MTp >> 2, ntiles = nig * (cols >> 2);
  for (int t = threadIdx.x; t < ntiles; t += NTHREADS) {
    const int cg = t / nig, ig = t - cg * nig;
    const float* pa = in + 4 * ig;
    // forward: column c's row of W, 4 k at a time; dz: row k's 4 columns
    const float* pw = DZ ? w + 4 * cg : w + 4 * cg * rows;
    float acc[4][4];  // [item][column]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < MAX_WIDTH; k0 += 4) {
      if (k0 >= rows) break;
      float4 a[4], b[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk] = ld4(pa + (k0 + kk) * LDA);
        b[kk] = DZ ? ld4(pw + (k0 + kk) * cols) : ld4(pw + kk * rows + k0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float av[4] = {a[kk].x, a[kk].y, a[kk].z, a[kk].w};
        // the tile's 4 columns at k0 + kk: W[c][k0 + kk] (forward), W[k0 + kk][c] (dz)
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = DZ ? at(b[kk], j) : at(b[j], kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* po = out + (4 * cg + j) * LDA + 4 * ig;
      if constexpr (DZ) {
        const float4 o = ld4(po);
        st4(po, acc[0][j] * (o.x > 0.f ? 1.f : neg_slope), acc[1][j] * (o.y > 0.f ? 1.f : neg_slope),
            acc[2][j] * (o.z > 0.f ? 1.f : neg_slope), acc[3][j] * (o.w > 0.f ? 1.f : neg_slope));
      } else {
        const float bj = bias[4 * cg + j];
        st4(po, leaky(acc[0][j] + bj, neg_slope), leaky(acc[1][j] + bj, neg_slope),
            leaky(acc[2][j] + bj, neg_slope), leaky(acc[3][j] + bj, neg_slope));
      }
    }
  }
}

// Layer 1 of the item tile, items p0 .. p0 + MTp - 1 of the row tile (mt of
// them real): a0[j][m] = leaky(s_n * (x_r w1x_j) + ph_rj), one FMA, from
// ph and xw = x_r w1x kept per row with stride ldr; items past mt get 0.
// Thread: item m and every G-th group of 4 units, G = NTHREADS / MTp (at
// least 1).
__device__ __forceinline__ void layer1(float* a0, const float* ph, const float* xw,
                                       const float* sn, int p0, int mt, int MTp, int LDA, int K,
                                       int ld0, int ldr, float neg_slope) {
  const int G = NTHREADS >= MTp ? NTHREADS / MTp : 1;
  for (int i = threadIdx.x; i < G * MTp; i += NTHREADS) {
    const int c = i / MTp, m = i - c * MTp;
    float* pa = a0 + m;
    if (m < mt) {
      const int q = p0 + m, r = q / K;
      const float s = sn[q - r * K];
      const float* phr = ph + r * ldr;
      const float* xwr = xw + r * ldr;
      for (int j = 4 * c; j < ld0; j += 4 * G) {
        const float4 p = ld4(phr + j), v = ld4(xwr + j);
        pa[j * LDA] = leaky(fmaf(s, v.x, p.x), neg_slope);
        pa[(j + 1) * LDA] = leaky(fmaf(s, v.y, p.y), neg_slope);
        pa[(j + 2) * LDA] = leaky(fmaf(s, v.z, p.z), neg_slope);
        pa[(j + 3) * LDA] = leaky(fmaf(s, v.w, p.w), neg_slope);
      }
    } else {
      for (int j = 4 * c; j < ld0; j += 4 * G) {
        pa[j * LDA] = 0.f;
        pa[(j + 1) * LDA] = 0.f;
        pa[(j + 2) * LDA] = 0.f;
        pa[(j + 3) * LDA] = 0.f;
      }
    }
  }
}

// ph = h W1[:, 1:]^T + b1 (one FMA chain a unit, then the bias) and xw = x
// W1[:, 0], for each row of the row tile, from W1 as staged (row stride
// ldw1): lane j a unit, warp w the rows w, w + NWARPS, ..., four of them at
// a time (four chains side by side).
__device__ __forceinline__ void first_layer_rows(float* ph, float* xw, const float* hs,
                                                 const float* xs, const float* w1,
                                                 const float* b1, int rows, int e, int ld0,
                                                 int ldw1, int ldr) {
  const int j = threadIdx.x & 31;
  if (j >= ld0) return;
  const float* wj = w1 + j * ldw1;
  for (int r0 = threadIdx.x >> 5; r0 < rows; r0 += 4 * NWARPS) {
    const float* hr = hs + r0 * e;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < e; ++k) {
      const float wk = wj[1 + k];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r0 + u * NWARPS < rows) acc[u] = fmaf(hr[u * NWARPS * e + k], wk, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * NWARPS;
      if (r < rows) {
        ph[r * ldr + j] = acc[u] + b1[j];
        xw[r * ldr + j] = xs[r] * wj[0];
      }
    }
  }
}

// The output layer's z = sum_k a[k] wout[k] + bout of one item (a: its
// column of the last hidden activations, stride LDA), one FMA chain in k
// order.
__device__ __forceinline__ float output_z(const float* a, const float* wout, float bout, int dl,
                                          int LDA) {
  float z = 0.f;
  for (int k = 0; k < dl; ++k) z = fmaf(a[k * LDA], wout[k], z);
  return z + bout;
}

// Row tiles that fit: tr, the most rows a row tile may take with all its
// items in one item tile (0 if one row's items do not fit), else mt, the
// most items an item tile of a one-row tile may take (0 if none fits).
// bytes(TR, MT): the shared memory of that layout.
struct Fit {
  int tr, mt;
};

template <class Bytes>
inline Fit fit(Bytes bytes, int K) {
  Fit f = {0, 0};
  for (int lo = 1, hi = MAX_TR; lo <= hi;) {
    const int mid = (lo + hi) / 2;
    if (bytes(mid, mid * K) <= SMEM_LIMIT) {
      f.tr = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  if (f.tr == 0)
    for (int lo = 1, hi = (K - 1) / 4; lo <= hi;) {
      const int mid = (lo + hi) / 2;
      if (bytes(1, 4 * mid) <= SMEM_LIMIT) {
        f.mt = 4 * mid;
        lo = mid + 1;
      } else {
        hi = mid - 1;
      }
    }
  return f;
}

// Rows per row tile for R rows on `slots` resident blocks, at most tr_max:
// the fewest waves of row tiles, then the fewest rows a tile for them.
inline int rows_per_tile(int R, int slots, int tr_max) {
  const long long cap = (long long)slots * tr_max;
  const long long per_wave = (R + cap - 1) / cap * slots;
  return (int)((R + per_wave - 1) / per_wave);
}

// The slots of a launcher: the blocks of `kernel` resident on the card at
// once with `bytes` of dynamic shared memory (its largest layout for some
// widths and K), or a negative CUDA error code. It sets the kernel's limit
// to the card's opt-in maximum, not to `bytes`: the limit belongs to the
// kernel, not to the widths and K, and the caller asks once per widths and
// K, so a limit of one set's layout would refuse a later launch of another
// set that was asked before.
template <typename Kernel>
int resident_blocks(Kernel kernel, long long bytes) {
  int dev = 0, max_bytes = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && bytes > max_bytes) err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, (size_t)bytes);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return per_sm * sms;
}

}  // namespace
