// Helpers shared by the integrand kernels of this directory: the
// integrand's widths and their check, LeakyReLU, aligned vector loads from
// shared memory, asynchronous copies into it, the offsets of the flat
// parameter gradient, the ordered sum of per-block partials, and the dynamic
// shared memory set-up of a launch.
// Each kernel keeps its own tile sizes, width limit and shared-memory layout.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LAYERS = 8;  // linear layers, hidden and output

struct Dims {
  int n_layers;
  int w[MAX_LAYERS + 1];  // w[0] = 1 + e, ..., w[n_layers] = 1
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Fills `d` from the widths; false if a kernel cannot take them: 2 to
// MAX_LAYERS layers, one output, every hidden width in [1, max_hidden] and
// 1 + e in [1, max_first].
inline bool make_dims(const int* widths, int n_layers, int max_hidden, int max_first, Dims* d) {
  if (n_layers < 2 || n_layers > MAX_LAYERS || widths[0] < 1 || widths[0] > max_first ||
      widths[n_layers] != 1)
    return false;
  d->n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) d->w[i] = widths[i];
  for (int i = 1; i < n_layers; ++i)
    if (d->w[i] < 1 || d->w[i] > max_hidden) return false;
  return true;
}

__device__ __forceinline__ float leaky(float v, float neg_slope) {
  return v > 0.f ? v : neg_slope * v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// An asynchronous 4-byte copy from global to shared memory (cp.async): a
// thread's copies are all in flight at once and take no registers; wait_all
// waits for them. Compiled for the host, a plain copy.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Offsets of each layer's dW ([dout][din]) and db in the flat gradient;
// returns its length.
__host__ __device__ inline int param_offsets(const Dims& d, int* pw, int* pb) {
  int off = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    pw[l] = off;  off += d.w[l + 1] * d.w[l];
    pb[l] = off;  off += d.w[l + 1];
  }
  return off;
}

// out[p] = sum over `blocks` slices, in slice order, of partial[b][p]: the
// body of each backward's reduction launch.
__device__ __forceinline__ void sum_partials(const float* __restrict__ partial,
                                             float* __restrict__ out, int P, int blocks) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P) {
    float acc = 0.f;
    for (int b = 0; b < blocks; ++b) acc += partial[(size_t)b * P + p];
    out[p] = acc;
  }
}

// Checks `bytes` of dynamic shared memory against the card's opt-in limit
// (cudaErrorInvalidValue past it) and sets it as `kernel`'s limit.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, long long bytes) {
  int dev = 0, max_bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > max_bytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
