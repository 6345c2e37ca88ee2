// Forward Clenshaw-Curtis integral of the UMNN integrand MLP for integrands
// whose every layer is at most 32 wide (the pack-4 route):
//
//   z_r = x_r/2 * sum_n w_n * ELU+1( MLP([x_r * s_n, h_r]) ),  s_n = (t_n+1)/2
//
// with LeakyReLU(neg_slope) between layers. It computes the same function as
// integrand_fwd.cu; only the grouping of the (row, node) items and the order
// of the sums in each layer differ.
//
// Replaces the TPU kernel `_fwd_kernel_pn` of umnn_tpu/ops/integrand_kernel.py
// (:522-570, launched by `_run_fwd_pn` :786). There four nodes ride one
// matmul row through block-diagonal weights diag(W, W, W, W) and [x, h] x 4
// feature rows (`_prep_pn` :756, `_packn_params` :702), which fills the MXU's
// 128 lanes with 32-wide layers, K padded to a multiple of 4 (`_packn_nodes`
// :723). None of that is carried over: the kernel reads x as [R], h as
// [R, e] and each layer's own weight and bias tensors, and its unit of work
// is a (row, node) item with no padding; the weight float4 that feeds 4
// items x 4 columns of a register tile is what diag(W, W, W, W) buys on the
// MXU. Per item the float32 operations come in the order of
// integrand_bwd_p4.cu's forward (layer 1: an in-order FMA chain over h, the
// bias added, x w1x rounded once and one FMA with s_n; later layers: an
// in-order FMA chain, then the bias).
//
// Bound on an H100: operations, but below a launch at the shapes that use
// it: the toy flow's block (R = 512 rows, 17 nodes, widths 11-32-32-1) is
// 19.27 MFLOP of useful float32 work (chip_smoke.py::kernel_flops), 0.29 us
// at the 66.9 TFLOP/s float32 peak; a 4,096-row block 2.30 us. An empty
// launch at its shape takes about 0.9 us on the card
// (chip_smoke.py::launch_floor_ms), so its time is set by how soon each SM
// gets through its share: staging, a chain of barriers, and the product.
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
//     column and warp a row: no division, no bank conflict; each weight as
//     nn.Linear keeps it, read along its rows by the products.
//   - ph = h W1[:, 1:]^T + b1 and x W1[:, 0] once per row, from h staged in
//     shared memory; layer 1 from them for every item.
//   - A row tile's items go through the hidden layers in one item tile where
//     it fits in shared memory (else in tiles of MT items), on register
//     tiles of 4 items x 4 columns sized to the tile: 136 of them at the toy
//     block, 1,088 at 4,096 rows.
//   - Each item's output layer is one FMA chain; each row's sum over its
//     nodes is taken in one thread, in node order: no atomics, no carry
//     between blocks, bit-identical reruns.
//   - The layout is computed on the host and read from the constant bank.

#include "pack4.cuh"

namespace {

// Offsets into shared memory, in floats, each a multiple of 4 (16 bytes),
// and the tile sizes: TR rows a row tile, MT items an item tile (MTp rounded
// up to 4, also the activations' row stride). ld[l]: layer l+1's width
// rounded up to 4. Layer 1: w1 (W1 as it is, [ld0][ldw1]), b1; hidden
// layer l: wn (W as it is, [ld[l]][ld[l-1]]), bias. Per row of the row tile
// (stride ldr): ph and xw (x w1x); fw per (row, node), stride ldfw (odd). Layer l's
// output goes to buf[l % 2].
struct Layout {
  int TR, MT, MTp, ldr, ldfw, ldw1;
  int w1, b1, wout, bout, s, ccw, xs, hs, ph, xw, fw, buf[2], total;
  int ld[MAX_LAYERS], wn[MAX_LAYERS], bias[MAX_LAYERS];
};

inline Layout layout_for(const Dims& d, int K, int TR, int MT) {
  Layout L;
  const int nl = d.n_layers, e = d.w[0] - 1;
  L.TR = TR;
  L.MT = MT;
  L.MTp = round_up(MT, 4);
  for (int l = 0; l < nl - 1; ++l) L.ld[l] = round_up(d.w[l + 1], 4);
  const int ld0 = L.ld[0];
  L.ldr = ld0 % 8 == 0 ? ld0 + 4 : ld0;  // rows of ph read side by side: other banks
  L.ldfw = K | 1;
  L.ldw1 = d.w[0] | 1;
  int off = 0;
  L.w1 = off;   off += round_up(ld0 * L.ldw1, 4);
  L.b1 = off;   off += ld0;
  for (int l = 1; l < nl - 1; ++l) {
    L.wn[l] = off;    off += L.ld[l] * L.ld[l - 1];
    L.bias[l] = off;  off += L.ld[l];
  }
  L.wout = off;  off += L.ld[nl - 2];
  L.bout = off;  off += 4;
  L.s = off;     off += round_up(K, 4);
  L.ccw = off;   off += round_up(K, 4);
  L.xs = off;    off += round_up(TR, 4);
  L.hs = off;    off += round_up(TR * e, 4);
  L.ph = off;    off += TR * L.ldr;
  L.xw = off;    off += TR * L.ldr;
  L.fw = off;    off += round_up(TR * L.ldfw, 4);
  int bufw[2] = {0, 0};
  for (int l = 0; l < nl - 1; ++l)
    bufw[l % 2] = L.ld[l] > bufw[l % 2] ? L.ld[l] : bufw[l % 2];
  L.buf[0] = off;  off += bufw[0] * L.MTp;
  L.buf[1] = off;  off += bufw[1] * L.MTp;
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

// W: the layers' own tensors. L: launch_layout(...), computed on the host,
// so that the kernel reads it from the constant bank.
__global__ void __launch_bounds__(NTHREADS, 1)
integrand_fwd_p4_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        const __grid_constant__ Weights W, const float* __restrict__ nodes,
                        const float* __restrict__ ccw, float* __restrict__ out, int R, int K,
                        const __grid_constant__ Dims d, const __grid_constant__ Layout L,
                        float neg_slope) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int nl = d.n_layers, F = d.w[0], e = F - 1, H1 = d.w[1], dl = d.w[nl - 1];
  const int TR = L.TR, MTp = L.MTp, ldr = L.ldr, ldfw = L.ldfw, ld0 = L.ld[0];

  // Stage the weights once, from the layers' own tensors, and the first row
  // tile's x and h, every copy in flight (cp.async).
  float* xs = sm + L.xs;
  float* hs = sm + L.hs;
  auto stage_rows = [&](int tile) {  // a row tile's x and h
    const int row0 = tile * TR, rows = min(TR, R - row0);
    for (int r = tid; r < rows; r += NTHREADS) cp_async4(xs + r, x + row0 + r);
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

  const float* wout = sm + L.wout;
  const float* sn = sm + L.s;
  const float* cw = sm + L.ccw;
  float* ph = sm + L.ph;
  float* xw = sm + L.xw;
  float* fw = sm + L.fw;
  const float* aL = sm + L.buf[(nl - 2) % 2];
  const int n_tiles = (R + TR - 1) / TR;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TR, rows = min(TR, R - row0);
    // The row tile's x and h (the first's are in flight already).
    if (tile != (int)blockIdx.x) stage_rows(tile);
    cp_async_wait_all();
    if (tile == (int)blockIdx.x) nodes_to_s(sm + L.s, K);
    __syncthreads();
    // Node-invariant first layer, once per row.
    first_layer_rows(ph, xw, hs, xs, sm + L.w1, sm + L.b1, rows, e, ld0, L.ldw1, ldr);
    __syncthreads();

    const int PQ = rows * K;
    for (int p0 = 0; p0 < PQ; p0 += L.MT) {
      const int mt = min(L.MT, PQ - p0);
      // Layer 1 for each item from ph and the rank-1 node term (items past
      // the row tile: 0).
      layer1(sm + L.buf[0], ph, xw, sn, p0, mt, MTp, MTp, K, ld0, ldr, neg_slope);
      __syncthreads();
      // Hidden products.
      for (int l = 1; l < nl - 1; ++l) {
        product<false>(sm + L.buf[(l - 1) % 2], sm + L.buf[l % 2], sm + L.wn[l], sm + L.bias[l],
                       L.ld[l - 1], L.ld[l], MTp, MTp, neg_slope);
        __syncthreads();
      }
      // Output layer: f at every item, times its quadrature weight.
      const float bout = sm[L.bout];
      for (int m = tid; m < mt; m += NTHREADS) {
        const int q = p0 + m, r = q / K, n = q - r * K;
        const float z = output_z(aL + m, wout, bout, dl, MTp);
        const float f = z > 0.f ? z + 1.f : expf(z);  // ELU + 1
        fw[r * ldfw + n] = cw[n] * f;
      }
      __syncthreads();
    }

    // Each row's node sum in node order (beside the next row tile's x and h).
    for (int r = NTHREADS - 1 - tid; r < rows; r += NTHREADS) {
      float acc = 0.f;
#pragma unroll 4
      for (int n = 0; n < K; ++n) acc += fw[r * ldfw + n];
      out[row0 + r] = acc * x[row0 + r] * 0.5f;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs at most for these widths and node count,
// in bytes (a launch's row tile may take less); -1 if the widths are outside
// what the kernel takes (1 + e and every hidden width at most 32, 2 to
// MAX_LAYERS layers, one output).
long long umnn_integrand_fwd_p4_smem_bytes(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return -1;
  return (long long)make_layout(d, K).total * sizeof(float);
}

// Once per widths, K and device: checks them, lets the kernel take the
// card's opt-in shared memory and returns the blocks resident on the card
// at once with the largest layout of these widths and K (blocks per SM,
// times the SMs): the `slots` of the launcher. A negative CUDA error code
// on failure.
int umnn_integrand_fwd_p4_slots(int K, const int* widths, int n_layers) {
  Dims d;
  if (K < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d))
    return -(int)cudaErrorInvalidValue;
  return resident_blocks(integrand_fwd_p4_kernel,
                         (long long)make_layout(d, K).total * sizeof(float));
}

// The launch shape for R rows, for reports: out[0] threads per block, out[1]
// shared bytes of the launch, out[2] resident blocks per SM, out[3]
// registers per thread, out[4] items per item tile, out[5] rows per row
// tile, out[6] blocks. Returns a CUDA error code (cudaErrorInvalidValue for
// widths the kernel cannot take).
int umnn_integrand_fwd_p4_occupancy(int R, int K, const int* widths, int n_layers, int* out) {
  Dims d;
  const int slots = umnn_integrand_fwd_p4_slots(K, widths, n_layers);
  if (slots < 1) return -slots;
  if (R < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d)) return cudaErrorInvalidValue;
  int grid = 0, per_sm = 0;
  const Layout L = launch_layout(d, K, R, slots, &grid);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, integrand_fwd_p4_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, integrand_fwd_p4_kernel, NTHREADS,
        (size_t)make_layout(d, K).total * sizeof(float));
  if (err != cudaSuccess) return err;
  out[0] = NTHREADS;
  out[1] = L.total * (int)sizeof(float);
  out[2] = per_sm;
  out[3] = attr.numRegs;
  out[4] = L.MT;
  out[5] = L.TR;
  out[6] = grid;
  return cudaSuccess;
}

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for widths, shared memory or slots the kernel
// cannot take). layers: the device addresses of each layer's weight
// ([dout][din], nn.Linear's layout) and bias, w0, b0, w1, b1, ...; slots:
// umnn_integrand_fwd_p4_slots's count for these widths and K on this device.
int umnn_integrand_fwd_p4(const float* x, const float* h, const float* const* layers,
                          const float* nodes, const float* ccw, float* out, int R, int K,
                          int slots, const int* widths, int n_layers, float neg_slope,
                          void* stream) {
  Dims d;
  if (R < 1 || K < 1 || slots < 1 || !make_dims(widths, n_layers, MAX_WIDTH, MAX_WIDTH, &d))
    return cudaErrorInvalidValue;
  int grid = 0;
  const Layout L = launch_layout(d, K, R, slots, &grid);
  if ((long long)L.total * sizeof(float) > SMEM_LIMIT) return cudaErrorInvalidValue;
  integrand_fwd_p4_kernel<<<grid, NTHREADS, (size_t)L.total * sizeof(float),
                            (cudaStream_t)stream>>>(x, h, weights_at(layers, n_layers), nodes,
                                                    ccw, out, R, K, d, L, neg_slope);
  return cudaGetLastError();
}

}  // extern "C"
