// Kneller/Calandrini assembly of the Einstein lag differences, float64, for
// Hopper (sm_90a). Built by transport_analysis_tpu_torch/_build.py and called
// through ctypes from transport_analysis_tpu_torch/ops/cuda_kneller.py.
//
// K6a ta_kneller_totals
//     Replaces transport_analysis_tpu/ops/pallas_kneller.py::window_sums'
//     first kernel (::_totals_kernel): the column totals of sq (N, P) over
//     each block of `rows` rows, for sq and for sq read in reverse row order.
// K6b ta_kneller_windows
//     Replaces the second kernel (::_windows_kernel) with the ::_finish
//     combine fused in:
//       out[lag] = (css[N-1-lag] + total - css[lag-1] - 2 corr[lag])
//                  / ((N - lag) * dfac),   out[0] = 0,
//     css the inclusive prefix sum of sq down the rows. The two window sums
//     are evaluated as suffix sums, css[N-1-lag] = sum_{i >= lag} sq[N-1-i]
//     and total - css[lag-1] = sum_{i >= lag} sq[i], which needs no
//     subtraction of large prefixes; the reversed leg is read by index.
//
// What bounds them: device-memory bandwidth; there is almost no
// arithmetic. K6b reads sq twice and corr once and writes out once. K6a
// needs to read sq once, and does so: with N = q R + r (R = `rows`,
// 0 <= r < R) the reversed block b covers rows [(q-b-1) R + r, (q-b) R + r),
// the upper part (the "hi", from row k R + r on) of forward block q-b-1
// and the lower r rows (the "lo") of forward block q-b. So K6a walks runs
// of consecutive forward blocks, sums each as lo and hi, writes lo + hi
// as the forward total and the previous block's
// hi plus this block's lo as a reversed total; block 0's lone lo is the
// last reversed block. When r = 0 the reversed totals are the forward ones
// in reverse order. A run starts by summing the hi of the block before it
// (the halo, none when r = 0); runs are one block where r = 0 and eight
// where r > 0, so the halo stays at most 1/8 of sq (cuda_kneller.py
// totals_split). As the library's reshape-sum does, a block of K6a works
// on one tile of rows at a time: its kSplit warps each sum a slice of a
// row block's 32 columns and warp 0 adds the slices, so the card holds
// many short-lived blocks each reading a compact tile, rather than
// long-lived threads streaming down whole columns (a few percent faster
// on the H100 at the deep shape, PERF.md; each sum is 16 terms, not 128).
// A warp reads 32 neighbouring columns of a row (256 contiguous bytes),
// in both kernels. K6b takes the suffix offsets of a block from the
// small (2, nb, P) totals array, so no prefix array is written to device
// memory. Any N >= 1 and P >= 1: the ragged last block is masked by the
// row bound. Grid y walks K6a's runs and K6b's row blocks; past CUDA's y
// limit of 65,535 a block strides over them by gridDim.y, so N up to 2^23
// and beyond runs with the same per-block arithmetic. Sizes are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the column sum of rows [i0, i1) from `at`, the column's row 0
__device__ __forceinline__ double column_sum(const double* __restrict__ at,
                                             int64_t i0, int64_t i1,
                                             int64_t p) {
  double acc = 0.0;
#pragma unroll 8
  for (int64_t i = i0; i < i1; ++i) acc += at[i * p];
  return acc;
}

constexpr int kSplit = 8;  // K6a's thread rows, a slice of a block's rows each

// block (32 x kSplit threads; x: a tile of 32 columns, y: runs j of `run`
// row blocks, strided). tot (2, nb, P): tot[0, b] sums sq rows [b rows,
// (b + 1) rows), tot[1, b] the same positions of the reversed rows
// sq[N-1-i]. Thread row ty sums the slice [ty rows / kSplit, (ty + 1)
// rows / kSplit) of each block as its lo and hi parts; warp 0 adds the
// slices in order and writes both legs.
__global__ void kneller_totals_kernel(const double* __restrict__ sq,
                                      double* __restrict__ tot, int64_t n,
                                      int64_t p, int rows, int64_t nb,
                                      int64_t run, int64_t runs) {
  __shared__ double part[2][kSplit][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t col = (int64_t)blockIdx.x * 32 + tx;
  const bool in = col < p;
  const double* at = sq + (in ? col : 0);
  const int64_t q = n / rows, r = n % rows;
  const int slice = rows / kSplit;
  for (int64_t j = blockIdx.y; j < runs; j += gridDim.y) {
    const int64_t k0 = j * run;
    const int64_t k1 = k0 + run < nb ? k0 + run : nb;
    double carry = 0.0;  // the hi of the block before, in warp 0
    // from the block before the run where its hi is the halo
    for (int64_t k = r > 0 && k0 > 0 ? k0 - 1 : k0; k < k1; ++k) {
      const int64_t r0 = k * rows;
      const int64_t split = r0 + r < n ? r0 + r : n;
      const int64_t r1 = r0 + rows < n ? r0 + rows : n;
      // this thread row's slice [a, e), its lo [a, s) and hi [s, e)
      const int64_t a = r0 + ty * slice;
      const int64_t e = a + slice < r1 ? a + slice : (r1 > a ? r1 : a);
      const int64_t s = split < a ? a : (split > e ? e : split);
      const bool halo = k < k0;
      part[0][ty][tx] = column_sum(at, a, halo ? a : s, p);
      part[1][ty][tx] = column_sum(at, s, e, p);
      __syncthreads();
      if (ty == 0 && in) {
        double lo = part[0][0][tx], hi = part[1][0][tx];
        for (int y = 1; y < kSplit; ++y) {
          lo += part[0][y][tx];
          hi += part[1][y][tx];
        }
        if (!halo) {
          // the reversed block this block's lo completes
          const int64_t rev = r == 0 ? q - 1 - k : q - k;
          tot[k * p + col] = lo + hi;
          tot[(nb + rev) * p + col] = r == 0 ? hi : carry + lo;
        }
        carry = hi;
      }
      __syncthreads();
    }
  }
}

// block (x: column tile, y: lag blocks b, strided): lags [b rows,
// (b + 1) rows).
__global__ void kneller_windows_kernel(const double* __restrict__ sq,
                                       const double* __restrict__ corr,
                                       const double* __restrict__ tot,
                                       double* __restrict__ out, int64_t n,
                                       int64_t p, int rows, int64_t nb,
                                       double dfac) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= p) return;
  for (int64_t b = blockIdx.y; b < nb; b += gridDim.y) {
    // suffix sums past this block: tail over sq, head over reversed sq
    double tail = 0.0, head = 0.0;
    for (int64_t bb = nb - 1; bb > b; --bb) {
      tail += tot[bb * p + col];
      head += tot[(nb + bb) * p + col];
    }
    const int64_t r0 = b * rows;
    const int64_t r1 = r0 + rows < n ? r0 + rows : n;
    for (int64_t lag = r1 - 1; lag >= r0; --lag) {
      tail += sq[lag * p + col];
      head += sq[(n - 1 - lag) * p + col];
      const int64_t at = lag * p + col;
      out[at] = lag == 0 ? 0.0
                         : (head + tail - 2.0 * corr[at]) /
                               ((double)(n - lag) * dfac);
    }
  }
}

}  // namespace

extern "C" {

// sq (n, p) float64 -> tot (2, nb, p) float64, nb = ceil(n / rows), in
// `runs` runs of `run` row blocks, on a (grid_x, grid_y) grid of blocks of
// 32 x kSplit threads; all from cuda_kneller.py.
int ta_kneller_totals(const void* sq, void* tot, int64_t n, int64_t p,
                      int64_t rows, int64_t nb, int64_t run, int64_t runs,
                      int64_t grid_x, int64_t grid_y, void* stream) {
  if (run < 1 || runs * run < nb || (runs - 1) * run >= nb ||
      rows % kSplit != 0)
    return (int)cudaErrorInvalidValue;
  kneller_totals_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y),
                          dim3(32, kSplit), 0, (cudaStream_t)stream>>>(
      (const double*)sq, (double*)tot, n, p, (int)rows, nb, run, runs);
  return (int)cudaGetLastError();
}

// sq, corr (n, p) and tot from ta_kneller_totals -> out (n, p) float64;
// the launch as for ta_kneller_totals.
int ta_kneller_windows(const void* sq, const void* corr, const void* tot,
                       void* out, int64_t n, int64_t p, int64_t rows,
                       int64_t nb, double dfac, int64_t cols, int64_t grid_x,
                       int64_t grid_y, void* stream) {
  kneller_windows_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y),
                           (unsigned)cols, 0, (cudaStream_t)stream>>>(
      (const double*)sq, (const double*)corr, (const double*)tot,
      (double*)out, n, p, (int)rows, nb, dfac);
  return (int)cudaGetLastError();
}

}  // extern "C"
