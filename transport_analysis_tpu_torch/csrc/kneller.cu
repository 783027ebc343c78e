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
// What bounds them: device-memory bandwidth. Per element K6a reads sq twice
// and K6b reads sq twice and corr once and writes out once; there is almost
// no arithmetic. Measured on an NVIDIA H100 80GB HBM3 at 700 W at (8,192,
// 3,680): K6a 0.17 ms (about 2.8 TB/s of the 3.35 TB/s peak), K6b 0.49 ms
// (about 2 TB/s). What the design does about it: one thread per column, so
// a warp reads 32 neighbouring columns of a row (256 contiguous bytes); the
// suffix offsets of a block come from the small (2, nb, P) totals array, so
// no prefix array is written to device memory. Any N >= 1 and P >= 1: the
// ragged last block is masked by the row bound. Grid y walks the nb row
// blocks; past CUDA's y limit of 65,535 (N > 8,388,480 frames at 128 rows a
// block) a block strides over them by gridDim.y, so N up to 2^23 and beyond
// runs with the same per-block arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// block (x: column tile, y: row blocks b, strided). tot (2, nb, P):
// tot[0, b] sums sq rows [b rows, (b + 1) rows), tot[1, b] the same
// positions of the reversed rows sq[N-1-i].
__global__ void kneller_totals_kernel(const double* __restrict__ sq,
                                      double* __restrict__ tot, int64_t n,
                                      int64_t p, int rows, int64_t nb) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= p) return;
  for (int64_t b = blockIdx.y; b < nb; b += gridDim.y) {
    const int64_t r0 = b * rows;
    const int64_t r1 = r0 + rows < n ? r0 + rows : n;
    double fwd = 0.0, rev = 0.0;
    for (int64_t i = r0; i < r1; ++i) {
      fwd += sq[i * p + col];
      rev += sq[(n - 1 - i) * p + col];
    }
    tot[b * p + col] = fwd;
    tot[(nb + b) * p + col] = rev;
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

// sq (n, p) float64 -> tot (2, nb, p) float64, nb = ceil(n / rows), on a
// (grid_x, grid_y) grid of blocks of `cols` threads, one column each, all
// three from cuda_kneller.py.
int ta_kneller_totals(const void* sq, void* tot, int64_t n, int64_t p,
                      int64_t rows, int64_t nb, int64_t cols, int64_t grid_x,
                      int64_t grid_y, void* stream) {
  kneller_totals_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y),
                          (unsigned)cols, 0, (cudaStream_t)stream>>>(
      (const double*)sq, (double*)tot, n, p, (int)rows, nb);
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
