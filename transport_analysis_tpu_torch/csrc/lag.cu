// Windowed lag sums of the exact (fft=False) path, accumulated in float64,
// for Hopper (sm_90a). Built by transport_analysis_tpu_torch/_build.py and
// called through ctypes from transport_analysis_tpu_torch/ops/cuda_lag.py.
//
// K8  ta_lag_sums
//     For the series of an (N, P, d) row-major operand x, d <= 3, and each
//     lag < n_lags:
//       acf:      out[lag, p] = sum_{i < N-lag} sum_c x[i,p,c] x[i+lag,p,c]
//                               / ((N - lag) dfac)
//       einstein: out[lag, p] = sum_{i < N-lag} sum_c (x[i,p,c] - x[i+lag,p,c])^2
//                               / ((N - lag) dfac),   out[0, p] = 0,
//     dfac = d for the component mean, 1 for the sum. With a float operand it
//     replaces transport_analysis_tpu/ops/pallas_lag.py::_lag_sums_transposed
//     (:100, body _lag_kernel :58; K8a), with a double operand
//     ::_lag_sums_transposed_pair (:265, body _lag_kernel_pair :147; K8b).
//     A float operand is read at 4 bytes and upcast exactly, so both give the
//     float64 sums of the float64 values; K8b's (hi, lo) float32 pairs, band
//     slicing and N <= 2^17 cap existed only because the TPU has no f64.
//
// What bounds it: float64 arithmetic. Every (frame, lag, series) pair costs
// one multiply-add (acf) or a subtract and a multiply-add (einstein). At
// 3,680 atoms x 8,192 frames over all lags (3.7e11 pairs) the acf sums, a
// Gram product of frame tiles, could run on the tensor cores' 67 TFLOP/s
// FP64 peak (H100 SXM data sheet) in 11.1 ms; the einstein sums subtract
// before they square, which is no matrix product, so the 34 TFLOP/s FP64
// peak outside the tensor cores allows 32.7 ms. The operand, 362 MB in
// float32 or 723 MB in float64, takes at most 0.22 ms to read once. This
// kernel runs both modes on the FP64 units, outside the tensor cores.
// What the design does about
// it: one thread per particle keeps kLagBlock float64 sums and a register
// window of kLagBlock future frames of each component; per frame it loads
// one new value per component and does kLagBlock * d multiply-adds, all on
// registers, so an operand value is read from memory once per lag block
// rather than once per lag. The frame loop is unrolled by kLagBlock, so the
// window is a ring whose slots are compile-time indices: no register moves.
// The mask i < N - lag is needed only on the last frames of a lag block,
// which a separate masked loop takes. A warp's threads are neighbouring
// particles, so each load of a frame row is coalesced. Not yet done: sharing
// a frame tile between lag blocks through shared memory, which would cut the
// re-reads the L2 cache serves today.
//
// Launch geometry: grid x walks tiles of `cols` particles, grid y the lag
// blocks, strided by gridDim.y past CUDA's y limit of 65,535. Any N >= 1,
// n_lags in [1, N] and P >= 1; sizes and offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLagBlock = 16;

template <bool kEinstein>
__device__ __forceinline__ double accumulate(double acc, double a, double b) {
  if (kEinstein) {
    const double diff = a - b;
    return fma(diff, diff, acc);
  }
  return fma(a, b, acc);
}

// block (x: particle tile, y: lag blocks b, strided): lags
// [b kLagBlock, (b + 1) kLagBlock) of particle q, one thread each.
template <typename T, int D, bool kEinstein>
__global__ void lag_sums_kernel(const T* __restrict__ x,
                                double* __restrict__ out, int64_t n,
                                int64_t p, int64_t n_lags, int64_t nlb,
                                double dfac) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p) return;
  const int64_t s = p * D;  // row stride of the operand
  const T* col = x + q * D;
  for (int64_t b = blockIdx.y; b < nlb; b += gridDim.y) {
    const int64_t l0 = b * kLagBlock;
    double acc[kLagBlock];
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) acc[l] = 0.0;
    // frames i at which every lag of the block has its partner,
    // i + l0 + kLagBlock - 1 < n, in whole groups of kLagBlock
    const int64_t n_full = n - l0 - (kLagBlock - 1);
    const int64_t i_main = n_full > 0 ? n_full - n_full % kLagBlock : 0;
    if (i_main > 0) {
      // ring window: x[j + l0] of component c lives in w[c][j % kLagBlock]
      double w[D][kLagBlock];
#pragma unroll
      for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
        for (int c = 0; c < D; ++c) w[c][j] = (double)col[(l0 + j) * s + c];
      }
      const T* xi_ptr = col;
      const T* xw_ptr = col + (l0 + kLagBlock - 1) * s;
      for (int64_t i0 = 0; i0 < i_main; i0 += kLagBlock) {
#pragma unroll
        for (int k = 0; k < kLagBlock; ++k) {
          // frame i = i0 + k: the new partner x[i + l0 + kLagBlock - 1]
          // takes the slot x[i - 1 + l0] held, which no lag needs again
          double xi[D];
#pragma unroll
          for (int c = 0; c < D; ++c) {
            w[c][(k + kLagBlock - 1) % kLagBlock] = (double)xw_ptr[c];
            xi[c] = (double)xi_ptr[c];
          }
          xi_ptr += s;
          xw_ptr += s;
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) {
#pragma unroll
            for (int c = 0; c < D; ++c)
              acc[l] = accumulate<kEinstein>(acc[l], xi[c],
                                             w[c][(k + l) % kLagBlock]);
          }
        }
      }
    }
    // the last frames of the block, each lag bounded by i + lag < n
    for (int64_t i = i_main; i < n - l0; ++i) {
      double xi[D];
#pragma unroll
      for (int c = 0; c < D; ++c) xi[c] = (double)col[i * s + c];
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l) {
        const int64_t j = i + l0 + l;
        if (j < n) {
#pragma unroll
          for (int c = 0; c < D; ++c)
            acc[l] = accumulate<kEinstein>(acc[l], xi[c],
                                           (double)col[j * s + c]);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) {
      const int64_t lag = l0 + l;
      if (lag < n_lags) {
        out[lag * p + q] = kEinstein && lag == 0
                               ? 0.0
                               : acc[l] / ((double)(n - lag) * dfac);
      }
    }
  }
}

template <typename T, int D>
void launch(const void* x, void* out, int64_t n, int64_t p, int64_t n_lags,
            bool einstein, double dfac, dim3 grid, unsigned cols,
            cudaStream_t stream) {
  const int64_t nlb = (n_lags + kLagBlock - 1) / kLagBlock;
  if (einstein) {
    lag_sums_kernel<T, D, true><<<grid, cols, 0, stream>>>(
        (const T*)x, (double*)out, n, p, n_lags, nlb, dfac);
  } else {
    lag_sums_kernel<T, D, false><<<grid, cols, 0, stream>>>(
        (const T*)x, (double*)out, n, p, n_lags, nlb, dfac);
  }
}

template <typename T>
void launch_d(const void* x, void* out, int64_t n, int64_t p, int64_t d,
              int64_t n_lags, bool einstein, double dfac, dim3 grid,
              unsigned cols, cudaStream_t stream) {
  if (d == 1) launch<T, 1>(x, out, n, p, n_lags, einstein, dfac, grid, cols, stream);
  if (d == 2) launch<T, 2>(x, out, n, p, n_lags, einstein, dfac, grid, cols, stream);
  if (d == 3) launch<T, 3>(x, out, n, p, n_lags, einstein, dfac, grid, cols, stream);
}

}  // namespace

extern "C" {

// x (n, p, d) float32 (f64 == 0) or float64 -> out (n_lags, p) float64, on
// a (grid_x, grid_y) grid of blocks of `cols` threads, one particle each,
// grid y over the ceil(n_lags / lag_block) lag blocks; all from cuda_lag.py,
// whose lag block must be this file's.
int ta_lag_sums(const void* x, void* out, int64_t n, int64_t p, int64_t d,
                int64_t n_lags, int64_t f64, int64_t einstein, double dfac,
                int64_t lag_block, int64_t cols, int64_t grid_x,
                int64_t grid_y, void* stream) {
  if (lag_block != kLagBlock || d < 1 || d > 3 || n_lags < 1 || n_lags > n)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (f64) {
    launch_d<double>(x, out, n, p, d, n_lags, einstein != 0, dfac, grid,
                     (unsigned)cols, (cudaStream_t)stream);
  } else {
    launch_d<float>(x, out, n, p, d, n_lags, einstein != 0, dfac, grid,
                    (unsigned)cols, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
