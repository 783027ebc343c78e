// Four-step FFT kernels of the Wiener–Khinchin autocorrelation, complex128,
// for Hopper (sm_90a). Built by transport_analysis_tpu_torch/_build.py and
// called through ctypes from transport_analysis_tpu_torch/ops/cuda_fft.py,
// which plans the levels (plan_levels) and computes every launch's grid.
//
// K1  ta_fft_level
//     Replaces transport_analysis_tpu/ops/pallas_fft.py::_banded_level3 (and
//     its 2-D form ::_banded_level) and, as the top level of a plan of three
//     or more levels, ops/deep_acf.py::_outer_level_pallas (K3): one level of
//     the four-step transform, a batched DFT of length n <= 512 along the
//     middle axis of an (A, n, C) tensor, written transposed as (n, A, C) so
//     that the next level reads it as it lies. Optionally multiplies
//     output (k, a, c) by the twiddle W_m^(sign * k * (c / tw_cols)), m the
//     order of the sub-transform the level belongs to.
// K2  ta_unpack_power_inva
//     Replaces ::_inva_fused and, at a deep split, ops/deep_acf.py::
//     _unpack_to_pair_dif_pallas (K4) with ops/pallas_mirror.py's two kernels
//     (K7a, K7b): the Hermitian unpack of the two-for-one packed spectrum,
//     the power spectra summed over the d components of each particle, and
//     inverse level A over the top frequency digit, in one kernel. The
//     mirror Z[(M - k) mod M] is an index (K7a's permutation matmuls), and
//     both Z[k] and Z[M - k] are read for every k (K7b's synthesis of the
//     upper half by symmetry).
// K5  ta_inverse_last_level
//     Replaces ops/deep_acf.py::_epilogue_transpose_pallas: the last inverse
//     level, writing the (N, P) float64 result itself (the real parts of the
//     particle-pair columns to columns q < ph, the imaginary parts to
//     ph + q), times 1 / (N - lag) when asked; the rows past N are not formed.
//
// What bounds them: each output is a direct sum of n complex products, so
// a level does n complex multiply-adds per point and reads and writes its
// tensor once. In the inner loop a warp's threads share one k (a few when
// n > 128), so the root is a shared-memory broadcast and each complex
// multiply-add reads one 16-byte slab value: shared-memory bandwidth caps a
// long level (a 128-point level of M = 16,384 at the EC width ran at about
// 10 TFLOP/s), while a short one is bounded by device memory. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: a 16-point level over the 11.6 GB packed
// spectrum of M = 2^17 at the EC width in 11.4 ms (2.0 TB/s of 3.35), 4.1x
// the plain version (cuFFT along the middle axis plus a twiddle pass); K2
// there in 10.2 ms (2.6 TB/s: it reads the spectrum twice). What the design
// does about it: a block stages an n x tc column slab and the n roots of
// unity in shared memory, so every operand of the inner loop comes from
// shared memory and each global element is read once per level, and
// plan_levels keeps the levels near 16 points, where the two bounds meet.
// Next: more than one row of A per block when C is narrow (a 64-column tile
// of a 4-column level is mostly idle), then register blocking or a radix
// form for longer levels.
//
// Launch geometry: grid x walks column tiles, grid y the A axis (the
// frequency rows for K2); when A exceeds CUDA's y limit of 65,535 a block
// strides over A by gridDim.y. Sizes and offsets are 64-bit.
//
// Numerics: native f64 throughout; the roots come from tables built on the
// host in float64 with the angle reduced to the first octant. No int8 bands,
// no double-float pairs and no power-of-two column scales: those existed only
// because the TPU has no f64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

inline size_t smem_bytes(int64_t n, int64_t tc) {
  return (size_t)(n + n * tc) * sizeof(double2);
}

// rts[t] = W_n^(sign * t) from the order-m table roots[i] = exp(-2 pi i i / m).
__device__ void load_roots(double2* rts, const double2* __restrict__ roots,
                           int64_t m, int n, int sign) {
  const int64_t stride = m / n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    double2 r = roots[t * stride];
    if (sign > 0) r.y = -r.y;
    rts[t] = r;
  }
}

// slab[j * tc + cl] = src[j * C + c0 + cl] for j < n, zero past column C.
__device__ void load_slab(double2* slab, const double2* __restrict__ src,
                          int n, int tc, int64_t c0, int64_t C) {
  for (int idx = threadIdx.x; idx < n * tc; idx += blockDim.x) {
    const int j = idx / tc;
    const int64_t c = c0 + (idx - j * tc);
    slab[idx] = c < C ? src[j * C + c] : make_double2(0.0, 0.0);
  }
}

// sum over j < n of slab[j * tc + cl] * rts[(j * k) mod n].
__device__ __forceinline__ double2 dft_point(const double2* slab,
                                             const double2* rts, int n,
                                             int tc, int k, int cl) {
  const int mask = n - 1;
  double re = 0.0, im = 0.0;
  int e = 0;
  for (int j = 0; j < n; ++j) {
    const double2 x = slab[j * tc + cl];
    const double2 r = rts[e];
    re = fma(x.x, r.x, re);
    re = fma(-x.y, r.y, re);
    im = fma(x.x, r.y, im);
    im = fma(x.y, r.x, im);
    e = (e + k) & mask;
  }
  return make_double2(re, im);
}

// dst[k * k_stride + c] for k < n_out and c = c0 + cl < C: the DFT over j of
// slab[j * tc + cl], times the twiddle W_m^(sign * k * f) with
// f = c / tw_cols when tw_cols > 0, else f = tw_fixed (no twiddle if < 0).
__device__ void dft_columns(const double2* slab, const double2* rts, int n,
                            int tc, int n_out, int64_t c0, int64_t C,
                            double2* dst, int64_t k_stride,
                            const double2* __restrict__ roots, int64_t m,
                            int sign, int64_t tw_cols, int64_t tw_fixed) {
  for (int idx = threadIdx.x; idx < n_out * tc; idx += blockDim.x) {
    const int k = idx / tc;
    const int cl = idx - k * tc;
    const int64_t c = c0 + cl;
    if (c >= C) continue;
    double2 v = dft_point(slab, rts, n, tc, k, cl);
    const int64_t f = tw_cols > 0 ? c / tw_cols : tw_fixed;
    if (f > 0 && k > 0) {
      double2 t = roots[(k * f) & (m - 1)];
      if (sign > 0) t.y = -t.y;
      v = cmul(v, t);
    }
    dst[k * k_stride + c] = v;
  }
}

// K1: block (x: column tile, y: a, strided). in (A, n, C) -> out (n, A, C).
__global__ void fft_level_kernel(const double2* __restrict__ in,
                                 double2* __restrict__ out,
                                 const double2* __restrict__ roots, int64_t m,
                                 int n, int64_t C, int64_t A, int tc, int sign,
                                 int64_t tw_cols) {
  extern __shared__ double2 smem[];
  double2* rts = smem;
  double2* slab = smem + n;
  const int64_t c0 = (int64_t)blockIdx.x * tc;
  load_roots(rts, roots, m, n, sign);
  for (int64_t a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the slab's last readers are done
    load_slab(slab, in + a * n * C, n, tc, c0, C);
    __syncthreads();
    dft_columns(slab, rts, n, tc, n, c0, C, out + a * C, A * C, roots, m, sign,
                tw_cols, -1);
  }
}

// 4 |F_s[k]|^2 of real series s in the two-for-one packing: series s < w is
// the real part of column s, series s >= w the imaginary part of column
// s - w; F1 = (Z[k] + conj Z[M-k]) / 2 and F2 = (Z[k] - conj Z[M-k]) / 2i.
__device__ __forceinline__ double series_power4(const double2* __restrict__ z,
                                                int64_t row, int64_t mrow,
                                                int64_t s, int64_t w) {
  double re, im;
  if (s < w) {
    const double2 a = z[row + s];
    const double2 b = z[mrow + s];
    re = a.x + b.x;
    im = a.y - b.y;
  } else {
    const double2 a = z[row + s - w];
    const double2 b = z[mrow + s - w];
    re = a.x - b.x;
    im = a.y + b.y;
  }
  return re * re + im * im;
}

// K2: block (x: tile of output columns q, y: k_low, strided). z (m, w) in
// natural frequency order k = k_top * R + k_low -> out (n_top, R, ph) =
// (dd, k_low, q): inverse level A over k_top, with the twiddle
// W_m^(k_low * dd), of
// P[k, q] = (sum_c |F_{q d + c}|^2 + i sum_c |F_{(q + ph) d + c}|^2) / m.
__global__ void unpack_power_inva_kernel(const double2* __restrict__ z,
                                         double2* __restrict__ out,
                                         const double2* __restrict__ roots,
                                         int64_t m, int n_top, int64_t R,
                                         int64_t w, int64_t P, int d,
                                         int64_t ph, int tc) {
  extern __shared__ double2 smem[];
  double2* rts = smem;
  double2* slab = smem + n_top;
  const int64_t q0 = (int64_t)blockIdx.x * tc;
  load_roots(rts, roots, m, n_top, +1);
  // the halves' 1/4 and the inverse transform's 1/m: a power of two, exact
  const double scale = 0.25 / (double)m;
  for (int64_t kl = blockIdx.y; kl < R; kl += gridDim.y) {
    __syncthreads();  // the slab's last readers are done
    for (int idx = threadIdx.x; idx < n_top * tc; idx += blockDim.x) {
      const int kt = idx / tc;
      const int64_t q = q0 + (idx - kt * tc);
      double p1 = 0.0, p2 = 0.0;
      if (q < ph) {
        const int64_t k = kt * R + kl;
        const int64_t row = k * w;
        const int64_t mrow = ((m - k) & (m - 1)) * w;  // the mirror (M - k) mod M
        for (int c = 0; c < d; ++c) p1 += series_power4(z, row, mrow, q * d + c, w);
        if (q + ph < P) {
          for (int c = 0; c < d; ++c)
            p2 += series_power4(z, row, mrow, (q + ph) * d + c, w);
        }
      }
      slab[idx] = make_double2(p1 * scale, p2 * scale);
    }
    __syncthreads();
    dft_columns(slab, rts, n_top, tc, n_top, q0, ph, out + kl * ph, R * ph,
                roots, m, +1, 0, kl);
  }
}

// K5: block (x: column tile, y: a, strided). in (A, n, C), C = ph, the
// inverse DFT over n (no twiddle: the last level of its sub-transform),
// output row lag = k * A + a < N of out (N, P) float64:
// out[lag, q] = re * s and, for ph + q < P, out[lag, ph + q] = im * s, with
// s = 1 / (N - lag) when normalize, else no scaling.
__global__ void inverse_last_level_kernel(const double2* __restrict__ in,
                                          double* __restrict__ out,
                                          const double2* __restrict__ roots,
                                          int n, int64_t C, int64_t A,
                                          int n_out, int tc, int64_t N,
                                          int64_t P, int normalize) {
  extern __shared__ double2 smem[];
  double2* rts = smem;
  double2* slab = smem + n;
  const int64_t c0 = (int64_t)blockIdx.x * tc;
  load_roots(rts, roots, n, n, +1);
  for (int64_t a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the slab's last readers are done
    load_slab(slab, in + a * n * C, n, tc, c0, C);
    __syncthreads();
    for (int idx = threadIdx.x; idx < n_out * tc; idx += blockDim.x) {
      const int k = idx / tc;
      const int cl = idx - k * tc;
      const int64_t q = c0 + cl;
      const int64_t lag = k * A + a;
      if (q >= C || lag >= N) continue;
      const double2 v = dft_point(slab, rts, n, tc, k, cl);
      double re = v.x, im = v.y;
      if (normalize) {
        // the reciprocal first, then the product: ops/acf.py's order
        const double inv = 1.0 / (double)(N - lag);
        re *= inv;
        im *= inv;
      }
      out[lag * P + q] = re;
      if (C + q < P) out[lag * P + C + q] = im;
    }
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* ta_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in (A, n, C) complex128 -> out (n, A, C); roots: the order-m table; tc
// columns per block on a (grid_x, grid_y) grid from cuda_fft.py.
int ta_fft_level(const void* in, void* out, const void* roots, int64_t A,
                 int64_t n, int64_t C, int64_t sign, int64_t tw_cols,
                 int64_t m, int64_t tc, int64_t grid_x, int64_t grid_y,
                 void* stream) {
  const size_t smem = smem_bytes(n, tc);
  cudaError_t err = allow_smem((const void*)fft_level_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fft_level_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y), kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const double2*)in, (double2*)out, (const double2*)roots, m, (int)n, C,
      A, (int)tc, (int)sign, tw_cols);
  return (int)cudaGetLastError();
}

// z (m, w) complex128, natural order -> out (n_top, R, ph) complex128;
// roots: the order-m table.
int ta_unpack_power_inva(const void* z, void* out, const void* roots,
                         int64_t m, int64_t n_top, int64_t R, int64_t w,
                         int64_t P, int64_t d, int64_t ph, int64_t tc,
                         int64_t grid_x, int64_t grid_y, void* stream) {
  const size_t smem = smem_bytes(n_top, tc);
  cudaError_t err = allow_smem((const void*)unpack_power_inva_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  unpack_power_inva_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y), kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const double2*)z, (double2*)out, (const double2*)roots, m, (int)n_top,
      R, w, P, (int)d, ph, (int)tc);
  return (int)cudaGetLastError();
}

// in (A, n, ph) complex128 -> out (N, P) float64; roots: the order-n table.
int ta_inverse_last_level(const void* in, void* out, const void* roots,
                          int64_t A, int64_t n, int64_t ph, int64_t n_out,
                          int64_t N, int64_t P, int64_t normalize, int64_t tc,
                          int64_t grid_x, int64_t grid_y, void* stream) {
  const size_t smem = smem_bytes(n, tc);
  cudaError_t err = allow_smem((const void*)inverse_last_level_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  inverse_last_level_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y), kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const double2*)in, (double*)out, (const double2*)roots, (int)n, ph, A,
      (int)n_out, (int)tc, N, P, (int)normalize);
  return (int)cudaGetLastError();
}

}  // extern "C"
