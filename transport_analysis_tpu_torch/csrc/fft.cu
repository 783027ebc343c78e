// Four-step FFT kernels of the Wiener–Khinchin autocorrelation, complex128,
// for Hopper (sm_90a). Built by transport_analysis_tpu_torch/_build.py and
// called through ctypes from transport_analysis_tpu_torch/ops/cuda_fft.py.
//
// K1  ta_fft_level
//     Replaces transport_analysis_tpu/ops/pallas_fft.py::_banded_level3 (and
//     its 2-D form ::_banded_level): one level of the four-step transform, a
//     batched DFT of length n <= 512 along the middle axis of an (A, n, C)
//     tensor, written transposed as (n_out, A, C) so that the next level
//     reads it as it lies. Optionally multiplies output (k, a, c) by the
//     twiddle W_m^(sign * k * (c / tw_cols)).
// K2  ta_unpack_power_inva
//     Replaces ::_inva_fused: the Hermitian unpack of the two-for-one packed
//     spectrum, the power spectra summed over the d components of each
//     particle, and inverse level A, in one kernel.
//
// What bounds them: each output is a direct sum of n complex products, so
// a level does n complex multiply-adds per point (about 0.46 TFLOP of f64 for
// the two autocorrelations of an 8,192-frame, 3,680-atom analysis). In the
// inner loop a warp's threads share one k (a few when n > 128), so the root
// is a shared-memory broadcast and each complex multiply-add reads one
// 16-byte slab value: shared-memory bandwidth, not device memory (each level
// reads and writes its tensor once), caps a level at about half the FP64 FMA
// rate. Measured on an NVIDIA H100 80GB HBM3 at 700 W: the 9.3e10-flop
// forward L1 level in 9.3 ms (about 10 TFLOP/s), against 5.4 ms for cuFFT
// through the plain version; K2 in 3.7 ms against 14.8 ms plain.
// What the design does about it: a block stages an n x tc column slab and the
// n roots of unity in shared memory, so every operand of the inner loop comes
// from shared memory and each global element is read once per level. Next:
// several outputs per thread from one slab read (register blocking), then a
// radix or tensor-core (DMMA) form.
//
// Numerics: native f64 throughout; the roots come from a table built on the
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

// Columns per block: the n x tc slab of 16-byte values stays at 64 KB or less.
inline int tile_cols(int n) {
  int tc = 4096 / n;
  return tc < 8 ? 8 : (tc > 64 ? 64 : tc);
}

inline size_t smem_bytes(int n, int tc) {
  return (size_t)(n + n * tc) * sizeof(double2);
}

// rts[t] = W_n^(sign * t) from the order-m table roots[i] = exp(-2 pi i i / m).
__device__ void load_roots(double2* rts, const double2* __restrict__ roots,
                           int m, int n, int sign) {
  const int stride = m / n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    double2 r = roots[(int64_t)t * stride];
    if (sign > 0) r.y = -r.y;
    rts[t] = r;
  }
}

// dst[k * k_stride + c] for k < n_out and c = c0 + cl < C: the DFT over j of
// slab[j * tc + cl], times the twiddle W_m^(sign * k * f) with
// f = c / tw_cols when tw_cols > 0, else f = tw_fixed (no twiddle if < 0).
__device__ void dft_columns(const double2* slab, const double2* rts, int n,
                            int tc, int n_out, int c0, int C, double2* dst,
                            int64_t k_stride,
                            const double2* __restrict__ roots, int m,
                            int sign, int tw_cols, int tw_fixed) {
  const int mask = n - 1;
  for (int idx = threadIdx.x; idx < n_out * tc; idx += blockDim.x) {
    const int k = idx / tc;
    const int cl = idx - k * tc;
    const int c = c0 + cl;
    if (c >= C) continue;
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
    double2 v = make_double2(re, im);
    const int f = tw_cols > 0 ? c / tw_cols : tw_fixed;
    if (f > 0 && k > 0) {
      double2 t = roots[((int64_t)k * f) & (m - 1)];
      if (sign > 0) t.y = -t.y;
      v = cmul(v, t);
    }
    dst[(int64_t)k * k_stride + c] = v;
  }
}

// K1: block (x: column tile, y: a). in (A, n, C) -> out (n_out, A, C).
__global__ void fft_level_kernel(const double2* __restrict__ in,
                                 double2* __restrict__ out,
                                 const double2* __restrict__ roots, int m,
                                 int n, int C, int n_out, int tc, int sign,
                                 int tw_cols) {
  extern __shared__ double2 smem[];
  double2* rts = smem;
  double2* slab = smem + n;
  const int a = blockIdx.y;
  const int A = gridDim.y;
  const int c0 = blockIdx.x * tc;
  load_roots(rts, roots, m, n, sign);
  const double2* src = in + (int64_t)a * n * C;
  for (int idx = threadIdx.x; idx < n * tc; idx += blockDim.x) {
    const int j = idx / tc;
    const int c = c0 + idx - j * tc;
    slab[idx] = c < C ? src[(int64_t)j * C + c] : make_double2(0.0, 0.0);
  }
  __syncthreads();
  dft_columns(slab, rts, n, tc, n_out, c0, C, out + (int64_t)a * C,
              (int64_t)A * C, roots, m, sign, tw_cols, -1);
}

// 4 |F_s[k]|^2 of real series s in the two-for-one packing: series s < w is
// the real part of column s, series s >= w the imaginary part of column
// s - w; F1 = (Z[k] + conj Z[M-k]) / 2 and F2 = (Z[k] - conj Z[M-k]) / 2i.
__device__ __forceinline__ double series_power4(const double2* __restrict__ z,
                                                int64_t row, int64_t mrow,
                                                int s, int w) {
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

// K2: block (x: tile of output columns q, y: k1). z (m, w) in natural
// frequency order k = k2 * n1 + k1 -> out (n2, n1, ph): inverse level A of
// P[k, q] = (sum_c |F_{q d + c}|^2 + i sum_c |F_{(q + ph) d + c}|^2) / m.
__global__ void unpack_power_inva_kernel(const double2* __restrict__ z,
                                         double2* __restrict__ out,
                                         const double2* __restrict__ roots,
                                         int m, int n1, int n2, int w, int P,
                                         int d, int ph, int tc) {
  extern __shared__ double2 smem[];
  double2* rts = smem;
  double2* slab = smem + n2;
  const int k1 = blockIdx.y;
  const int q0 = blockIdx.x * tc;
  load_roots(rts, roots, m, n2, +1);
  // the halves' 1/4 and the inverse transform's 1/m: a power of two, exact
  const double scale = 0.25 / (double)m;
  for (int idx = threadIdx.x; idx < n2 * tc; idx += blockDim.x) {
    const int k2 = idx / tc;
    const int q = q0 + idx - k2 * tc;
    double p1 = 0.0, p2 = 0.0;
    if (q < ph) {
      const int64_t k = (int64_t)k2 * n1 + k1;
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
  dft_columns(slab, rts, n2, tc, n2, q0, ph, out + (int64_t)k1 * ph,
              (int64_t)n1 * ph, roots, m, +1, 0, k1);
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

// in (A, n, C) complex128 -> out (n_out, A, C); roots: the order-m table.
int ta_fft_level(const void* in, void* out, const void* roots, int A, int n,
                 int C, int n_out, int sign, int tw_cols, int m,
                 void* stream) {
  const int tc = tile_cols(n);
  const size_t smem = smem_bytes(n, tc);
  cudaError_t err = allow_smem((const void*)fft_level_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + tc - 1) / tc, A);
  fft_level_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)in, (double2*)out, (const double2*)roots, m, n, C,
      n_out, tc, sign, tw_cols);
  return (int)cudaGetLastError();
}

// z (m, w) complex128, natural order -> out (n2, n1, ph) complex128.
int ta_unpack_power_inva(const void* z, void* out, const void* roots, int m,
                         int n1, int n2, int w, int P, int d, int ph,
                         void* stream) {
  const int tc = tile_cols(n2);
  const size_t smem = smem_bytes(n2, tc);
  cudaError_t err = allow_smem((const void*)unpack_power_inva_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ph + tc - 1) / tc, n1);
  unpack_power_inva_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)z, (double2*)out, (const double2*)roots, m, n1, n2, w,
      P, d, ph, tc);
  return (int)cudaGetLastError();
}

}  // extern "C"
