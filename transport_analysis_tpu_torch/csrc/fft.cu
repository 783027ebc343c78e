// Four-step FFT kernels of the Wiener–Khinchin autocorrelation, complex128
// and complex64, for Hopper (sm_90a). Built by
// transport_analysis_tpu_torch/_build.py and called through ctypes from
// transport_analysis_tpu_torch/ops/cuda_fft.py, which plans the levels
// (plan_levels) and computes every launch's grid.
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
//     mirror Z[(M - k) mod M] is an index (K7a's permutation matmuls): a
//     block loads each row and its mirror once and forms the outputs of
//     both from the one load (K7b's synthesis of the upper half by
//     symmetry).
// K5  ta_inverse_last_level
//     Replaces ops/deep_acf.py::_epilogue_transpose_pallas: the last inverse
//     level, writing the (N, P) real result itself (the real parts of the
//     particle-pair columns to columns q < ph, the imaginary parts to
//     ph + q), times 1 / (N - lag) when asked; the rows past N are not formed.
//
// What bounds them: a level reads and writes its tensor once; in the slab
// and row kernels each output is a direct sum of n complex products (n
// complex multiply-adds per point), in the column kernel a butterfly
// network (log2 n). In the slab kernel's inner loop a warp's threads share
// one k (a few when n > 128), so the root is a shared-memory broadcast and
// each complex multiply-add reads one 16-byte slab value: shared-memory
// bandwidth caps a long level (a 128-point level of M = 16,384 at the EC width ran at about
// 10 TFLOP/s), while a short one is bounded by device memory. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: a 16-point level over the 11.6 GB packed
// spectrum of M = 2^17 at the EC width in 11.4 ms (2.0 TB/s of 3.35), 4.1x
// the plain version (cuFFT along the middle axis plus a twiddle pass); K2
// there in 10.2 ms (2.6 TB/s: it reads the spectrum twice). What the design
// does about it: a block stages an n x tc column slab and the n roots of
// unity in shared memory, so every operand of the inner loop comes from
// shared memory and each global element is read once per level, and
// plan_levels keeps the levels near 16 points, where the two bounds meet.
//
// Wide levels of n <= 16 points (every wide level a plan makes): the slab
// kernel's loads and its sums from shared memory, between two barriers,
// did not overlap, and each complex64 point cost a complex128 point's
// shared-memory reads and multiply-adds at half the bytes: 51.6 ms for the
// 8 levels of one complex64 autocorrelation at M = 2^17 over the EC width
// (40 % of the 20.7 ms byte bound), 61.5 ms in complex128 (67 %). What the
// design does about it (fft_level_columns_kernel, cuda_fft.LevelTiles'
// column launch): a thread owns one column, issues its n coalesced loads at
// once, forms the DFT in registers as a radix-2 butterfly network (n log n
// multiply-adds, the level's roots read once), twiddles and stores its n
// outputs coalesced; no shared memory, no barrier, so each level streams
// its tensor once each way. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/kernel_times.py, beside the parent commit in one call): 24.2 ms
// in complex64 (86 % of its bound), 50.8 ms in complex128 (82 %; its
// first level, 134 registers a thread and one block an SM, at 66 %).
// Next: the first complex128 16-point level's registers.
//
// At narrow widths (C <= 64 at n <= 64: the last levels of 8 series) a
// 64-column tile and one row of A a block left most lanes idle (60 of 64
// at C = 4) and spent two barriers on a 1 KB slab: K1's levels summed to
// 17.0 ms at M = 2^24 against the library's 11.7 and K5 took 5.9 ms
// against a 0.24 ms bound (4 %). What the design does about it
// (cuda_fft.LevelTiles): a block takes ra whole rows of A (ra·n·C <= 1,024
// values), one contiguous run staged by cp.async at a padded pitch, and
// its lanes lie over (a_l, c); a K1 item forms k and k + n/2 from one read
// of its slab column, halving the slab reads; K5 forms each complex sum
// once into a shared stage that lanes over (a_l, p) write out as whole
// output rows. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/kernel_times.py --only fft): K1 8.4-8.5 ms at M = 2^24 and
// 18.9-19.0 ms at 2^25 over 4 columns (61-65 % of their bounds, against
// the library's 11.6 and 27.6), K5 0.38 and 0.62 ms (62-77 %).
// Next: a radix form for the slab kernel's longer levels (n > 16).
//
// K2 is bounded by device memory: it reads the spectrum once and writes a
// third of its bytes (at the EC width). A first design, one block per
// k_low row, read every row twice (the row and, for its mirror, again from
// the block of R - k_low) with strided component reads and 64-column tiles
// that narrow widths left idle: 10.2 ms at M = 2^17 over the EC width
// (44 % of its 4.608 ms bound), 18.3 ms at M = 2^24 over 4 columns (3 %).
// What the design does about it: a block takes a run of k_low values in
// [0, R/2] with their mirrors R - k_low, loads each row pair once with
// consecutive lanes on consecutive columns (and, at narrow widths, on
// consecutive rows), sums components from shared memory, forms both
// outputs of a pair from one DFT over k_top of the real power halves, and
// forms its twiddles from ~sqrt(M)-entry parts of the table. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (scripts/kernel_times.py --only k2):
// 5.4 ms at M = 2^17 over the EC width (85 % of its bound), 0.66 ms at
// M = 2^24 and 1.22 ms at M = 2^25 over 4 columns (84 %, 92 %).
//
// Launch geometry: grid x walks column tiles, grid y the A axis (groups of
// ra rows at narrow levels, the frequency rows for K2); when they exceed
// CUDA's y limit of 65,535 a block strides over them by gridDim.y. Sizes
// and offsets are 64-bit.
//
// Numerics: each kernel is a template over the real type R. R = double
// (complex128 in, float64 out) is the float64 work mode: native f64
// throughout. R = float (complex64 in, float32 out) is the float32 work mode
// (dtype=np.float32), the JAX package's 4-band "fast" profile of the same
// kernels (pallas_fft.py:294-299, deep_acf.py:1176): every multiply-add, sum
// and stored value in float32, the bytes of every slab, stage and tensor
// halved, on the same plan and the same work split (cuda_fft.LevelTiles,
// UnpackTiles). The roots come from tables built on the host in float64 with
// the angle reduced to the first octant, rounded once to float32 for R =
// float. No int8 bands, no double-float pairs and no power-of-two column
// scales: those existed only because the TPU has no f64.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kThreads = 256;

// Every kernel is a template over its complex type V: double2 (complex128,
// the float64 work mode) or float2 (complex64, the float32 work mode); its
// real type is decltype(V::x).
__device__ __forceinline__ double2 cplx(double x, double y) {
  return make_double2(x, y);
}
__device__ __forceinline__ float2 cplx(float x, float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ double fmar(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fmar(float a, float b, float c) {
  return fmaf(a, b, c);
}

template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  return cplx(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// the dynamic shared memory of a block, as complex values of type V
template <typename V>
__device__ __forceinline__ V* shared_values() {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  return reinterpret_cast<V*>(smem_bytes);
}

// rts[t] = W_n^(sign * t) from the order-m table roots[i] = exp(-2 pi i i / m).
template <typename V>
__device__ void load_roots(V* rts, const V* __restrict__ roots, int64_t m,
                           int n, int sign) {
  const int64_t stride = m / n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    V r = roots[t * stride];
    if (sign > 0) r.y = -r.y;
    rts[t] = r;
  }
}

// slab[j * tc + cl] = src[j * C + c0 + cl] for j < n, zero past column C.
template <typename V>
__device__ void load_slab(V* slab, const V* __restrict__ src, int n, int tc,
                          int64_t c0, int64_t C) {
  for (int idx = threadIdx.x; idx < n * tc; idx += blockDim.x) {
    const int j = idx / tc;
    const int64_t c = c0 + (idx - j * tc);
    slab[idx] = c < C ? src[j * C + c] : V{};
  }
}

// sum over j < n of slab[j * tc + cl] * rts[(j * k) mod n].
template <typename V>
__device__ __forceinline__ V dft_point(const V* slab, const V* rts, int n,
                                       int tc, int k, int cl) {
  const int mask = n - 1;
  decltype(V::x) re = 0, im = 0;
  int e = 0;
  for (int j = 0; j < n; ++j) {
    const V x = slab[j * tc + cl];
    const V r = rts[e];
    re = fmar(x.x, r.x, re);
    re = fmar(-x.y, r.y, re);
    im = fmar(x.x, r.y, im);
    im = fmar(x.y, r.x, im);
    e = (e + k) & mask;
  }
  return cplx(re, im);
}

// v times the twiddle W_m^(sign * k * (c / tw_cols)) when tw_cols > 0.
template <typename V>
__device__ __forceinline__ V level_twiddle(V v, int k, int64_t c,
                                           const V* roots, int64_t m,
                                           int sign, int64_t tw_cols) {
  const int64_t f = tw_cols > 0 ? c / tw_cols : 0;
  if (f > 0 && k > 0) {
    V t = roots[(k * f) & (m - 1)];
    if (sign > 0) t.y = -t.y;
    v = cmul(v, t);
  }
  return v;
}

// dst[k * k_stride + c] for k < n and c = c0 + cl < C: the DFT over j of
// slab[j * tc + cl], times the twiddle W_m^(sign * k * (c / tw_cols)) when
// tw_cols > 0.
template <typename V>
__device__ void dft_columns(const V* slab, const V* rts, int n, int tc,
                            int64_t c0, int64_t C, V* dst, int64_t k_stride,
                            const V* __restrict__ roots, int64_t m, int sign,
                            int64_t tw_cols) {
  for (int idx = threadIdx.x; idx < n * tc; idx += blockDim.x) {
    const int k = idx / tc;
    const int cl = idx - k * tc;
    const int64_t c = c0 + cl;
    if (c >= C) continue;
    dst[k * k_stride + c] = level_twiddle(dft_point(slab, rts, n, tc, k, cl),
                                          k, c, roots, m, sign, tw_cols);
  }
}

// one asynchronous copy of a complex value into shared memory: 16 bytes
// (cp.async.cg) for complex128, 8 bytes (cp.async.ca) for complex64
__device__ __forceinline__ void cp_async_value(double2* dst,
                                               const double2* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_value(float2* dst,
                                               const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Rows [a0, a0 + rows) of an (A, n, C) input are one contiguous run of
// rows * n * C values: staged by one cp.async copy a value, row a_l at
// slab + a_l * pitch (LevelTiles' narrow split). The caller synchronizes
// after.
template <typename V>
__device__ void stage_rows(V* slab, const V* __restrict__ src, int total,
                           int nc, int pitch) {
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int al = i / nc;
    cp_async_value(slab + i + al * (pitch - nc), src + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename V>
__device__ __forceinline__ V cadd(V a, V b) {
  return cplx(a.x + b.x, a.y + b.y);
}
template <typename V>
__device__ __forceinline__ V csub(V a, V b) {
  return cplx(a.x - b.x, a.y - b.y);
}

// The N-point DFT of v in registers, radix 2, decimation in frequency
// (Gentleman-Sande): in the stage of length LEN, butterfly B takes the
// pair (lo, lo + LEN/2), j = B mod LEN/2, lo = (B / (LEN/2)) LEN + j, to
// (x + y, (x - y) W_LEN^j), W_LEN^j = w[j N / LEN]. Run from LEN = N, the
// stages leave output k in v[bitrev(k)]. w[t] = W_N^(sign t), t < N/2.
// Every index is a template constant (a pack expansion, not a loop), so v
// and w stay in registers.
template <int N, int LEN, int B, typename V>
__device__ __forceinline__ void butterfly(V (&v)[N],
                                          const V (&w)[N > 1 ? N / 2 : 1]) {
  constexpr int kHalf = LEN / 2, j = B % kHalf, lo = (B / kHalf) * LEN + j;
  const V x = v[lo], y = v[lo + kHalf];
  v[lo] = cadd(x, y);
  if constexpr (j == 0)
    v[lo + kHalf] = csub(x, y);
  else
    v[lo + kHalf] = cmul(csub(x, y), w[j * (N / LEN)]);
}

template <int N, int LEN, typename V, int... B>
__device__ __forceinline__ void dif_registers(
    V (&v)[N], const V (&w)[N > 1 ? N / 2 : 1],
    std::integer_sequence<int, B...>) {
  if constexpr (LEN >= 2) {
    (butterfly<N, LEN, B>(v, w), ...);
    dif_registers<N, LEN / 2>(v, w, std::integer_sequence<int, B...>{});
  }
}

__host__ __device__ constexpr int bit_reverse(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

__host__ __device__ constexpr int log2_of(int n) {
  int b = 0;
  while ((1 << b) < n) ++b;
  return b;
}

// out[k] = v[bitrev(k)] for each K, times the twiddle W_m^(sign k f) from
// the order-m table when k > 0 and f > 0: the stores of one column.
template <int N, typename V, int... K>
__device__ __forceinline__ void store_outputs(
    const V (&v)[N], V* dst, int64_t k_stride, const V* __restrict__ roots,
    int64_t m, int sign, int64_t f, std::integer_sequence<int, K...>) {
  (
      [&] {
        constexpr int kFrom = bit_reverse(K, log2_of(N));
        V y = v[kFrom];
        if (K > 0 && f > 0) {
          V t = roots[(K * f) & (m - 1)];
          if (sign > 0) t.y = -t.y;
          y = cmul(y, t);
        }
        dst[K * k_stride] = y;
      }(),
      ...);
}

// w[t] = W_N^(sign t) = roots[t m / N] for each T < N/2, conjugated for
// sign > 0: the level's roots, read once a thread.
template <int S, typename V, int... T>
__device__ __forceinline__ void level_roots(V (&w)[S],
                                            const V* __restrict__ roots,
                                            int64_t stride, int sign,
                                            std::integer_sequence<int, T...>) {
  (
      [&] {
        V r = roots[T * stride];
        if (sign > 0) r.y = -r.y;
        w[T] = r;
      }(),
      ...);
}

// v[j] = src[j * stride] for each J: the loads of one column, all issued
// before any arithmetic.
template <int N, typename V, int... J>
__device__ __forceinline__ void load_column(V (&v)[N], const V* src,
                                            int64_t stride,
                                            std::integer_sequence<int, J...>) {
  ((v[J] = src[J * stride]), ...);
}

// K1, columns (C > tile_cols(n), n <= kColumnLevel: cuda_fft.LevelTiles'
// column launch): a thread owns column c of row a and forms its N outputs
// in registers. Block (x: blockDim.x consecutive columns, y: a, strided).
// Its N loads of in[a, j, c] are issued before any arithmetic, each a
// coalesced warp load (consecutive lanes, consecutive c); the DFT is the
// butterfly network of dif_registers on the level's roots, read once;
// output k takes the twiddle W_m^(sign k (c / tw_cols)) from the order-m
// table as the slab kernel does; its N stores are coalesced likewise. No
// shared memory, no barrier. in (A, N, C) -> out (N, A, C).
constexpr int kColumnLevel = 16;
template <typename V, int N>
__global__ void __launch_bounds__(kThreads)
    fft_level_columns_kernel(const V* __restrict__ in, V* __restrict__ out,
                             const V* __restrict__ roots, int64_t m,
                             int64_t C, int64_t A, int sign,
                             int64_t tw_cols) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  V w[N > 1 ? N / 2 : 1];
  level_roots(w, roots, m / N, sign,
              std::make_integer_sequence<int, N / 2>{});
  const int64_t f = tw_cols > 0 ? c / tw_cols : 0;
  for (int64_t a = blockIdx.y; a < A; a += gridDim.y) {
    V v[N];
    load_column(v, in + a * N * C + c, C,
                std::make_integer_sequence<int, N>{});
    dif_registers<N, N>(v, w, std::make_integer_sequence<int, N / 2>{});
    store_outputs(v, out + a * C + c, A * C, roots, m, sign, f,
                  std::make_integer_sequence<int, N>{});
  }
}

// K1, wide slab (C > tc, n > kColumnLevel): block (x: column tile, y: a,
// strided). in (A, n, C) -> out (n, A, C).
template <typename V>
__global__ void fft_level_kernel(const V* __restrict__ in,
                                 V* __restrict__ out,
                                 const V* __restrict__ roots, int64_t m,
                                 int n, int64_t C, int64_t A, int tc, int sign,
                                 int64_t tw_cols) {
  V* rts = shared_values<V>();
  V* slab = rts + n;
  const int64_t c0 = (int64_t)blockIdx.x * tc;
  load_roots(rts, roots, m, n, sign);
  for (int64_t a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the slab's last readers are done
    load_slab(slab, in + a * n * C, n, tc, c0, C);
    __syncthreads();
    dft_columns(slab, rts, n, tc, c0, C, out + a * C, A * C, roots, m, sign,
                tw_cols);
  }
}

// Two outputs k0 and k1 of one slab column from one read of each slab
// value: each the sum of dft_point, in its order of multiply-adds.
template <typename V>
__device__ __forceinline__ void dft_pair(const V* col, const V* rts, int n,
                                         int stride, int k0, int k1, V& v0,
                                         V& v1) {
  const int mask = n - 1;
  decltype(V::x) re0 = 0, im0 = 0, re1 = 0, im1 = 0;
  int e0 = 0, e1 = 0;
  for (int j = 0; j < n; ++j) {
    const V x = col[j * stride];
    const V r0 = rts[e0], r1 = rts[e1];
    re0 = fmar(x.x, r0.x, re0);
    re0 = fmar(-x.y, r0.y, re0);
    im0 = fmar(x.x, r0.y, im0);
    im0 = fmar(x.y, r0.x, im0);
    re1 = fmar(x.x, r1.x, re1);
    re1 = fmar(-x.y, r1.y, re1);
    im1 = fmar(x.x, r1.y, im1);
    im1 = fmar(x.y, r1.x, im1);
    e0 = (e0 + k0) & mask;
    e1 = (e1 + k1) & mask;
  }
  v0 = cplx(re0, im0);
  v1 = cplx(re1, im1);
}

// K1, narrow (C <= tc, LevelTiles' row groups): block (y: group of ra rows
// of A, strided). An item (k, a_l, c), c fastest, forms outputs k and
// k + n/2 of its slab column from one read of each slab value (at n = 1,
// k alone), so each k writes the group's ra * C contiguous outputs. A
// warp's lanes read consecutive (a_l, c) of one slab row j: row a_l lies
// at a_l * pitch with pitch = C (mod 8) values, so the eight lanes of a
// quarter-warp fall in eight different 16-byte bank groups (complex128).
// in (A, n, C) -> out (n, A, C).
template <typename V>
__global__ void fft_level_rows_kernel(const V* __restrict__ in,
                                      V* __restrict__ out,
                                      const V* __restrict__ roots, int64_t m,
                                      int n, int64_t C, int64_t A, int ra,
                                      int pitch, int sign, int64_t tw_cols) {
  V* rts = shared_values<V>();
  V* slab = rts + n;
  const int cols = (int)C, nc = n * cols, half = n >> 1;
  const int nk = half > 0 ? half : 1;  // the k of an item's first output
  load_roots(rts, roots, m, n, sign);
  for (int64_t a0 = (int64_t)blockIdx.y * ra; a0 < A;
       a0 += (int64_t)gridDim.y * ra) {
    const int rows = (int)(A - a0 < ra ? A - a0 : ra);
    const int width = rows * cols;  // the outputs of one k
    __syncthreads();  // the slab's last readers are done
    stage_rows(slab, in + a0 * nc, rows * nc, nc, pitch);
    __syncthreads();
    V* dst = out + a0 * C;
    for (int idx = threadIdx.x; idx < nk * width; idx += blockDim.x) {
      const int k = idx / width;
      const int r = idx - k * width;
      const int al = r / cols;
      const int c = r - al * cols;
      const V* col = slab + al * pitch + c;
      if (half > 0) {
        V v0, v1;
        dft_pair(col, rts, n, cols, k, k + half, v0, v1);
        dst[k * A * C + r] =
            level_twiddle(v0, k, c, roots, m, sign, tw_cols);
        dst[(k + half) * A * C + r] =
            level_twiddle(v1, k + half, c, roots, m, sign, tw_cols);
      } else {
        dst[r] = dft_point(col, rts, n, cols, 0, 0);  // n = 1: no twiddle
      }
    }
  }
}

// log2 of the lanes of a warp that share one row of n items: a power of
// two, at most 32 and at least min(n, 32); the warp takes 32 / lanes rows
// at a time.
__device__ __forceinline__ int row_lanes_log2(int n) {
  int l = 0;
  while ((1 << l) < n && l < 5) ++l;
  return l;
}

// The staged power of series s: the real (x) or imaginary (y) half of its
// column, s < w the real part of column s, else the imaginary part of
// column s - w; columns left of the tile's first are the wrap slots.
template <typename V>
__device__ __forceinline__ decltype(V::x) staged_power(const V* row,
                                                       int64_t s, int64_t w,
                                                       int64_t c_lo,
                                                       int span) {
  const bool re = s < w;
  const int64_t col = re ? s : s - w;
  const V v = row[col >= c_lo ? (int)(col - c_lo) : span + (int)col];
  return re ? v.x : v.y;
}

// K2: block (x: column tile of tq particle pairs, y: run of nj k_low values
// [kl0, kl0 + nj) within [0, R/2], strided). z (m, w) in natural frequency
// order k = k_top * R + k_low -> out (n_top, R, ph) = (dd, k_low, q):
// inverse level A over k_top, with the twiddle W_m^(k_low * dd), of
// P[k, q] = (sum_c |F_{q d + c}|^2 + i sum_c |F_{(q + ph) d + c}|^2) / m.
// Row k and its mirror (m - k) mod m = (n_top - 1 - k_top) R + (R - k_low)
// give 4 |F_s|^2 = (a.x + b.x)^2 + (a.y - b.y)^2 for a real-part series and
// (a.x - b.x)^2 + (a.y + b.y)^2 for an imaginary-part one (a = Z[k], b =
// Z[m - k]), the same for both rows, so a block loads the rows of its k_low
// values and of their mirrors R - k_low once and forms the outputs of both.
// Per run: (1) each staging pass of ktc k_top rows loads the element pairs
// of its rows' column span (coalesced: consecutive lanes, consecutive
// columns, and at narrow widths consecutive k_low rows) and stores the two
// halves' powers; (2) each (k_top, k_low, q) sums its particles' d
// components from there into the slab; (3) each (dd, k_low, q) forms
// A1 = sum_kt p1[kt] W_n^(kt dd) and A2 likewise from the real p1, p2, and
// writes tw (A1 + i A2) at k_low and conj(tw) (conj A1 + i conj A2) at
// R - k_low: the mirror's power runs over k_top reversed, and W_m^((R - kl)
// dd) = W_n^dd conj(W_m^(kl dd)). tw = W_m^(kl dd) is formed once per
// (k_low, dd) as the product of a fine and a coarse entry of the order-m
// table (fine_bits low bits, the rest): both sets of entries are ~sqrt(m).
// cuda_fft.UnpackTiles lists this split; the CPU tests replay it.
template <typename V>
__global__ void unpack_power_inva_kernel(
    const V* __restrict__ z, V* __restrict__ out, const V* __restrict__ roots,
    int64_t m, int n_top, int64_t R, int64_t w, int64_t P, int d, int64_t ph,
    int shift, int tq, int nj, int ktc, int cols_alloc, int fine_bits) {
  using Real = decltype(V::x);
  V* rts = shared_values<V>();              // n_top
  V* tws = rts + n_top;                     // (j, dd)
  V* slab = tws + nj * n_top;               // (kt, j, ql): p1, p2
  V* stage = slab + n_top * nj * tq;        // (kt, j, col)
  const int lnj = __ffs(nj) - 1, lntop = __ffs(n_top) - 1;
  const int64_t q0 = (int64_t)blockIdx.x * tq;
  const int tq_eff = (int)(ph - q0 < tq ? ph - q0 : tq);
  const int64_t c_lo = q0 * d;
  const int64_t c_hi = (q0 + tq_eff) * d + shift;
  const int span = (int)((c_hi < w ? c_hi : w) - c_lo);
  const int wrap = (q0 + tq_eff == ph && c_lo > 0) ? shift : 0;
  const int cols = span + wrap;
  const int64_t pairs = R / 2 + 1;
  const int64_t fine = ((int64_t)1 << fine_bits) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int llc = row_lanes_log2(cols), llq = row_lanes_log2(tq);
  // the halves' 1/4 and the inverse transform's 1/m: a power of two, exact
  const Real scale = (Real)(0.25 / (double)m);
  load_roots(rts, roots, m, n_top, +1);
  for (int64_t kl0 = (int64_t)blockIdx.y * nj; kl0 < pairs;
       kl0 += (int64_t)gridDim.y * nj) {
    const int nj_eff = (int)(pairs - kl0 < nj ? pairs - kl0 : nj);
    __syncthreads();  // the last run's readers of tws and slab are done
    for (int i = threadIdx.x; i < (nj << lntop); i += blockDim.x) {
      const int j = i >> lntop, dd = i & (n_top - 1);
      if (j >= nj_eff) continue;
      const int64_t e = ((kl0 + j) * dd) & (m - 1);
      V t = cmul(roots[e & fine], roots[e & ~fine]);
      t.y = -t.y;  // W_m^(+e)
      tws[i] = t;
    }
    for (int kt0 = 0; kt0 < n_top; kt0 += ktc) {
      __syncthreads();  // the last pass's readers of the stage are done
      for (int row = (warp << (5 - llc)) + (lane >> llc); row < (ktc << lnj);
           row += warps << (5 - llc)) {
        const int j = row & (nj - 1);
        if (j >= nj_eff) continue;
        const int64_t k = (int64_t)(kt0 + (row >> lnj)) * R + kl0 + j;
        const V* za = z + k * w;
        const V* zb = z + ((m - k) & (m - 1)) * w;
        V* dst = stage + row * cols_alloc;
        for (int col = lane & ((1 << llc) - 1); col < cols; col += 1 << llc) {
          const int64_t c = col < span ? c_lo + col : col - span;
          const V a = za[c], b = zb[c];
          const Real sr = a.x + b.x, di = a.y - b.y;
          const Real dr = a.x - b.x, si = a.y + b.y;
          dst[col] = cplx(sr * sr + di * di, dr * dr + si * si);
        }
      }
      __syncthreads();
      for (int row = (warp << (5 - llq)) + (lane >> llq); row < (ktc << lnj);
           row += warps << (5 - llq)) {
        const int j = row & (nj - 1), ql = lane & ((1 << llq) - 1);
        if (j >= nj_eff || ql >= tq_eff) continue;
        const V* src = stage + row * cols_alloc;
        const int64_t q = q0 + ql;
        Real p1 = 0, p2 = 0;
        for (int c = 0; c < d; ++c)
          p1 += staged_power(src, q * d + c, w, c_lo, span);
        if (q + ph < P) {
          for (int c = 0; c < d; ++c)
            p2 += staged_power(src, (q + ph) * d + c, w, c_lo, span);
        }
        slab[(((kt0 << lnj) + row) * tq) + ql] = cplx(p1 * scale, p2 * scale);
      }
    }
    __syncthreads();
    for (int row = (warp << (5 - llq)) + (lane >> llq); row < (n_top << lnj);
         row += warps << (5 - llq)) {
      const int j = row & (nj - 1), dd = row >> lnj;
      const int ql = lane & ((1 << llq) - 1);
      if (j >= nj_eff || ql >= tq_eff) continue;
      const V* src = slab + j * tq + ql;
      Real a1r = 0, a1i = 0, a2r = 0, a2i = 0;
      int e = 0;
      for (int kt = 0; kt < n_top; ++kt) {
        const V p = src[(kt << lnj) * tq];
        const V r = rts[e];
        a1r = fmar(p.x, r.x, a1r);
        a1i = fmar(p.x, r.y, a1i);
        a2r = fmar(p.y, r.x, a2r);
        a2i = fmar(p.y, r.y, a2i);
        e = (e + dd) & (n_top - 1);
      }
      const V tw = tws[(j << lntop) + dd];
      const int64_t kl = kl0 + j, q = q0 + ql;
      out[(dd * R + kl) * ph + q] = cmul(tw, cplx(a1r - a2i, a1i + a2r));
      if (kl != 0 && 2 * kl != R) {
        out[(dd * R + R - kl) * ph + q] =
            cmul(cplx(tw.x, -tw.y), cplx(a1r + a2i, a2r - a1i));
      }
    }
  }
}

// K5, wide (C > tc): block (x: column tile, y: a, strided). in (A, n, C),
// C = ph, the inverse DFT over n (no twiddle: the last level of its
// sub-transform), output row lag = k * A + a < N of out (N, P) real:
// out[lag, q] = re * s and, for ph + q < P, out[lag, ph + q] = im * s, with
// s = 1 / (N - lag) when normalize, else no scaling.
template <typename V>
__global__ void inverse_last_level_kernel(const V* __restrict__ in,
                                          decltype(V::x)* __restrict__ out,
                                          const V* __restrict__ roots, int n,
                                          int64_t C, int64_t A, int n_out,
                                          int tc, int64_t N, int64_t P,
                                          int normalize) {
  using Real = decltype(V::x);
  V* rts = shared_values<V>();
  V* slab = rts + n;
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
      const V v = dft_point(slab, rts, n, tc, k, cl);
      Real re = v.x, im = v.y;
      if (normalize) {
        // the reciprocal first, then the product: ops/acf.py's order
        const Real inv = (Real)1 / (Real)(N - lag);
        re *= inv;
        im *= inv;
      }
      out[lag * P + q] = re;
      if (C + q < P) out[lag * P + C + q] = im;
    }
  }
}

// K5, narrow (C <= tc, LevelTiles' row groups), the same function: block
// (y: group of ra rows of A, strided). Items (k, a_l, q), q fastest, form
// each complex sum once (dft_point, its slab reads as K1's) and put its
// real part at column q and its imaginary part at ph + q of a shared
// (k, a_l, p) stage; then the output lanes, over (k, a_l, p) with p
// fastest, write the group's ra * P contiguous reals of each k (lags
// k * A + a0 ...), rows past N skipped.
template <typename V>
__global__ void inverse_last_level_rows_kernel(
    const V* __restrict__ in, decltype(V::x)* __restrict__ out,
    const V* __restrict__ roots, int n, int64_t C, int64_t A, int n_out,
    int ra, int pitch, int64_t N, int64_t P, int normalize) {
  using Real = decltype(V::x);
  V* rts = shared_values<V>();
  V* slab = rts + n;
  Real* stage = (Real*)(slab + ra * pitch);  // (k, a_l, p)
  const int cols = (int)C, nc = n * cols, np = (int)P;
  load_roots(rts, roots, n, n, +1);
  for (int64_t a0 = (int64_t)blockIdx.y * ra; a0 < A;
       a0 += (int64_t)gridDim.y * ra) {
    const int rows = (int)(A - a0 < ra ? A - a0 : ra);
    const int wq = rows * cols;     // the complex sums of one k
    const int width = rows * np;    // the output reals of one k
    __syncthreads();  // the slab's and the stage's last readers are done
    stage_rows(slab, in + a0 * nc, rows * nc, nc, pitch);
    __syncthreads();
    for (int idx = threadIdx.x; idx < n_out * wq; idx += blockDim.x) {
      const int k = idx / wq;
      const int r = idx - k * wq;
      const int al = r / cols;
      const int q = r - al * cols;
      const int64_t lag = k * A + a0 + al;
      if (lag >= N) continue;
      const V v = dft_point(slab + al * pitch, rts, n, cols, k, q);
      Real re = v.x, im = v.y;
      if (normalize) {
        // the reciprocal first, then the product: ops/acf.py's order
        const Real inv = (Real)1 / (Real)(N - lag);
        re *= inv;
        im *= inv;
      }
      Real* row = stage + k * width + al * np;
      row[q] = re;
      if (cols + q < np) row[cols + q] = im;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n_out * width; idx += blockDim.x) {
      const int k = idx / width;
      const int r = idx - k * width;
      if (k * A + a0 + r / np < N) out[(k * A + a0) * P + r] = stage[idx];
    }
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K1's and K5's split from cuda_fft.LevelTiles, checked: wide (tc < C, one
// row a block) or narrow (tc == C, ra rows a block at pitch); the shared
// memory of the root table and the wide slab, or of the narrow slab and,
// for K5, its stage, in complex values of `value_bytes` bytes.
cudaError_t level_smem(const void* wide_fn, const void* rows_fn, int64_t n,
                       int64_t C, int64_t tc, int64_t ra, int64_t pitch,
                       bool epilogue, size_t value_bytes, size_t* bytes) {
  const bool wide = tc < C;
  if (n < 1 || tc < 1 || ra < 1 || tc > C || (wide && ra != 1) ||
      pitch < n * tc)
    return cudaErrorInvalidValue;
  const int64_t stage = epilogue ? n * ra * C : 0;  // K5's (k, a_l, p)
  *bytes = (size_t)(wide ? n + n * tc : n + ra * pitch + stage) * value_bytes;
  return allow_smem(wide ? wide_fn : rows_fn, *bytes);
}

template <typename V, int N>
int fft_level_columns(const void* in, void* out, const void* roots, int64_t A,
                      int64_t C, int64_t sign, int64_t tw_cols, int64_t m,
                      int64_t tc, int64_t grid_x, int64_t grid_y,
                      void* stream) {
  fft_level_columns_kernel<V, N>
      <<<dim3((unsigned)grid_x, (unsigned)grid_y), (unsigned)tc, 0,
         (cudaStream_t)stream>>>((const V*)in, (V*)out, (const V*)roots, m, C,
                                 A, (int)sign, tw_cols);
  return (int)cudaGetLastError();
}

template <typename V>
int fft_level(const void* in, void* out, const void* roots, int64_t A,
              int64_t n, int64_t C, int64_t sign, int64_t tw_cols, int64_t m,
              int64_t tc, int64_t ra, int64_t pitch, int64_t grid_x,
              int64_t grid_y, void* stream) {
  if (pitch == 0) {
    // the column launch: tc threads a block, a column each
    if (tc < 32 || tc > kThreads || tc % 32 || ra != 1 || grid_x * tc < C)
      return (int)cudaErrorInvalidValue;
    switch (n) {
      case 1:
        return fft_level_columns<V, 1>(in, out, roots, A, C, sign, tw_cols,
                                       m, tc, grid_x, grid_y, stream);
      case 2:
        return fft_level_columns<V, 2>(in, out, roots, A, C, sign, tw_cols,
                                       m, tc, grid_x, grid_y, stream);
      case 4:
        return fft_level_columns<V, 4>(in, out, roots, A, C, sign, tw_cols,
                                       m, tc, grid_x, grid_y, stream);
      case 8:
        return fft_level_columns<V, 8>(in, out, roots, A, C, sign, tw_cols,
                                       m, tc, grid_x, grid_y, stream);
      case 16:
        return fft_level_columns<V, 16>(in, out, roots, A, C, sign, tw_cols,
                                        m, tc, grid_x, grid_y, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  size_t smem = 0;
  cudaError_t err = level_smem((const void*)fft_level_kernel<V>,
                               (const void*)fft_level_rows_kernel<V>, n, C,
                               tc, ra, pitch, false, sizeof(V), &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (tc < C)
    fft_level_kernel<V><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const V*)in, (V*)out, (const V*)roots, m, (int)n, C, A, (int)tc,
        (int)sign, tw_cols);
  else
    fft_level_rows_kernel<V><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const V*)in, (V*)out, (const V*)roots, m, (int)n, C, A, (int)ra,
        (int)pitch, (int)sign, tw_cols);
  return (int)cudaGetLastError();
}

template <typename V>
int unpack_power_inva(const void* z, void* out, const void* roots, int64_t m,
                      int64_t n_top, int64_t R, int64_t w, int64_t P,
                      int64_t d, int64_t ph, int64_t shift, int64_t tq,
                      int64_t nj, int64_t ktc, int64_t cols,
                      int64_t fine_bits, int64_t grid_x, int64_t grid_y,
                      void* stream) {
  const bool pow2 = !(n_top & (n_top - 1)) && !(nj & (nj - 1)) &&
                    !(ktc & (ktc - 1));
  if (!pow2 || n_top < 1 || nj < 1 || ktc < 1 || ktc > n_top || tq < 1 ||
      tq > 32 || shift < 0 || cols < tq * d + 2 * shift)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(n_top * (1 + nj * (1 + tq)) + ktc * nj * cols) * sizeof(V);
  cudaError_t err = allow_smem((const void*)unpack_power_inva_kernel<V>, smem);
  if (err != cudaSuccess) return (int)err;
  unpack_power_inva_kernel<V><<<dim3((unsigned)grid_x, (unsigned)grid_y),
                                kThreads, smem, (cudaStream_t)stream>>>(
      (const V*)z, (V*)out, (const V*)roots, m, (int)n_top, R, w, P, (int)d,
      ph, (int)shift, (int)tq, (int)nj, (int)ktc, (int)cols, (int)fine_bits);
  return (int)cudaGetLastError();
}

template <typename V>
int inverse_last_level(const void* in, void* out, const void* roots,
                       int64_t A, int64_t n, int64_t ph, int64_t n_out,
                       int64_t N, int64_t P, int64_t normalize, int64_t tc,
                       int64_t ra, int64_t pitch, int64_t grid_x,
                       int64_t grid_y, void* stream) {
  using Real = decltype(V::x);
  size_t smem = 0;
  cudaError_t err = level_smem((const void*)inverse_last_level_kernel<V>,
                               (const void*)inverse_last_level_rows_kernel<V>,
                               n, ph, tc, ra, pitch, true, sizeof(V), &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (tc < ph)
    inverse_last_level_kernel<V><<<grid, kThreads, smem,
                                   (cudaStream_t)stream>>>(
        (const V*)in, (Real*)out, (const V*)roots, (int)n, ph, A, (int)n_out,
        (int)tc, N, P, (int)normalize);
  else
    inverse_last_level_rows_kernel<V><<<grid, kThreads, smem,
                                        (cudaStream_t)stream>>>(
        (const V*)in, (Real*)out, (const V*)roots, (int)n, ph, A, (int)n_out,
        (int)ra, (int)pitch, N, P, (int)normalize);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ta_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in (A, n, C) complex128 -> out (n, A, C); roots: the order-m table; the
// split (tc, ra, pitch) and the (grid_x, grid_y) grid from
// cuda_fft.LevelTiles. ta_fft_level_f32: the same for complex64.
int ta_fft_level(const void* in, void* out, const void* roots, int64_t A,
                 int64_t n, int64_t C, int64_t sign, int64_t tw_cols,
                 int64_t m, int64_t tc, int64_t ra, int64_t pitch,
                 int64_t grid_x, int64_t grid_y, void* stream) {
  return fft_level<double2>(in, out, roots, A, n, C, sign, tw_cols, m, tc, ra,
                            pitch, grid_x, grid_y, stream);
}
int ta_fft_level_f32(const void* in, void* out, const void* roots, int64_t A,
                     int64_t n, int64_t C, int64_t sign, int64_t tw_cols,
                     int64_t m, int64_t tc, int64_t ra, int64_t pitch,
                     int64_t grid_x, int64_t grid_y, void* stream) {
  return fft_level<float2>(in, out, roots, A, n, C, sign, tw_cols, m, tc, ra,
                           pitch, grid_x, grid_y, stream);
}

// z (m, w) complex128, natural order -> out (n_top, R, ph) complex128;
// roots: the order-m table; the work split (shift, tq, nj, ktc, cols,
// fine_bits and the grid) from cuda_fft.UnpackTiles.
// ta_unpack_power_inva_f32: the same for complex64.
int ta_unpack_power_inva(const void* z, void* out, const void* roots,
                         int64_t m, int64_t n_top, int64_t R, int64_t w,
                         int64_t P, int64_t d, int64_t ph, int64_t shift,
                         int64_t tq, int64_t nj, int64_t ktc, int64_t cols,
                         int64_t fine_bits, int64_t grid_x, int64_t grid_y,
                         void* stream) {
  return unpack_power_inva<double2>(z, out, roots, m, n_top, R, w, P, d, ph,
                                    shift, tq, nj, ktc, cols, fine_bits,
                                    grid_x, grid_y, stream);
}
int ta_unpack_power_inva_f32(const void* z, void* out, const void* roots,
                             int64_t m, int64_t n_top, int64_t R, int64_t w,
                             int64_t P, int64_t d, int64_t ph, int64_t shift,
                             int64_t tq, int64_t nj, int64_t ktc,
                             int64_t cols, int64_t fine_bits, int64_t grid_x,
                             int64_t grid_y, void* stream) {
  return unpack_power_inva<float2>(z, out, roots, m, n_top, R, w, P, d, ph,
                                   shift, tq, nj, ktc, cols, fine_bits,
                                   grid_x, grid_y, stream);
}

// in (A, n, ph) complex128 -> out (N, P) float64; roots: the order-n table;
// the split and the grid from cuda_fft.LevelTiles.
// ta_inverse_last_level_f32: complex64 -> float32.
int ta_inverse_last_level(const void* in, void* out, const void* roots,
                          int64_t A, int64_t n, int64_t ph, int64_t n_out,
                          int64_t N, int64_t P, int64_t normalize, int64_t tc,
                          int64_t ra, int64_t pitch, int64_t grid_x,
                          int64_t grid_y, void* stream) {
  return inverse_last_level<double2>(in, out, roots, A, n, ph, n_out, N, P,
                                     normalize, tc, ra, pitch, grid_x, grid_y,
                                     stream);
}
int ta_inverse_last_level_f32(const void* in, void* out, const void* roots,
                              int64_t A, int64_t n, int64_t ph, int64_t n_out,
                              int64_t N, int64_t P, int64_t normalize,
                              int64_t tc, int64_t ra, int64_t pitch,
                              int64_t grid_x, int64_t grid_y, void* stream) {
  return inverse_last_level<float2>(in, out, roots, A, n, ph, n_out, N, P,
                                    normalize, tc, ra, pitch, grid_x, grid_y,
                                    stream);
}

}  // extern "C"
