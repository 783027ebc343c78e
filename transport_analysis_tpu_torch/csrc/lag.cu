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
// peak outside the tensor cores allows 32.7 ms (and the FP64 pipe's issue
// rate, two instructions a pair-component, 43.7 ms). The operand, 362 MB
// in float32 or 723 MB in float64, takes at most 0.22 ms to read once.
// Both modes run on the FP64 units, outside the tensor cores.
//
// The acf mode (lag_sums_kernel): one thread per particle keeps kLagBlock
// float64 sums and a register window of kLagBlock future frames of each
// component; per frame it loads one new value per component and does
// kLagBlock * d multiply-adds, all on registers, so an operand value is
// read from memory once per lag block rather than once per lag. The frame
// loop is unrolled by kLagBlock, so the window is a ring whose slots are
// compile-time indices: no register moves. The mask i < N - lag is needed
// only on the last frames of a lag block, which a separate masked loop
// takes. A warp's threads are neighbouring particles, so each load of a
// frame row is coalesced. Each lag block still streams the whole operand,
// through the L2 cache.
//
// The einstein mode (einstein_tile_kernel): that re-read held it to 30-33
// % of its bound with a double operand, about 0.5 byte of L2 traffic per
// FP64 instruction, more than L2 delivers to 132 SMs. So a CTA takes a
// tile of kTileP = 32 particles (a lane each) x a span of kSpan = 128 lags
// (a warp each kLagBlock of them, the register ring as above), and the
// frames stream through shared memory, component-major ([c][frame]
// [particle], so a warp's 32 reads of a component are 32 consecutive
// values): a double-buffered tile of base frames x[i] (32 frames for a
// double operand, 64 for a float one: what 227 KB hold at d = 3), and a
// ring of partner rows x[i + lag] that every warp of the CTA reads its new
// window value from. Copies go by cp.async (one 4- or 8-byte copy a value,
// the transposition for free, zero-filled past P) one tile ahead of the
// sums, with one barrier a tile. Each operand value now crosses L2 about twice per 128 lags, not
// twice per 16. Each lag sums a tile of kTileF frames into a partial that
// it adds to its running sum (a two-level sum), so the error grows with
// N / kTileF terms, not N. The sums are the reference's (a - b)^2, never
// the cancelling a^2 + b^2 - 2ab. Past the last whole tile at which every
// lag of the span has its partner, the register ring goes on from global
// memory, each lag masked by i + lag < N. cuda_lag.py lists this work
// split (einstein_tiles, ring_slot, ...) and the CPU tests check it.
//
// Launch geometry: grid x walks tiles of particles (`cols` threads of one
// particle each in the acf mode, kTileP particles in the einstein mode),
// grid y the lag blocks or spans, strided by gridDim.y past CUDA's y limit
// of 65,535. Any N >= 1, n_lags in [1, N] and P >= 1; sizes and offsets
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLagBlock = 16;

// The acf mode. block (x: particle tile, y: lag blocks b, strided): lags
// [b kLagBlock, (b + 1) kLagBlock) of particle q, one thread each.
template <typename T, int D>
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
              acc[l] = fma(xi[c], w[c][(k + l) % kLagBlock], acc[l]);
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
            acc[l] = fma(xi[c], (double)col[j * s + c], acc[l]);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) {
      const int64_t lag = l0 + l;
      if (lag < n_lags) {
        out[lag * p + q] = acc[l] / ((double)(n - lag) * dfac);
      }
    }
  }
}

// The einstein mode's CTA: kTileP particles x kSpan lags, kWarps warps of
// kLagBlock lags each; shared-memory tiles of kTileF frames.
constexpr int kTileP = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = kWarps * kLagBlock;
// frames of a tile: as many as the shared memory takes at d = 3 (a float
// operand's rows are half the bytes), so the per-tile barrier and copies
// weigh less
template <typename T>
__host__ __device__ constexpr int tile_frames() {
  return sizeof(T) == 4 ? 4 * kLagBlock : 2 * kLagBlock;
}
// partner rows x[l0 + r] sit in ring slot (r + 1) mod ring_rows: the rows
// a tile reads (kTileF + kSpan - kLagBlock of them), the next tile's while
// they load, and the kLagBlock - 1 rows each warp primes its window with;
// a multiple of kLagBlock, so the reads of one warp in a chunk of
// kLagBlock frames never wrap
template <typename T>
__host__ __device__ constexpr int ring_rows() {
  return 2 * tile_frames<T>() + kSpan;
}
static_assert(ring_rows<float>() % kLagBlock == 0 &&
                  ring_rows<double>() % kLagBlock == 0,
              "a chunk's ring slots must not wrap");

template <typename T, int D>
constexpr size_t tile_smem_bytes() {
  return (size_t)(ring_rows<T>() + 2 * tile_frames<T>()) * D * kTileP *
         sizeof(T);
}

__device__ __forceinline__ void cp_async(void* dst, const float* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async(void* dst, const double* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy frame rows [row0, row0 + count) of particles [p0, p0 + kTileP) into
// shared memory, component-major: value (row0 + k, particle e, c) goes to
// dst[(c * stride + slot(k)) * kTileP + e], slot(k) = (first + k) mod
// wrap. Past P the copy fills zeros. All threads of the CTA take part.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, T* dst,
                                          int64_t row0, int count,
                                          int64_t p, int64_t p0, int stride,
                                          int first, int wrap) {
  constexpr int kRow = kTileP * D;
  for (int e = threadIdx.x; e < count * kRow; e += kThreads) {
    const int k = e / kRow, rem = e - k * kRow;
    const int part = rem / D, c = rem - part * D;
    const bool valid = p0 + part < p;
    const T* src = valid ? x + ((row0 + k) * p + p0) * D + rem : x;
    int slot = first + k;
    if (slot >= wrap) slot -= wrap;
    cp_async(dst + ((int64_t)c * stride + slot) * kTileP + part, src, valid);
  }
}

// block (x: tile of kTileP particles, y: spans b of kSpan lags, strided);
// warp w sums lags [b kSpan + w kLagBlock, ... + kLagBlock) of the lane's
// particle p0 + lane.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    einstein_tile_kernel(const T* __restrict__ x, double* __restrict__ out,
                         int64_t n, int64_t p, int64_t n_lags,
                         int64_t nspans, double dfac) {
  constexpr int kTileF = tile_frames<T>();
  constexpr int kRing = ring_rows<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);            // [D][kRing][kTileP]
  T* base = ring + (size_t)D * kRing * kTileP;      // [2][D][kTileF][kTileP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * kTileP;
  const int64_t q = p0 + lane;
  const int64_t s = p * D;  // row stride of the operand
  for (int64_t b = blockIdx.y; b < nspans; b += gridDim.y) {
    const int64_t l0 = b * kSpan;
    const int64_t lw = l0 + warp * kLagBlock;  // the warp's first lag
    const bool active = lw < n_lags;           // uniform in the warp
    double acc[kLagBlock];
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) acc[l] = 0.0;
    // ring window: x[i + lw + j] of component c in w[c][j % kLagBlock]
    double w[D][kLagBlock];
    // frames at which every lag of the span has its partner,
    // i + l0 + kSpan - 1 < n, in whole tiles
    const int64_t n_full = n - l0 - (kSpan - 1);
    const int64_t n_tiles = n_full > 0 ? n_full / kTileF : 0;
    if (n_tiles > 0) {
      // partner rows r = 0 .. kTileF + kSpan - 2 and base tile 0
      load_rows<T, D>(x, ring, l0, kTileF + kSpan - 1, p, p0, kRing, 1,
                      kRing);
      load_rows<T, D>(x, base, 0, kTileF, p, p0, kTileF, 0, kTileF);
      cp_async_commit();
      for (int64_t t = 0; t < n_tiles; ++t) {
        cp_async_wait_all();  // tile t's copies
        // tile t's rows are in for every thread, and every warp is done
        // with tile t - 1, whose slots the next copies take
        __syncthreads();
        if (t + 1 < n_tiles) {
          // tile t + 1: partner rows r = (t + 1) kTileF + kSpan - 1 on,
          // base rows (t + 1) kTileF on, into the other base buffer;
          // they land while tile t is summed
          const int64_t r = (t + 1) * kTileF + kSpan - 1;
          load_rows<T, D>(x, ring, l0 + r, kTileF, p, p0, kRing,
                          (int)((r + 1) % kRing), kRing);
          load_rows<T, D>(x, base + (size_t)((t + 1) & 1) * D * kTileF *
                                        kTileP,
                          (t + 1) * kTileF, kTileF, p, p0, kTileF, 0, kTileF);
          cp_async_commit();
        }
        if (active) {
          if (t == 0) {
#pragma unroll
            for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
              for (int c = 0; c < D; ++c)
                w[c][j] = (double)ring[(c * kRing + warp * kLagBlock + j +
                                        1) * kTileP + lane];
            }
          }
          double part[kLagBlock];
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) part[l] = 0.0;
#pragma unroll 1
          for (int kk = 0; kk < kTileF; kk += kLagBlock) {
            const T* xb = base + (size_t)(t & 1) * D * kTileF * kTileP +
                          kk * kTileP + lane;
            // slot of partner row t kTileF + kk + k + warp kLagBlock +
            // kLagBlock - 1, frame k of the chunk
            const int sb = (int)((t * kTileF + kk + (warp + 1) * kLagBlock) %
                                 kRing);
            const T* xw = ring + sb * kTileP + lane;
#pragma unroll
            for (int k = 0; k < kLagBlock; ++k) {
              double xi[D];
#pragma unroll
              for (int c = 0; c < D; ++c) {
                w[c][(k + kLagBlock - 1) % kLagBlock] =
                    (double)xw[(c * kRing + k) * kTileP];
                xi[c] = (double)xb[(c * kTileF + k) * kTileP];
              }
#pragma unroll
              for (int l = 0; l < kLagBlock; ++l) {
#pragma unroll
                for (int c = 0; c < D; ++c) {
                  const double diff = xi[c] - w[c][(k + l) % kLagBlock];
                  part[l] = fma(diff, diff, part[l]);
                }
              }
            }
          }
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) acc[l] += part[l];
        }
      }
      __syncthreads();  // the next span's copies overwrite the last tile
    }
    if (active && q < p) {
      // the frames past the tiles, each lag bounded by i + lag < n: the
      // register ring goes on from global memory, in chunks of kLagBlock
      // frames, primed here where there were no tiles
      const T* col = x + q * D;
      const int64_t i_end = n - lw;
      if (n_tiles == 0) {
#pragma unroll
        for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
          for (int c = 0; c < D; ++c)
            w[c][j] = j < i_end ? (double)col[(lw + j) * s + c] : 0.0;
        }
      }
      double part[kLagBlock];
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l) part[l] = 0.0;
      for (int64_t i0 = n_tiles * kTileF; i0 < i_end; i0 += kLagBlock) {
#pragma unroll
        for (int k = 0; k < kLagBlock; ++k) {
          const int64_t i = i0 + k;
          const int64_t lim = i_end - i;  // lags lw + l, l < lim, pair
          const int64_t jn = i + kLagBlock - 1;  // the new partner, - lw
          double xi[D];
#pragma unroll
          for (int c = 0; c < D; ++c) {
            w[c][(k + kLagBlock - 1) % kLagBlock] =
                jn < i_end ? (double)col[(lw + jn) * s + c] : 0.0;
            xi[c] = lim > 0 ? (double)col[i * s + c] : 0.0;
          }
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) {
            if (l < lim) {
#pragma unroll
              for (int c = 0; c < D; ++c) {
                const double diff = xi[c] - w[c][(k + l) % kLagBlock];
                part[l] = fma(diff, diff, part[l]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l) {
        const int64_t lag = lw + l;
        if (lag < n_lags) {
          out[lag * p + q] =
              lag == 0 ? 0.0 : (acc[l] + part[l]) / ((double)(n - lag) * dfac);
        }
      }
    }
  }
}

template <typename T, int D>
int launch(const void* x, void* out, int64_t n, int64_t p, int64_t n_lags,
           bool einstein, double dfac, dim3 grid, unsigned cols,
           cudaStream_t stream) {
  if (einstein) {
    constexpr size_t smem = tile_smem_bytes<T, D>();
    const cudaError_t err = cudaFuncSetAttribute(
        einstein_tile_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t nspans = (n_lags + kSpan - 1) / kSpan;
    einstein_tile_kernel<T, D><<<grid, cols, smem, stream>>>(
        (const T*)x, (double*)out, n, p, n_lags, nspans, dfac);
  } else {
    const int64_t nlb = (n_lags + kLagBlock - 1) / kLagBlock;
    lag_sums_kernel<T, D><<<grid, cols, 0, stream>>>(
        (const T*)x, (double*)out, n, p, n_lags, nlb, dfac);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* x, void* out, int64_t n, int64_t p, int64_t d,
             int64_t n_lags, bool einstein, double dfac, dim3 grid,
             unsigned cols, cudaStream_t stream) {
  if (d == 1) return launch<T, 1>(x, out, n, p, n_lags, einstein, dfac, grid, cols, stream);
  if (d == 2) return launch<T, 2>(x, out, n, p, n_lags, einstein, dfac, grid, cols, stream);
  return launch<T, 3>(x, out, n, p, n_lags, einstein, dfac, grid, cols, stream);
}

}  // namespace

extern "C" {

// x (n, p, d) float32 (f64 == 0) or float64 -> out (n_lags, p) float64, on
// a (grid_x, grid_y) grid of blocks of `cols` threads; all from
// cuda_lag.py, whose constants must be this file's. acf: one particle a
// thread, grid y over the ceil(n_lags / lag_block) lag blocks, lag_block
// = kLagBlock; einstein: kTileP particles a block of kThreads, grid y over
// the ceil(n_lags / lag_block) spans, lag_block = kSpan.
int ta_lag_sums(const void* x, void* out, int64_t n, int64_t p, int64_t d,
                int64_t n_lags, int64_t f64, int64_t einstein, double dfac,
                int64_t lag_block, int64_t cols, int64_t grid_x,
                int64_t grid_y, void* stream) {
  const bool geometry = einstein ? lag_block == kSpan && cols == kThreads
                                 : lag_block == kLagBlock;
  if (!geometry || d < 1 || d > 3 || n_lags < 1 || n_lags > n)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (f64) {
    return launch_d<double>(x, out, n, p, d, n_lags, einstein != 0, dfac,
                            grid, (unsigned)cols, (cudaStream_t)stream);
  }
  return launch_d<float>(x, out, n, p, d, n_lags, einstein != 0, dfac, grid,
                         (unsigned)cols, (cudaStream_t)stream);
}

}  // extern "C"
