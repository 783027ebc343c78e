// Kneller/Calandrini assembly of the Einstein lag differences, for Hopper
// (sm_90a), float64 or float32. Built by transport_analysis_tpu_torch/_build.py and called
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
// arithmetic. K6a needs to read sq once, and does so: with N = q R + r
// (R = `rows`, 0 <= r < R) the reversed block b covers rows
// [(q-b-1) R + r, (q-b) R + r), the upper part (the "hi", from row k R + r
// on) of forward block q-b-1 and the lower r rows (the "lo") of forward
// block q-b. So K6a walks runs of consecutive forward blocks, sums each as
// lo and hi, writes lo + hi as the forward total and the previous block's
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
// A warp of K6a reads 32 neighbouring columns of a row (256 contiguous
// bytes).
//
// K6b reads sq twice (its forward and its reversed rows), corr once and
// writes out once. Its sums past a row come in three parts, each a sum of
// later terms: the tile's offsets, the later row lanes of the tile, and
// the thread's own later rows.
//  - The offsets, off[leg, i] = sum of tot[leg] past tile i, come from one
//    scan of the (2, nb, P) totals in two small launches (segment sums,
//    then each segment's exclusive suffix scan on top of the later
//    segments' sums), so each total is read three times whatever nb is.
//    Segments are at least sqrt(tiles) long, so the later-segment sums of
//    the second launch stay linear in N too.
//  - A tile is (kThreads / cols) kRun lags of `cols` columns: cols is 32
//    for P >= 32 and P rounded up to a power of two below, so at narrow
//    widths the lanes of a warp lie over 32 / cols row lanes of the same
//    columns, and a warp reads one contiguous span of sq. Each thread
//    loads its kRun consecutive lags' forward and reversed rows at once
//    (32 independent loads in flight a thread), and the row lanes' sums
//    meet in a shuffle scan within a warp and shared memory across warps.
//  - Tiles run in mirror order (a tile beside its mirror), so that sq's
//    second read can come from L2 rather than device memory.
// tile rows are a multiple of R, so a tile's offsets are sums of whole
// totals. Any N >= 1 and P >= 1: the ragged last block is masked by the
// row bound. Grid y walks K6a's runs and K6b's tiles and segments; past
// CUDA's y limit of 65,535 a block strides over them by gridDim.y, so N
// up to 2^23 and beyond runs with the same per-block arithmetic. Sizes are
// 64-bit.
//
// Types: K6a and K6b read sq and corr and write out in the work mode's type,
// float64 (ta_kneller_totals, ta_kneller_windows) or float32 (the _f32
// entries, the float32 work mode, dtype=np.float32), and keep the block
// totals tot, the scan's seg and off, and every running sum in float64 in
// both: they are 1/rows of the data, and the window sums they carry meet
// 2 corr in s_head + s_tail - 2 corr, which cancels at small lags. That is
// what the TPU kernel's compensated float32 pairs give
// (pallas_kneller.py:27); a float32 running sum of 65,536 frames would lose
// the MSD there. Only the result is rounded to float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the column sum of rows [i0, i1) from `at`, the column's row 0, in float64
template <typename T>
__device__ __forceinline__ double column_sum(const T* __restrict__ at,
                                             int64_t i0, int64_t i1,
                                             int64_t p) {
  double acc = 0.0;
#pragma unroll 8
  for (int64_t i = i0; i < i1; ++i) acc += (double)at[i * p];
  return acc;
}

constexpr int kSplit = 8;  // K6a's thread rows, a slice of a block's rows each

// block (32 x kSplit threads; x: a tile of 32 columns, y: runs j of `run`
// row blocks, strided). tot (2, nb, P): tot[0, b] sums sq rows [b rows,
// (b + 1) rows), tot[1, b] the same positions of the reversed rows
// sq[N-1-i]. Thread row ty sums the slice [ty rows / kSplit, (ty + 1)
// rows / kSplit) of each block as its lo and hi parts; warp 0 adds the
// slices in order and writes both legs.
template <typename T>
__global__ void kneller_totals_kernel(const T* __restrict__ sq,
                                      double* __restrict__ tot, int64_t n,
                                      int64_t p, int rows, int64_t nb,
                                      int64_t run, int64_t runs) {
  __shared__ double part[2][kSplit][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t col = (int64_t)blockIdx.x * 32 + tx;
  const bool in = col < p;
  const T* at = sq + (in ? col : 0);
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

// K6b. Threads of a block: kThreads, as `cols` = 2^log2c columns (a
// power of two up to 32, covering P where P < 32) by kThreads / cols row
// lanes; thread t takes column t mod cols and row lane t / cols, so a warp
// holds 32 / cols consecutive row lanes of its columns.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;  // consecutive lags of one K6b thread

struct Legs {  // a sum over sq (f) and over the reversed rows (r)
  double f, r;
};

// Exclusive suffix sums over the block's row lanes of one column: thread
// (c, j) gets the sum of x over row lanes j' > j of column c. Within a warp
// by shuffles (the lanes of a column lie `cols` apart), across warps
// through shared memory `wsum` (kWarps x 32). Sums of later terms only,
// never a total minus a prefix. Every thread of the block calls it.
__device__ __forceinline__ Legs later_lanes(Legs x, int log2c, Legs* wsum) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = lane & ((1 << log2c) - 1), jj = lane >> log2c;
  const int per_warp = 32 >> log2c;
  Legs inc = x;  // inclusive: row lanes jj' >= jj of this warp
  for (int d = 1; d < per_warp; d <<= 1) {
    const double f = __shfl_down_sync(full, inc.f, d << log2c);
    const double r = __shfl_down_sync(full, inc.r, d << log2c);
    if (jj + d < per_warp) {
      inc.f += f;
      inc.r += r;
    }
  }
  Legs out;
  out.f = __shfl_down_sync(full, inc.f, 1 << log2c);
  out.r = __shfl_down_sync(full, inc.r, 1 << log2c);
  if (jj + 1 >= per_warp) out.f = out.r = 0.0;
  if (jj == 0) wsum[w * 32 + c] = inc;
  __syncthreads();
  for (int v = w + 1; v < kWarps; ++v) {
    out.f += wsum[v * 32 + c].f;
    out.r += wsum[v * 32 + c].r;
  }
  __syncthreads();  // wsum is free again when the caller returns
  return out;
}

// the sum of tot[leg] (2, nb, P) over rows b0, b0 + stride, ... below
// b1 of column col: a segment's rows for one row lane of the scan, or the
// rows of consecutive tiles (stride 1)
__device__ __forceinline__ Legs total_rows(const double* __restrict__ tot,
                                           int64_t b0, int64_t b1,
                                           int64_t stride, int64_t nb,
                                           int64_t p, int64_t col) {
  Legs a = {0.0, 0.0};
#pragma unroll 8
  for (int64_t b = b0; b < b1; b += stride) {
    a.f += tot[b * p + col];
    a.r += tot[(nb + b) * p + col];
  }
  return a;
}

// K6b's scan, first launch. block (x: column tile, y: segments s,
// strided): seg[leg, s] = the sum of tot[leg] over rows [s seg_rows,
// (s + 1) seg_rows) (tiles [s segt, (s + 1) segt)). Row lane j reads
// rows j, j + lanes, ..., so a warp reads consecutive rows.
__global__ void __launch_bounds__(kThreads)
    kneller_scan_segments_kernel(const double* __restrict__ tot,
                                 double* __restrict__ seg, int64_t nb,
                                 int64_t p, int log2c, int64_t seg_rows,
                                 int64_t segs) {
  __shared__ Legs wsum[kWarps * 32];
  const int c = threadIdx.x & ((1 << log2c) - 1);
  const int j = threadIdx.x >> log2c, lanes = kThreads >> log2c;
  const int64_t col = ((int64_t)blockIdx.x << log2c) + c;
  const bool in = col < p;
  for (int64_t s = blockIdx.y; s < segs; s += gridDim.y) {
    const int64_t b0 = s * seg_rows;
    const int64_t b1 = b0 + seg_rows < nb ? b0 + seg_rows : nb;
    const Legs x = in ? total_rows(tot, b0 + j, b1, lanes, nb, p, col)
                      : Legs{0.0, 0.0};
    const Legs later = later_lanes(x, log2c, wsum);
    if (j == 0 && in) {
      seg[s * p + col] = x.f + later.f;
      seg[(segs + s) * p + col] = x.r + later.r;
    }
  }
}

// K6b's scan, second launch. block (x: column tile, y: segments s,
// strided): off[leg, i] = sum of tot[leg] over the rows past tile i, for
// the tiles i of segment s: the later segments' sums (seg), reduced over
// the row lanes, plus an exclusive suffix scan of the segment's tiles,
// `chunk` consecutive tiles a row lane.
__global__ void __launch_bounds__(kThreads)
    kneller_scan_offsets_kernel(const double* __restrict__ tot,
                                const double* __restrict__ seg,
                                double* __restrict__ off, int64_t nb,
                                int64_t p, int log2c, int64_t g, int64_t nt,
                                int64_t segt, int64_t segs, int64_t chunk) {
  __shared__ Legs wsum[kWarps * 32];
  __shared__ Legs base[32];
  const int c = threadIdx.x & ((1 << log2c) - 1);
  const int j = threadIdx.x >> log2c, lanes = kThreads >> log2c;
  const int64_t col = ((int64_t)blockIdx.x << log2c) + c;
  const bool in = col < p;
  for (int64_t s = blockIdx.y; s < segs; s += gridDim.y) {
    Legs x = {0.0, 0.0};
    if (in)
      for (int64_t s2 = s + 1 + j; s2 < segs; s2 += lanes) {
        x.f += seg[s2 * p + col];
        x.r += seg[(segs + s2) * p + col];
      }
    const Legs later = later_lanes(x, log2c, wsum);
    if (j == 0) base[c] = Legs{x.f + later.f, x.r + later.r};
    __syncthreads();
    const int64_t i_end = (s + 1) * segt < nt ? (s + 1) * segt : nt;
    const int64_t t0 = s * segt + j * chunk;
    const int64_t t1 = t0 + chunk < i_end ? t0 + chunk : i_end;
    // this row lane's tiles: rows [t0 g, t1 g)
    const Legs mine =
        in ? total_rows(tot, t0 * g, t1 * g < nb ? t1 * g : nb, 1, nb, p, col)
           : Legs{0.0, 0.0};
    Legs run = base[c];  // read before later_lanes' barriers
    const Legs after = later_lanes(mine, log2c, wsum);
    run.f += after.f;
    run.r += after.r;
    if (in) {
#pragma unroll 4
      for (int64_t i = t1 - 1; i >= t0; --i) {
        off[i * p + col] = run.f;
        off[(nt + i) * p + col] = run.r;
        const int64_t b1 = (i + 1) * g < nb ? (i + 1) * g : nb;
        const Legs a = total_rows(tot, i * g, b1, 1, nb, p, col);
        run.f += a.f;
        run.r += a.r;
      }
    }
  }
}

// K6b. block (x: column tile, y: tiles of (kThreads / cols) kRun lags, in
// mirror order, strided): row lane j takes the kRun consecutive lags from
// l0 = tile tile_rows + j kRun, loads its forward rows and the reversed
// rows N-1-lag of them in one go, and walks them from the last down,
// adding to the sums past its own rows: the tile's offsets (off, from the
// scan) plus the later row lanes' sums (later_lanes). Neighbouring y take
// a tile and its mirror, whose forward rows are the first one's reversed
// rows (shifted by N mod tile_rows), so the two run side by side and the
// second read of those rows can come from L2.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    kneller_windows_kernel(const T* __restrict__ sq,
                           const T* __restrict__ corr,
                           const double* __restrict__ off,
                           T* __restrict__ out, int64_t n, int64_t p,
                           int log2c, int64_t nt, double dfac) {
  __shared__ Legs wsum[kWarps * 32];
  const int c = threadIdx.x & ((1 << log2c) - 1);
  const int j = threadIdx.x >> log2c;
  const int64_t col = ((int64_t)blockIdx.x << log2c) + c;
  const bool in = col < p;
  const int64_t tile_rows = (int64_t)(kThreads >> log2c) * kRun;
  for (int64_t y = blockIdx.y; y < nt; y += gridDim.y) {
    // mirror order: y = 2k takes tile k, y = 2k + 1 tile nt - 1 - k
    const int64_t tile = y & 1 ? nt - 1 - (y >> 1) : y >> 1;
    const int64_t l0 = tile * tile_rows + (int64_t)j * kRun;
    // every load of the tile issued at once; corr too, as a load inside
    // the conditional store below would wait for each in turn
    double fw[kRun], rv[kRun], cr[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int64_t lag = l0 + k;
      const bool ok = in && lag < n;
      fw[k] = ok ? (double)sq[lag * p + col] : 0.0;
      rv[k] = ok ? (double)sq[(n - 1 - lag) * p + col] : 0.0;
      cr[k] = ok ? (double)corr[lag * p + col] : 0.0;
    }
    Legs own = {0.0, 0.0};
#pragma unroll
    for (int k = kRun - 1; k >= 0; --k) {
      own.f += fw[k];
      own.r += rv[k];
    }
    Legs run = later_lanes(own, log2c, wsum);
    if (in) {
      run.f += off[tile * p + col];
      run.r += off[(nt + tile) * p + col];
    }
#pragma unroll
    for (int k = kRun - 1; k >= 0; --k) {
      const int64_t lag = l0 + k;
      run.f += fw[k];
      run.r += rv[k];
      if (in && lag < n)
        out[lag * p + col] =
            (T)(lag == 0 ? 0.0
                         : (run.r + run.f - 2.0 * cr[k]) /
                               ((double)(n - lag) * dfac));
    }
  }
}

template <typename T>
int kneller_totals(const void* sq, void* tot, int64_t n, int64_t p,
                   int64_t rows, int64_t nb, int64_t run, int64_t runs,
                   int64_t grid_x, int64_t grid_y, void* stream) {
  if (run < 1 || runs * run < nb || (runs - 1) * run >= nb ||
      rows % kSplit != 0)
    return (int)cudaErrorInvalidValue;
  kneller_totals_kernel<T><<<dim3((unsigned)grid_x, (unsigned)grid_y),
                             dim3(32, kSplit), 0, (cudaStream_t)stream>>>(
      (const T*)sq, (double*)tot, n, p, (int)rows, nb, run, runs);
  return (int)cudaGetLastError();
}

template <typename T>
int kneller_windows(const void* sq, const void* corr, const void* tot,
                    void* seg, void* off, void* out, int64_t n, int64_t p,
                    int64_t rows, int64_t nb, double dfac, int64_t log2c,
                    int64_t g, int64_t nt, int64_t segt, int64_t segs,
                    int64_t chunk, int64_t grid_x, int64_t grid_segs,
                    int64_t grid_tiles, void* stream) {
  if (log2c < 0 || log2c > 5 || (kThreads >> log2c) * kRun != g * rows ||
      nt * g < nb || (nt - 1) * g >= nb || segs * segt < nt ||
      (segs - 1) * segt >= nt || chunk * (kThreads >> log2c) < segt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  kneller_scan_segments_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_segs),
                                 kThreads, 0, st>>>(
      (const double*)tot, (double*)seg, nb, p, (int)log2c, segt * g, segs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kneller_scan_offsets_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_segs),
                                kThreads, 0, st>>>(
      (const double*)tot, (const double*)seg, (double*)off, nb, p,
      (int)log2c, g, nt, segt, segs, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kneller_windows_kernel<T><<<dim3((unsigned)grid_x, (unsigned)grid_tiles),
                              kThreads, 0, st>>>(
      (const T*)sq, (const T*)corr, (const double*)off, (T*)out, n, p,
      (int)log2c, nt, dfac);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sq (n, p) float64 -> tot (2, nb, p) float64, nb = ceil(n / rows), in
// `runs` runs of `run` row blocks, on a (grid_x, grid_y) grid of blocks of
// 32 x kSplit threads; all from cuda_kneller.py. ta_kneller_totals_f32:
// sq float32, tot float64.
int ta_kneller_totals(const void* sq, void* tot, int64_t n, int64_t p,
                      int64_t rows, int64_t nb, int64_t run, int64_t runs,
                      int64_t grid_x, int64_t grid_y, void* stream) {
  return kneller_totals<double>(sq, tot, n, p, rows, nb, run, runs, grid_x,
                                grid_y, stream);
}
int ta_kneller_totals_f32(const void* sq, void* tot, int64_t n, int64_t p,
                          int64_t rows, int64_t nb, int64_t run, int64_t runs,
                          int64_t grid_x, int64_t grid_y, void* stream) {
  return kneller_totals<float>(sq, tot, n, p, rows, nb, run, runs, grid_x,
                               grid_y, stream);
}

// sq, corr (n, p) and tot from ta_kneller_totals -> out (n, p) float64,
// through the scratch seg (2, segs, p) and off (2, nt, p) of float64: three
// launches on a grid of (grid_x column tiles, grid_segs segments) for the
// scan's two and (grid_x, grid_tiles) for the windows; the split from
// cuda_kneller.py windows_split. ta_kneller_windows_f32: sq, corr and out
// float32.
int ta_kneller_windows(const void* sq, const void* corr, const void* tot,
                       void* seg, void* off, void* out, int64_t n, int64_t p,
                       int64_t rows, int64_t nb, double dfac, int64_t log2c,
                       int64_t g, int64_t nt, int64_t segt, int64_t segs,
                       int64_t chunk, int64_t grid_x, int64_t grid_segs,
                       int64_t grid_tiles, void* stream) {
  return kneller_windows<double>(sq, corr, tot, seg, off, out, n, p, rows, nb,
                                 dfac, log2c, g, nt, segt, segs, chunk,
                                 grid_x, grid_segs, grid_tiles, stream);
}
int ta_kneller_windows_f32(const void* sq, const void* corr, const void* tot,
                           void* seg, void* off, void* out, int64_t n,
                           int64_t p, int64_t rows, int64_t nb, double dfac,
                           int64_t log2c, int64_t g, int64_t nt, int64_t segt,
                           int64_t segs, int64_t chunk, int64_t grid_x,
                           int64_t grid_segs, int64_t grid_tiles,
                           void* stream) {
  return kneller_windows<float>(sq, corr, tot, seg, off, out, n, p, rows, nb,
                                dfac, log2c, g, nt, segt, segs, chunk, grid_x,
                                grid_segs, grid_tiles, stream);
}

}  // extern "C"
