// Windowed lag sums of the exact (fft=False) path, for Hopper (sm_90a). Built by transport_analysis_tpu_torch/_build.py and
// called through ctypes from transport_analysis_tpu_torch/ops/cuda_lag.py.
//
// K8  ta_lag_sums
//     For the series of an (N, P, d) row-major operand x, d <= 3 (past
//     that cuda_lag.lag_sums launches it once per group of at most three
//     components and adds the sums), and each lag < n_lags:
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
//     The output is float64, or float32 (ta_lag_sums_f32) for the float32 work mode
//     (dtype=np.float32, K8a's own type: a float operand, float32 results
//     at about 1e-6 grade). There the acf mode keeps its float64 Gram on
//     the FP64 tensor cores, which run at the 67 TFLOP/s of FP32 outside
//     them (TF32's 10-bit mantissa cannot hold the 1e-6 grade), and only
//     rounds its result; the einstein mode (einstein_rows_kernel) takes
//     float32 differences and squares (twice the FP64 rate), each lag's
//     partial of at most 64 frames summed in float32 and added to a
//     float64 running sum, so no float32 register sums more terms.
//
// K8  ta_lag_pair (ta_lag_pair_f32), the two-block launch
//     For two (n, p, d) blocks xa and xb of one series and each relative
//     lag j < n_lags, the raw sums (no 1 / (n - lag))
//       acf:      out[j, p] = sum_a sum_c xa[a,p,c] xb[a+j+shift,p,c] / dfac
//       einstein: out[j, p] = sum_a sum_c (xa[a,p,c] - xb[a+j+shift,p,c])^2 / dfac
//     over the base frames a < n whose partner a + j + shift lies in [0, n):
//     the pair sums of the exact ring (parallel/ring.py), where block i
//     meets block i + k at lags kL + delta, shift = lag_lo - kL. The JAX
//     package forms them in plain jnp (transport_analysis_tpu/parallel/
//     ring.py:35-76, a loop over 2L - 1 shifts). Its pairs fill a band of
//     the (base frame, lag) plane that narrows to nothing at both ends of
//     the window (lag j has n - |j + shift| of them), where the one-operand
//     launch's fill a triangle that runs from N frames at lag 0. So the
//     launch has kernels of its own (acf_pair_kernel, einstein_pair_kernel,
//     einstein_pair_rows_kernel) on the one-operand kernels' helpers, and
//     the one-operand launches keep their code:
//     - acf: acf_gram_kernel's Gram product over chunks of 256 base frames
//       (kPairSteps = kRing, the fewest steps the Hankel ring of B
//       fragments allows), a warp's MMAs of a chunk only for its tiles
//       whose partner rows meet the block, spans of a CTA's full 497 lags
//       (64 tiles, so the four sub-partitions get equal work), so that the
//       products follow the band: 1.17x its pair-components at the ring's
//       round 1 of the EC model system, 1.16x at round 0, where 1,024-frame
//       chunks over the whole frame range of a span did 1.61x and 1.69x.
//       The partner rows stay in a ring of four 256-row groups, one group
//       copied a chunk, and the rows stay in the operand's type in shared
//       memory, converted to double as a fragment is read: no landing
//       buffer and no conversion pass, 66,560 bytes of shared memory (the
//       Gram rows) and two CTAs an SM for both types.
//     - einstein: the tiles of einstein_tile_kernel (float64 sums) or
//       einstein_rows_kernel (float32 sums) cover every frame that pairs
//       with some lag of the span, [max(0, -(d0 + kSpan - 1)), min(n, n -
//       d0)), d0 = l0 + shift, partner rows outside the block zero-filled
//       by the copy; a warp sums only the tiles where one of its lags has a
//       pair, and those where some lag of it lacks a partner at some frame
//       (the band's edges) through a masked copy of the inner loop, so no
//       lane reads a pair's frame from global memory. The float32 kernel
//       runs one CTA an SM, where its registers need no spill.
//     The spans run in order of their pairs, most first (pair_span): along
//     grid x in the acf launch, whose grid y walks the particles, so that
//     the CTAs that run together read the same particles' frames and share
//     them in L2; along grid y in the einstein launches, whose grid x walks
//     tiles of particles, so that the short spans run last. cuda_lag.py
//     lists this work split (pair_span_order, acf_pair_*, einstein_pair_*)
//     and the CPU tests replay it.
//
// What bounds it: float64 arithmetic. Every (frame, lag, series) pair costs
// one multiply-add (acf) or a subtract and a multiply-add (einstein). At
// 3,680 atoms x 8,192 frames over all lags (3.7e11 pairs) the acf sums, a
// Gram product of frame tiles, can run on the tensor cores' 67 TFLOP/s
// FP64 peak (H100 SXM data sheet) in 11.1 ms, where the FP64 units' one
// multiply-add a pair at 17e12 instructions/s would need 21.8 ms; the
// einstein sums subtract before they square, which is no matrix product,
// so the 34 TFLOP/s FP64 peak outside the tensor cores allows 32.7 ms (and
// the FP64 pipe's issue rate, two instructions a pair-component, 43.7 ms).
// The operand, 362 MB in float32 or 723 MB in float64, takes at most 0.22
// ms to read once.
//
// The acf mode (acf_gram_kernel) runs on the FP64 tensor cores. For one
// series, zero past frame N, and B = kRows frame phases, let
//   C[p, m] = sum_u sum_c x[B u + p, c] x[B u + m, c],  p < B;
// then S[lag] = sum_{p < B} C[p, p + lag]: frame t = B u + p runs over
// every frame once, and the zeros give the bound t + lag < N. C is a
// product (B x K)(K x cols), K = (u, c), whose two factors are slices of
// the same frames, so a CTA stages one window of frames and feeds both
// from it. A CTA takes one particle and a span of at most kAcfSpan lags:
// columns m in [l0, l0 + kAcfCols), 8 warps of kWarpTiles n8 tiles each,
// the accumulators (4 doubles a lane a m16n8 tile) in registers for the
// whole frame loop. The FP64 MMA on Hopper is mma.sync (wgmma has no
// f64): scripts/dmma_shapes.py times m16n8k4, m16n8k8 and m16n8k16 at 98
// % of the 67 TFLOP/s peak, even at 2 warps a sub-partition, and m8n8k4
// at half of it. The kernel takes m16n8k4: its fragments are the fewest
// registers, so two CTAs fit an SM (128 registers a thread, 94 KB of
// shared memory for a float operand at d = 3), and one CTA's barriers and
// conversion pass overlap the other's products; one CTA an SM ran 20-25 %
// slower. Shared memory would bound it next: read afresh for every MMA,
// the B fragments of a warp's 8 tiles would move about the bytes a clock
// that shared memory delivers. Two things lower it. (1) The k-slices of
// one MMA lie kSteps frame rows
// u apart, and a chunk of frames is kSteps consecutive steps, so the B
// fragment of tile m + B at step s is that of tile m at step s + 1 (the
// Hankel shift): a warp keeps a ring of kRing fragments of each residue in
// registers and reads one new fragment a residue a step. (2) Frame rows
// sit in shared memory component-major with kPad doubles of padding every
// kPadEvery rows, so the 16 lanes of a half-warp read 16 distinct bank
// pairs. A float operand is converted once, when a chunk lands: cp.async
// copies it (4 or 8 bytes a value, zero past N) one chunk ahead into a
// landing buffer, and one pass converts it into the double buffer the
// fragments read. A span at first lag l0 needs frames t < N - l0 only, so
// its frame loop stops there; grid y orders the spans, so the long CTAs
// (low lags) start first. The operand's rows of one particle are 12 bytes
// (float, d = 3) at a stride of P d values; neighbouring particles' CTAs
// run together along grid x and share their sectors in L2. After the
// frame loop the warps store C into shared memory and each lag's diagonal
// sum of B elements, / ((N - lag) dfac), is written once. Each element of
// C sums N d / B products, so the sums are shorter than a single running
// sum of N d terms. cuda_lag.py lists this work split (acf_spans,
// acf_tile_columns, acf_frame_rows, ...) and the CPU tests check it.
//
// The einstein mode (einstein_tile_kernel): a kernel that streamed the
// whole operand through L2 once per 16-lag block was held to 30-33 % of
// its bound with a double operand, about 0.5 byte of L2 traffic per FP64
// instruction, more than L2 delivers to 132 SMs. So a CTA takes a
// tile of kTileP = 32 particles (a lane each) x a span of kSpan = 128 lags
// (a warp each kLagBlock of them, a lane a register ring of kLagBlock
// frames), and the frames stream through shared memory, component-major
// ([c][frame][particle], so a warp's 32 reads of a component are 32
// consecutive values): a double-buffered tile of base frames x[i] (32
// frames for a double operand, 64 for a float one: what 227 KB hold at d =
// 3), and a ring of partner rows x[i + lag] that every warp of the CTA
// reads its new window value from. Copies go by cp.async (one 4- or 8-byte
// copy a value, the transposition for free, zero-filled past P) one tile
// ahead of the sums, with one barrier a tile. Each operand value crosses
// L2 about twice per 128 lags, not twice per 16. Each lag sums a tile of kTileF frames into a partial that
// it adds to its running sum (a two-level sum), so the error grows with
// N / kTileF terms, not N. The sums are the reference's (a - b)^2, never
// the cancelling a^2 + b^2 - 2ab. Past the last whole tile at which every
// lag of the span has its partner, the register ring goes on from global
// memory, each lag masked by i + lag < N. cuda_lag.py lists this work
// split (einstein_tiles, ring_slot, ...) and the CPU tests check it.
//
// The float32 work mode's einstein launch is bounded by the FP32 pipe's
// issue: two instructions a pair-component, the subtract and the
// multiply-add, 87.0 ms at 33.5e12 a second for 65,536 frames x 2,048 lags
// at the EC width (the flop bound, 3 flop at 67 TFLOP/s, is 65.3). On
// einstein_tile_kernel's tile of 64 float frames a thread spent 48 4-byte
// cp.async a tile at 41 instructions each (cuobjdump -sass) beside 6,144
// FP32 ones, and one CTA an SM waited at each tile's barrier: 157.6-158.8
// ms on an NVIDIA H100 80GB HBM3 at 700 W. A pipeline of 16-frame stages
// copied a row a cp.async.bulk by warp 0 and synchronized by mbarriers,
// two CTAs an SM, did not help (156.5-164.3 ms: its copies and barriers
// alone took 41.6 ms and its sums with the barriers but no copies 131.5).
// What the design does about it (einstein_rows_kernel, above): the frame
// rows keep the operand's particle-major order, so a tile row is one
// contiguous run copied by 16-byte cp.async (about 6 a thread a 32-frame
// tile), and 32-frame tiles in 102,400 bytes fit two CTAs an SM. Measured
// there (scripts/kernel_times.py, beside the parent commit in one call):
// 126.2-127.2 ms at the deep shape (69 % of the issue ceiling), 33.9 ms
// for the 8,192-lag model shape (parent 41.7). Next: the issue rate of the
// sums themselves: the inner loop issues 1,658 instructions a 16-frame
// chunk, 1,536 of them FP32 (the parent's SASS), so at one a cycle the
// deep launch would take about 94 ms; it runs at about 75 % of that, at
// one CTA an SM as at two.
//
// Launch geometry: grid x walks the particles (one a CTA in the acf mode,
// tiles of kTileP in the einstein mode), grid y the spans of lags, strided
// by gridDim.y past CUDA's y limit of 65,535. Any N >= 1, n_lags in [1, N]
// and P >= 1; sizes and offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLagBlock = 16;

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

__device__ __forceinline__ double fmar(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fmar(float a, float b, float c) {
  return fmaf(a, b, c);
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

// The frames [i0, n - lw) past a warp's staged tiles, for its lags lw + l
// of the lane's particle q < p, each bounded by i + lag < n: the register
// ring w goes on from global memory in chunks of kLagBlock frames (primed
// here when i0 == 0: nothing was staged); then each lag's mean, (acc + the
// tail's partial) / ((n - lag) dfac), lag 0 pinned to 0, is written.
template <typename T, int D, typename W>
__device__ __forceinline__ void einstein_tail(
    const T* __restrict__ x, W* __restrict__ out, int64_t n, int64_t p,
    int64_t n_lags, double dfac, int64_t q, int64_t lw, int64_t i0,
    W (&w)[D][kLagBlock], const double (&acc)[kLagBlock]) {
  const int64_t s = p * D;  // row stride of the operand
  const T* col = x + q * D;
  const int64_t i_end = n - lw;
  if (i0 == 0) {
#pragma unroll
    for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
      for (int c = 0; c < D; ++c)
        w[c][j] = j < i_end ? (W)col[(lw + j) * s + c] : (W)0;
    }
  }
  W part[kLagBlock];
#pragma unroll
  for (int l = 0; l < kLagBlock; ++l) part[l] = 0;
  for (; i0 < i_end; i0 += kLagBlock) {
#pragma unroll
    for (int k = 0; k < kLagBlock; ++k) {
      const int64_t i = i0 + k;
      const int64_t lim = i_end - i;  // lags lw + l, l < lim, pair
      const int64_t jn = i + kLagBlock - 1;  // the new partner, - lw
      W xi[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        w[c][(k + kLagBlock - 1) % kLagBlock] =
            jn < i_end ? (W)col[(lw + jn) * s + c] : (W)0;
        xi[c] = lim > 0 ? (W)col[i * s + c] : (W)0;
      }
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l) {
        if (l < lim) {
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const W diff = xi[c] - w[c][(k + l) % kLagBlock];
            part[l] = fmar(diff, diff, part[l]);
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
          (W)(lag == 0 ? 0.0
                       : (acc[l] + (double)part[l]) /
                             ((double)(n - lag) * dfac));
    }
  }
}

// block (x: tile of kTileP particles, y: spans b of kSpan lags, strided);
// warp w sums lags [b kSpan + w kLagBlock, ... + kLagBlock) of the lane's
// particle p0 + lane. W is the type of the differences, squares and tile
// partials, and of the output: double, or float for the float32 work mode;
// the running sums acc are double either way.
template <typename T, int D, typename W>
__global__ void __launch_bounds__(kThreads, 1)
    einstein_tile_kernel(const T* __restrict__ x, W* __restrict__ out,
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
  for (int64_t b = blockIdx.y; b < nspans; b += gridDim.y) {
    const int64_t l0 = b * kSpan;
    const int64_t lw = l0 + warp * kLagBlock;  // the warp's first lag
    const bool active = lw < n_lags;           // uniform in the warp
    double acc[kLagBlock];
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) acc[l] = 0.0;
    // ring window: x[i + lw + j] of component c in w[c][j % kLagBlock]
    W w[D][kLagBlock];
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
                w[c][j] = (W)ring[(c * kRing + warp * kLagBlock + j + 1) *
                                      kTileP + lane];
            }
          }
          W part[kLagBlock];
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) part[l] = 0;
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
              W xi[D];
#pragma unroll
              for (int c = 0; c < D; ++c) {
                w[c][(k + kLagBlock - 1) % kLagBlock] =
                    (W)xw[(c * kRing + k) * kTileP];
                xi[c] = (W)xb[(c * kTileF + k) * kTileP];
              }
#pragma unroll
              for (int l = 0; l < kLagBlock; ++l) {
#pragma unroll
                for (int c = 0; c < D; ++c) {
                  const W diff = xi[c] - w[c][(k + l) % kLagBlock];
                  part[l] = fmar(diff, diff, part[l]);
                }
              }
            }
          }
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) acc[l] += (double)part[l];
        }
      }
      __syncthreads();  // the next span's copies overwrite the last tile
    }
    if (active && q < p)
      einstein_tail<T, D, W>(x, out, n, p, n_lags, dfac, q, lw,
                             n_tiles * kTileF, w, acc);
  }
}

// The float32 work mode's einstein launch (einstein_rows_kernel):
// einstein_tile_kernel's CTA, ring and barrier a tile, with tiles of
// kRowsF frames and frame rows kept particle-major, as the operand holds
// them: a row slot holds a tile row's kTileP D values, copied by 16-byte
// cp.async of the chunks that hold them, so a row lands delta = its first
// value's offset mod 4 values into its slot (row_pitch's padding takes
// the chunks' edges), and a lane reads values delta + lane D + c (no bank
// conflict for odd D), delta known from the row's frame mod 4 (tiles start
// at frames = 0 mod 4). Lanes past P read values not copied for them (the
// chunks' edges, earlier rows) and store nothing. A CTA takes 102,400
// bytes of shared memory at d = 3 and at most 128 registers a thread, so
// two CTAs share an SM; each lag's float32 partial sums two tiles, 64
// frames, before it is added to the float64 running sum.
constexpr int kRowsF = 2 * kLagBlock;          // frames of a tile
constexpr int kRowsRing = 2 * kRowsF + kSpan;  // partner-row slots
static_assert(kRowsRing % kLagBlock == 0, "a chunk's slots must not wrap");
template <int D>
__host__ __device__ constexpr int row_pitch() {
  return kTileP * D + 4;  // floats of a row slot: a row and its chunks' edges
}
template <int D>
constexpr size_t rows_smem_bytes() {
  return (size_t)(kRowsRing + 2 * kRowsF) * row_pitch<D>() * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Copy frame rows [f0, f0 + count) of particles [p0, p0 + kTileP) into
// row slots of dst (row k at slot (first + k) mod wrap, row_pitch<D>()
// floats apart): the 16-byte chunks that hold a row's values, so the row
// lands delta values into its slot. All threads take part.
template <int D>
__device__ __forceinline__ void copy_rows(const float* __restrict__ x,
                                          float* dst, int64_t f0, int count,
                                          int64_t p, int64_t p0, int first,
                                          int wrap) {
  constexpr int kPitch = row_pitch<D>(), kChunks = kPitch / 4;
  const int64_t v = (p - p0 < kTileP ? p - p0 : kTileP) * D;
  for (int e = threadIdx.x; e < count * kChunks; e += kThreads) {
    const int k = e / kChunks, j = e - k * kChunks;
    const float* row = x + ((f0 + k) * p + p0) * D;
    const uintptr_t src =
        (reinterpret_cast<uintptr_t>(row) & ~(uintptr_t)15) + 16 * j;
    if (src < reinterpret_cast<uintptr_t>(row + v)) {
      int slot = first + k;
      if (slot >= wrap) slot -= wrap;
      cp_async16(dst + slot * kPitch + 4 * j,
                 reinterpret_cast<const void*>(src));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    einstein_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int64_t n, int64_t p, int64_t n_lags,
                         int64_t nspans, double dfac) {
  constexpr int kPitch = row_pitch<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [kRowsRing][kPitch]
  float* base = ring + kRowsRing * kPitch;       // [2][kRowsF][kPitch]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * kTileP;
  const int64_t q = p0 + lane;
  // lane offset of a row's values by its frame mod 4: delta + lane D
  int lo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    lo[r] = (int)(((reinterpret_cast<uintptr_t>(x) >> 2) + p0 * D +
                   (int64_t)r * p * D) &
                  3) +
            lane * D;
  for (int64_t b = blockIdx.y; b < nspans; b += gridDim.y) {
    const int64_t l0 = b * kSpan;
    const int64_t lw = l0 + warp * kLagBlock;  // the warp's first lag
    const bool active = lw < n_lags;           // uniform in the warp
    double acc[kLagBlock];
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) acc[l] = 0.0;
    float w[D][kLagBlock];
    const int64_t n_full = n - l0 - (kSpan - 1);
    const int64_t n_tiles = n_full > 0 ? n_full / kRowsF : 0;
    if (n_tiles > 0) {
      // partner rows r = 0 .. kRowsF + kSpan - 2 (frames l0 + r, slot
      // r + 1) and base tile 0
      copy_rows<D>(x, ring, l0, kRowsF + kSpan - 1, p, p0, 1, kRowsRing);
      copy_rows<D>(x, base, 0, kRowsF, p, p0, 0, kRowsF);
      cp_async_commit();
      float part[kLagBlock];
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l) part[l] = 0.0f;
      for (int64_t t = 0; t < n_tiles; ++t) {
        cp_async_wait_all();  // tile t's copies
        // tile t's rows are in for every thread, and every warp is done
        // with tile t - 1, whose slots the next copies take
        __syncthreads();
        if (t + 1 < n_tiles) {
          const int64_t r = (t + 1) * kRowsF + kSpan - 1;
          copy_rows<D>(x, ring, l0 + r, kRowsF, p, p0,
                       (int)((r + 1) % kRowsRing), kRowsRing);
          copy_rows<D>(x, base + ((t + 1) & 1) * kRowsF * kPitch,
                       (t + 1) * kRowsF, kRowsF, p, p0, 0, kRowsF);
          cp_async_commit();
        }
        if (active) {
          if (t == 0) {
#pragma unroll
            for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
              for (int c = 0; c < D; ++c)
                w[c][j] = ring[(warp * kLagBlock + j + 1) * kPitch +
                               lo[j & 3] + c];
            }
          }
#pragma unroll 1
          for (int kk = 0; kk < kRowsF; kk += kLagBlock) {
            const float* xb = base + ((t & 1) * kRowsF + kk) * kPitch;
            // slot of partner row t kRowsF + kk + k + warp kLagBlock +
            // kLagBlock - 1, frame k of the chunk; that row's frame is
            // k + 3 mod 4
            const float* xw =
                ring + (int)((t * kRowsF + kk + (warp + 1) * kLagBlock) %
                             kRowsRing) *
                           kPitch;
#pragma unroll
            for (int k = 0; k < kLagBlock; ++k) {
              float xi[D];
#pragma unroll
              for (int c = 0; c < D; ++c) {
                w[c][(k + kLagBlock - 1) % kLagBlock] =
                    xw[k * kPitch + lo[(k + 3) & 3] + c];
                xi[c] = xb[k * kPitch + lo[k & 3] + c];
              }
#pragma unroll
              for (int l = 0; l < kLagBlock; ++l) {
#pragma unroll
                for (int c = 0; c < D; ++c) {
                  const float diff = xi[c] - w[c][(k + l) % kLagBlock];
                  part[l] = fmaf(diff, diff, part[l]);
                }
              }
            }
          }
          // a float32 partial of at most two tiles, 64 frames
          if ((t & 1) || t + 1 == n_tiles) {
#pragma unroll
            for (int l = 0; l < kLagBlock; ++l) {
              acc[l] += (double)part[l];
              part[l] = 0.0f;
            }
          }
        }
      }
      __syncthreads();  // the next span's copies overwrite the last tile
    }
    if (active && q < p)
      einstein_tail<float, D, float>(x, out, n, p, n_lags, dfac, q, lw,
                                     n_tiles * kRowsF, w, acc);
  }
}

// The acf mode's CTA: one particle x a span of at most kAcfSpan lags, the
// Gram product C of the header on the FP64 tensor cores (mma.sync
// m16n8k{kMmaK}, M = kRows frame phases p, N = 8 columns m, K = kMmaK
// frame rows u of one component).
constexpr int kRows = 16;                  // B: frame phases p, the MMA's m
constexpr int kMmaK = 4;                   // the MMA's k
constexpr int kSteps = 16;                 // k-slice j of step s: row u = s + j kSteps
constexpr int kChunk = kRows * kMmaK * kSteps;  // frames of a chunk: 1024
constexpr int kAcfWarps = 8;
constexpr int kAcfThreads = 32 * kAcfWarps;
constexpr int kWarpTiles = 8;              // n8 tiles of a warp
constexpr int kRing = kWarpTiles / 2;      // B fragments of a residue held
constexpr int kWarpCols = 8 * kWarpTiles;  // columns m of a warp: 64
constexpr int kAcfCols = kAcfWarps * kWarpCols;   // of a CTA: 512
constexpr int kAcfSpan = kAcfCols - (kRows - 1);  // lags of a CTA: 497
// shared memory: frame row r of a component at smem_row(r), kPad doubles of
// padding every kPadEvery rows, the rows one lane's k-slices lie apart
constexpr int kPadEvery = kRows * kSteps;
constexpr int kPad = 4;
__host__ __device__ constexpr int smem_row(int r) {
  return r + kPad * (r / kPadEvery);
}
constexpr int kARows = kChunk;             // rows x[f0 + r] of a chunk
constexpr int kBRows = kChunk + kAcfCols;  // partner rows x[f0 + l0 + r]
constexpr int kAStride = smem_row(kARows);
constexpr int kBStride = smem_row(kBRows);
constexpr int kCStride = kAcfCols + 8;     // a row of C in shared memory
static_assert(kRing * 2 == kWarpTiles && kRows == 16 && kSteps >= kRing,
              "a warp's tiles are two residues of kRing tiles 16 apart");
static_assert(kWarpCols == 16 * kRing,
              "the ring's last fragment reaches the warp's last column");

template <typename T, int D>
constexpr size_t acf_smem_bytes() {
  const size_t stage = (size_t)D * (kAStride + kBStride) * (sizeof(T) + 8);
  const size_t gram = (size_t)kRows * kCStride * 8;
  return stage > gram ? stage : gram;
}

// d += a b: one m16n8k4 tile, a[h] = A[g + 8 h][t], b[0] = B[t][g],
// d[2 h + j] = C[g + 8 h][2 t + j] (lane = 4 g + t); scripts/dmma_shapes.cu
// checks this layout (and those of k8 and k16, the other kMmaK) on the card
static_assert(kMmaK == 4, "mma_f64 issues m16n8k4");
__device__ __forceinline__ void mma_f64(double (&d)[4],
                                        const double (&a)[kMmaK / 2],
                                        const double (&b)[kMmaK / 4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// Copy chunk f0 of particle q into the landing buffer, component-major:
// rows x[f0 + r] (r < kARows) to land[c kAStride + smem_row(r)], partner
// rows x[f0 + l0 + r] (r < kBRows) to land[D kAStride + c kBStride +
// smem_row(r)]; zeros past frame N.
template <typename T, int D>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ x, T* land,
                                            int64_t f0, int64_t l0,
                                            int64_t n, int64_t p, int64_t q) {
  for (int e = threadIdx.x; e < (kARows + kBRows) * D; e += kAcfThreads) {
    const int row = e / D, c = e - row * D;
    const bool partner = row >= kARows;
    const int r = partner ? row - kARows : row;
    const int64_t frame = f0 + r + (partner ? l0 : 0);
    const bool valid = frame < n;
    const T* src = valid ? x + (frame * p + q) * D + c : x;
    T* dst = land + (partner ? D * kAStride + c * kBStride : c * kAStride) +
             smem_row(r);
    cp_async(dst, src, valid);
  }
}

// One chunk's products into a warp's accumulators: for each component and
// step s, the A fragment (rows 16 (s + j kSteps) + p, k-slice j), one new B
// fragment of each residue e (tiles m = 64 warp + 8 e + 16 i use ring slot
// (s + i) mod kRing, the fragment of tile 64 warp + 8 e at step s + i),
// and the MMAs of the warp's tiles that the span needs. kGroup warps'
// columns fill the rows between two pads, so for warp = kGroup w' + kSub
// every shared-memory offset is kLaneK (t + w') + g plus a compile-time
// constant: no address arithmetic a load.
constexpr int kLaneK = kPadEvery + kPad;  // shared-memory rows between k-slices
constexpr int kGroup = kPadEvery / kWarpCols;
static_assert(kPadEvery % kWarpCols == 0, "warps' columns tile the pads");

template <int D, int kSub>
__device__ __forceinline__ void gram_chunk_at(const double* buf,
                                              double (&acc)[2][kRing][4],
                                              int warp, int g, int t,
                                              int tiles) {
  bool on[2][kRing];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < kRing; ++i)
      on[e][i] = warp * kWarpTiles + e + 2 * i < tiles;
  const double* lane = buf + kLaneK * t + g;
#pragma unroll 1
  for (int c = 0; c < D; ++c) {
    const double* A = lane + c * kAStride;
    const double* B =
        lane + D * kAStride + c * kBStride + kLaneK * (warp / kGroup);
    double ring[2][kRing][kMmaK / 4];
    // fragment of tile 64 warp + 8 e at step v: rows 16 (v + j kSteps) +
    // 64 warp + 8 e + g, k-slice j = t + 4 i
    auto load_b = [&](int e, int v, double (&f)[kMmaK / 4]) {
      const int off = smem_row(kWarpCols * kSub + 16 * v + 8 * e);
#pragma unroll
      for (int i = 0; i < kMmaK / 4; ++i) f[i] = B[off + 4 * i * kLaneK];
    };
#pragma unroll
    for (int v = 0; v < kRing - 1; ++v) {
      load_b(0, v, ring[0][v]);
      load_b(1, v, ring[1][v]);
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      double a[kMmaK / 2];
#pragma unroll
      for (int i = 0; i < kMmaK / 4; ++i) {
        a[2 * i] = A[4 * i * kLaneK + 16 * s];
        a[2 * i + 1] = A[4 * i * kLaneK + 16 * s + 8];
      }
      load_b(0, s + kRing - 1, ring[0][(s + kRing - 1) % kRing]);
      load_b(1, s + kRing - 1, ring[1][(s + kRing - 1) % kRing]);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < kRing; ++i)
          if (on[e][i]) mma_f64(acc[e][i], a, ring[e][(s + i) % kRing]);
    }
  }
}

template <int D, int kSub = 0>
__device__ __forceinline__ void gram_chunk(const double* buf,
                                           double (&acc)[2][kRing][4],
                                           int warp, int g, int t,
                                           int tiles) {
  if constexpr (kSub + 1 < kGroup) {
    if (warp % kGroup != kSub) {
      gram_chunk<D, kSub + 1>(buf, acc, warp, g, t, tiles);
      return;
    }
  }
  gram_chunk_at<D, kSub>(buf, acc, warp, g, t, tiles);
}

// block (x: particle q, y: spans b, strided): lags [b span, (b + 1) span)
// of particle q, span <= kAcfSpan; the float64 sums stored as O.
template <typename T, int D, typename O>
__global__ void __launch_bounds__(kAcfThreads, 2)
    acf_gram_kernel(const T* __restrict__ x, O* __restrict__ out,
                    int64_t n, int64_t p, int64_t n_lags, int64_t nspans,
                    int span, double dfac) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = D * (kAStride + kBStride);
  T* land = reinterpret_cast<T*>(smem);              // [kStage] of T
  double* buf = reinterpret_cast<double*>(smem + (size_t)kStage * sizeof(T));
  double* gram = reinterpret_cast<double*>(smem);    // [kRows][kCStride]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q = blockIdx.x;
  const int tiles = (span + kRows - 1 + 7) / 8;  // n8 tiles the span needs
  for (int64_t b = blockIdx.y; b < nspans; b += gridDim.y) {
    const int64_t l0 = b * span;
    // frames t < N - l0 have a partner for some lag of the span
    const int64_t chunks = (n - l0 + kChunk - 1) / kChunk;
    double acc[2][kRing][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < kRing; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[e][i][v] = 0.0;
    stage_chunk<T, D>(x, land, 0, l0, n, p, q);
    cp_async_commit();
    for (int64_t k = 0; k < chunks; ++k) {
      cp_async_wait_all();
      // chunk k has landed for every thread, and every warp is done with
      // chunk k - 1's doubles
      __syncthreads();
      for (int i = threadIdx.x; i < kStage; i += kAcfThreads)
        buf[i] = (double)land[i];
      __syncthreads();  // the doubles are in; the landing buffer is free
      if (k + 1 < chunks) {
        stage_chunk<T, D>(x, land, (k + 1) * kChunk, l0, n, p, q);
        cp_async_commit();
      }
      if (warp * kWarpTiles < tiles)
        gram_chunk<D>(buf, acc, warp, g, t, tiles);
    }
    __syncthreads();  // every warp is done with buf, which C takes over
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < kRing; ++i) {
        double* dst = gram + g * kCStride + kWarpCols * warp + 8 * e +
                      16 * i + 2 * t;
        *reinterpret_cast<double2*>(dst) =
            make_double2(acc[e][i][0], acc[e][i][1]);
        *reinterpret_cast<double2*>(dst + 8 * kCStride) =
            make_double2(acc[e][i][2], acc[e][i][3]);
      }
    __syncthreads();
    for (int l = threadIdx.x; l < span; l += kAcfThreads) {
      const int64_t lag = l0 + l;
      if (lag < n_lags) {
        double s = 0.0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) s += gram[r * kCStride + l + r];
        out[lag * p + q] = (O)(s / ((double)(n - lag) * dfac));
      }
    }
    __syncthreads();  // the next span's copies overwrite C
  }
}

// ---------------------------------------------------------------------------
// K8's two-block launch (module header, ta_lag_pair): kernels of its own on
// the one-operand launch's helpers.

// The first frame of a block that pairs with some lag whose partner offset
// is at most reach, and the end of the frames that pair with some lag of
// offset at least d0: frame i pairs at offset d iff 0 <= i + d < n.
__host__ __device__ __forceinline__ int64_t pair_lo(int64_t reach) {
  return reach < 0 ? -reach : 0;
}
__host__ __device__ __forceinline__ int64_t pair_hi(int64_t n, int64_t d0) {
  return d0 > 0 ? n - d0 : n;
}

// The y-th span, in launch order, of a two-block launch of nspans spans
// of span lags: the spans in order of their pairs, most first, so that the
// long CTAs start first. Relative lag j pairs n - |j + shift|
// base frames, a tent about j0 = -shift, so a whole span's pairs fall with
// the distance of its centre from j0: the order starts at the whole span
// whose centre lies nearest j0 and takes the whole spans outward, nearer
// side first; a last span shorter than the others comes last.
__host__ __device__ __forceinline__ int64_t pair_span(int64_t y,
                                                      int64_t nspans,
                                                      int64_t shift,
                                                      int64_t n_lags,
                                                      int64_t span) {
  const int64_t whole = n_lags / span;
  if (y >= whole) return y;
  // twice the distance of span b's centre from j0: 2 b span + span - 1 + 2
  // shift; the nearest span rounds it to 0
  const int64_t twice = span - 1 + 2 * shift;  // at b = 0
  int64_t first = (span - twice) / (2 * span);
  first = first < 0 ? 0 : (first >= whole ? whole - 1 : first);
  const bool right = 2 * first * span + twice <= 0;  // the right side nearer
  const int64_t left_n = first, right_n = whole - 1 - first;
  const int64_t m = left_n < right_n ? left_n : right_n;
  if (y == 0) return first;
  if (y <= 2 * m) {
    const int64_t k = (y + 1) / 2;
    return ((y & 1) != 0) == right ? first + k : first - k;
  }
  return right_n > left_n ? first + (y - m) : first - (y - m);
}

// One chunk of kLagBlock frames of a warp's lags dw + l, l < kLagBlock, as
// the one-operand einstein kernels sum them: frame k's base values
// base(k, c), its new partner row's partner(k, c) into the register window
// w. kMasked keeps lag l's term only where the base frame i0 + k < n and
// its partner i0 + k + dw + l lies in [0, n).
template <int D, typename W, bool kMasked, typename Base, typename Partner>
__device__ __forceinline__ void pair_chunk(W (&w)[D][kLagBlock],
                                           W (&part)[kLagBlock],
                                           const Base& base,
                                           const Partner& partner,
                                           int64_t i0, int64_t dw,
                                           int64_t n) {
#pragma unroll
  for (int k = 0; k < kLagBlock; ++k) {
    W xi[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      w[c][(k + kLagBlock - 1) % kLagBlock] = partner(k, c);
      xi[c] = base(k, c);
    }
    int lo = 0, hi = kLagBlock;  // lags l in [lo, hi) have their partner
    if constexpr (kMasked) {
      const int64_t f = i0 + k + dw;  // lag l's partner frame: f + l
      lo = f >= 0 ? 0 : (-f < kLagBlock ? (int)-f : kLagBlock);
      hi = (i0 + k >= n || n - f <= 0) ? 0
                                        : (n - f < kLagBlock ? (int)(n - f)
                                                             : kLagBlock);
    }
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) {
      if (!kMasked || (l >= lo && l < hi)) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const W diff = xi[c] - w[c][(k + l) % kLagBlock];
          part[l] = fmar(diff, diff, part[l]);
        }
      }
    }
  }
}

// ceil(a / b) for b > 0
__device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

// The einstein tiles of a span of the two-block launch at partner offset
// d0 (lag l0 + j pairs base frame i with partner frame i + d0 + j): tiles
// of tile_f frames from i_lo cover every frame that pairs with some lag of
// the span; the warp with first offset dw has a pair in tiles [t_lo, t_hi),
// and the tiles [w_lo, w_hi) of those are whole: every lag of the warp
// has its partner at every frame. The others are masked.
struct PairTiles {
  int64_t i_lo;
  int n_tiles, t_lo, t_hi, w_lo, w_hi;
  __device__ __forceinline__ PairTiles(int64_t n, int64_t d0, int64_t dw,
                                       int tile_f) {
    i_lo = pair_lo(d0 + kSpan - 1);
    const int64_t i_hi = pair_hi(n, d0);
    n_tiles = i_hi > i_lo ? (int)((i_hi - i_lo + tile_f - 1) / tile_f) : 0;
    const int64_t f_lo = pair_lo(dw + kLagBlock - 1), f_hi = pair_hi(n, dw);
    t_lo = (int)((f_lo - i_lo) / tile_f);
    t_hi = f_hi > f_lo ? (int)((f_hi - i_lo + tile_f - 1) / tile_f) : t_lo;
    // whole: t >= (-dw - i_lo) / tile_f, and (t + 1) tile_f + i_lo <= the
    // end of the frames every lag of the warp pairs at
    const int64_t first = ceil_div(-dw - i_lo, tile_f);
    const int64_t end =
        (dw + kLagBlock - 1 > 0 ? n - dw - (kLagBlock - 1) : n) - i_lo;
    w_lo = (int)(first > t_lo ? first : t_lo);
    w_hi = end < tile_f ? w_lo : (int)(end / tile_f);
    if (w_hi > t_hi) w_hi = t_hi;
    if (w_hi < w_lo) w_hi = w_lo;
  }
};

// load_rows with zeros for the frames outside [0, n) too, and each copying
// thread on one column (particle, component) of the rows, kThreads / kRow
// rows a pass, so that a copy costs no division: the copies are issued
// between a tile's barrier and its sums, one CTA an SM.
template <typename T, int D>
__device__ __forceinline__ void load_rows_in(const T* __restrict__ x,
                                               T* dst, int64_t f0, int count,
                                               int64_t n, int64_t p,
                                               int64_t p0, int stride,
                                               int first, int wrap) {
  constexpr int kRow = kTileP * D;
  constexpr int kStep = kThreads / kRow;   // rows a pass
  if (threadIdx.x >= kStep * kRow) return;
  const int rem = threadIdx.x % kRow;
  const int part = rem / D, c = rem - part * D;
  const bool col = p0 + part < p;
  const T* src = x + p0 * D + rem;
  T* d = dst + (int64_t)c * stride * kTileP + part;
  const int64_t pd = p * D;
  for (int k = threadIdx.x / kRow; k < count; k += kStep) {
    const int64_t f = f0 + k;
    const bool valid = col && f >= 0 && f < n;
    int slot = first + k;
    if (slot >= wrap) slot -= wrap;
    cp_async(d + slot * kTileP, valid ? src + f * pd : x, valid);
  }
}

// The two-block launch's einstein kernel for float64 sums. block (x: tile
// of kTileP particles, y: the spans in pair_span's order, strided):
// einstein_tile_kernel's CTA, ring and tiles, base rows from xa and
// partner rows from xb, over the span's whole frame range (PairTiles);
// raw sums / dfac.
template <typename T, int D, typename W>
__global__ void __launch_bounds__(kThreads, 1)
    einstein_pair_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                         W* __restrict__ out, int64_t n, int64_t p,
                         int64_t n_lags, int64_t nspans, int64_t shift,
                         double dfac) {
  constexpr int kTileF = tile_frames<T>();
  constexpr int kRing = ring_rows<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);            // [D][kRing][kTileP]
  T* base = ring + (size_t)D * kRing * kTileP;      // [2][D][kTileF][kTileP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * kTileP;
  const int64_t q = p0 + lane;
  for (int64_t y = blockIdx.y; y < nspans; y += gridDim.y) {
    const int64_t l0 = pair_span(y, nspans, shift, n_lags, kSpan) * kSpan;
    const int64_t lw = l0 + warp * kLagBlock;  // the warp's first lag
    const bool active = lw < n_lags;           // uniform in the warp
    const int64_t d0 = l0 + shift, dw = d0 + warp * kLagBlock;
    const PairTiles tl(n, d0, dw, kTileF);
    double acc[kLagBlock];
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) acc[l] = 0.0;
    // ring window: xb[i + dw + j] of component c in w[c][j % kLagBlock]
    W w[D][kLagBlock];
    if (tl.n_tiles > 0) {
      // partner row r is frame d0 + i_lo + r of xb, base row r frame i_lo
      // + r of xa: rows r = 0 .. kTileF + kSpan - 2 and base tile 0
      load_rows_in<T, D>(xb, ring, d0 + tl.i_lo, kTileF + kSpan - 1, n, p,
                         p0, kRing, 1, kRing);
      load_rows_in<T, D>(xa, base, tl.i_lo, kTileF, n, p, p0, kTileF, 0,
                         kTileF);
      cp_async_commit();
      for (int t = 0; t < tl.n_tiles; ++t) {
        cp_async_wait_all();  // tile t's copies
        // tile t's rows are in for every thread, and every warp is done
        // with tile t - 1, whose slots the next copies take
        __syncthreads();
        if (t + 1 < tl.n_tiles) {
          const int64_t r = (t + 1) * kTileF + kSpan - 1;
          load_rows_in<T, D>(xb, ring, d0 + tl.i_lo + r, kTileF, n, p, p0,
                             kRing, (int)((r + 1) % kRing), kRing);
          load_rows_in<T, D>(xa, base + (size_t)((t + 1) & 1) * D * kTileF *
                                           kTileP,
                             tl.i_lo + (t + 1) * kTileF, kTileF, n, p, p0,
                             kTileF, 0, kTileF);
          cp_async_commit();
        }
        if (active && t >= tl.t_lo && t < tl.t_hi) {
          if (t == tl.t_lo) {
            // the warp's first tile: its window, partner rows t kTileF +
            // warp kLagBlock + j, j < kLagBlock - 1
            const int s0 = (int)((t * kTileF + warp * kLagBlock + 1) % kRing);
#pragma unroll
            for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
              for (int c = 0; c < D; ++c)
                w[c][j] = (W)ring[(c * kRing + s0 + j) * kTileP + lane];
            }
          }
          W part[kLagBlock];
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) part[l] = 0;
          const int64_t i0 = tl.i_lo + (int64_t)t * kTileF;
          const T* xt = base + (size_t)(t & 1) * D * kTileF * kTileP + lane;
          // slot of partner row t kTileF + kk + k + warp kLagBlock +
          // kLagBlock - 1, frame k of chunk kk
          const int sw = (t * kTileF + (warp + 1) * kLagBlock) % kRing;
          // whole tiles and masked ones in loops of their own
          const auto sum = [&](auto masked) {
#pragma unroll 1
            for (int kk = 0; kk < kTileF; kk += kLagBlock) {
              const T* xk = xt + kk * kTileP;
              const T* xw = ring + ((sw + kk) % kRing) * kTileP + lane;
              pair_chunk<D, W, decltype(masked)::value>(
                  w, part,
                  [&](int k, int c) {
                    return (W)xk[(c * kTileF + k) * kTileP];
                  },
                  [&](int k, int c) {
                    return (W)xw[(c * kRing + k) * kTileP];
                  },
                  i0 + kk, dw, n);
            }
          };
          if (t >= tl.w_lo && t < tl.w_hi)
            sum(std::false_type());
          else
            sum(std::true_type());
#pragma unroll
          for (int l = 0; l < kLagBlock; ++l) acc[l] += (double)part[l];
        }
      }
      __syncthreads();  // the next span's copies overwrite the last tile
    }
    if (active && q < p) {
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l)
        if (lw + l < n_lags) out[(lw + l) * p + q] = (W)(acc[l] / dfac);
    }
  }
}

__device__ __forceinline__ void cp_async16_zero(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(0)
               : "memory");
}

// copy_rows with the frames outside [0, n) zero-filled, their whole slot.
template <int D>
__device__ __forceinline__ void copy_rows_in(const float* __restrict__ x,
                                             float* dst, int64_t f0,
                                             int count, int64_t n, int64_t p,
                                             int64_t p0, int first,
                                             int wrap) {
  constexpr int kPitch = row_pitch<D>(), kChunks = kPitch / 4;
  const int64_t v = (p - p0 < kTileP ? p - p0 : kTileP) * D;
  for (int e = threadIdx.x; e < count * kChunks; e += kThreads) {
    const int k = e / kChunks, j = e - k * kChunks;
    const int64_t f = f0 + k;
    int slot = first + k;
    if (slot >= wrap) slot -= wrap;
    float* to = dst + slot * kPitch + 4 * j;
    if (f < 0 || f >= n) {
      cp_async16_zero(to, x);
    } else {
      const float* row = x + (f * p + p0) * D;
      const uintptr_t src =
          (reinterpret_cast<uintptr_t>(row) & ~(uintptr_t)15) + 16 * j;
      if (src < reinterpret_cast<uintptr_t>(row + v))
        cp_async16(to, reinterpret_cast<const void*>(src));
    }
  }
}

// lane offset delta + lane D of the values of frame row f of particles
// [p0, p0 + kTileP) of a float operand at x
template <int D>
__device__ __forceinline__ int row_lane(const float* x, int64_t f, int64_t p,
                                        int64_t p0, int lane) {
  return (int)(((reinterpret_cast<uintptr_t>(x) >> 2) + (f * p + p0) * D) &
               3) +
         lane * D;
}

// The two-block launch's einstein kernel for float32 sums: einstein_rows_
// kernel's CTA and particle-major row slots over the span's whole frame
// range (PairTiles), one CTA an SM: at 128 registers (two CTAs) its window,
// partials and float64 running sums spill; a warp's float32 partial sums
// at most two of its tiles, 64 frames, before it joins the float64 running
// sum; raw sums / dfac.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    einstein_pair_rows_kernel(const float* __restrict__ xa,
                              const float* __restrict__ xb,
                              float* __restrict__ out, int64_t n, int64_t p,
                              int64_t n_lags, int64_t nspans, int64_t shift,
                              double dfac) {
  constexpr int kPitch = row_pitch<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [kRowsRing][kPitch]
  float* base = ring + kRowsRing * kPitch;       // [2][kRowsF][kPitch]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * kTileP;
  const int64_t q = p0 + lane;
  for (int64_t y = blockIdx.y; y < nspans; y += gridDim.y) {
    const int64_t l0 = pair_span(y, nspans, shift, n_lags, kSpan) * kSpan;
    const int64_t lw = l0 + warp * kLagBlock;  // the warp's first lag
    const bool active = lw < n_lags;           // uniform in the warp
    const int64_t d0 = l0 + shift, dw = d0 + warp * kLagBlock;
    const PairTiles tl(n, d0, dw, kRowsF);
    double acc[kLagBlock];
#pragma unroll
    for (int l = 0; l < kLagBlock; ++l) acc[l] = 0.0;
    float w[D][kLagBlock];
    if (tl.n_tiles > 0) {
      // partner row r is frame d0 + i_lo + r of xb (slot r + 1), base row
      // r frame i_lo + r of xa; la (base) and lb (partner) are the lane
      // offsets of rows r = 0 .. 3 mod 4
      int la[4], lb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        la[r] = row_lane<D>(xa, tl.i_lo + r, p, p0, lane);
        lb[r] = row_lane<D>(xb, d0 + tl.i_lo + r, p, p0, lane);
      }
      copy_rows_in<D>(xb, ring, d0 + tl.i_lo, kRowsF + kSpan - 1, n, p, p0, 1,
                   kRowsRing);
      copy_rows_in<D>(xa, base, tl.i_lo, kRowsF, n, p, p0, 0, kRowsF);
      cp_async_commit();
      float part[kLagBlock];
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l) part[l] = 0.0f;
      for (int t = 0; t < tl.n_tiles; ++t) {
        cp_async_wait_all();  // tile t's copies
        // tile t's rows are in for every thread, and every warp is done
        // with tile t - 1, whose slots the next copies take
        __syncthreads();
        if (t + 1 < tl.n_tiles) {
          const int64_t r = (t + 1) * kRowsF + kSpan - 1;
          copy_rows_in<D>(xb, ring, d0 + tl.i_lo + r, kRowsF, n, p, p0,
                       (int)((r + 1) % kRowsRing), kRowsRing);
          copy_rows_in<D>(xa, base + ((t + 1) & 1) * kRowsF * kPitch,
                       tl.i_lo + (t + 1) * kRowsF, kRowsF, n, p, p0, 0,
                       kRowsF);
          cp_async_commit();
        }
        if (active && t >= tl.t_lo && t < tl.t_hi) {
          if (t == tl.t_lo) {
            // the warp's first tile: its window, partner rows t kRowsF +
            // warp kLagBlock + j (frame j mod 4), j < kLagBlock - 1
            const int s0 =
                (int)((t * kRowsF + warp * kLagBlock + 1) % kRowsRing);
#pragma unroll
            for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
              for (int c = 0; c < D; ++c)
                w[c][j] = ring[(s0 + j) * kPitch + lb[j & 3] + c];
            }
          }
          const int64_t i0 = tl.i_lo + (int64_t)t * kRowsF;
          const float* xt = base + (t & 1) * kRowsF * kPitch;
          // slot of partner row t kRowsF + kk + k + warp kLagBlock +
          // kLagBlock - 1, frame k of chunk kk; that row is k + 3 mod 4
          const int sw = (t * kRowsF + (warp + 1) * kLagBlock) % kRowsRing;
          // whole tiles and masked ones in loops of their own
          const auto sum = [&](auto masked) {
#pragma unroll 1
            for (int kk = 0; kk < kRowsF; kk += kLagBlock) {
              const float* xk = xt + kk * kPitch;
              const float* xw = ring + ((sw + kk) % kRowsRing) * kPitch;
              pair_chunk<D, float, decltype(masked)::value>(
                  w, part,
                  [&](int k, int c) { return xk[k * kPitch + la[k & 3] + c]; },
                  [&](int k, int c) {
                    return xw[k * kPitch + lb[(k + 3) & 3] + c];
                  },
                  i0 + kk, dw, n);
            }
          };
          if (t >= tl.w_lo && t < tl.w_hi)
            sum(std::false_type());
          else
            sum(std::true_type());
          // a float32 partial of at most two of the warp's tiles, 64 frames
          if (((t - tl.t_lo) & 1) || t + 1 == tl.t_hi) {
#pragma unroll
            for (int l = 0; l < kLagBlock; ++l) {
              acc[l] += (double)part[l];
              part[l] = 0.0f;
            }
          }
        }
      }
      __syncthreads();  // the next tile of particles' copies overwrite it
    }
    if (active && q < p) {
#pragma unroll
      for (int l = 0; l < kLagBlock; ++l)
        if (lw + l < n_lags) out[(lw + l) * p + q] = (float)(acc[l] / dfac);
    }
  }
}

// The two-block launch's acf layout (acf_pair_kernel): chunks of kPairChunk
// base frames in kPairSteps = kRing steps, the fewest the Hankel ring
// allows; k-slices kPairPadEvery rows apart. Rows stay in the operand's
// type T in shared memory, with pair_pad<T>() values of padding every
// kPairPadEvery rows (pair_row), so that the lanes of a fragment read
// distinct banks (a half-warp's 16 8-byte words, a warp's 32 4-byte
// ones), and a fragment is converted to double as it is read. Partner
// rows R of a span (frame f_lo + d0 + R of xb) sit in a ring of
// kPairGroups groups of kPairChunk rows: group R / kPairChunk in slot
// group (R / kPairChunk) mod kPairGroups. A chunk reads three groups; the
// fourth is copied meanwhile.
constexpr int kPairSteps = kRing;
constexpr int kPairChunk = kRows * kMmaK * kPairSteps;   // 256
constexpr int kPairPadEvery = kRows * kPairSteps;        // 64
constexpr int kPairGroups = 4;
// blocks of kPairPadEvery rows in the ring and in a chunk
constexpr int kPairBlocks = kPairGroups * kPairChunk / kPairPadEvery;
constexpr int kPairChunkBlocks = kPairChunk / kPairPadEvery;
template <typename T>
__host__ __device__ constexpr int pair_pad() {
  return sizeof(T) == 8 ? 4 : 8;
}
template <typename T>
__host__ __device__ constexpr int pair_row(int r) {
  return r + pair_pad<T>() * (r / kPairPadEvery);
}
template <typename T>
__host__ __device__ constexpr int pair_lane_k() {  // rows between k-slices
  return kPairPadEvery + pair_pad<T>();
}
// a tile's partner rows in a chunk, past its first column: 16 u + n, u <
// kPairChunk / kRows, n < 8
constexpr int kPairReach = kPairChunk - kRows + 7;
static_assert(kPairPadEvery == kWarpCols,
              "a warp's columns fill the rows between two pads");
static_assert(kRows * (kPairSteps + kRing - 2 + (kMmaK - 1) * kPairSteps) +
                      (kAcfWarps - 1) * kWarpCols + 16 <=
                  (kPairGroups - 1) * kPairChunk,
              "a chunk reads three partner groups, the fourth is in flight");

template <typename T, int D>
constexpr size_t acf_pair_smem_bytes() {
  // the ring and two buffers of base rows, in T; the Gram rows after
  const size_t rows =
      (size_t)D * (kPairGroups + 2) * pair_row<T>(kPairChunk) * sizeof(T);
  const size_t gram = (size_t)kRows * kCStride * 8;
  return rows > gram ? rows : gram;
}

// Copy rows [f0, f0 + rows) of particle q of x to dst[c stride +
// pair_row(r)], zeros for the frames outside [0, n).
template <typename T, int D>
__device__ __forceinline__ void pair_copy(const T* __restrict__ x, T* dst,
                                          int64_t f0, int rows, int64_t n,
                                          int64_t p, int64_t q, int stride) {
  // each thread on one component, kAcfThreads / D rows a pass
  constexpr int kStep = kAcfThreads / D;
  if (threadIdx.x >= kStep * D) return;
  const int c = threadIdx.x % D;
  const T* src = x + q * D + c;
  T* to = dst + c * stride;
  const int64_t pd = p * D;
  for (int r = threadIdx.x / D; r < rows; r += kStep) {
    const int64_t f = f0 + r;
    const bool valid = f >= 0 && f < n;
    cp_async(to + pair_row<T>(r), valid ? src + f * pd : x, valid);
  }
}

// One chunk's products of the two-block acf launch into a warp's
// accumulators: gram_chunk_at's steps, kPairSteps of them. The A fragment
// at step s: rows 16 (s + 4 t) + g (+ 8) of the chunk, at a[lane_k t + g
// + 16 s]; the B fragment of tile 64 warp + 8 e at step v: partner rows
// 16 (v + 4 t) + 64 warp + 8 e + g of the chunk, in ring block cb (rows 64
// (t + warp) on, 16 v + 8 e < 64) or the next; tile (e, i) runs where bit
// e + 2 i of live is set.
template <typename T, int D>
__device__ __forceinline__ void gram_pair_chunk(const T* a, const T* ring,
                                                double (&acc)[2][kRing][4],
                                                unsigned live, int g, int t,
                                                int cb) {
  constexpr int kLaneK = pair_lane_k<T>();
  constexpr int kAStride = pair_row<T>(kPairChunk);
  constexpr int kBStride = kPairGroups * kAStride;
  const T* a0 = a + kLaneK * t + g;
  const T* r0 = ring + kLaneK * cb + g;
  const T* r1 = ring + kLaneK * ((cb + 1) % kPairBlocks) + g;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const T* A = a0 + c * kAStride;
    const T* B0 = r0 + c * kBStride;
    const T* B1 = r1 + c * kBStride;
    double frag[2][kRing][kMmaK / 4];
    auto load_b = [&](int e, int v, double (&f)[kMmaK / 4]) {
      const int off = 16 * v + 8 * e;
      f[0] = (double)(off < kPairPadEvery ? B0[off] : B1[off - kPairPadEvery]);
    };
#pragma unroll
    for (int v = 0; v < kRing - 1; ++v) {
      load_b(0, v, frag[0][v]);
      load_b(1, v, frag[1][v]);
    }
#pragma unroll
    for (int s = 0; s < kPairSteps; ++s) {
      const double av[kMmaK / 2] = {(double)A[16 * s], (double)A[16 * s + 8]};
      load_b(0, s + kRing - 1, frag[0][(s + kRing - 1) % kRing]);
      load_b(1, s + kRing - 1, frag[1][(s + kRing - 1) % kRing]);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < kRing; ++i)
          if ((live >> (e + 2 * i)) & 1u)
            mma_f64(acc[e][i], av, frag[e][(s + i) % kRing]);
    }
  }
}

// The two-block launch's acf kernel. block (x: the spans in pair_span's
// order, y: particles q, strided): relative lags [l0, l0 + span) of q, span <=
// kAcfSpan, the Gram product of acf_gram_kernel over the base frames [f_lo,
// f_end) that pair with some lag of the span, in chunks of kPairChunk; raw
// sums / dfac stored as O.
template <typename T, int D, typename O>
__global__ void __launch_bounds__(kAcfThreads, 2)
    acf_pair_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                    O* __restrict__ out, int64_t n, int64_t p, int64_t n_lags,
                    int64_t nspans, int span, int64_t shift, double dfac) {
  constexpr int kAStride = pair_row<T>(kPairChunk);
  constexpr int kGroupRows = kAStride;          // slots of a partner group
  constexpr int kBStride = kPairGroups * kGroupRows;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);         // [D][kBStride]
  T* abuf = ring + D * kBStride;                // [2][D][kAStride]
  double* gram = reinterpret_cast<double*>(smem);  // [kRows][kCStride]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t l0 = pair_span(blockIdx.x, nspans, shift, n_lags, span) * span;
  const int64_t d0 = l0 + shift;
  const int lags = n_lags - l0 < span ? (int)(n_lags - l0) : span;
  const int tiles = (lags + kRows - 1 + 7) / 8;
  for (int64_t q = blockIdx.y; q < p; q += gridDim.y) {
    // base frames [f_lo, f_end) pair with some lag of the span; base row r
    // of chunk s is frame f_lo + s kPairChunk + r of xa, partner row R of
    // the span frame fb + R of xb
    const int64_t f_lo = pair_lo(d0 + span - 1), f_end = pair_hi(n, d0);
    const int64_t fb = f_lo + d0;
    const int chunks =
        f_end > f_lo ? (int)((f_end - f_lo + kPairChunk - 1) / kPairChunk)
                     : 0;
    double acc[2][kRing][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < kRing; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[e][i][v] = 0.0;
    // the copies of chunk k: its base rows, and partner group k + 2 (with
    // chunk 0 groups 0, 1, 2), into the slots chunk k - 2 held
    const auto stage = [&](int k) {
      pair_copy<T, D>(xa, abuf + (k & 1) * D * kAStride,
                      f_lo + (int64_t)k * kPairChunk, kPairChunk, n, p, q,
                      kAStride);
      const int g0 = k == 0 ? 0 : k + 2;
      pair_copy<T, D>(xb, ring + (g0 % kPairGroups) * kGroupRows,
                      fb + (int64_t)g0 * kPairChunk,
                      (k == 0 ? 3 : 1) * kPairChunk, n, p, q, kBStride);
      cp_async_commit();
    };
    if (chunks > 0) stage(0);
    for (int s = 0; s < chunks; ++s) {
      cp_async_wait_all();
      // chunk s's rows are in for every thread, and every warp is done
      // with chunk s - 1; chunk s + 1's copies land while s is summed
      __syncthreads();
      if (s + 1 < chunks) stage(s + 1);
      // the warp's tiles m = 64 warp + 8 e + 16 i that the span needs and
      // whose partner rows in this chunk, frames fm + [0, kPairReach] with
      // fm = f_lo + s kPairChunk + d0 + m, meet the block
      const int64_t fw = fb + (int64_t)s * kPairChunk + kWarpCols * warp;
      unsigned live = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < kRing; ++i) {
          const int64_t fm = fw + 8 * e + 16 * i;
          if (warp * kWarpTiles + e + 2 * i < tiles && fm + kPairReach >= 0 &&
              fm < n)
            live |= 1u << (e + 2 * i);
        }
      if (live)
        gram_pair_chunk<T, D>(abuf + (s & 1) * D * kAStride, ring, acc, live,
                              g, t,
                              (s * kPairChunkBlocks + t + warp) % kPairBlocks);
    }
    __syncthreads();  // every warp is done with the buffers, which C takes
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < kRing; ++i) {
        double* dst = gram + g * kCStride + kWarpCols * warp + 8 * e +
                      16 * i + 2 * t;
        *reinterpret_cast<double2*>(dst) =
            make_double2(acc[e][i][0], acc[e][i][1]);
        *reinterpret_cast<double2*>(dst + 8 * kCStride) =
            make_double2(acc[e][i][2], acc[e][i][3]);
      }
    __syncthreads();
    for (int l = threadIdx.x; l < span; l += kAcfThreads) {
      const int64_t lag = l0 + l;
      if (lag < n_lags) {
        double sum = 0.0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) sum += gram[r * kCStride + l + r];
        out[lag * p + q] = (O)(sum / dfac);
      }
    }
    __syncthreads();  // the next span's copies overwrite C
  }
}

template <typename K>
cudaError_t pair_smem(K kernel, size_t smem) {
  // all of the SM's shared memory for the launch's CTAs
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, int D, typename O>
int launch_pair(const void* xa, const void* xb, int64_t shift, void* out,
                int64_t n, int64_t p, int64_t n_lags, bool einstein,
                double dfac, int64_t lag_block, dim3 grid, unsigned cols,
                cudaStream_t stream) {
  if (einstein) {
    const int64_t nspans = (n_lags + kSpan - 1) / kSpan;
    if constexpr (sizeof(T) == 4) {
      constexpr size_t smem = rows_smem_bytes<D>();
      const cudaError_t err = pair_smem(einstein_pair_rows_kernel<D>, smem);
      if (err != cudaSuccess) return (int)err;
      einstein_pair_rows_kernel<D><<<grid, cols, smem, stream>>>(
          (const float*)xa, (const float*)xb, (float*)out, n, p, n_lags,
          nspans, shift, dfac);
    } else {
      constexpr size_t smem = tile_smem_bytes<T, D>();
      const cudaError_t err = pair_smem(einstein_pair_kernel<T, D, O>, smem);
      if (err != cudaSuccess) return (int)err;
      einstein_pair_kernel<T, D, O><<<grid, cols, smem, stream>>>(
          (const T*)xa, (const T*)xb, (O*)out, n, p, n_lags, nspans, shift,
          dfac);
    }
  } else {
    constexpr size_t smem = acf_pair_smem_bytes<T, D>();
    const cudaError_t err = pair_smem(acf_pair_kernel<T, D, O>, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t nspans = (n_lags + lag_block - 1) / lag_block;
    acf_pair_kernel<T, D, O><<<grid, cols, smem, stream>>>(
        (const T*)xa, (const T*)xb, (O*)out, n, p, n_lags, nspans,
        (int)lag_block, shift, dfac);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_pair_d(const void* xa, const void* xb, int64_t shift, void* out,
                  int64_t n, int64_t p, int64_t d, int64_t n_lags,
                  bool einstein, double dfac, int64_t lag_block, dim3 grid,
                  unsigned cols, cudaStream_t stream) {
  if (d == 1) return launch_pair<T, 1, O>(xa, xb, shift, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
  if (d == 2) return launch_pair<T, 2, O>(xa, xb, shift, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
  return launch_pair<T, 3, O>(xa, xb, shift, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
}

template <typename T, int D, typename O>
int launch(const void* x, void* out, int64_t n, int64_t p, int64_t n_lags,
           bool einstein, double dfac, int64_t lag_block, dim3 grid,
           unsigned cols, cudaStream_t stream) {
  if (einstein) {
    const int64_t nspans = (n_lags + kSpan - 1) / kSpan;
    if constexpr (sizeof(T) == 4 && sizeof(O) == 4) {
      // the float32 work mode's einstein launch: all of the SM's shared
      // memory, so that two CTAs fit
      constexpr size_t smem = rows_smem_bytes<D>();
      cudaError_t err = cudaFuncSetAttribute(
          einstein_rows_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            einstein_rows_kernel<D>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
      einstein_rows_kernel<D><<<grid, cols, smem, stream>>>(
          (const float*)x, (float*)out, n, p, n_lags, nspans, dfac);
    } else {
      constexpr size_t smem = tile_smem_bytes<T, D>();
      const cudaError_t err = cudaFuncSetAttribute(
          einstein_tile_kernel<T, D, O>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      einstein_tile_kernel<T, D, O><<<grid, cols, smem, stream>>>(
          (const T*)x, (O*)out, n, p, n_lags, nspans, dfac);
    }
  } else {
    constexpr size_t smem = acf_smem_bytes<T, D>();
    const cudaError_t err = cudaFuncSetAttribute(
        acf_gram_kernel<T, D, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t nspans = (n_lags + lag_block - 1) / lag_block;
    acf_gram_kernel<T, D, O><<<grid, cols, smem, stream>>>(
        (const T*)x, (O*)out, n, p, n_lags, nspans, (int)lag_block, dfac);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_d(const void* x, void* out, int64_t n, int64_t p, int64_t d,
             int64_t n_lags, bool einstein, double dfac, int64_t lag_block,
             dim3 grid, unsigned cols, cudaStream_t stream) {
  if (d == 1) return launch<T, 1, O>(x, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
  if (d == 2) return launch<T, 2, O>(x, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
  return launch<T, 3, O>(x, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
}

// The launch geometry cuda_lag.py hands a C entry: what the kernels take.
// One operand takes n_lags <= n; the two-block launch any n_lags >= 1.
bool lag_geometry(int64_t n, int64_t p, int64_t d, int64_t n_lags,
                  int64_t einstein, int64_t lag_block, int64_t cols,
                  int64_t grid_x, bool pair = false) {
  // grid x: particles (acf; the two-block launch's spans), or tiles of
  // kTileP particles (einstein)
  const bool geometry =
      einstein ? lag_block == kSpan && cols == kThreads &&
                     grid_x == (p + kTileP - 1) / kTileP
               : lag_block >= 1 && lag_block <= kAcfSpan &&
                     cols == kAcfThreads &&
                     grid_x == (pair ? (n_lags + lag_block - 1) / lag_block
                                     : p);
  return geometry && d >= 1 && d <= 3 && n_lags >= 1 && n >= 1 &&
         (pair || n_lags <= n);
}

}  // namespace

extern "C" {

// x (n, p, d) float32 (f64 == 0) or float64 -> out (n_lags, p) float64, on
// a (grid_x, grid_y) grid of blocks of `cols` threads; all from
// cuda_lag.py, whose constants must be this file's. acf: one particle a
// block of kAcfThreads, grid y over the ceil(n_lags / lag_block) spans,
// lag_block <= kAcfSpan; einstein: kTileP particles a block of kThreads,
// grid y over the ceil(n_lags / lag_block) spans, lag_block = kSpan.
int ta_lag_sums(const void* x, void* out, int64_t n, int64_t p, int64_t d,
                int64_t n_lags, int64_t f64, int64_t einstein, double dfac,
                int64_t lag_block, int64_t cols, int64_t grid_x,
                int64_t grid_y, void* stream) {
  if (!lag_geometry(n, p, d, n_lags, einstein, lag_block, cols, grid_x))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return launch_d<double, double>(x, out, n, p, d, n_lags, einstein != 0,
                                    dfac, lag_block, grid, (unsigned)cols, st);
  return launch_d<float, double>(x, out, n, p, d, n_lags, einstein != 0, dfac,
                                 lag_block, grid, (unsigned)cols, st);
}

// The float32 work mode's instantiation: x float32 (f64 must be 0) -> out
// (n_lags, p) float32; the arguments are ta_lag_sums'.
int ta_lag_sums_f32(const void* x, void* out, int64_t n, int64_t p,
                    int64_t d, int64_t n_lags, int64_t f64, int64_t einstein,
                    double dfac, int64_t lag_block, int64_t cols,
                    int64_t grid_x, int64_t grid_y, void* stream) {
  if (f64 || !lag_geometry(n, p, d, n_lags, einstein, lag_block, cols, grid_x))
    return (int)cudaErrorInvalidValue;
  return launch_d<float, float>(x, out, n, p, d, n_lags, einstein != 0, dfac,
                                lag_block, dim3((unsigned)grid_x,
                                                (unsigned)grid_y),
                                (unsigned)cols, (cudaStream_t)stream);
}

// The two-block launch: xa, xb (n, p, d) float64 (f64 must be 1) -> out
// (n_lags, p) float64, out[j, q] the raw sums over frames a, b < n with
// b - a = j + shift, by mode, / dfac; the other arguments are
// ta_lag_sums'.
int ta_lag_pair(const void* xa, const void* xb, void* out, int64_t n,
                int64_t p, int64_t d, int64_t n_lags, int64_t shift,
                int64_t f64, int64_t einstein, double dfac, int64_t lag_block,
                int64_t cols, int64_t grid_x, int64_t grid_y, void* stream) {
  if (!f64 ||
      !lag_geometry(n, p, d, n_lags, einstein, lag_block, cols, grid_x, true))
    return (int)cudaErrorInvalidValue;
  return launch_pair_d<double, double>(
      xa, xb, shift, out, n, p, d, n_lags, einstein != 0, dfac, lag_block,
      dim3((unsigned)grid_x, (unsigned)grid_y), (unsigned)cols,
      (cudaStream_t)stream);
}

// The float32 work mode's two-block launch: xa, xb float32 (f64 must be 0)
// -> out (n_lags, p) float32; the arguments are ta_lag_pair's.
int ta_lag_pair_f32(const void* xa, const void* xb, void* out, int64_t n,
                    int64_t p, int64_t d, int64_t n_lags, int64_t shift,
                    int64_t f64, int64_t einstein, double dfac,
                    int64_t lag_block, int64_t cols, int64_t grid_x,
                    int64_t grid_y, void* stream) {
  if (f64 ||
      !lag_geometry(n, p, d, n_lags, einstein, lag_block, cols, grid_x, true))
    return (int)cudaErrorInvalidValue;
  return launch_pair_d<float, float>(
      xa, xb, shift, out, n, p, d, n_lags, einstein != 0, dfac, lag_block,
      dim3((unsigned)grid_x, (unsigned)grid_y), (unsigned)cols,
      (cudaStream_t)stream);
}

}  // extern "C"
