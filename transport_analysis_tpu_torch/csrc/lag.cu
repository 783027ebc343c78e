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
//     ring.py:35-76, a loop over 2L - 1 shifts); here they are K8's two
//     kernels under the compile-time flag kPair: the acf Gram product reads
//     its partner rows from xb (zero outside the block) and runs its frame
//     loop only over the frames that pair with some lag of its span; the
//     einstein kernels stage base rows from xa and partner rows from xb for
//     the frames at which every lag of the span has its partner, and sum the
//     frames before and after them (a warp's partial lags) from global
//     memory, each pair masked (pair_end). The one-operand launches keep
//     their code (kPair = false) and their times. At the ring's round 1 of
//     the EC model system (blocks of 2,048 frames) a CTA's frame loop is
//     two acf chunks, so the fixed costs of a span weigh more than in the
//     one-operand launch over 65,536 frames (PERF.md section 6).
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

// The two-block launch's frames [i0, i1) of a warp whose lags l <
// kLagBlock pair base frame xa[i] with partner xb[i + dw + l]: the terms of
// the pairs with 0 <= i + dw + l < n are added to part. The register ring w
// goes on from global memory and is primed here; i1 <= n.
template <typename T, int D, typename W>
__device__ __forceinline__ void pair_frames(
    const T* __restrict__ xa, const T* __restrict__ xb, int64_t n, int64_t p,
    int64_t q, int64_t dw, int64_t i0, int64_t i1, W (&w)[D][kLagBlock],
    W (&part)[kLagBlock]) {
  const int64_t s = p * D;  // row stride of the operands
  const T* ca = xa + q * D;
  const T* cb = xb + q * D;
#pragma unroll
  for (int j = 0; j < kLagBlock - 1; ++j) {
    const int64_t f = i0 + dw + j;
#pragma unroll
    for (int c = 0; c < D; ++c)
      w[c][j] = (f >= 0 && f < n) ? (W)cb[f * s + c] : (W)0;
  }
  for (; i0 < i1; i0 += kLagBlock) {
#pragma unroll
    for (int k = 0; k < kLagBlock; ++k) {
      const int64_t i = i0 + k;
      const int64_t f = i + dw + kLagBlock - 1;  // the new partner
      // lags l in [lo, hi) have a partner in [0, n)
      const int64_t lo = -(i + dw), hi = n - (i + dw);
      W xi[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        w[c][(k + kLagBlock - 1) % kLagBlock] =
            (f >= 0 && f < n) ? (W)cb[f * s + c] : (W)0;
        xi[c] = i < i1 ? (W)ca[i * s + c] : (W)0;
      }
      if (i < i1) {
#pragma unroll
        for (int l = 0; l < kLagBlock; ++l) {
          if (l >= lo && l < hi) {
#pragma unroll
            for (int c = 0; c < D; ++c) {
              const W diff = xi[c] - w[c][(k + l) % kLagBlock];
              part[l] = fmar(diff, diff, part[l]);
            }
          }
        }
      }
    }
  }
}

// The two-block launch's end of a warp (kPair): the frames of its lags
// outside the span's tiles, before them ([max(0, -(dw + kLagBlock - 1)),
// i_lo)) and after them ([i_tail, min(n, n - dw))), then each lag's raw sum
// (acc + the partials) / dfac, for relative lags lw + l < n_lags.
template <typename T, int D, typename W>
__device__ __forceinline__ void pair_end(
    const T* __restrict__ xa, const T* __restrict__ xb, W* __restrict__ out,
    int64_t n, int64_t p, int64_t n_lags, double dfac, int64_t q, int64_t lw,
    int64_t dw, int64_t i_lo, int64_t i_tail, W (&w)[D][kLagBlock],
    const double (&acc)[kLagBlock]) {
  W head[kLagBlock], tail[kLagBlock];
#pragma unroll
  for (int l = 0; l < kLagBlock; ++l) head[l] = tail[l] = 0;
  const int64_t h0 = -(dw + kLagBlock - 1);
  pair_frames<T, D, W>(xa, xb, n, p, q, dw, h0 > 0 ? h0 : 0,
                       i_lo < n ? i_lo : n, w, head);
  pair_frames<T, D, W>(xa, xb, n, p, q, dw, i_tail, n - dw < n ? n - dw : n,
                       w, tail);
#pragma unroll
  for (int l = 0; l < kLagBlock; ++l) {
    if (lw + l < n_lags)
      out[(lw + l) * p + q] =
          (W)((acc[l] + (double)head[l] + (double)tail[l]) / dfac);
  }
}

// block (x: tile of kTileP particles, y: spans b of kSpan lags, strided);
// warp w sums lags [b kSpan + w kLagBlock, ... + kLagBlock) of the lane's
// particle p0 + lane. kPair: the two-block launch (module header, K8
// ta_lag_pair): base rows from x, partner rows from xb, relative lag j at
// offset j + shift from its base frame, raw sums. W is the type of the differences, squares and tile
// partials, and of the output: double, or float for the float32 work mode;
// the running sums acc are double either way.
template <typename T, int D, typename W, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
    einstein_tile_kernel(const T* __restrict__ x, W* __restrict__ out,
                         int64_t n, int64_t p, int64_t n_lags,
                         int64_t nspans, double dfac,
                         const T* __restrict__ xb, int64_t shift) {
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
    // partner row r of the span is frame d0 + i_lo + r of xp, base row r
    // frame i_lo + r of x; frames [i_lo, i_hi) are those at which every
    // lag of the span has its partner (i + d0 + kSpan - 1 < n), in whole
    // tiles
    const T* xp = x;
    int64_t d0 = l0, i_lo = 0, i_hi = n - l0 - (kSpan - 1);
    if constexpr (kPair) {
      xp = xb;
      d0 = l0 + shift;
      i_lo = d0 < 0 ? -d0 : 0;
      i_hi = n - d0 - (kSpan - 1) < n ? n - d0 - (kSpan - 1) : n;
    }
    const int64_t n_full = i_hi - i_lo;
    const int64_t n_tiles = n_full > 0 ? n_full / kTileF : 0;
    if (n_tiles > 0) {
      // partner rows r = 0 .. kTileF + kSpan - 2 and base tile 0
      load_rows<T, D>(xp, ring, d0 + i_lo, kTileF + kSpan - 1, p, p0, kRing,
                      1, kRing);
      load_rows<T, D>(x, base, i_lo, kTileF, p, p0, kTileF, 0, kTileF);
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
          load_rows<T, D>(xp, ring, d0 + i_lo + r, kTileF, p, p0, kRing,
                          (int)((r + 1) % kRing), kRing);
          load_rows<T, D>(x, base + (size_t)((t + 1) & 1) * D * kTileF *
                                        kTileP,
                          i_lo + (t + 1) * kTileF, kTileF, p, p0, kTileF, 0,
                          kTileF);
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
    if constexpr (kPair) {
      if (active && q < p)
        pair_end<T, D, W>(x, xb, out, n, p, n_lags, dfac, q, lw,
                          d0 + warp * kLagBlock, i_lo,
                          i_lo + n_tiles * kTileF, w, acc);
    } else {
      if (active && q < p)
        einstein_tail<T, D, W>(x, out, n, p, n_lags, dfac, q, lw,
                               n_tiles * kTileF, w, acc);
    }
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

// lane offset delta + lane D of the values of frame row f of particles
// [p0, p0 + kTileP) of a float operand at x
template <int D>
__device__ __forceinline__ int row_lane(const float* x, int64_t f, int64_t p,
                                        int64_t p0, int lane) {
  return (int)(((reinterpret_cast<uintptr_t>(x) >> 2) + (f * p + p0) * D) &
               3) +
         lane * D;
}

template <int D, bool kPair>
__global__ void __launch_bounds__(kThreads, 2)
    einstein_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int64_t n, int64_t p, int64_t n_lags,
                         int64_t nspans, double dfac,
                         const float* __restrict__ xb, int64_t shift) {
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
    // partner row r is frame d0 + i_lo + r of xp, base row r frame i_lo + r
    // of x, as in einstein_tile_kernel; la (base) and lb (partner) are the
    // lane offsets of rows r = 0 .. 3 mod 4
    const float* xp = x;
    int64_t d0 = l0, i_lo = 0, i_hi = n - l0 - (kSpan - 1);
    int la[4], lb[4];
    if constexpr (kPair) {
      xp = xb;
      d0 = l0 + shift;
      i_lo = d0 < 0 ? -d0 : 0;
      i_hi = n - d0 - (kSpan - 1) < n ? n - d0 - (kSpan - 1) : n;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        la[r] = row_lane<D>(x, i_lo + r, p, p0, lane);
        lb[r] = row_lane<D>(xb, d0 + i_lo + r, p, p0, lane);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) la[r] = lb[r] = lo[r];
    }
    const int64_t n_full = i_hi - i_lo;
    const int64_t n_tiles = n_full > 0 ? n_full / kRowsF : 0;
    if (n_tiles > 0) {
      // partner rows r = 0 .. kRowsF + kSpan - 2 (frames d0 + i_lo + r,
      // slot r + 1) and base tile 0
      copy_rows<D>(xp, ring, d0 + i_lo, kRowsF + kSpan - 1, p, p0, 1,
                   kRowsRing);
      copy_rows<D>(x, base, i_lo, kRowsF, p, p0, 0, kRowsF);
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
          copy_rows<D>(xp, ring, d0 + i_lo + r, kRowsF, p, p0,
                       (int)((r + 1) % kRowsRing), kRowsRing);
          copy_rows<D>(x, base + ((t + 1) & 1) * kRowsF * kPitch,
                       i_lo + (t + 1) * kRowsF, kRowsF, p, p0, 0, kRowsF);
          cp_async_commit();
        }
        if (active) {
          if (t == 0) {
#pragma unroll
            for (int j = 0; j < kLagBlock - 1; ++j) {
#pragma unroll
              for (int c = 0; c < D; ++c)
                w[c][j] = ring[(warp * kLagBlock + j + 1) * kPitch +
                               lb[j & 3] + c];
            }
          }
#pragma unroll 1
          for (int kk = 0; kk < kRowsF; kk += kLagBlock) {
            const float* xt = base + ((t & 1) * kRowsF + kk) * kPitch;
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
                    xw[k * kPitch + lb[(k + 3) & 3] + c];
                xi[c] = xt[k * kPitch + la[k & 3] + c];
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
    if constexpr (kPair) {
      if (active && q < p)
        pair_end<float, D, float>(x, xb, out, n, p, n_lags, dfac, q, lw,
                                  d0 + warp * kLagBlock, i_lo,
                                  i_lo + n_tiles * kRowsF, w, acc);
    } else {
      if (active && q < p)
        einstein_tail<float, D, float>(x, out, n, p, n_lags, dfac, q, lw,
                                       n_tiles * kRowsF, w, acc);
    }
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
// rows x[f0 + l0 + r] (r < kBRows; kPair: xb[f0 + l0 + r]) to land[D
// kAStride + c kBStride + smem_row(r)]; zeros past frame N (kPair: and
// before frame 0).
template <typename T, int D, bool kPair>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ x,
                                            const T* __restrict__ xb, T* land,
                                            int64_t f0, int64_t l0,
                                            int64_t n, int64_t p, int64_t q) {
  for (int e = threadIdx.x; e < (kARows + kBRows) * D; e += kAcfThreads) {
    const int row = e / D, c = e - row * D;
    const bool partner = row >= kARows;
    const int r = partner ? row - kARows : row;
    const int64_t frame = f0 + r + (partner ? l0 : 0);
    const bool valid = frame < n && (!kPair || frame >= 0);
    const T* src = valid ? ((kPair && partner) ? xb : x) + (frame * p + q) * D + c
                         : x;
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
// of particle q, span <= kAcfSpan; the float64 sums stored as O. kPair: the
// two-block launch (module header, K8 ta_lag_pair): rows x[f], partners
// xb[f + j + shift] for relative lag j, raw sums.
template <typename T, int D, typename O, bool kPair>
__global__ void __launch_bounds__(kAcfThreads, 2)
    acf_gram_kernel(const T* __restrict__ x, O* __restrict__ out,
                    int64_t n, int64_t p, int64_t n_lags, int64_t nspans,
                    int span, double dfac, const T* __restrict__ xb,
                    int64_t shift) {
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
    // frames t in [f_lo, f_end) have a partner, frame t + d0 + j of the
    // partner operand, for some lag j of the span: t < N - l0 for one
    // operand; for two, t + d0 + span - 1 >= 0 and t < min(N, N - d0)
    int64_t d0 = l0, f_lo = 0, f_end = n - l0;
    if constexpr (kPair) {
      d0 = l0 + shift;
      f_lo = -(d0 + span - 1) > 0 ? -(d0 + span - 1) : 0;
      f_end = n - d0 < n ? n - d0 : n;
    }
    const int64_t chunks =
        f_end > f_lo ? (f_end - f_lo + kChunk - 1) / kChunk : 0;
    double acc[2][kRing][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < kRing; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[e][i][v] = 0.0;
    if (!kPair || chunks > 0) {
      stage_chunk<T, D, kPair>(x, xb, land, f_lo, d0, n, p, q);
      cp_async_commit();
    }
    for (int64_t k = 0; k < chunks; ++k) {
      cp_async_wait_all();
      // chunk k has landed for every thread, and every warp is done with
      // chunk k - 1's doubles
      __syncthreads();
      for (int i = threadIdx.x; i < kStage; i += kAcfThreads)
        buf[i] = (double)land[i];
      __syncthreads();  // the doubles are in; the landing buffer is free
      if (k + 1 < chunks) {
        stage_chunk<T, D, kPair>(x, xb, land, f_lo + (k + 1) * kChunk, d0,
                                 n, p, q);
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
        if constexpr (kPair)
          out[lag * p + q] = (O)(s / dfac);
        else
          out[lag * p + q] = (O)(s / ((double)(n - lag) * dfac));
      }
    }
    __syncthreads();  // the next span's copies overwrite C
  }
}

template <typename T, int D, typename O, bool kPair>
int launch(const void* x, const void* xb, int64_t shift, void* out, int64_t n,
           int64_t p, int64_t n_lags, bool einstein, double dfac,
           int64_t lag_block, dim3 grid, unsigned cols, cudaStream_t stream) {
  if (einstein) {
    const int64_t nspans = (n_lags + kSpan - 1) / kSpan;
    if constexpr (sizeof(T) == 4 && sizeof(O) == 4) {
      // the float32 work mode's einstein launch: all of the SM's shared
      // memory, so that two CTAs fit
      constexpr size_t smem = rows_smem_bytes<D>();
      cudaError_t err = cudaFuncSetAttribute(
          einstein_rows_kernel<D, kPair>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            einstein_rows_kernel<D, kPair>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
      einstein_rows_kernel<D, kPair><<<grid, cols, smem, stream>>>(
          (const float*)x, (float*)out, n, p, n_lags, nspans, dfac,
          (const float*)xb, shift);
    } else {
      constexpr size_t smem = tile_smem_bytes<T, D>();
      const cudaError_t err = cudaFuncSetAttribute(
          einstein_tile_kernel<T, D, O, kPair>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      einstein_tile_kernel<T, D, O, kPair><<<grid, cols, smem, stream>>>(
          (const T*)x, (O*)out, n, p, n_lags, nspans, dfac, (const T*)xb,
          shift);
    }
  } else {
    constexpr size_t smem = acf_smem_bytes<T, D>();
    const cudaError_t err = cudaFuncSetAttribute(
        acf_gram_kernel<T, D, O, kPair>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t nspans = (n_lags + lag_block - 1) / lag_block;
    acf_gram_kernel<T, D, O, kPair><<<grid, cols, smem, stream>>>(
        (const T*)x, (O*)out, n, p, n_lags, nspans, (int)lag_block, dfac,
        (const T*)xb, shift);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool kPair = false>
int launch_d(const void* x, void* out, int64_t n, int64_t p, int64_t d,
             int64_t n_lags, bool einstein, double dfac, int64_t lag_block,
             dim3 grid, unsigned cols, cudaStream_t stream,
             const void* xb = nullptr, int64_t shift = 0) {
  if (d == 1) return launch<T, 1, O, kPair>(x, xb, shift, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
  if (d == 2) return launch<T, 2, O, kPair>(x, xb, shift, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
  return launch<T, 3, O, kPair>(x, xb, shift, out, n, p, n_lags, einstein, dfac, lag_block, grid, cols, stream);
}

// The launch geometry cuda_lag.py hands a C entry: what the kernels take.
// One operand takes n_lags <= n; the two-block launch any n_lags >= 1.
bool lag_geometry(int64_t n, int64_t p, int64_t d, int64_t n_lags,
                  int64_t einstein, int64_t lag_block, int64_t cols,
                  int64_t grid_x, bool pair = false) {
  const bool geometry =
      einstein ? lag_block == kSpan && cols == kThreads
               : lag_block >= 1 && lag_block <= kAcfSpan &&
                     cols == kAcfThreads && grid_x == p;
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
  return launch_d<double, double, true>(
      xa, out, n, p, d, n_lags, einstein != 0, dfac, lag_block,
      dim3((unsigned)grid_x, (unsigned)grid_y), (unsigned)cols,
      (cudaStream_t)stream, xb, shift);
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
  return launch_d<float, float, true>(
      xa, out, n, p, d, n_lags, einstein != 0, dfac, lag_block,
      dim3((unsigned)grid_x, (unsigned)grid_y), (unsigned)cols,
      (cudaStream_t)stream, xb, shift);
}

}  // extern "C"
