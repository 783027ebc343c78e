// FP64 tensor-core shapes of Hopper's mma.sync: fragment layouts and
// throughput. Built and run by scripts/dmma_shapes.py (nvcc, sm_90a):
//
//   dmma_shapes            check each shape's fragment layout on one warp,
//                          then time each shape's issue rate
//
// Shapes: m8n8k4 (sm_80 on) and m16n8k4, m16n8k8, m16n8k16 (new in
// sm_90), each at 8, 4 and 2 warps a sub-partition of an SM. The layouts
// assumed are the ones csrc/lag.cu uses: lane
// = 4 g + t; A (M x K, row): a[h + 2 i] = A[g + 8 h][t + 4 i]; B (K x 8,
// col): b[i] = B[t + 4 i][g]; C (M x 8): c[2 h + j] = C[g + 8 h][2 t + j].

#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

template <int M, int K>
struct Mma;

template <>
struct Mma<8, 4> {
  static constexpr int kA = 1, kB = 1, kC = 2;
  __device__ static void run(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, "
        "{%3}, {%0,%1};\n"
        : "+d"(c[0]), "+d"(c[1])
        : "d"(a[0]), "d"(b[0]));
  }
};

template <>
struct Mma<16, 4> {
  static constexpr int kA = 2, kB = 1, kC = 4;
  __device__ static void run(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};

template <>
struct Mma<16, 8> {
  static constexpr int kA = 4, kB = 2, kC = 4;
  __device__ static void run(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
  }
};

template <>
struct Mma<16, 16> {
  static constexpr int kA = 8, kB = 4, kC = 4;
  __device__ static void run(double* c, const double* a, const double* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

// One warp: C = A B with A (M x K) and B (K x 8) row-major in global
// memory, through the assumed fragment layouts.
template <int M, int K>
__global__ void layout_kernel(const double* A, const double* B, double* C) {
  using T = Mma<M, K>;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[T::kA], b[T::kB], c[T::kC];
  for (int v = 0; v < T::kA; ++v) {
    const int h = M == 16 ? v & 1 : 0, i = M == 16 ? v >> 1 : v;
    a[v] = A[(g + 8 * h) * K + t + 4 * i];
  }
  for (int i = 0; i < T::kB; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  for (int v = 0; v < T::kC; ++v) c[v] = 0.0;
  T::run(c, a, b);
  for (int v = 0; v < T::kC; ++v) {
    const int h = v >> 1, j = v & 1;
    C[(g + 8 * h) * 8 + 2 * t + j] = c[v];
  }
}

// Each warp keeps kTiles independent accumulators and issues kTiles MMAs
// an iteration on register operands.
constexpr int kTiles = 8;
template <int M, int K>
__global__ void __launch_bounds__(256) rate_kernel(double* out, int iters,
                                                   double seed) {
  using T = Mma<M, K>;
  double a[T::kA], b[T::kB], c[kTiles][T::kC];
  for (int v = 0; v < T::kA; ++v) a[v] = seed + threadIdx.x + v;
  for (int v = 0; v < T::kB; ++v) b[v] = seed - threadIdx.x - v;
  for (int j = 0; j < kTiles; ++j)
    for (int v = 0; v < T::kC; ++v) c[j][v] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) T::run(c[j], a, b);
  }
  double s = 0.0;
  for (int j = 0; j < kTiles; ++j)
    for (int v = 0; v < T::kC; ++v) s += c[j][v];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int M, int K>
int check_layout() {
  double hA[M * K], hB[K * 8], hC[M * 8], ref[M * 8];
  srand(M * 100 + K);
  for (auto& v : hA) v = (double)(rand() % 17) - 8.0;
  for (auto& v : hB) v = (double)(rand() % 13) - 6.0;
  for (int m = 0; m < M; ++m)
    for (int n = 0; n < 8; ++n) {
      double s = 0.0;
      for (int k = 0; k < K; ++k) s += hA[m * K + k] * hB[k * 8 + n];
      ref[m * 8 + n] = s;
    }
  double *dA, *dB, *dC;
  cudaMalloc(&dA, sizeof hA);
  cudaMalloc(&dB, sizeof hB);
  cudaMalloc(&dC, sizeof hC);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout_kernel<M, K><<<1, 32>>>(dA, dB, dC);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(hC, dC, sizeof hC, cudaMemcpyDeviceToHost);
  cudaFree(dA);
  cudaFree(dB);
  cudaFree(dC);
  int bad = 0;
  for (int i = 0; i < M * 8; ++i) bad += hC[i] != ref[i];
  printf("layout m%dn8k%d: %s, %d of %d elements differ\n", M, K,
         err == cudaSuccess ? "ran" : cudaGetErrorString(err), bad, M * 8);
  return bad != 0 || err != cudaSuccess;
}

template <int M, int K>
void time_rate(int sms, int per_sm) {
  const int blocks = sms * per_sm, threads = 256, iters = 4096;
  double* out;
  cudaMalloc(&out, sizeof(double) * blocks * threads);
  rate_kernel<M, K><<<blocks, threads>>>(out, 16, 1.0);  // warm
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e30f;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(e0);
    rate_kernel<M, K><<<blocks, threads>>>(out, iters, 1.0 + r);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (ms < best) best = ms;
  }
  const double flop = 2.0 * M * 8 * K * (double)kTiles * iters *
                      (blocks * threads / 32);
  printf("rate m%dn8k%d: %.3f ms for %.3e flop, %.2f TFLOP/s (%.1f %% of "
         "67), %d blocks of %d threads (%d warps a sub-partition), %d "
         "independent MMAs a warp\n",
         M, K, best, flop, flop / best / 1e9, flop / best / 1e9 / 67 * 100,
         blocks, threads, per_sm * threads / 32 / 4, kTiles);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int bad = check_layout<8, 4>() + check_layout<16, 4>() +
            check_layout<16, 8>() + check_layout<16, 16>();
  // 4 blocks an SM: 8 warps on each of its 4 sub-partitions; then 2 and 1
  // (the acf kernel's 2 CTAs or 1 CTA of 8 warps an SM)
  for (int per_sm : {4, 2, 1}) {
    time_rate<8, 4>(sms, per_sm);
    time_rate<16, 4>(sms, per_sm);
    time_rate<16, 8>(sms, per_sm);
    time_rate<16, 16>(sms, per_sm);
  }
  return bad ? 1 : 0;
}
