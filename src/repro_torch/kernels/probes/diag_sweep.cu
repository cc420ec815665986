// Times the diagonal-block sweep of the fused-chain kernel on its own.
//
// One block runs chol_tile::diag_tile (the device function the kernel in
// ../csrc/fused_chain.cu calls on every diagonal tile) on a P x P upper
// tile with k rotations per row, fp32, and reads clock64() around it. The
// best of three runs is printed as SM cycles per sweep and per row, for
// P in {256, 128} and k in {16, 1, 32}, and once without the transform T.
// Nothing else of the port uses this file; it is a measurement aid.
//
// Build and run on a machine with the CUDA toolkit and a Hopper card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o diag_sweep src/repro_torch/kernels/probes/diag_sweep.cu
//   ./diag_sweep
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../csrc/chol_tile.cuh"

using namespace chol_tile;

template <bool kWithT, int KM>
__global__ void __launch_bounds__(kThreads)
sweep(float* D, int ld, const float* vt, float* T, int P, int k,
      long long* cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float rot[kRotElems];
  __shared__ float vnext[kNextElems];
  __shared__ float dg[kMaxPanel];
  float* slab = reinterpret_cast<float*>(smem);
  for (int e = threadIdx.x; e < k * P; e += kThreads) slab[e] = vt[e];
  __syncthreads();
  const long long t0 = clock64();
  diag_tile<KM, float, float>(D, ld, slab, rot, vnext, dg,
                              kWithT ? T : nullptr, nullptr, nullptr, P, k,
                              1.f);
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

template <bool kWithT, int KM>
void run(const char* name, const std::vector<float>& tile, float* D,
         float* vt, float* T, int P, int k, long long* cycles) {
  const size_t smem = sizeof(float) * k * P;
  cudaFuncSetAttribute(sweep<kWithT, KM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  long long best = -1;
  for (int rep = 0; rep < 3; ++rep) {
    cudaMemcpy(D, tile.data(), sizeof(float) * tile.size(),
               cudaMemcpyHostToDevice);
    sweep<kWithT, KM><<<1, kThreads, smem>>>(D, kMaxPanel, vt, T, P, k,
                                             cycles);
    const cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
      std::printf("%s: %s\n", name, cudaGetErrorString(err));
      std::exit(1);
    }
    long long c = 0;
    cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
    if (best < 0 || c < best) best = c;
  }
  std::printf("%-20s P=%3d k=%2d cycles %9lld per row %7.1f\n", name, P, k,
              best, double(best) / P);
}

int main() {
  const int n = kMaxPanel;
  // A well-conditioned upper tile (diagonal 16, off-diagonal 0.01) and a
  // small V, so every sweep stays finite for any P <= n and k <= 32.
  std::vector<float> tile(size_t(n) * n, 0.f);
  for (int i = 0; i < n; ++i) {
    for (int j = i; j < n; ++j) {
      tile[size_t(i) * n + j] = (i == j) ? 16.f : 0.01f;
    }
  }
  std::vector<float> v(size_t(kMaxK) * n, 0.05f);
  float *D, *vt, *T;
  long long* cycles;
  cudaMalloc(&D, sizeof(float) * n * n);
  cudaMalloc(&vt, sizeof(float) * kMaxK * n);
  cudaMalloc(&T, sizeof(float) * (n + kMaxK) * t_pitch(n, kMaxK));
  cudaMalloc(&cycles, sizeof(long long));
  cudaMemcpy(vt, v.data(), sizeof(float) * v.size(), cudaMemcpyHostToDevice);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  std::printf("SM clock (attribute) %d kHz\n", khz);
  for (int P : {256, 128}) {
    run<true, 16>("diag_tile", tile, D, vt, T, P, 16, cycles);
    run<true, 8>("diag_tile", tile, D, vt, T, P, 1, cycles);
    run<true, 32>("diag_tile", tile, D, vt, T, P, 32, cycles);
  }
  run<false, 16>("diag_tile without T", tile, D, vt, T, 256, 16, cycles);
  return 0;
}
