// Times the diagonal-block sweep of the fused-chain and block-chain kernels
// on its own, and the phases of one sweep row.
//
// One block runs chol_tile::diag_tile<kRef = false> (what the fused kernel
// and the block chain's CTA route run: two columns a thread, a block
// barrier and two shared-memory hand-overs a row) on a P x P upper tile
// with k rotations per row, fp32, with T, and reads clock64() around it:
// the best of three runs is printed as SM cycles per row, for P in
// {256, 128} and k in {1, 16, 32} (and P = 100, k = 16). Then the one-warp
// sweep (chol_tile::sweep_warp, the block chain's route for P + k <= 32)
// at P in {4, 16, 31}.
//
// Then each phase of a row alone, P = 256 rows, cycles per row:
//   wait        diag_tile's hand-over: one thread stores the pivot's V
//               values to shared memory, a block barrier over 288
//               threads, every thread reads them;
//   rotations   diag_tile's ("table"): one warp reads them, runs the warp
//               scan and writes the row's rotations (row_rotations),
//               __syncwarp; in registers ("registers"): the gather from
//               the pivot lane and the scan (scan_rotations);
//   apply       the chain of KM rotations on a column that feeds the next
//               row: reading (c, s, 1/c) from shared memory (two columns a
//               thread), or shuffling them from the lanes that computed
//               them.
// Each phase kernel chains its rows through its own result, so a row waits
// for the row before, as in the sweep. Nothing else of the port uses this
// file; it is a measurement aid.
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

template <int KM>
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
  diag_tile<KM, float, float>(D, ld, slab, rot, vnext, dg, T, nullptr,
                              nullptr, P, k, 1.f);
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// The sweep of one warp (P + k <= 32), as the block chain's one-warp route
// runs it, cycles per row.
template <int KM>
__global__ void sweep_warp(float* D, int ld, const float* vt, float* T,
                           int P, int k, long long* cycles) {
  __shared__ __align__(16) float xchg[4 * kMaxK];
  __shared__ float slab[kMaxK * 32];
  for (int e = threadIdx.x; e < k * P; e += 32) slab[e] = vt[e];
  __syncwarp();
  const long long t0 = clock64();
  sweep_warp<KM, float, float, float>(D, ld, D, ld, slab, P, xchg, T,
                                      t_pitch(P, k), P, k, 1.f);
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// diag_tile's per-row hand-over and block barrier.
__global__ void __launch_bounds__(kThreads)
phase_wait(int P, float* out, long long* cycles) {
  __shared__ float vn[2 * kMaxK];
  float acc = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < P; ++i) {
    float* buf = vn + (i & 1) * kMaxK;
    if (threadIdx.x == (i + 1) % kDiagThreads) {
      for (int m = 0; m < kMaxK; ++m) buf[m] = acc + m;
    }
    __syncthreads();
    acc += buf[threadIdx.x & 31] * 1e-3f;
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

// One warp: the rotations of each row, from and to shared memory (the
// table) or in registers, the next row's V values made from this row's
// rotations.
template <bool kRegs, int KM>
__global__ void phase_rotations(int P, int k, float* out,
                                long long* cycles) {
  __shared__ __align__(16) float rot[kRotElems];
  __shared__ float vn[kNextElems];
  const int lane = threadIdx.x & 31;
  float v[KM];
#pragma unroll
  for (int m = 0; m < KM; ++m) v[m] = 0.01f * (m + 1);
  vn[lane] = v[lane % KM];
  float c = 1.f, s = 0.f, ci = 1.f;
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < P; ++i) {
    if constexpr (kRegs) {
      float vpiv = 0.f;
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        const float t = __shfl_sync(0xffffffffu, v[m], i & 31);
        if (lane == m) vpiv = t;
      }
      scan_rotations<KM, float>(4.f, lane < k ? vpiv : 0.f, k, 1.f, c, s,
                                ci, nullptr, nullptr);
#pragma unroll
      for (int m = 0; m < KM; ++m) v[m] = 0.5f * v[m] + 1e-3f * s;
    } else {
      float* r = rot + (i & 1) * 4 * kMaxK;
      row_rotations<KM, float>(4.f, lane < k ? vn[lane] : 0.f, k, 1.f, r,
                               nullptr, nullptr);
      __syncwarp();
      vn[lane] = 0.5f * vn[lane] + 1e-3f * r[4 * lane + 1];
      __syncwarp();
    }
  }
  const long long t1 = clock64();
  out[lane] = kRegs ? v[0] + c + ci : vn[lane];
  if (lane == 0) *cycles = t1 - t0;
}

// One warp: each row's KM rotations on a column whose result feeds the
// next row, the coefficients read from shared memory (the table, two
// columns a thread) or shuffled from the lanes that hold them.
template <bool kRegs, int KM>
__global__ void phase_apply(int P, float* out, long long* cycles) {
  __shared__ __align__(16) float rot[4 * kMaxK];
  const int lane = threadIdx.x & 31;
  const float c = 1.f + 1e-3f * lane, s = 1e-3f * lane, ci = 1.f / c;
  rot[4 * lane] = c;
  rot[4 * lane + 1] = s;
  rot[4 * lane + 2] = ci;
  float v0[KM], v1[KM];
#pragma unroll
  for (int m = 0; m < KM; ++m) v0[m] = v1[m] = 0.01f * m;
  float y0 = 1.f, y1 = 2.f;
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < P; ++i) {
    // The coefficients depend on the row before, as a sweep's do.
    const float d = 1e-30f * y0;
    if constexpr (!kRegs) __syncwarp();
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      if constexpr (kRegs) {
        const float cm = __shfl_sync(0xffffffffu, c + d, m);
        const float sm = __shfl_sync(0xffffffffu, s + d, m);
        const float cim = __shfl_sync(0xffffffffu, ci + d, m);
        rotate<false, float>(y0, v0[m], cm, sm, cim, 1.f);
      } else {
        float cm, sm, cim, unused;
        load4(rot + 4 * m, cm, sm, cim, unused);
        cm += d;
        rotate<false, float>(y0, v0[m], cm, sm, cim, 1.f);
        rotate<false, float>(y1, v1[m], cm, sm, cim, 1.f);
      }
    }
  }
  const long long t1 = clock64();
  out[lane] = y0 + y1 + v0[0] + v1[KM - 1];
  if (lane == 0) *cycles = t1 - t0;
}

long long read_cycles(const char* name, long long* cycles) {
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    std::printf("%s: %s\n", name, cudaGetErrorString(err));
    std::exit(1);
  }
  long long c = 0;
  cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  return c;
}

template <int KM>
void run(const std::vector<float>& tile, float* D, float* vt, float* T,
         int P, int k, long long* cycles) {
  const size_t smem = sizeof(float) * k * P;
  cudaFuncSetAttribute(sweep<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  long long best = -1;
  for (int rep = 0; rep < 3; ++rep) {
    cudaMemcpy(D, tile.data(), sizeof(float) * tile.size(),
               cudaMemcpyHostToDevice);
    sweep<KM><<<1, kThreads, smem>>>(D, kMaxPanel, vt, T, P, k, cycles);
    const long long c = read_cycles("sweep", cycles);
    if (best < 0 || c < best) best = c;
  }
  std::printf("diag_tile P=%3d k=%2d cycles %9lld per row %7.1f\n", P, k,
              best, double(best) / P);
}

template <int KM>
void phases(int k, float* out, long long* cycles) {
  const int P = kMaxPanel;
  long long c[5];
  phase_rotations<false, KM><<<1, 32>>>(P, k, out, cycles);
  c[0] = read_cycles("rotations", cycles);
  phase_rotations<true, KM><<<1, 32>>>(P, k, out, cycles);
  c[1] = read_cycles("rotations", cycles);
  phase_apply<false, KM><<<1, 32>>>(P, out, cycles);
  c[2] = read_cycles("apply", cycles);
  phase_apply<true, KM><<<1, 32>>>(P, out, cycles);
  c[3] = read_cycles("apply", cycles);
  std::printf("phases k=%2d (KM=%2d), cycles per row: rotations table "
              "%6.1f registers %6.1f; apply table %6.1f shuffles %6.1f\n",
              k, KM, double(c[0]) / P, double(c[1]) / P, double(c[2]) / P,
              double(c[3]) / P);
}

int main() {
  const int n = kMaxPanel;
  // A well-conditioned upper tile (diagonal 16 to 17, off-diagonal 0 to
  // 0.02) and a small V (0 to 0.1), from a fixed linear congruential
  // sequence, so every sweep stays finite for any P <= n and k <= 32.
  unsigned state = 12345u;
  auto uniform = [&]() {
    state = state * 1664525u + 1013904223u;
    return float(state >> 8) / float(1u << 24);
  };
  std::vector<float> tile(size_t(n) * n, 0.f);
  for (int i = 0; i < n; ++i) {
    for (int j = i; j < n; ++j) {
      tile[size_t(i) * n + j] = (i == j) ? 16.f + uniform()
                                         : 0.02f * uniform();
    }
  }
  std::vector<float> v(size_t(kMaxK) * n);
  for (float& x : v) x = 0.1f * uniform();
  float *D, *vt, *T, *out;
  long long* cycles;
  cudaMalloc(&D, sizeof(float) * n * n);
  cudaMalloc(&vt, sizeof(float) * kMaxK * n);
  cudaMalloc(&T, sizeof(float) * (n + kMaxK) * t_pitch(n, kMaxK));
  cudaMalloc(&out, sizeof(float) * kThreads);
  cudaMalloc(&cycles, sizeof(long long));
  cudaMemcpy(vt, v.data(), sizeof(float) * v.size(), cudaMemcpyHostToDevice);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  std::printf("SM clock (attribute) %d kHz\n", khz);
  for (int P : {256, 128}) {
    run<16>(tile, D, vt, T, P, 16, cycles);
    run<8>(tile, D, vt, T, P, 1, cycles);
    run<32>(tile, D, vt, T, P, 32, cycles);
  }
  run<16>(tile, D, vt, T, 100, 16, cycles);
  for (int kk : {1, 16}) {
    for (int P : {4, 16, 31}) {
      if (P + kk > 32) continue;
      long long best = -1;
      for (int rep = 0; rep < 3; ++rep) {
        cudaMemcpy(D, tile.data(), sizeof(float) * tile.size(),
                   cudaMemcpyHostToDevice);
        if (kk == 1) {
          sweep_warp<8><<<1, 32>>>(D, kMaxPanel, vt, T, P, kk, cycles);
        } else {
          sweep_warp<16><<<1, 32>>>(D, kMaxPanel, vt, T, P, kk, cycles);
        }
        const long long c = read_cycles("sweep_warp", cycles);
        if (best < 0 || c < best) best = c;
      }
      std::printf("sweep_warp P=%2d k=%2d: %7.1f cycles per row\n",
                  P, kk, double(best) / P);
    }
  }
  phase_wait<<<1, kThreads>>>(kMaxPanel, out, cycles);
  std::printf("phase wait (hand-over and block barrier, 288 threads): "
              "%.1f cycles per row\n",
              double(read_cycles("wait", cycles)) / kMaxPanel);
  phases<8>(1, out, cycles);
  phases<16>(16, out, cycles);
  phases<32>(32, out, cycles);
  return 0;
}
