// Block-tridiagonal rank-k up/down-date on Hopper (sm_90a), one launch.
//
// Replaces the TPU kernel repro/kernels/blocktridiag.py:_btd_call (:117,
// body _btd_kernel :71). The factor is upper block-bidiagonal: diag[j]
// (b x b upper triangular) and off[j] = U[j, j+1] (b x b). With every
// column of V supported inside one adjacent block pair, block row j has
// one trailing tile, so the update is a chain of nb steps:
//
//   diag[j], T_j        <- diagonal sweep of (diag[j], V^T slab j)
//   [off[j]; slab j+1]  <- T_j [off[j]; slab j+1]
//
// Design. One CTA per fleet member walks the whole chain; the members of a
// fleet run side by side in the same launch. The running V^T slab (k x b)
// lives in shared memory: the sweep reads slab j into registers, after
// which the buffer takes slab j+1 from device memory and the apply rotates
// it in place, ready for step j+1. T_j goes to a per-member scratch buffer
// that stays in L2, where the apply's cp.async strips read it. The sweep
// and the apply are the fused kernel's device functions (chol_tile.cuh).
//
// What bounds it on an H100: by bytes, each block read and written once
// plus V^T read once (blocktridiag.bytes_per_update: 4.2 MB for nb = 8192,
// b = 4, k = 16 in fp32, ~1.3 us at 3.35 TB/s). The chain is nb b dependent
// sweep rows, one barrier each, plus an apply per block: pure latency, far
// above both roofline bounds at small b. See PERF.md.
#include <cstddef>
#include <cstdint>

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

template <typename S, typename A>
size_t smem_bytes(int b, int k) {
  return align16(sizeof(S) * size_t(k) * b) +
         sizeof(A) * size_t(gemm_work_elems<A>());
}

// diag: (B, nb, b, b) storage, in place; off: (B, nb-1, b, b) storage, in
// place; vt: (B, k, nb b) storage, read only; tscr: (B, b+k, t_pitch)
// accum scratch.
template <int KM, typename S, typename A>
__global__ void __launch_bounds__(kThreads)
btd_chain_kernel(S* diag, S* off, const S* vt, A* tscr, int nb, int b,
                 int k, int sigma_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) A rot[kRotElems];
  __shared__ A vnext[kNextElems];
  __shared__ A dg[kMaxPanel];
  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const size_t bb = size_t(b) * b;
  const size_t n = size_t(nb) * b;
  S* Dm = diag + m * nb * bb;
  S* Om = off + m * size_t(nb - 1) * bb;
  const S* vm = vt + m * k * n;
  A* T = tscr + m * size_t(b + k) * t_pitch(b, k);
  S* slab = reinterpret_cast<S*>(smem);  // k x b, pitch b
  A* work = reinterpret_cast<A*>(smem + align16(sizeof(S) * size_t(k) * b));
  const A sigma = A(sigma_i);
  for (int e = tid; e < k * b; e += kThreads) {
    slab[e] = vm[size_t(e / b) * n + e % b];
  }
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    diag_tile<KM, S, A>(Dm + j * bb, b, slab, rot, vnext, dg, T, nullptr,
                        nullptr, b, k, sigma);
    if (j + 1 == nb) break;
    // The sweep holds slab j in registers and annihilated it: the buffer
    // takes slab j+1, untouched so far (block-local columns).
    for (int e = tid; e < k * b; e += kThreads) {
      slab[e] = vm[size_t(e / b) * n + size_t(j + 1) * b + e % b];
    }
    // T_j's stores reach L2 before the apply's cp.async reads them.
    __threadfence();
    __syncthreads();
    gemm_apply_tile<S, A>(Om + j * bb, b, slab, b, b, T, t_pitch(b, k),
                          work, work + kTRows * kChunkW, b, k);
  }
}

template <int KM, typename S, typename A>
int launch_km(void* diag, void* off, const void* vt, void* tscr, int B,
              int nb, int b, int k, int sigma, cudaStream_t stream) {
  const size_t smem = smem_bytes<S, A>(b, k);
  cudaError_t err = cudaFuncSetAttribute(
      btd_chain_kernel<KM, S, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  btd_chain_kernel<KM, S, A><<<B, kThreads, smem, stream>>>(
      static_cast<S*>(diag), static_cast<S*>(off), static_cast<const S*>(vt),
      static_cast<A*>(tscr), nb, b, k, sigma);
  return int(cudaGetLastError());
}

template <typename S, typename A>
int launch(void* diag, void* off, const void* vt, void* tscr, int B, int nb,
           int b, int k, int sigma, cudaStream_t stream) {
  if (B < 1 || nb < 1 || b < 1 || b > kMaxPanel || k < 1 || k > kMaxK ||
      (sigma != 1 && sigma != -1) || (nb > 1 && off == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  if (k <= 8) {
    return launch_km<8, S, A>(diag, off, vt, tscr, B, nb, b, k, sigma,
                              stream);
  }
  if (k <= 16) {
    return launch_km<16, S, A>(diag, off, vt, tscr, B, nb, b, k, sigma,
                               stream);
  }
  return launch_km<32, S, A>(diag, off, vt, tscr, B, nb, b, k, sigma,
                             stream);
}

}  // namespace

// dtype: 0 = fp32 storage / fp32 accum, 1 = bf16 / fp32, 2 = f64 / f64.
// Returns a cudaError_t.
extern "C" int repro_btd_chain(void* diag, void* off, const void* vt,
                               void* tscr, int B, int nb, int b, int k,
                               int sigma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(diag, off, vt, tscr, B, nb, b, k, sigma,
                                  st);
    case 1:
      return launch<__nv_bfloat16, float>(diag, off, vt, tscr, B, nb, b, k,
                                          sigma, st);
    case 2:
      return launch<double, double>(diag, off, vt, tscr, B, nb, b, k, sigma,
                                    st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The padded row pitch of the transform scratch, for the wrapper.
extern "C" int repro_btd_t_pitch(int b, int k) { return t_pitch(b, k); }

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
