// Single-launch fused rank-k Cholesky up/down-date on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused.py:_fused_call (bodies
// _portable_kernel / _indexed_kernel / _rect_kernel over _fused_body): the
// whole update of a panel-padded (n, n) upper factor, or of a (B, n, n)
// fleet, in ONE launch, walking the upper tiles (p, t) in dependency order:
// (p, t) needs (p, p) and (p-1, t); (p, p) needs (p-1, p).
//
// Design. Column tile t of factor b is split into G groups of W = P / G
// columns, one block each. A block walks rows p = 0..t-1 in order, so
// (p-1, t) -> (p, t) costs nothing, and keeps its W columns of V^T slab t
// in shared memory for the whole launch: no other block touches them. At
// p < t it waits on flag (b, p), then applies T_p (or the rotation chain)
// to its columns of tile (p, t) and of its slab. Group 0 leads: the other
// groups hand their slab columns over through global scratch and count
// themselves done; the leader waits for them, runs the diagonal recurrence
// on tile (t, t) with the whole slab, publishes T_t (gemm apply) or
// c_t, s_t (paper apply) to a global scratch buffer that stays in L2, and
// releases flag (b, t). Blocks take (t, b, g) from an atomic ticket, t
// first and the leader last, so a block only ever waits on blocks that
// started before it: the spin cannot deadlock even when not every block is
// resident. The wrapper picks G so that the blocks fill the card.
//
// What bounds it on an H100: by bytes, each upper tile read and written
// once plus V^T read once (fused.bytes_per_update, 110 MB at n=5000 fp32,
// ~33 us at 3.35 TB/s); by operations, the gemm apply's 2 (P+k)^2 P per
// tile (~7.3 GFLOP at n=5000, P=256, k=16, ~110 us at 67 TFLOP/s fp32).
// Beyond both, the chain is serial: diagonal p+1 waits for diagonal p and
// the apply on (p, p+1). The design shortens that chain: the diagonal
// sweep is chol_tile.cuh's sweep_wavefront (the reference recurrence's own
// operations, so each diagonal block's D_new, T, c and s are the plain
// chain's, scheduled by anti-diagonals of (row, rotation): P + k - 1
// dependent steps instead of P k, one column a thread with its k V values
// in registers, warps paced by mbarriers instead of a block barrier a row),
// and the apply on the critical tile is split over G blocks. CUDA cores
// only: TF32 tensor cores would break the fp32 error budget. See PERF.md.
#include <cstddef>
#include <cstdint>

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

template <typename S, typename A>
size_t smem_bytes(int P, int k, int paper) {
  const size_t slab = align16(sizeof(S) * size_t(k) * P);
  return slab + sizeof(A) * size_t(paper ? paper_work_elems(P, k)
                                         : gemm_work_elems<A>());
}

__device__ __forceinline__ void wait_flag(const int* flag, int value) {
  const volatile int* f = flag;
  while (*f < value) __nanosleep(20);
  __threadfence();
}

template <int KM, typename S, typename A>
__global__ void __launch_bounds__(kWaveThreads)
fused_chain_kernel(S* L, const S* vt, A* tscr, A* cscr, A* sscr, S* slabscr,
                   int* flags, int B, int n_pad, int P, int k, int G,
                   int sigma_i, int paper) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ticket;
  __shared__ __align__(16) WaveSmem<A> ws;
  const int tid = threadIdx.x;
  const int nP = n_pad / P;
  const int pk = P + k;
  const int tp = t_pitch(P, k);
  const int W = P / G;
  int* done = flags;            // (B, nP): diagonal block published
  int* handed = flags + B * nP;  // (B, nP): groups that handed their slab
  int* ticket = flags + 2 * B * nP;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = s_ticket / (B * G);
  const int b = (s_ticket / G) % B;
  const int g = G - 1 - s_ticket % G;
  const int bt = b * nP + t;

  S* Lb = L + size_t(b) * n_pad * n_pad;
  S* slab = reinterpret_cast<S*>(smem);  // k x P, this block's W columns
  A* work = reinterpret_cast<A*>(smem + align16(sizeof(S) * size_t(k) * P));
  const S* vtb = vt + size_t(b) * k * n_pad + size_t(t) * P + g * W;
  for (int e = tid; e < k * W; e += kWaveThreads) {
    const int m = e / W, j = e % W;
    slab[m * P + g * W + j] = vtb[size_t(m) * n_pad + j];
  }
  __syncthreads();
  const A sigma = A(sigma_i);

  for (int p = 0; p < t; ++p) {
    if (tid == 0) wait_flag(done + b * nP + p, 1);
    __syncthreads();
    S* R = Lb + size_t(p) * P * n_pad + size_t(t) * P + g * W;
    const size_t tile = size_t(b) * nP + p;
    if (paper) {
      rotation_apply_tile<KM, S, A, true>(
          R, n_pad, slab + g * W, P, W, cscr + tile * P * k,
          sscr + tile * P * k, work, P, k, sigma);
    } else {
      gemm_apply_tile<S, A, S, false, true>(R, n_pad, slab + g * W, P, W,
                                            tscr + tile * pk * tp, tp, work,
                                            work + kTRows * kChunkW, P, k);
    }
  }

  S* scr = slabscr + size_t(bt) * k * P;
  if (g > 0) {
    // Hand this group's slab columns to the leader.
    for (int e = tid; e < k * W; e += kWaveThreads) {
      const int m = e / W, j = e % W;
      scr[m * P + g * W + j] = slab[m * P + g * W + j];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(handed + bt, 1);
    return;
  }
  if (G > 1) {
    if (tid == 0) wait_flag(handed + bt, G - 1);
    __syncthreads();
    for (int e = tid; e < k * (P - W); e += kWaveThreads) {
      const int m = e / (P - W), j = W + e % (P - W);
      slab[m * P + j] = load_cg(scr + m * P + j);
    }
    __syncthreads();
  }
  S* D = Lb + size_t(t) * P * n_pad + size_t(t) * P;
  const size_t tile = size_t(bt);
  sweep_wavefront<KM, S, A>(D, n_pad, slab, ws,
                            paper ? nullptr : tscr + tile * pk * tp,
                            paper ? cscr + tile * P * k : nullptr,
                            paper ? sscr + tile * P * k : nullptr, P, k,
                            sigma);
  // Release: every thread's T / (c, s) / D_new stores are visible device-
  // wide before the flag flips.
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicExch(done + bt, 1);
}

template <int KM, typename S, typename A>
int launch_km(void* L, const void* vt, void* tscr, void* cscr, void* sscr,
           void* slabscr, void* flags, int B, int n_pad, int P, int k, int G,
           int sigma, int paper, cudaStream_t stream) {
  if (B < 1 || P < 1 || P > kMaxPanel || k < 1 || k > kMaxK ||
      n_pad % P != 0 || G < 1 || P % G != 0 ||
      (sigma != 1 && sigma != -1)) {
    return int(cudaErrorInvalidValue);
  }
  if (paper ? (cscr == nullptr || sscr == nullptr) : tscr == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  if (G > 1 && slabscr == nullptr) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<S, A>(P, k, paper);
  cudaError_t err = cudaFuncSetAttribute(
      fused_chain_kernel<KM, S, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int nP = n_pad / P;
  fused_chain_kernel<KM, S, A><<<B * nP * G, kWaveThreads, smem, stream>>>(
      static_cast<S*>(L), static_cast<const S*>(vt), static_cast<A*>(tscr),
      static_cast<A*>(cscr), static_cast<A*>(sscr), static_cast<S*>(slabscr),
      static_cast<int*>(flags), B, n_pad, P, k, G, sigma, paper);
  return int(cudaGetLastError());
}

// The diagonal sweep keeps KM >= k rotations per row in registers: k
// rounded up to 8, 16 or 32.
template <typename S, typename A>
int launch(void* L, const void* vt, void* tscr, void* cscr, void* sscr,
           void* slabscr, void* flags, int B, int n_pad, int P, int k, int G,
           int sigma, int paper, cudaStream_t stream) {
  if (k <= 8) {
    return launch_km<8, S, A>(L, vt, tscr, cscr, sscr, slabscr, flags, B,
                              n_pad, P, k, G, sigma, paper, stream);
  }
  if (k <= 16) {
    return launch_km<16, S, A>(L, vt, tscr, cscr, sscr, slabscr, flags, B,
                               n_pad, P, k, G, sigma, paper, stream);
  }
  return launch_km<32, S, A>(L, vt, tscr, cscr, sscr, slabscr, flags, B,
                             n_pad, P, k, G, sigma, paper, stream);
}

}  // namespace

// dtype: 0 = fp32 storage / fp32 accum, 1 = bf16 / fp32, 2 = f64 / f64.
// L: (B, n_pad, n_pad) storage, updated in place. vt: (B, k, n_pad)
// storage, read only. tscr: (B * nP, P+k, t_pitch) accum (gemm apply);
// cscr, sscr: (B * nP, P, k) accum (paper apply); slabscr: (B * nP, k, P)
// storage (G > 1). flags: 2 * B * nP + 1 ints, zero (the last one is the
// ticket counter). G: column groups per tile, dividing P. Returns a
// cudaError_t.
extern "C" int repro_fused_chain(void* L, const void* vt, void* tscr,
                                 void* cscr, void* sscr, void* slabscr,
                                 void* flags, int B, int n_pad, int P, int k,
                                 int G, int sigma, int paper, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(L, vt, tscr, cscr, sscr, slabscr, flags, B,
                                  n_pad, P, k, G, sigma, paper, st);
    case 1:
      return launch<__nv_bfloat16, float>(L, vt, tscr, cscr, sscr, slabscr,
                                           flags, B, n_pad, P, k, G, sigma,
                                           paper, st);
    case 2:
      return launch<double, double>(L, vt, tscr, cscr, sscr, slabscr, flags,
                                    B, n_pad, P, k, G, sigma, paper, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The padded row pitch of the transform scratch, for the wrapper.
extern "C" int repro_fused_chain_t_pitch(int P, int k) {
  return t_pitch(P, k);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
