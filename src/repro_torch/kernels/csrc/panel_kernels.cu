// Per-panel kernels of the paper's multi-kernel cascade on Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/cholupdate.py:
//   diag_block        (:282, body _diag_kernel :267 over diag_recurrence :45)
//   panel_apply_gemm  (:224, body _gemm_kernel :195)
//   panel_apply_paper (:149, body _paper_kernel :134 over apply_rotations :93)
// The cascade (repro_torch/kernels/ops.py) launches, per panel p, the
// diagonal pass on block (p, p) and then one panel apply over the trailing
// columns of row-panel p: 2 n_panels - 1 launches per update.
//
// Design. Every kernel takes its operands in place through a leading
// dimension (the row pitch of the padded factor) and a per-member stride,
// so the driver hands it views of the padded L and V^T and nothing is
// copied. A (B, n, n) fleet rides the same launch: one CTA per member for
// the diagonal pass, a grid over (column tile, member) for the applies.
// The diagonal sweep and the element-wise rotation chain are the fused
// kernel's tile math (chol_tile.cuh); the transform-GEMM apply runs on the
// tile of gemm_tile.cuh (3xTF32 on the tensor cores for fp32
// accumulation, a cp.async ring of K slices, full-height column strips so
// it may write in place, K split over a thread-block cluster for narrow
// applies). The diagonal pass is sweep_wavefront: the reference
// recurrence's own operations (square roots, divisions, no fused
// multiply-adds), so D_new, c, s and T are the plain recurrence's bit for
// bit (the rotation state carries all P k rotations of the block, and a
// warp-scan form drifts ~0.25 units a rotation), taken by anti-diagonals
// of (row, rotation), P + k - 1 dependent steps.
//
// What bounds them on an H100: the diagonal pass is one CTA per block,
// bounded by its dependent chain and one SM's issue rate (PERF.md), far
// above its bytes;
// the applies move the trailing panel once in and once out (bytes) and the
// gemm apply does 2 (P(P+1)/2 + 2Pk + k(k+1)/2) per column, T_rr and T_vv
// being lower triangular (operations at the fp32 rate: 3xTF32 keeps fp32
// accuracy, TF32 alone would break the fp32 error budget). Short launches at the tail of the
// cascade are bounded by launch latency. See PERF.md.
#include <cstddef>
#include <cstdint>

#include "chol_tile.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace chol_tile;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// The diagonal pass of one P x P block per fleet member. D (in place,
// leading dimension ld, member stride d_bs) and the V^T slab (k x P,
// leading dimension ldv, member stride v_bs) are storage; T
// ((P+k) x t_pitch per member), c and s (P x k per member) are accum.
// With zero_slab the slab is written back as the recurrence leaves it:
// annihilated.
template <int KM, typename S, typename A>
__global__ void __launch_bounds__(kWaveThreads)
diag_block_kernel(S* D, long long d_bs, int ld, S* vt, long long v_bs,
                  int ldv, A* T, A* c, A* s, int P, int k, int sigma_i,
                  int zero_slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) WaveSmem<A> ws;
  const int b = blockIdx.x;
  S* Db = D + b * d_bs;
  S* vb = vt + b * v_bs;
  S* slab = reinterpret_cast<S*>(smem);  // k x P, pitch P
  for (int e = threadIdx.x; e < k * P; e += kWaveThreads) {
    slab[e] = vb[size_t(e / P) * ldv + e % P];
  }
  __syncthreads();
  const size_t tp = t_pitch(P, k);
  sweep_wavefront<KM, S, A>(
      Db, ld, slab, ws, T == nullptr ? nullptr : T + b * size_t(P + k) * tp,
      c == nullptr ? nullptr : c + b * size_t(P) * k,
      s == nullptr ? nullptr : s + b * size_t(P) * k, P, k, A(sigma_i));
  if (zero_slab) {
    for (int e = threadIdx.x; e < k * P; e += kWaveThreads) {
      vb[size_t(e / P) * ldv + e % P] = down<S>(A(0));
    }
  }
}

// [R; vt] <- T [R; vt] on the column strip blockIdx.x / split (kBN
// columns, all P + k rows) of member blockIdx.y, K split over the `split`
// CTAs of a cluster at the slice boundaries `bounds` (gemm_tile.cuh
// rank_slices). R: P x w (leading dimension ldr), vt: k x w (ldv), both
// storage, in place; T: (P+k) x (P+k) accum per member (t_bs), row pitch
// ldt.
template <typename S, typename A>
__global__ void __launch_bounds__(gemm_tile::kThreads)
panel_gemm_kernel(S* R, long long r_bs, int ldr, S* vt, long long v_bs,
                  int ldv, const A* T, long long t_bs, int ldt, int w, int P,
                  int k, int split, unsigned bounds) {
  using namespace gemm_tile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x % split;
  const int c0 = blockIdx.x / split * kBN;
  const int b = blockIdx.y;
  S* Rb = R + b * r_bs + c0;
  S* vb = vt + b * v_bs + c0;
  const bool vec = aligned_rows(Rb, ldr) && aligned_rows(vb, ldv);
  const Strip<S, A> st{Rb,  vb, ldr, ldv,   min(kBN, w - c0), T + b * t_bs,
                       ldt, P,  k,   P + k, vec};
  int s_lo, s_hi;
  rank_slices(n_slices(P, k), split, rank, bounds, s_lo, s_hi);
  apply(st, s_lo, s_hi, split, smem, Rb, ldr, vb, ldv, vec);
}

// The paper's element-wise apply on the same grid; c, s: P x k accum per
// member (cs_bs), staged in shared memory.
template <int KM, typename S, typename A>
__global__ void __launch_bounds__(kThreads)
panel_paper_kernel(S* R, long long r_bs, int ldr, S* vt, long long v_bs,
                   int ldv, const A* c, const A* s, long long cs_bs, int w,
                   int cw, int P, int k, int sigma_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* cs = reinterpret_cast<A*>(smem);
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cw;
  const int W = min(cw, w - c0);
  rotation_apply_tile<KM, S, A>(R + b * r_bs + c0, ldr, vt + b * v_bs + c0,
                                ldv, W, c + b * cs_bs, s + b * cs_bs, cs, P,
                                k, A(sigma_i));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

bool shape_ok(int B, int P, int k, int sigma) {
  return B >= 1 && P >= 1 && P <= kMaxPanel && k >= 1 && k <= kMaxK &&
         (sigma == 1 || sigma == -1);
}

template <int KM, typename S, typename A>
int diag_km(void* D, long long d_bs, int ld, void* vt, long long v_bs,
            int ldv, void* T, void* c, void* s, int B, int P, int k,
            int sigma, int zero_slab, cudaStream_t stream) {
  const size_t smem = align16(sizeof(S) * size_t(k) * P);
  cudaError_t err = allow_smem(diag_block_kernel<KM, S, A>, smem);
  if (err != cudaSuccess) return int(err);
  diag_block_kernel<KM, S, A><<<B, kWaveThreads, smem, stream>>>(
      static_cast<S*>(D), d_bs, ld, static_cast<S*>(vt), v_bs, ldv,
      static_cast<A*>(T), static_cast<A*>(c), static_cast<A*>(s), P, k,
      sigma, zero_slab);
  return int(cudaGetLastError());
}

template <typename S, typename A>
int diag_launch(void* D, long long d_bs, int ld, void* vt, long long v_bs,
                int ldv, void* T, void* c, void* s, int B, int P, int k,
                int sigma, int zero_slab, cudaStream_t stream) {
  if (!shape_ok(B, P, k, sigma) || ld < P || ldv < P) {
    return int(cudaErrorInvalidValue);
  }
  if (k <= 8) {
    return diag_km<8, S, A>(D, d_bs, ld, vt, v_bs, ldv, T, c, s, B, P, k,
                            sigma, zero_slab, stream);
  }
  if (k <= 16) {
    return diag_km<16, S, A>(D, d_bs, ld, vt, v_bs, ldv, T, c, s, B, P, k,
                             sigma, zero_slab, stream);
  }
  return diag_km<32, S, A>(D, d_bs, ld, vt, v_bs, ldv, T, c, s, B, P, k,
                           sigma, zero_slab, stream);
}

template <int KM, typename S, typename A>
int paper_km(void* R, long long r_bs, int ldr, void* vt, long long v_bs,
             int ldv, const void* c, const void* s, long long cs_bs, int B,
             int w, int cw, int P, int k, int sigma, cudaStream_t stream) {
  const size_t smem = sizeof(A) * size_t(paper_work_elems(P, k));
  cudaError_t err = allow_smem(panel_paper_kernel<KM, S, A>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((w + cw - 1) / cw, B);
  panel_paper_kernel<KM, S, A><<<grid, kThreads, smem, stream>>>(
      static_cast<S*>(R), r_bs, ldr, static_cast<S*>(vt), v_bs, ldv,
      static_cast<const A*>(c), static_cast<const A*>(s), cs_bs, w, cw, P, k,
      sigma);
  return int(cudaGetLastError());
}

template <typename S, typename A>
int paper_launch(void* R, long long r_bs, int ldr, void* vt, long long v_bs,
                 int ldv, const void* c, const void* s, long long cs_bs,
                 int B, int w, int cw, int P, int k, int sigma,
                 cudaStream_t stream) {
  if (!shape_ok(B, P, k, sigma) || w < 1 || cw < 1 || ldr < w ||
      ldv < w || c == nullptr || s == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  if (k <= 8) {
    return paper_km<8, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, cs_bs, B, w,
                             cw, P, k, sigma, stream);
  }
  if (k <= 16) {
    return paper_km<16, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, cs_bs, B,
                              w, cw, P, k, sigma, stream);
  }
  return paper_km<32, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, cs_bs, B, w,
                            cw, P, k, sigma, stream);
}

// Whether bounds holds split - 1 ascending slice boundaries inside
// (0, n_slices), one byte each from the lowest.
inline bool bounds_ok(unsigned bounds, int split, int n_slices) {
  int prev = 0;
  for (int j = 0; j < split - 1; ++j) {
    const int b = int((bounds >> (8 * j)) & 255u);
    if (b <= prev || b >= n_slices) return false;
    prev = b;
  }
  return true;
}

// Grid: (ceil(w / kBN) strips x split, B), clusters of split CTAs along x.
template <typename S, typename A>
int gemm_launch(void* R, long long r_bs, int ldr, void* vt, long long v_bs,
                int ldv, const void* T, long long t_bs, int ldt, int B,
                int w, int P, int k, int split, unsigned bounds,
                cudaStream_t stream) {
  if (!shape_ok(B, P, k, 1) || B > 65535 || w < 1 || ldr < w || ldv < w ||
      T == nullptr || ldt < P + k ||
      !(split == 1 || split == 2 || split == gemm_tile::kMaxSplit) ||
      !bounds_ok(bounds, split, gemm_tile::n_slices(P, k))) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = gemm_tile::smem_bytes<S, A>(split);
  cudaError_t err = allow_smem(panel_gemm_kernel<S, A>, smem);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  constexpr int kBN = gemm_tile::kBN;
  cfg.gridDim = dim3((w + kBN - 1) / kBN * split, B);
  cfg.blockDim = dim3(gemm_tile::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, panel_gemm_kernel<S, A>, static_cast<S*>(R),
                           r_bs, ldr, static_cast<S*>(vt), v_bs, ldv,
                           static_cast<const A*>(T), t_bs, ldt, w, P, k,
                           split, bounds);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// Clusters of split CTAs of the gemm apply the device holds at once
// (split 1: CTAs), or a negative cudaError_t.
template <typename S, typename A>
int gemm_capacity(int split) {
  const size_t smem = gemm_tile::smem_bytes<S, A>(split);
  cudaError_t err = allow_smem(panel_gemm_kernel<S, A>, smem);
  int n = 0;
  if (err == cudaSuccess && split == 1) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, panel_gemm_kernel<S, A>, gemm_tile::kThreads, smem);
    }
    n *= sms;
  } else if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split * 1024);
    cfg.blockDim = dim3(gemm_tile::kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(panel_gemm_kernel<S, A>), &cfg);
  }
  return err == cudaSuccess ? n : -int(err);
}

}  // namespace

// dtype: 0 = fp32 storage / fp32 accum, 1 = bf16 / fp32, 2 = f64 / f64.
// Strides and leading dimensions are in elements. Each returns a
// cudaError_t.

// The diagonal pass of B members. D: storage, in place. vt: the V^T slab,
// storage, read (and zeroed when zero_slab). T: (B, P+k, t_pitch) accum,
// zero padding written by the kernel, or null; c, s: (B, P, k) accum, or
// null.
extern "C" int repro_diag_block(void* D, long long d_bs, int ld, void* vt,
                                long long v_bs, int ldv, void* T, void* c,
                                void* s, int B, int P, int k, int sigma,
                                int zero_slab, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return diag_launch<float, float>(D, d_bs, ld, vt, v_bs, ldv, T, c, s,
                                       B, P, k, sigma, zero_slab, st);
    case 1:
      return diag_launch<__nv_bfloat16, float>(D, d_bs, ld, vt, v_bs, ldv, T,
                                               c, s, B, P, k, sigma,
                                               zero_slab, st);
    case 2:
      return diag_launch<double, double>(D, d_bs, ld, vt, v_bs, ldv, T, c, s,
                                         B, P, k, sigma, zero_slab, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The transform-GEMM apply over w trailing columns of B members: T
// ((B, P+k, P+k) accum, row pitch ldt, member stride t_bs), K split over
// clusters of split (1, 2 or 4) CTAs at the slice boundaries bounds
// (split - 1 ascending bytes from the lowest; 0 for split 1).
extern "C" int repro_panel_gemm(void* R, long long r_bs, int ldr, void* vt,
                                long long v_bs, int ldv, const void* T,
                                long long t_bs, int ldt, int B, int w, int P,
                                int k, int split, unsigned bounds, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return gemm_launch<float, float>(R, r_bs, ldr, vt, v_bs, ldv, T, t_bs,
                                       ldt, B, w, P, k, split, bounds, st);
    case 1:
      return gemm_launch<__nv_bfloat16, float>(R, r_bs, ldr, vt, v_bs, ldv,
                                               T, t_bs, ldt, B, w, P, k,
                                               split, bounds, st);
    case 2:
      return gemm_launch<double, double>(R, r_bs, ldr, vt, v_bs, ldv, T,
                                         t_bs, ldt, B, w, P, k, split,
                                         bounds, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Clusters of split CTAs of the transform-GEMM apply that the current
// device holds at once (split 1: CTAs), or a negative cudaError_t.
extern "C" int repro_panel_gemm_capacity(int split, int dtype) {
  switch (dtype) {
    case 0:
      return gemm_capacity<float, float>(split);
    case 1:
      return gemm_capacity<__nv_bfloat16, float>(split);
    case 2:
      return gemm_capacity<double, double>(split);
    default:
      return -int(cudaErrorInvalidValue);
  }
}

// The paper's apply over w trailing columns of B members, cw columns per
// CTA: c, s ((B, P, k) accum, member stride cs_bs).
extern "C" int repro_panel_paper(void* R, long long r_bs, int ldr, void* vt,
                                 long long v_bs, int ldv, const void* c,
                                 const void* s, long long cs_bs, int B,
                                 int w, int cw, int P, int k, int sigma,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return paper_launch<float, float>(R, r_bs, ldr, vt, v_bs, ldv, c, s,
                                        cs_bs, B, w, cw, P, k, sigma, st);
    case 1:
      return paper_launch<__nv_bfloat16, float>(R, r_bs, ldr, vt, v_bs, ldv,
                                                c, s, cs_bs, B, w, cw, P, k,
                                                sigma, st);
    case 2:
      return paper_launch<double, double>(R, r_bs, ldr, vt, v_bs, ldv, c, s,
                                          cs_bs, B, w, cw, P, k, sigma, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The padded row pitch of the T that repro_diag_block writes.
extern "C" int repro_panel_t_pitch(int P, int k) { return t_pitch(P, k); }

// The transform-GEMM tile's layout that the host's split and slice costs
// assume (_launch.GEMM_BN, GEMM_BK, GEMM_WARP_BLOCKS): out[0] the strip's
// columns, out[1] a K slice's values, out[2 + w] and out[11 + w] warp w's
// row block with the vt rows and panel only.
extern "C" void repro_gemm_tile_layout(int* out) {
  out[0] = gemm_tile::kBN;
  out[1] = gemm_tile::kBK;
  for (int w = 0; w < gemm_tile::kThreads / 32; ++w) {
    out[2 + w] = gemm_tile::row_block(w, true);
    out[11 + w] = gemm_tile::row_block(w, false);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
