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
// The tile math is the fused kernel's (chol_tile.cuh): the diagonal sweep
// (two live columns per thread, V values in registers), the transform-GEMM
// apply (T strips through L2 by cp.async) and the element-wise rotation
// chain. The diagonal pass runs the sweep in its reference arithmetic
// (diag_tile's kRef: each row's rotations one at a time, divisions, no
// fused multiply-adds), so D_new, c, s and T are the plain recurrence's
// own values; the rotation state carries all P k rotations of the block,
// and the faster warp-scan form drifts from the plain values by ~0.25
// units per rotation.
//
// What bounds them on an H100: the diagonal pass is one CTA walking P
// dependent rows of k serial rotations (PERF.md), far above its bytes;
// the applies move the trailing panel once in and once out (bytes) and the
// gemm apply does 2 (P+k)^2 per column (operations, fp32 CUDA cores: TF32
// would break the fp32 error budget). Short launches at the tail of the
// cascade are bounded by launch latency. See PERF.md.
#include <cstddef>
#include <cstdint>

#include "chol_tile.cuh"

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
__global__ void __launch_bounds__(kThreads)
diag_block_kernel(S* D, long long d_bs, int ld, S* vt, long long v_bs,
                  int ldv, A* T, A* c, A* s, int P, int k, int sigma_i,
                  int zero_slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) A rot[kRotElems];
  __shared__ A vnext[kNextElems];
  __shared__ A dg[kMaxPanel];
  const int b = blockIdx.x;
  S* Db = D + b * d_bs;
  S* vb = vt + b * v_bs;
  S* slab = reinterpret_cast<S*>(smem);  // k x P, pitch P
  for (int e = threadIdx.x; e < k * P; e += kThreads) {
    slab[e] = vb[size_t(e / P) * ldv + e % P];
  }
  __syncthreads();
  const size_t tp = t_pitch(P, k);
  diag_tile<KM, S, A, true>(Db, ld, slab, rot, vnext, dg,
                      T == nullptr ? nullptr : T + b * size_t(P + k) * tp,
                      c == nullptr ? nullptr : c + b * size_t(P) * k,
                      s == nullptr ? nullptr : s + b * size_t(P) * k, P, k,
                      A(sigma_i));
  if (zero_slab) {
    for (int e = threadIdx.x; e < k * P; e += kThreads) {
      vb[size_t(e / P) * ldv + e % P] = down<S>(A(0));
    }
  }
}

// [R; vt] <- T [R; vt] on column tile blockIdx.x (cw columns) of member
// blockIdx.y. R: P x w (leading dimension ldr), vt: k x w (ldv), both
// storage, in place; T: (P+k) x (P+k) accum per member (t_bs), row pitch
// ldt.
template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
panel_gemm_kernel(S* R, long long r_bs, int ldr, S* vt, long long v_bs,
                  int ldv, const A* T, long long t_bs, int ldt, int w, int cw,
                  int P, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* xbuf = reinterpret_cast<A*>(smem);
  A* tstrip = xbuf + kTRows * kChunkW;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cw;
  const int W = min(cw, w - c0);
  gemm_apply_tile<S, A>(R + b * r_bs + c0, ldr, vt + b * v_bs + c0, ldv, W,
                        T + b * t_bs, ldt, xbuf, tstrip, P, k);
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
  diag_block_kernel<KM, S, A><<<B, kThreads, smem, stream>>>(
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
int apply_launch(void* R, long long r_bs, int ldr, void* vt, long long v_bs,
                 int ldv, const void* T, int ldt, const void* c,
                 const void* s, long long st_bs, int B, int w, int cw, int P,
                 int k, int sigma, int paper, cudaStream_t stream) {
  if (!shape_ok(B, P, k, sigma) || w < 1 || cw < 1 || ldr < w ||
      ldv < w) {
    return int(cudaErrorInvalidValue);
  }
  if (paper) {
    if (c == nullptr || s == nullptr) return int(cudaErrorInvalidValue);
    if (k <= 8) {
      return paper_km<8, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, st_bs, B,
                               w, cw, P, k, sigma, stream);
    }
    if (k <= 16) {
      return paper_km<16, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, st_bs, B,
                                w, cw, P, k, sigma, stream);
    }
    return paper_km<32, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, st_bs, B,
                              w, cw, P, k, sigma, stream);
  }
  if (T == nullptr || ldt < P + k) return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(A) * size_t(gemm_work_elems<A>());
  cudaError_t err = allow_smem(panel_gemm_kernel<S, A>, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((w + cw - 1) / cw, B);
  panel_gemm_kernel<S, A><<<grid, kThreads, smem, stream>>>(
      static_cast<S*>(R), r_bs, ldr, static_cast<S*>(vt), v_bs, ldv,
      static_cast<const A*>(T), st_bs, ldt, w, cw, P, k);
  return int(cudaGetLastError());
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

// One panel apply over w trailing columns of B members, cw columns per
// CTA. paper = 0: T ((B, P+k, P+k) accum, row pitch ldt, member stride
// st_bs); paper = 1: c, s ((B, P, k) accum, member stride st_bs).
extern "C" int repro_panel_apply(void* R, long long r_bs, int ldr, void* vt,
                                 long long v_bs, int ldv, const void* T,
                                 int ldt, const void* c, const void* s,
                                 long long st_bs, int B, int w, int cw,
                                 int P, int k, int sigma, int paper,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return apply_launch<float, float>(R, r_bs, ldr, vt, v_bs, ldv, T, ldt,
                                        c, s, st_bs, B, w, cw, P, k, sigma,
                                        paper, st);
    case 1:
      return apply_launch<__nv_bfloat16, float>(R, r_bs, ldr, vt, v_bs, ldv,
                                                T, ldt, c, s, st_bs, B, w, cw,
                                                P, k, sigma, paper, st);
    case 2:
      return apply_launch<double, double>(R, r_bs, ldr, vt, v_bs, ldv, T, ldt,
                                          c, s, st_bs, B, w, cw, P, k, sigma,
                                          paper, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The padded row pitch of the T that repro_diag_block writes.
extern "C" int repro_panel_t_pitch(int P, int k) { return t_pitch(P, k); }

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
