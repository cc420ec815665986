// Panel phase of the column-sharded rank-k up/down-date on Hopper (sm_90a):
// one launch per shard per update, for a factor or a fleet.
//
// Replaces the TPU kernel repro/kernels/sharded.py:panel_apply_sharded
// (:118, body _panel_kernel :67). The column-sharded driver
// (repro_torch/core/distributed.py) first runs the chain phase: per panel p
// the diagonal pass on the gathered block gives the transform T^(p), the
// new diagonal block D^(p) and the running V^T entering panel p. Every row
// panel of L is read in its original state, so the tiles of the shard are
// then independent. Tile (p, t) of the shard, global tile g = tile_off + t:
//
//   p <  g:  L[p, t] <- T_rr^(p) L[p, t] + T_rv^(p) vt_in^(p)[:, t]
//   p == g:  L[p, t] <- D^(p), rounded to storage
//   p >  g:  L[p, t] <- 0
//
// with T_rr = T[:P, :P] and T_rv = T[:P, P:].
//
// Design. One CTA owns all P rows of a strip of cw columns of one tile
// (b, p, t): a strip of the result depends only on the same strip of L and
// vt_in, so no two CTAs touch the same data and the kernel may write in
// place. The apply is the transform-GEMM tile of the other kernels
// (chol_tile.cuh gemm_apply_tile) in its panel-only form: only the first P
// rows of T are applied and the new V^T is not written, as the chain phase
// already produced it. The diagonal and zero tiles are plain copies.
//
// What bounds it on an H100: the upper tiles' 2 P^2 (P+k) operations each
// (fp32 CUDA cores: TF32 would break the fp32 error budget); at n = 5120,
// P = 256, k = 16 on one shard that is ~0.10 ms against ~0.05 ms of bytes.
// See PERF.md.
#include <cstddef>
#include <cstdint>

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

// L, out: (B, n_panels P, w) storage, row-major, out may alias L. T: accum,
// member stride t_bs, panel stride t_ps, row pitch ldt. D: (B, n_panels,
// P, P) accum, contiguous. vt: (B, n_panels, k, w) storage, contiguous.
// Grid: (tiles of the shard x strips of a tile, n_panels, B).
template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
sharded_panel_kernel(const S* L, S* out, const A* T, long long t_bs,
                     long long t_ps, int ldt, const A* D, const S* vt,
                     int n_panels, int w, int P, int k, int tile_off,
                     int cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* xbuf = reinterpret_cast<A*>(smem);
  A* tstrip = xbuf + kTRows * kChunkW;
  const int strips = (P + cw - 1) / cw;
  const int t = blockIdx.x / strips;
  const int c0 = (blockIdx.x % strips) * cw;
  const int W = min(cw, P - c0);
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int g = tile_off + t;
  const size_t n = size_t(n_panels) * P;
  const size_t at =
      size_t(b) * n * w + size_t(p) * P * w + size_t(t) * P + c0;
  S* O = out + at;
  if (p < g) {
    const S* v = vt + (size_t(b) * n_panels + p) * k * w + size_t(t) * P + c0;
    gemm_apply_tile<S, A, true>(const_cast<S*>(L + at), w, const_cast<S*>(v),
                                w, W, T + b * t_bs + p * t_ps, ldt, xbuf,
                                tstrip, P, k, O);
  } else if (p == g) {
    const A* Dp = D + (size_t(b) * n_panels + p) * P * P + c0;
    for (int e = threadIdx.x; e < P * W; e += kThreads) {
      const int r = e / W, c = e % W;
      O[size_t(r) * w + c] = down<S>(Dp[size_t(r) * P + c]);
    }
  } else {
    for (int e = threadIdx.x; e < P * W; e += kThreads) {
      O[size_t(e / W) * w + e % W] = down<S>(A(0));
    }
  }
}

template <typename S, typename A>
int launch(const void* L, void* out, const void* T, long long t_bs,
           long long t_ps, int ldt, const void* D, const void* vt, int B,
           int n_panels, int w, int P, int k, int tile_off, int cw,
           cudaStream_t stream) {
  if (B < 1 || n_panels < 1 || P < 1 || P > kMaxPanel || k < 1 ||
      k > kMaxK || w < P || w % P != 0 || cw < 1 || ldt < P + k ||
      tile_off < 0 || B > 65535 || n_panels > 65535) {
    return int(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(A) * size_t(gemm_work_elems<A>());
  cudaError_t err = cudaFuncSetAttribute(
      sharded_panel_kernel<S, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int strips = (P + cw - 1) / cw;
  const dim3 grid((w / P) * strips, n_panels, B);
  sharded_panel_kernel<S, A><<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(L), static_cast<S*>(out),
      static_cast<const A*>(T), t_bs, t_ps, ldt, static_cast<const A*>(D),
      static_cast<const S*>(vt), n_panels, w, P, k, tile_off, cw);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32 storage / fp32 accum, 1 = bf16 / fp32, 2 = f64 / f64.
// Strides and pitches are in elements. Returns a cudaError_t.
extern "C" int repro_sharded_panel(const void* L, void* out, const void* T,
                                   long long t_bs, long long t_ps, int ldt,
                                   const void* D, const void* vt, int B,
                                   int n_panels, int w, int P, int k,
                                   int tile_off, int cw, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(L, out, T, t_bs, t_ps, ldt, D, vt, B,
                                  n_panels, w, P, k, tile_off, cw, st);
    case 1:
      return launch<__nv_bfloat16, float>(L, out, T, t_bs, t_ps, ldt, D, vt,
                                          B, n_panels, w, P, k, tile_off, cw,
                                          st);
    case 2:
      return launch<double, double>(L, out, T, t_bs, t_ps, ldt, D, vt, B,
                                    n_panels, w, P, k, tile_off, cw, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
