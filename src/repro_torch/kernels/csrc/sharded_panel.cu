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
// Design. The upper tiles are products T[:P, :] [L; vt] on the
// transform-GEMM tile of gemm_tile.cuh: one CTA per strip of 64 columns of
// a tile, all P rows (3xTF32 on the tensor cores for fp32 accumulation, a
// cp.async ring of K slices, T_rr's zero slices skipped), so at n = 5120,
// P = 256 one shard's 190 upper tiles are 760 CTAs. A strip of the result
// depends only on the same strip of L and vt_in, so no two CTAs touch the
// same data and out may alias L. The grid is one line: the GEMM strips
// first, row panel by row panel, then one CTA per diagonal or lower tile,
// which copies D (its loads batched, so it is not bound by their latency)
// or writes zeros.
//
// What bounds it on an H100: the bytes, 0.050 ms at n = 5120, P = 256,
// k = 16 on one shard (the diagonal and zero tiles included). The upper
// tiles' P^2 (P+1) + 2 P^2 k operations each (T_rr lower triangular) take
// 0.022 ms as 3xTF32 at the TF32 rate over three; 3xTF32 keeps fp32
// accuracy, TF32 alone would break the fp32 error budget. See PERF.md.
#include <cstddef>
#include <cstdint>

#include "chol_tile.cuh"
#include "gemm_tile.cuh"

namespace {

using chol_tile::down;
using chol_tile::kMaxK;
using chol_tile::kMaxPanel;

// Tiles right of the diagonal in row panel p of a shard of nt tiles whose
// first global tile is tile_off (_launch.upper_tiles).
__host__ __device__ inline int upper_tiles(int p, int nt, int tile_off) {
  const int left = p - tile_off + 1 > 0 ? p - tile_off + 1 : 0;
  return nt > left ? nt - left : 0;
}
// A diagonal tile takes D (P x P, contiguous) rounded to storage, a lower
// tile (D null) zeros: each warp takes rows, two at a time, its lanes
// along them, with all its loads of D in flight before it stores. Not
// inlined: the GEMM strips' registers stay the kernel's budget.
template <typename S, typename A>
__device__ __noinline__ void copy_tile(S* O, int w, const A* D, int P) {
  constexpr int kWarps = gemm_tile::kThreads / 32, kRows = 2;
  constexpr int kCols = kMaxPanel / 32;
  const int lane = threadIdx.x & 31;
  for (int r0 = threadIdx.x >> 5; r0 < P; r0 += kRows * kWarps) {
    A v[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int r = r0 + i * kWarps, c = lane + 32 * j;
        v[i][j] = D != nullptr && r < P && c < P ? D[size_t(r) * P + c]
                                                 : A(0);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int r = r0 + i * kWarps, c = lane + 32 * j;
        if (r < P && c < P) O[size_t(r) * w + c] = down<S>(v[i][j]);
      }
    }
  }
}

// L, out: (B, n_panels P, w) storage, row-major, out may alias L. T: accum,
// member stride t_bs, panel stride t_ps, row pitch ldt. D: (B, n_panels,
// P, P) accum, contiguous. vt: (B, n_panels, k, w) storage, contiguous.
// Grid: (n_gemm GEMM strips, then the diagonal and lower tiles, B).
template <typename S, typename A>
__global__ void __launch_bounds__(gemm_tile::kThreads)
sharded_panel_kernel(const S* L, S* out, const A* T, long long t_bs,
                     long long t_ps, int ldt, const A* D, const S* vt,
                     int n_panels, int w, int P, int k, int tile_off,
                     int n_gemm) {
  using namespace gemm_tile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = w / P;
  const int strips = (P + kBN - 1) / kBN;
  const bool gemm = int(blockIdx.x) < n_gemm;
  int idx = gemm ? int(blockIdx.x) : int(blockIdx.x) - n_gemm;
  int p = 0, t = 0, c0 = 0;
  for (; p < n_panels; ++p) {
    const int u = upper_tiles(p, nt, tile_off);
    const int cnt = gemm ? u * strips : nt - u;
    if (idx < cnt) {
      t = gemm ? nt - u + idx / strips : idx;
      c0 = gemm ? idx % strips * kBN : 0;
      break;
    }
    idx -= cnt;
  }
  const int b = blockIdx.y;
  const size_t n = size_t(n_panels) * P;
  const size_t at = size_t(b) * n * w + size_t(p) * P * w + size_t(t) * P;
  S* O = out + at;
  if (gemm) {
    const S* Lt = L + at + c0;
    const S* v = vt + (size_t(b) * n_panels + p) * k * w + size_t(t) * P + c0;
    const bool vec = aligned_rows(Lt, w) && aligned_rows(v, w) &&
                     aligned_rows(O + c0, w);
    const Strip<S, A> st{Lt, v, w, w, min(kBN, P - c0),
                         T + b * t_bs + p * t_ps, ldt, P, k, P, vec};
    apply(st, 0, n_slices(P, k), 1, smem, O + c0, w, static_cast<S*>(nullptr),
          0, vec);
  } else {
    copy_tile(O, w, p == tile_off + t
                        ? D + (size_t(b) * n_panels + p) * P * P
                        : static_cast<const A*>(nullptr), P);
  }
}

template <typename S, typename A>
int launch(const void* L, void* out, const void* T, long long t_bs,
           long long t_ps, int ldt, const void* D, const void* vt, int B,
           int n_panels, int w, int P, int k, int tile_off,
           cudaStream_t stream) {
  if (B < 1 || n_panels < 1 || P < 1 || P > kMaxPanel || k < 1 ||
      k > kMaxK || w < P || w % P != 0 || ldt < P + k || tile_off < 0 ||
      B > 65535) {
    return int(cudaErrorInvalidValue);
  }
  const int nt = w / P;
  long long upper = 0;
  for (int p = 0; p < n_panels; ++p) upper += upper_tiles(p, nt, tile_off);
  constexpr int kBN = gemm_tile::kBN;
  const long long strips = (P + kBN - 1) / kBN;
  const long long n_gemm = upper * strips;
  const long long n_ctas = n_gemm + (long long)(n_panels) * nt - upper;
  if (n_ctas > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = gemm_tile::smem_bytes<S, A>(1);
  cudaError_t err = cudaFuncSetAttribute(
      sharded_panel_kernel<S, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(n_ctas), B);
  sharded_panel_kernel<S, A><<<grid, gemm_tile::kThreads, smem, stream>>>(
      static_cast<const S*>(L), static_cast<S*>(out),
      static_cast<const A*>(T), t_bs, t_ps, ldt, static_cast<const A*>(D),
      static_cast<const S*>(vt), n_panels, w, P, k, tile_off, int(n_gemm));
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32 storage / fp32 accum, 1 = bf16 / fp32, 2 = f64 / f64.
// Strides and pitches are in elements. Returns a cudaError_t.
extern "C" int repro_sharded_panel(const void* L, void* out, const void* T,
                                   long long t_bs, long long t_ps, int ldt,
                                   const void* D, const void* vt, int B,
                                   int n_panels, int w, int P, int k,
                                   int tile_off, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(L, out, T, t_bs, t_ps, ldt, D, vt, B,
                                  n_panels, w, P, k, tile_off, st);
    case 1:
      return launch<__nv_bfloat16, float>(L, out, T, t_bs, t_ps, ldt, D, vt,
                                          B, n_panels, w, P, k, tile_off,
                                          st);
    case 2:
      return launch<double, double>(L, out, T, t_bs, t_ps, ldt, D, vt, B,
                                    n_panels, w, P, k, tile_off, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
