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
// Design. Each fleet member's chain is walked by one group of threads; the
// members of a fleet run side by side in the same launch. The chain's
// inputs (every diag, off and V^T slab) are known at launch, so they are
// prefetched into L2 a block ahead, and T_j stays on the SM where it fits.
// Two routes:
//
// * One warp a member (b + k <= 32: the Kalman smoother, the structured
//   fleet). Lanes are the columns of the augmented block, so the sweep
//   (chol_tile.cuh sweep_warp: no block barrier, the warp computing each
//   row's rotations by a warp scan), T_j and the apply (lane r forms row r
//   of T_j [off[j]; slab j+1]) stay in the warp's shared memory and
//   registers, synchronised by __syncwarp. While block j is swept, the
//   warp copies block j+1's inputs (diag[j+1], off[j+1], slab j+2) from L2
//   into a second stage buffer, one piece a sweep row (loaded at row i,
//   stored at row i+1).
// * One CTA a member (wider blocks): the block-wide sweep diag_tile (the
//   redesigned block-wide form measured slower at these sizes, PERF.md),
//   then gemm_apply_tile, with T_j in shared memory where it fits (else in
//   the member's scratch, read through L2 by cp.async). A block wider than
//   kMaxPanel rows is swept as row sub-tiles of kMaxPanel rows (the last
//   one ragged): sub-tile s sweeps its diagonal tile with the running
//   slab's columns of s, and its rotations go, in the reference's own
//   operations, to the same rows' columns to the right (the rest of
//   diag[j], with the running slab's remaining columns) and to the rows of
//   the block's whole transform T_j (in the member's scratch, built from
//   the identity as the plain chain builds it); then T_j [off[j]; slab
//   j+1] is formed once, as the plain chain forms it. The running slabs
//   stay in the accumulation type inside a block and are rounded to
//   storage once a block, as the plain chain stores them. Blocks of
//   kMaxPanel rows and more sweep in the reference's arithmetic
//   (diag_tile's kRef).
//
// What bounds it on an H100: by bytes, each block read and written once
// plus V^T read once (blocktridiag.bytes_per_update: 4.2 MB for nb = 8192,
// b = 4, k = 16 in fp32, ~1.3 us at 3.35 TB/s). The chain is nb b dependent
// sweep rows plus an apply a block: latency, far above both roofline
// bounds at small b. See PERF.md.
#include <cstddef>
#include <cstdint>

#include "chol_tile.cuh"

namespace {

using namespace chol_tile;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared memory a CTA may use, less a margin the CUDA driver keeps.
constexpr size_t kSmemBudget = 232448 - 1024;

// ---- one warp a member (b + k <= 32) ----------------------------------------

// A warp's shared memory: the sweep's rotation slot (4 kMaxK accum), two
// stage buffers of one block's inputs (E storage elements each: diag[j],
// off[j], slab j+1), the running slab (k x b, accum) and T ((b + k) rows
// at an odd pitch: lane r reads row r without bank conflicts).
struct WarpLayout {
  int E, tpw;
  size_t stage, slab, t, bytes;
};

template <typename S, typename A>
__host__ __device__ inline WarpLayout warp_layout(int b, int k) {
  WarpLayout L{};
  L.E = 2 * b * b + k * b;
  L.tpw = (b + k) | 1;
  L.stage = align16(sizeof(A) * 4 * kMaxK);
  L.slab = L.stage + align16(2 * sizeof(S) * size_t(L.E));
  L.t = L.slab + align16(sizeof(A) * size_t(k) * b);
  L.bytes = L.t + align16(sizeof(A) * size_t(b + k) * L.tpw);
  return L;
}

// One warp a CTA, one CTA a member. The body is written as for a CTA of
// several warps (the member from the warp index, its shared memory at
// warp * L.bytes, a bound check on B), which nvcc schedules faster than
// the same arithmetic written for one warp: 51.2 against 56.3 ms a
// smoother launch on an H100 80GB HBM3, equal outputs (PERF.md).
template <int KM, typename S, typename A>
__global__ void __launch_bounds__(128)
btd_warp_kernel(S* diag, S* off, const S* vt, int B, int nb, int b, int k,
                int sigma_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x * (blockDim.x >> 5) + warp;
  if (m >= B) return;
  const WarpLayout L = warp_layout<S, A>(b, k);
  unsigned char* base = smem + warp * L.bytes;
  A* xchg = reinterpret_cast<A*>(base);
  S* stage[2] = {reinterpret_cast<S*>(base + L.stage),
                 reinterpret_cast<S*>(base + L.stage) + L.E};
  A* slab = reinterpret_cast<A*>(base + L.slab);
  A* T = reinterpret_cast<A*>(base + L.t);
  const int bb = b * b, pk = b + k;
  const size_t n = size_t(nb) * b;
  S* Dm = diag + size_t(m) * nb * bb;
  S* Om = off + size_t(m) * (nb - 1) * bb;
  const S* vm = vt + size_t(m) * k * n;
  const A sigma = A(sigma_i);
  // Element e of block j's inputs: diag[j], then off[j] and slab j+1 (not
  // for the last block).
  auto src = [&](int j, int e) -> const S* {
    if (e < bb) return Dm + size_t(j) * bb + e;
    if (e < 2 * bb) return Om + size_t(j) * bb + (e - bb);
    const int r = (e - 2 * bb) / b;
    return vm + r * n + size_t(j + 1) * b + (e - 2 * bb) % b;
  };
  auto count = [&](int j) { return j + 1 < nb ? L.E : bb; };
  auto prefetch = [&](int j) {
    constexpr int kPer = 32 / int(sizeof(S));  // elements a 32-byte sector
    if (j >= nb) return;
    for (int e = lane * kPer; e < count(j); e += 32 * kPer) {
      prefetch_l2(src(j, e));
    }
  };
  prefetch(1);
  for (int e = lane; e < count(0); e += 32) stage[0][e] = *src(0, e);
  for (int e = lane; e < k * b; e += 32) {
    slab[e] = up<A>(vm[size_t(e / b) * n + e % b]);
  }
  __syncwarp();
  for (int j = 0; j < nb; ++j) {
    const S* cur = stage[j & 1];
    S* nxt = stage[(j + 1) & 1];
    prefetch(j + 2);
    // Block j+1's inputs, a piece of `per` elements each sweep row.
    const int En = j + 1 < nb ? count(j + 1) : 0;
    const int per = (En + b - 1) / b;
    S held[2];
    auto put = [&](int i) {  // store piece i, loaded a row earlier
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int e = i * per + lane + 32 * t;
        if (lane + 32 * t < per && e < En) nxt[e] = held[t];
      }
    };
    auto stream = [&](int i) {
      if (i > 0) put(i - 1);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int e = i * per + lane + 32 * t;
        if (lane + 32 * t < per && e < En) held[t] = *src(j + 1, e);
      }
    };
    sweep_warp<KM, S, A, A>(cur, b, Dm + size_t(j) * bb, b, slab, b, xchg,
                            T, L.tpw, b, k, sigma, stream);
    put(b - 1);
    if (j + 1 < nb) {
      // Lane r < b + k: row r of T_j [off[j]; slab j+1], four columns at a
      // time; rows < b are off[j]'s, the rest the next running slab's,
      // rounded to storage as the plain chain stores it.
      const S* Oc = cur + bb;
      const S* Vc = cur + 2 * bb;
      S* Oout = Om + size_t(j) * bb;
      if (lane < pk) {
        const A* Tr = T + lane * L.tpw;
        for (int c0 = 0; c0 < b; c0 += 4) {
          A acc[4] = {A(0), A(0), A(0), A(0)};
          for (int qq = 0; qq < pk; ++qq) {
            const A t = Tr[qq];
            const S* x = qq < b ? Oc + qq * b : Vc + (qq - b) * b;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (c0 + u < b) acc[u] += t * up<A>(x[c0 + u]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (c0 + u >= b) continue;
            if (lane < b) {
              Oout[lane * b + c0 + u] = down<S>(acc[u]);
            } else {
              slab[(lane - b) * b + c0 + u] = up<A>(down<S>(acc[u]));
            }
          }
        }
      }
    }
    __syncwarp();
  }
}

// ---- one CTA a member --------------------------------------------------------

// The CTA route's shared memory: the apply's column chunk (xbuf), the
// sweep's copy of a sub-tile's slab columns (k x kMaxPanel, accum), then,
// for a block of at most kMaxPanel rows, T_j (rows padded to the apply's
// whole row blocks) where it fits, else the apply's strips of it
// (tstrip), and the two running slabs (2 k b, accum) where they fit. The
// member's global scratch (`scratch` accum elements) holds what does not
// fit: T_j at 0, the slabs at slab_g; and for a block wider than
// kMaxPanel (`sub`) the block's whole transform (tf, (b+k) x (b+k)), the
// product's buffer (y, (b+k) x b) and a sub-tile's rotations (cs: c, then
// s, kMaxPanel x k each).
struct BlockLayout {
  bool sub, t_smem, slab_smem;
  int t_elems;
  size_t stage, tstrip, t, slab, bytes;
  size_t slab_g, tf, y, cs, scratch;
};

// Static shared memory of the CTA kernel: diag_tile's rotation rows,
// next pivot's V values and diagonal.
template <typename A>
__host__ __device__ constexpr size_t block_static_bytes() {
  return sizeof(A) * (kRotElems + kNextElems + kMaxPanel);
}

__host__ __device__ constexpr size_t round4(size_t x) {
  return (x + 3) / 4 * 4;
}

template <typename A>
__host__ __device__ inline BlockLayout block_layout(int b, int k) {
  BlockLayout L{};
  L.sub = b > kMaxPanel;
  const int P = L.sub ? kMaxPanel : b;
  const size_t budget = kSmemBudget - block_static_bytes<A>();
  L.stage = sizeof(A) * kTRows * kChunkW;
  size_t end = L.stage + align16(sizeof(A) * size_t(k) * P);
  size_t g = 0;
  L.t = L.tstrip = end;
  if (!L.sub) {
    const int rows = (b + k + kRowsPerThread - 1) / kRowsPerThread *
                     kRowsPerThread;
    L.t_elems = rows * t_pitch(b, k);
    const size_t tb = sizeof(A) * size_t(L.t_elems);
    L.t_smem = end + tb <= budget;
    if (L.t_smem) {
      end += tb;
    } else {
      end += sizeof(A) * 2 * kTRows * strip_q<A>();
      g = round4(L.t_elems);
    }
  }
  const size_t slab_elems = 2 * size_t(k) * b;
  const size_t sb = align16(sizeof(A) * slab_elems);
  L.slab = end;
  L.slab_smem = end + sb <= budget;
  if (L.slab_smem) {
    end += sb;
  } else {
    L.slab_g = g;
    g += round4(slab_elems);
  }
  L.bytes = end;
  if (L.sub) {
    const size_t pk = size_t(b) + k;
    L.tf = g;
    L.y = L.tf + round4(pk * pk);
    L.cs = L.y + round4(pk * b);
    g = L.cs + 2 * size_t(kMaxPanel) * k;
  }
  L.scratch = g;
  return L;
}

// A sub-tile's rotations (rows [r0, r0 + P) of the block; c, s: P x k,
// global, staged in shared memory cs) on W columns: the sub-tile's rows of
// them, R (leading dimension ld), and the V rows, V (k rows of accum,
// pitch vp). Each column goes through the rows in order in the
// reference's own operations (rotate<true>), as the plain chain's sweep of
// the whole block takes it, so these columns leave the sub-tile with the
// plain chain's values. cs holds 2 P k accum values: the chunk and stage
// buffers, idle here.
template <int KM, typename S, typename A>
__device__ void ref_apply_cols(S* R, int ld, A* V, int vp, int W,
                               const A* c, const A* s, A* cs, int P, int k,
                               A sigma) {
  A* cs_c = cs;
  A* cs_s = cs + P * k;
  for (int e = threadIdx.x; e < P * k; e += kThreads) {
    cs_c[e] = load_cg(c + e);
    cs_s[e] = load_cg(s + e);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += kThreads) {
    A v[KM];
#pragma unroll
    for (int m = 0; m < KM; ++m) v[m] = (m < k) ? V[m * vp + j] : A(0);
    for (int i = 0; i < P; ++i) {
      A y = up<A>(R[size_t(i) * ld + j]);
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        if (m < k) {
          rotate<true, A>(y, v[m], cs_c[i * k + m], cs_s[i * k + m], A(1),
                          sigma);
        }
      }
      R[size_t(i) * ld + j] = down<S>(y);
    }
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      if (m < k) V[m * vp + j] = v[m];
    }
  }
  __syncthreads();
}

// [off; V] <- T [off; V] for a block wider than kMaxPanel: T ((b+k) x
// (b+k), accum, row pitch b + k, global) as the plain chain forms it, off
// (b x b storage, in place) and V (k x b accum, pitch b). A thread forms
// kFullRows rows of one column, summing over T's columns in order; the
// product goes through Y ((b+k) x b accum, global) and then in place.
constexpr int kFullRows = 8;

template <typename S, typename A>
__device__ void full_apply(S* off, A* V, const A* T, A* Y, int b, int k) {
  const int pk = b + k;
  const size_t items = size_t((pk + kFullRows - 1) / kFullRows) * b;
  for (size_t e = threadIdx.x; e < items; e += kThreads) {
    const int c = int(e % b), r0 = int(e / b) * kFullRows;
    A acc[kFullRows];
#pragma unroll
    for (int u = 0; u < kFullRows; ++u) acc[u] = A(0);
    for (int q = 0; q < pk; ++q) {
      const A x = q < b ? up<A>(off[size_t(q) * b + c])
                        : V[size_t(q - b) * b + c];
#pragma unroll
      for (int u = 0; u < kFullRows; ++u) {
        if (r0 + u < pk) acc[u] += T[size_t(r0 + u) * pk + q] * x;
      }
    }
#pragma unroll
    for (int u = 0; u < kFullRows; ++u) {
      if (r0 + u < pk) Y[size_t(r0 + u) * b + c] = acc[u];
    }
  }
  __syncthreads();
  for (size_t e = threadIdx.x; e < size_t(pk) * b; e += kThreads) {
    if (e < size_t(b) * b) {
      off[e] = down<S>(Y[e]);
    } else {
      V[e - size_t(b) * b] = Y[e];
    }
  }
  __syncthreads();
}

template <int KM, typename S, typename A>
__global__ void __launch_bounds__(kThreads)
btd_block_kernel(S* diag, S* off, const S* vt, A* scr, int nb, int b, int k,
                 int sigma_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) A rot[kRotElems];
  __shared__ A vnext[kNextElems];
  __shared__ A dg[kMaxPanel];
  const BlockLayout L = block_layout<A>(b, k);
  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const int pk = b + k;
  const size_t bb = size_t(b) * b, n = size_t(nb) * b;
  S* Dm = diag + m * nb * bb;
  S* Om = off + m * size_t(nb - 1) * bb;
  const S* vm = vt + size_t(m) * k * n;
  A* g = scr + m * L.scratch;
  A* xbuf = reinterpret_cast<A*>(smem);
  A* stage = reinterpret_cast<A*>(smem + L.stage);
  A* tstrip = reinterpret_cast<A*>(smem + L.tstrip);
  A* Tsm = reinterpret_cast<A*>(smem + L.t);
  A* slab = L.slab_smem ? reinterpret_cast<A*>(smem + L.slab)
                        : g + L.slab_g;
  A* next = slab + k * b;
  A* Tf = g + L.tf;  // the sub-tiled route's
  A* Y = g + L.y;
  A* cs_c = g + L.cs;
  A* cs_s = cs_c + kMaxPanel * k;
  const A sigma = A(sigma_i);
  auto prefetch = [&](int j) {  // diag[j], off[j], slab j+1 into L2
    constexpr int kPer = 32 / int(sizeof(S));
    if (j >= nb) return;
    for (size_t e = size_t(tid) * kPer; e < bb; e += kThreads * kPer) {
      prefetch_l2(Dm + j * bb + e);
      if (j + 1 < nb) prefetch_l2(Om + j * bb + e);
    }
    if (j + 1 >= nb) return;
    for (int e = tid * kPer; e < k * b; e += kThreads * kPer) {
      prefetch_l2(vm + size_t(e / b) * n + size_t(j + 1) * b + e % b);
    }
  };
  prefetch(0);
  for (int e = tid; e < k * b; e += kThreads) {
    slab[e] = up<A>(vm[size_t(e / b) * n + e % b]);
  }
  for (int j = 0; j < nb; ++j) {
    S* Dj = Dm + j * bb;
    S* Oj = Om + j * bb;
    const bool more = j + 1 < nb;
    prefetch(j + 1);
    if (more) {
      for (int e = tid; e < k * b; e += kThreads) {
        next[e] = up<A>(vm[size_t(e / b) * n + size_t(j + 1) * b + e % b]);
      }
    }
    if (!L.sub) {
      __syncthreads();  // the last block is done with stage
      for (int e = tid; e < k * b; e += kThreads) stage[e] = slab[e];
      __syncthreads();
      // A block of kMaxPanel rows sweeps in the reference's own arithmetic
      // (as diag_block does): the scan form's drift in a downdate of such
      // a block passes 4 nb b units against the plain chain (PERF.md).
      A* T = L.t_smem ? Tsm : g;
      if (b == kMaxPanel) {
        diag_tile<KM, S, A, true, A>(Dj, b, stage, rot, vnext, dg, T,
                                     nullptr, nullptr, b, k, sigma);
      } else {
        diag_tile<KM, S, A, false, A>(Dj, b, stage, rot, vnext, dg, T,
                                      nullptr, nullptr, b, k, sigma);
      }
      if (more) {
        if (L.t_smem) {
          gemm_apply_tile<S, A, A, true>(Oj, b, next, b, b, Tsm,
                                         t_pitch(b, k), xbuf, tstrip, b, k);
        } else {
          // T_j's stores reach L2 before the apply's cp.async reads them.
          __threadfence();
          __syncthreads();
          gemm_apply_tile<S, A, A, false>(Oj, b, next, b, b, g,
                                          t_pitch(b, k), xbuf, tstrip, b, k);
        }
      }
    } else {
      for (size_t e = tid; e < size_t(pk) * pk; e += kThreads) {
        Tf[e] = (e / pk == e % pk) ? A(1) : A(0);
      }
      for (int r0 = 0; r0 < b; r0 += kMaxPanel) {
        const int P = min(kMaxPanel, b - r0), r1 = r0 + P;
        S* Ds = Dj + size_t(r0) * b;
        __syncthreads();  // the last sub-tile is done with stage
        for (int e = tid; e < k * P; e += kThreads) {
          stage[e] = slab[(e / P) * b + r0 + e % P];
        }
        __syncthreads();
        diag_tile<KM, S, A, true, A>(Ds + r0, b, stage, rot, vnext, dg,
                                     nullptr, cs_c, cs_s, P, k, sigma);
        __threadfence();
        __syncthreads();
        // The sub-tile's rows right of it with the slab's remaining
        // columns, then its rows of T_j with T_j's V rows.
        if (r1 < b) {
          ref_apply_cols<KM, S, A>(Ds + r1, b, slab + r1, b, b - r1, cs_c,
                                   cs_s, xbuf, P, k, sigma);
        }
        ref_apply_cols<KM, A, A>(Tf + size_t(r0) * pk, pk,
                                 Tf + size_t(b) * pk, pk, pk, cs_c, cs_s,
                                 xbuf, P, k, sigma);
      }
      if (more) full_apply<S, A>(Oj, next, Tf, Y, b, k);
    }
    if (more) {
      for (int e = tid; e < k * b; e += kThreads) {
        next[e] = up<A>(down<S>(next[e]));
      }
      A* t = slab;
      slab = next;
      next = t;
      __syncthreads();
    }
  }
}

template <int KM, typename S, typename A>
int launch_km(void* diag, void* off, const void* vt, void* scr, int B,
              int nb, int b, int k, int sigma, cudaStream_t stream) {
  if (b + k <= 32) {
    const size_t smem = warp_layout<S, A>(b, k).bytes;
    cudaError_t err = cudaFuncSetAttribute(
        btd_warp_kernel<KM, S, A>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    btd_warp_kernel<KM, S, A><<<B, 32, smem, stream>>>(
        static_cast<S*>(diag), static_cast<S*>(off),
        static_cast<const S*>(vt), B, nb, b, k, sigma);
    return int(cudaGetLastError());
  }
  const BlockLayout L = block_layout<A>(b, k);
  if (L.scratch > 0 && scr == nullptr) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      btd_block_kernel<KM, S, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(L.bytes));
  if (err != cudaSuccess) return int(err);
  btd_block_kernel<KM, S, A><<<B, kThreads, L.bytes, stream>>>(
      static_cast<S*>(diag), static_cast<S*>(off), static_cast<const S*>(vt),
      static_cast<A*>(scr), nb, b, k, sigma);
  return int(cudaGetLastError());
}

template <typename S, typename A>
int launch(void* diag, void* off, const void* vt, void* scr, int B, int nb,
           int b, int k, int sigma, cudaStream_t stream) {
  if (B < 1 || nb < 1 || b < 1 || k < 1 || k > kMaxK ||
      (sigma != 1 && sigma != -1) || (nb > 1 && off == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  if (k <= 8) {
    return launch_km<8, S, A>(diag, off, vt, scr, B, nb, b, k, sigma,
                              stream);
  }
  if (k <= 16) {
    return launch_km<16, S, A>(diag, off, vt, scr, B, nb, b, k, sigma,
                               stream);
  }
  return launch_km<32, S, A>(diag, off, vt, scr, B, nb, b, k, sigma, stream);
}

}  // namespace

// dtype: 0 = fp32 storage / fp32 accum, 1 = bf16 / fp32, 2 = f64 / f64.
// diag: (B, nb, b, b) storage, in place; off: (B, nb-1, b, b) storage, in
// place; vt: (B, k, nb b) storage, read only; scr: B x
// repro_btd_scratch_elems accum elements (may be null when that is 0).
// Returns a cudaError_t.
extern "C" int repro_btd_chain(void* diag, void* off, const void* vt,
                               void* scr, int B, int nb, int b, int k,
                               int sigma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(diag, off, vt, scr, B, nb, b, k, sigma,
                                  st);
    case 1:
      return launch<__nv_bfloat16, float>(diag, off, vt, scr, B, nb, b, k,
                                          sigma, st);
    case 2:
      return launch<double, double>(diag, off, vt, scr, B, nb, b, k, sigma,
                                    st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Accum elements of global scratch a member needs (0 on the one-warp
// route, and when T and the slabs fit in shared memory), for the wrapper.
extern "C" long long repro_btd_scratch_elems(int b, int k, int dtype) {
  if (b + k <= 32) return 0;
  return static_cast<long long>(dtype == 2 ? block_layout<double>(b, k).scratch
                                           : block_layout<float>(b, k).scratch);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
