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
// The diagonal pass is chol_tile.cuh's sweep_wavefront: the reference
// recurrence's own operations (square roots, divisions, no fused
// multiply-adds), so D_new, c, s and T are the plain recurrence's bit for
// bit (the rotation state carries all P k rotations of the block, and a
// warp-scan form drifts ~0.25 units a rotation), taken by anti-diagonals
// of (row, rotation), P + k - 1 dependent steps. The transform-GEMM apply
// runs on the tile of gemm_tile.cuh (3xTF32 on the tensor cores for fp32
// accumulation, the FFMA form where P + k <= 64, a cp.async ring of K
// slices, full-height column strips so it may write in place, K split over
// a thread-block cluster for narrow applies). The paper's apply is a
// (row, rotation) wavefront of its own, spread over the card, in the
// reference's operations: its result is apply_rotations', bit for bit.
//
// What bounds them on an H100: the diagonal pass is one CTA per block,
// bounded by its dependent chain and one SM's issue rate (PERF.md), far
// above its bytes; the applies move the trailing panel once in and once
// out (bytes) and the gemm apply does 2 (P(P+1)/2 + 2Pk + k(k+1)/2) per
// column, T_rr and T_vv being lower triangular (operations at the fp32
// rate: 3xTF32 keeps fp32 accuracy, TF32 alone would break the fp32 error
// budget); the paper's apply is bound by its chain of P + k - 1 ticks or
// by issue (below). Short launches at the tail of the cascade are bounded
// by launch latency. See PERF.md.
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
// ldt. kFfma: the FFMA form for fp32 accumulation (gemm_tile.cuh apply),
// which the host takes for P + k <= kFfmaRows (_launch.GEMM_FFMA_ROWS).
// There the split's error is not small against the 4 P limit: B = 2,
// P = 4, k = 16, w = 64, fp32, a downdate read 16.3 units on vt in
// 3xTF32 (PERF.md).
static constexpr int kFfmaRows = 64;

template <typename S, typename A, bool kFfma>
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
  apply<S, A, kFfma>(st, s_lo, s_hi, split, smem, Rb, ldr, vb, ldv, vec);
}

// ---------------------------------------------------------------------------
// The paper's element-wise apply: a (row, rotation) wavefront over the card
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel repro/kernels/cholupdate.py:149 panel_apply_paper
// (body _paper_kernel :134 over apply_rotations :93): per column j of R
// (P x w) and V^T (k x w), row i takes the k rotations (c, s)[i, m] in
// turn, t <- (t + (sigma s) v_m) / c, v_m <- c v_m - s t.
//
// What bounds it on an H100. Its bytes are [R; vt] once in and once out
// and c, s once (PERF.md); its operations, 6 P k a column, are few. Each
// column is a dependent chain, and rotation (i, m) needs only row i after
// (i, m-1) and v_m after (i-1, m): taken by anti-diagonals t = i + m, a
// column is P + k - 1 dependent steps (ticks), not P k. So the kernel is
// bound by that chain's latency where the columns are few (the narrow
// applies at the end of the cascade) and by the SMs' issue rate where
// they are many, far above its bytes.
//
// Design (Hopper).
// * Lanes along the rotations. A segment of KP lanes (KP = k rounded up to
//   8, 16 or 32; 1 at k = 1) owns one column: lane m keeps V row m's value
//   in a register, and at tick t takes rotation (t - m, m). The row value
//   passes from lane m to lane m + 1 by a shuffle each tick; lane 0 takes
//   row t's element from shared memory, lane k - 1 writes row t - k + 1's
//   result back there. A warp holds 32 / KP columns; the grid, w KP lanes
//   over (w / cpc) x B CTAs of nw warps (_launch.paper_warps), spreads
//   them over the whole card.
// * The reference's own operations. Each rotation is rotate_ref's values
//   (mul_rn, add_rn, IEEE division, no contraction), the operations of
//   apply_rotations, so the result is the plain version's bit for bit.
//   Every column shares the divisors: the CTA stages each rotation once as
//   (c, s, sigma s, recip_pre(c)), 16 bytes for fp32, and a division is
//   div_pre against the staged reciprocal. A tick tests nothing: a warp
//   that flagged a division in a window redoes the window with div_rn
//   from its state at the window's start (a branch a tick, with its
//   reconvergence, cost much of the tick). f64 divides by div_rn.
// * Windows of kPaperWin ticks, one barrier each. Shared memory holds two
//   rings of kPaperSlots windows: the rotations laid out by tick (rotation
//   (i, m) at row i + m, lane m's at column m: the lanes of a segment read
//   KP consecutive 16-byte entries) and the strip's rows (row r at r; lane
//   k - 1 writes a result over its row's input). During window g the CTA
//   loads chunk g + 1 (rows 32 (g + 1)..) of R, c and s into registers,
//   coalesced, and stores it to the rings after the window's ticks; it
//   writes chunk g - 2, final since the barrier, back to R as whole rows.
//   The k V values of a column are loaded once and stored once, rounded to
//   storage once.
static constexpr int kPaperWin = 32;     // ticks a window, rows a chunk
static constexpr int kPaperSlots = 3;    // windows a ring holds
static constexpr int kPaperRing = kPaperWin * kPaperSlots;
static constexpr int kPaperMinWarps = 4;
static constexpr int kPaperMaxWarps = 16;

// Dynamic shared memory of a CTA of nw warps, KP lanes a column: the
// rotation ring (4 values an entry) and the row ring (32 nw / KP columns,
// one row more than the ring: a tick's look-ahead past the last row reads
// it).
template <typename A>
__host__ __device__ constexpr size_t paper_smem_bytes(int kp, int nw) {
  return sizeof(A) * (size_t(kPaperRing) * 4 * kp +
                      size_t(kPaperRing + 1) * nw * (32 / kp));
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b,
                                       double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// [R; vt] <- the rotations (c, s) on the columns blockIdx.x * cpc.. of
// member blockIdx.y; R: P x w (leading dimension ldr), vt: k x w (ldv),
// both storage, in place; c, s: P x k accum per member (cs_bs).
template <int KP, typename S, typename A>
__global__ void __launch_bounds__(kPaperMaxWarps * 32)
panel_paper_kernel(S* R, long long r_bs, int ldr, S* vt, long long v_bs,
                   int ldv, const A* c, const A* s, long long cs_bs, int w,
                   int P, int k, int sigma_i) {
  constexpr int kCpw = 32 / KP;  // columns a warp
  // Rotation entries a thread stages a window: KP / nw, nw >= kPaperMinWarps.
  constexpr int kRotPer = KP >= kPaperMinWarps ? KP / kPaperMinWarps : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = int(blockDim.x), nw = nt >> 5, cpc = nw * kCpw;
  A* rot = reinterpret_cast<A*>(smem);  // kPaperRing x KP entries of 4
  A* xr = rot + 4 * KP * kPaperRing;    // (kPaperRing + 1) x cpc
  const int c0 = blockIdx.x * cpc;
  const int W = min(cpc, w - c0);
  S* Rb = R + blockIdx.y * r_bs + c0;
  S* vb = vt + blockIdx.y * v_bs + c0;
  const A* cb = c + blockIdx.y * cs_bs;
  const A* sb = s + blockIdx.y * cs_bs;
  const A sigma = A(sigma_i);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = lane & (KP - 1);  // this lane's rotation
  const int col = warp * kCpw + lane / KP;  // this lane's column
  // This thread's row entries of a chunk: rows xrow + u (nt / cpc), column
  // xcol.
  const int xrow = tid / cpc, xcol = tid % cpc, xstep = nt / cpc;

  // A chunk in flight: loads from addresses clamped into the block, whose
  // values commit masks (a select on a load's result would wait for it).
  S xq[kCpw];
  A cq[kRotPer], sq[kRotPer];
  const int xc = min(xcol, W - 1);
  auto fetch = [&](int g) {  // chunk g into registers
    const int r0 = g * kPaperWin;
#pragma unroll
    for (int u = 0; u < kCpw; ++u) {
      xq[u] = Rb[size_t(min(r0 + xrow + u * xstep, P - 1)) * ldr + xc];
    }
#pragma unroll
    for (int u = 0; u < kRotPer; ++u) {
      const int e = tid + u * nt;
      const size_t at = size_t(min(r0 + e / KP, P - 1)) * k +
                        min(e & (KP - 1), k - 1);
      cq[u] = cb[at];
      sq[u] = sb[at];
    }
  };
  auto commit = [&](int g) {  // chunk g from registers into the rings
    const int r0 = g * kPaperWin;
    A* xs = xr + (g % kPaperSlots) * kPaperWin * cpc;
#pragma unroll
    for (int u = 0; u < kCpw; ++u) {
      const int r = xrow + u * xstep;
      xs[r * cpc + xcol] = r0 + r < P && xcol < W ? up<A>(xq[u]) : A(0);
    }
#pragma unroll
    for (int u = 0; u < kRotPer; ++u) {
      const int e = tid + u * nt;
      if (e < kPaperWin * KP) {
        const int mm = e & (KP - 1);
        const bool real = r0 + e / KP < P && mm < k;
        const A cv = real ? cq[u] : A(1), sv = real ? sq[u] : A(0);
        const int tick = r0 + e / KP + mm;  // rotation (i, mm)
        store4(rot + 4 * ((tick % kPaperRing) * KP + mm), cv, sv, sigma * sv,
               recip_pre(cv));
      }
    }
  };
  auto write_back = [&](int g) {  // chunk g's final rows into R
    const A* xs = xr + (g % kPaperSlots) * kPaperWin * cpc;
    A out[kCpw];  // every shared load before the first store
#pragma unroll
    for (int u = 0; u < kCpw; ++u) {
      out[u] = xs[(xrow + u * xstep) * cpc + xcol];
    }
#pragma unroll
    for (int u = 0; u < kCpw; ++u) {
      const int r = g * kPaperWin + xrow + u * xstep;
      if (r < P && xcol < W) Rb[size_t(r) * ldr + xcol] = down<S>(out[u]);
    }
  };

  A v = col < W && m < k ? up<A>(vb[size_t(m) * ldv + col]) : A(0);
  A x = A(0);
  const int n_ticks = P + k - 1;
  const int n_win = (n_ticks + kPaperWin - 1) / kPaperWin;
  const int n_chunks = (P + kPaperWin - 1) / kPaperWin;
  fetch(0);
  commit(0);
  __syncthreads();
  for (int g = 0; g < n_win; ++g) {
    const bool more = g + 1 < n_chunks;
    if (g >= 2) write_back(g - 2);
    if (more) fetch(g + 1);  // in flight across the window's ticks
    if (warp * kCpw < W) {  // a warp with a column
      const int base = (g % kPaperSlots) * kPaperWin;
      const int t0 = g * kPaperWin, t1 = min(t0 + kPaperWin, n_ticks);
      // The window's ticks. Each tick loads the next tick's entries before
      // it stores its result, so no shared load waits on the chain. The
      // fast pass divides by div_pre and returns whether a division was
      // flagged; the exact pass divides by div_rn and takes lane 0's rows
      // from R (chunk g is written back at window g + 2), as the ring's
      // may already hold results. kEdge: a tick of the window has a lane
      // whose row lies outside [0, P) (the first and the last windows).
      auto window = [&](auto exact, auto edge) -> bool {
        constexpr bool kExact = decltype(exact)::value;
        constexpr bool kEdge = decltype(edge)::value;
        auto row_of = [&](int r) -> A {  // R's row r, as staged
          return m == 0 && r < P && col < W
                     ? up<A>(Rb[size_t(r) * ldr + col])
                     : A(0);
        };
        const A* pr = rot + 4 * (base * KP + m);
        const A* px = xr + base * cpc + col;
        const bool lane_on = m < k;
        bool bad = false;
        A cm, sm, ssm, ycm;
        load4(pr, cm, sm, ssm, ycm);
        A xin = kExact ? row_of(t0) : *px;
        int ro = base - (k - 1);  // the ring row of tick t0's result
        if (ro < 0) ro += kPaperRing;
        // The row value from lane m - 1, shuffled as soon as it exists:
        // the rest of a tick's work fills the shuffle's wait.
        A xu = x;
        if constexpr (KP > 1) xu = __shfl_up_sync(0xffffffffu, x, 1, KP);
#pragma unroll 4
        for (int t = t0; t < t1; ++t) {
          bool act = lane_on;
          if constexpr (kEdge) act = act && t - m >= 0 && t - m < P;
          const A a = add_rn(m == 0 ? xin : xu, mul_rn(ssm, v));
          A y;
          if constexpr (kExact) {
            y = div_rn(a, cm);
          } else {
            bool flag = false;
            y = div_pre(a, cm, ycm, flag);
            bad |= kEdge ? flag && act : flag;
          }
          x = y;
          if constexpr (KP > 1) xu = __shfl_up_sync(0xffffffffu, y, 1, KP);
          // The next tick's entries, loaded before this tick's store.
          pr += 4 * KP;
          px += cpc;
          A cn, sn, ssn, ycn;
          load4(pr, cn, sn, ssn, ycn);
          const A xn = kExact ? row_of(t + 1) : *px;
          const A vn = sub_rn(mul_rn(cm, v), mul_rn(sm, y));
          // In a window without edge, act is m < k; the lanes past k carry
          // identity rotations, and their values go nowhere.
          v = kEdge && !act ? v : vn;
          if (act && m == k - 1) {  // row t - k + 1 leaves the chain final
            xr[ro * cpc + col] = y;
          }
          ro = ro + 1 == kPaperRing ? 0 : ro + 1;
          cm = cn;
          sm = sn;
          ssm = ssn;
          ycm = ycn;
          xin = xn;
        }
        return bad && lane_on;
      };
      const A v_in = v, x_in = x;
      const bool edge = t0 < k - 1 || t1 > P;
      const bool flagged = edge ? window(Flag<false>(), Flag<true>())
                                : window(Flag<false>(), Flag<false>());
      if (__any_sync(0xffffffffu, flagged)) {
        v = v_in;  // a flagged division: the warp redoes the window
        x = x_in;
        window(Flag<true>(), Flag<true>());
      }
    }
    if (more) commit(g + 1);
    __syncthreads();
  }
  for (int g = max(0, n_win - 2); g < n_chunks; ++g) write_back(g);
  if (col < W && m < k) vb[size_t(m) * ldv + col] = down<S>(v);
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

template <int KP, typename S, typename A>
int paper_kp(void* R, long long r_bs, int ldr, void* vt, long long v_bs,
             int ldv, const void* c, const void* s, long long cs_bs, int B,
             int w, int nw, int P, int k, int sigma, cudaStream_t stream) {
  const size_t smem = paper_smem_bytes<A>(KP, nw);
  cudaError_t err = allow_smem(panel_paper_kernel<KP, S, A>, smem);
  if (err != cudaSuccess) return int(err);
  const int cpc = nw * (32 / KP);
  const dim3 grid((w + cpc - 1) / cpc, B);
  panel_paper_kernel<KP, S, A><<<grid, 32 * nw, smem, stream>>>(
      static_cast<S*>(R), r_bs, ldr, static_cast<S*>(vt), v_bs, ldv,
      static_cast<const A*>(c), static_cast<const A*>(s), cs_bs, w, P, k,
      sigma);
  return int(cudaGetLastError());
}

template <typename S, typename A>
int paper_launch(void* R, long long r_bs, int ldr, void* vt, long long v_bs,
                 int ldv, const void* c, const void* s, long long cs_bs,
                 int B, int w, int nw, int P, int k, int sigma,
                 cudaStream_t stream) {
  if (!shape_ok(B, P, k, sigma) || B > 65535 || w < 1 || ldr < w ||
      ldv < w || c == nullptr || s == nullptr ||
      !(nw == 4 || nw == 8 || nw == kPaperMaxWarps)) {
    return int(cudaErrorInvalidValue);
  }
  if (k == 1) {
    return paper_kp<1, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, cs_bs, B, w,
                             nw, P, k, sigma, stream);
  }
  if (k <= 8) {
    return paper_kp<8, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, cs_bs, B, w,
                             nw, P, k, sigma, stream);
  }
  if (k <= 16) {
    return paper_kp<16, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, cs_bs, B,
                              w, nw, P, k, sigma, stream);
  }
  return paper_kp<32, S, A>(R, r_bs, ldr, vt, v_bs, ldv, c, s, cs_bs, B, w,
                            nw, P, k, sigma, stream);
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
template <typename S, typename A, bool kFfma>
int gemm_launch_form(void* R, long long r_bs, int ldr, void* vt,
                     long long v_bs, int ldv, const void* T, long long t_bs,
                     int ldt, int B, int w, int P, int k, int split,
                     unsigned bounds, cudaStream_t stream) {
  const size_t smem = gemm_tile::smem_bytes<S, A>(split);
  cudaError_t err = allow_smem(panel_gemm_kernel<S, A, kFfma>, smem);
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
  err = cudaLaunchKernelEx(&cfg, panel_gemm_kernel<S, A, kFfma>,
                           static_cast<S*>(R), r_bs, ldr, static_cast<S*>(vt),
                           v_bs, ldv, static_cast<const A*>(T), t_bs, ldt, w,
                           P, k, split, bounds);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

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
  if constexpr (sizeof(A) == 4) {
    if (P + k <= kFfmaRows) {
      return gemm_launch_form<S, A, true>(R, r_bs, ldr, vt, v_bs, ldv, T,
                                          t_bs, ldt, B, w, P, k, split,
                                          bounds, stream);
    }
  }
  return gemm_launch_form<S, A, false>(R, r_bs, ldr, vt, v_bs, ldv, T, t_bs,
                                       ldt, B, w, P, k, split, bounds, stream);
}

// Clusters of split CTAs of the gemm apply's form the device holds at once
// (split 1: CTAs), or a negative cudaError_t.
template <typename S, typename A, bool kFfma>
int gemm_capacity_form(int split) {
  const size_t smem = gemm_tile::smem_bytes<S, A>(split);
  cudaError_t err = allow_smem(panel_gemm_kernel<S, A, kFfma>, smem);
  int n = 0;
  if (err == cudaSuccess && split == 1) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, panel_gemm_kernel<S, A, kFfma>, gemm_tile::kThreads, smem);
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
        &n, reinterpret_cast<const void*>(panel_gemm_kernel<S, A, kFfma>),
        &cfg);
  }
  return err == cudaSuccess ? n : -int(err);
}

template <typename S, typename A>
int gemm_capacity(int split, int ffma) {
  if constexpr (sizeof(A) == 4) {
    if (ffma) return gemm_capacity_form<S, A, true>(split);
  }
  return gemm_capacity_form<S, A, false>(split);
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
// device holds at once (split 1: CTAs), or a negative cudaError_t; ffma:
// of the FFMA form that takes fp32 accumulation at P + k <= kFfmaRows.
extern "C" int repro_panel_gemm_capacity(int split, int ffma, int dtype) {
  switch (dtype) {
    case 0:
      return gemm_capacity<float, float>(split, ffma);
    case 1:
      return gemm_capacity<__nv_bfloat16, float>(split, ffma);
    case 2:
      return gemm_capacity<double, double>(split, ffma);
    default:
      return -int(cudaErrorInvalidValue);
  }
}

// The paper's apply over w trailing columns of B members, CTAs of nw
// warps (4, 8 or 16; _launch.paper_warps): c, s ((B, P, k) accum, member
// stride cs_bs).
extern "C" int repro_panel_paper(void* R, long long r_bs, int ldr, void* vt,
                                 long long v_bs, int ldv, const void* c,
                                 const void* s, long long cs_bs, int B,
                                 int w, int nw, int P, int k, int sigma,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return paper_launch<float, float>(R, r_bs, ldr, vt, v_bs, ldv, c, s,
                                        cs_bs, B, w, nw, P, k, sigma, st);
    case 1:
      return paper_launch<__nv_bfloat16, float>(R, r_bs, ldr, vt, v_bs, ldv,
                                                c, s, cs_bs, B, w, nw, P, k,
                                                sigma, st);
    case 2:
      return paper_launch<double, double>(R, r_bs, ldr, vt, v_bs, ldv, c, s,
                                          cs_bs, B, w, nw, P, k, sigma, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The largest P + k whose fp32 gemm apply takes the FFMA form.
extern "C" int repro_gemm_ffma_rows() { return kFfmaRows; }

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
