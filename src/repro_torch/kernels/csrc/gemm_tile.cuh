// The transform-GEMM tile of the panel applies on Hopper:
// out = T[rows, :] [R; vt] on one strip of kBN columns, full height.
//
// Used by panel_gemm_kernel (panel_kernels.cu, the cascade's apply
// [R; vt] <- T [R; vt], in place) and sharded_panel_kernel
// (sharded_panel.cu, R' = T[:P, :] [L; vt] on the tiles above the
// diagonal, out of place). T is (P+k) x (P+k) in the accumulation type A,
// at any row pitch, its top-left P x P block lower triangular; R (P rows)
// and vt (k rows) are the storage type S, widened to A on the way into
// registers, and every output is rounded to S once.
//
// What bounds it on an H100: at 67 TFLOP/s of fp32 FMA the multiply-adds,
// 2 (P(P+1)/2 + 2Pk + k(k+1)/2) per column of the cascade's apply, take
// about as long as the bytes the sharded panel phase moves. An FFMA tile
// (8 x 8 outputs a thread) stays below half that rate: each FMA needs a
// byte of shared memory, and an SM delivers 128 bytes a clock against 128
// FMAs. So with fp32 accumulation the products run on the tensor cores as
// 3xTF32 (mma.sync m16n8k8): each fp32 operand splits into a TF32 head
// and a TF32 tail, and the head x head, head x tail and tail x head
// products, small terms first, keep fp32 accuracy (the error limit is
// derived in PERF.md); bf16 values are TF32 already, so X needs no tail.
// At the TF32 rate over three (~165 TFLOP/s) the products take less time
// than the bytes: both kernels are then bound by bytes.
// The MMAs of one tile are spread over passes across all 16 tiles, so
// none waits on the one before it.
// TF32 alone would break the port's fp32 error budget. f64 runs the FFMA
// form on DFMA (8 x 8 outputs a thread), for correctness, not speed; so
// does fp32 where the product is short (P + k <= 64, apply<kFfma>): there
// the split's error (each operand cut to two TF32 parts) is not small
// against a limit of 4 P units (vt read 16.3 units on a P = 4 draw,
// PERF.md), and the tensor cores save nothing.
//
// * A CTA holds all P + k <= 288 rows of a strip of 64 columns, so in
//   place no other CTA reads what it writes. Its 9 warps take one block of
//   32 rows each (two 16-row MMA tiles x eight 8-column tiles, fp32
//   accumulators in registers); the blocks are dealt so that each of the
//   SM's four schedulers (warp % 4) gets about the same number of slices.
// * T and the X strip go through a kStages ring of K slices (16 values of
//   K) by cp.async, overlapped with the MMAs; each slice of T is read
//   once per CTA for all 64 columns. Row pitches of 20 (T) and 72 (X)
//   words put the lanes of a fragment load on 32 different banks.
// * Triangular skip: a 16-row tile whose rows all lie left of a slice
//   inside T_rr (rows < q0, slice wholly below column P) skips it, and
//   those rows of T are not staged.
// * Split K over a thread-block cluster of `split` CTAs (1, 2 or 4) for
//   narrow applies that would leave most SMs idle: rank r sums the slices
//   the host dealt it (by their cost to the busiest scheduler,
//   _launch.gemm_split_bounds), the partial tiles (row pitch kRedPitch:
//   8-byte stores free of bank conflicts) meet in distributed shared
//   memory after cluster.sync() (every read of the strip is done by then,
//   so the in-place write is safe) and each rank sums one part of the
//   tile over the ranks, in rank order, 16 bytes of every rank in flight
//   at once, and stores it.
//
// The host picks the split and deals the slices
// (repro_torch/kernels/_launch.py); it keeps the strip width, the slice
// depth and the warps' row blocks, which repro_gemm_tile_layout
// (panel_kernels.cu) reports, so a test on the card holds the two equal.
#pragma once

#include <cooperative_groups.h>

#include "chol_tile.cuh"

namespace gemm_tile {

using chol_tile::down;
using chol_tile::up;

constexpr int kThreads = 288;  // 9 warps, one block of 32 rows each
constexpr int kBN = 64;        // columns a strip
constexpr int kMaxRows = 288;  // >= P + k
constexpr int kBK = 16;        // K values a slice
constexpr int kStages = 3;     // slices in flight
constexpr int kMaxSplit = 4;
constexpr int kSkipRows = 16;  // rows a skip decision covers (MMA tile)
constexpr int kRedPitch = kBN + 8;  // row pitch of a split-K partial tile
// FFMA form (f64): 8 x 8 outputs a thread, 36 row groups x 8 column
// groups.
constexpr int kTM = 8;
constexpr int kTN = 8;

// Row pitches in elements: T slice rows of kBK values plus one 16-byte
// piece, X slice rows of kBN values plus 8.
template <typename A>
__host__ __device__ constexpr int t_pitch() {
  return kBK + 16 / int(sizeof(A));
}
constexpr int kXPitch = kBN + 8;

// Row blocks of 32 rows dealt to the 9 warps, four bits a warp (warp 0
// lowest). Warp w issues on scheduler w % 4; blocks further down need more
// K slices (block j of T_rr needs 2 j + 2 of the 16, plus the vt columns),
// so each scheduler gets a light and a heavy block. With the vt rows
// (block 8, every slice): warps 0..8 take 8 7 6 5 0 2 3 4 1; panel only:
// 7 6 5 4 0 1 2 3 8 (_launch.GEMM_WARP_BLOCKS).
__host__ __device__ __forceinline__ int row_block(int warp, bool vt_rows) {
  const unsigned long long w = vt_rows ? 0x143205678ull : 0x832104567ull;
  return int((w >> (4 * warp)) & 15u);
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}
template <typename A>
__host__ __device__ constexpr size_t t_stage_bytes() {
  return align16(sizeof(A) * size_t(kMaxRows) * t_pitch<A>());
}
template <typename S, typename A>
__host__ __device__ constexpr size_t stage_bytes() {
  return t_stage_bytes<A>() + align16(sizeof(S) * size_t(kBK) * kXPitch);
}
// Dynamic shared memory of one CTA: the ring, and with split K the
// partial tile, which reuses the ring's space.
template <typename S, typename A>
__host__ __device__ constexpr size_t smem_bytes(int split) {
  return split > 1 && sizeof(A) * size_t(kMaxRows) * kRedPitch >
                          kStages * stage_bytes<S, A>()
             ? sizeof(A) * size_t(kMaxRows) * kRedPitch
             : kStages * stage_bytes<S, A>();
}
// Every instance, with or without split K, fits the 227 KB of shared
// memory an H100 block may take; the 9 warps' blocks of 32 rows cover
// every row a launch may apply; a partial tile's rows hold whole quads.
template <typename S, typename A>
constexpr bool fits_a_block() {
  return smem_bytes<S, A>(1) <= 227 * 1024 &&
         smem_bytes<S, A>(kMaxSplit) <= 227 * 1024;
}
static_assert(fits_a_block<float, float>() &&
                  fits_a_block<__nv_bfloat16, float>() &&
                  fits_a_block<double, double>(),
              "a GEMM CTA exceeds a block's shared memory");
static_assert(kThreads / 32 * 32 == kMaxRows &&
                  kMaxRows >= chol_tile::kMaxPanel + chol_tile::kMaxK,
              "the warps' row blocks miss rows");
static_assert(kRedPitch % 4 == 0 && kRedPitch >= kBN,
              "a partial tile's rows hold no whole quads");
__host__ __device__ constexpr int n_slices(int P, int k) {
  return (P + k + kBK - 1) / kBK;
}

// The operands of one column strip.
template <typename S, typename A>
struct Strip {
  const S* R;   // P rows, leading dimension ldr, at the strip's column 0
  const S* vt;  // k rows, leading dimension ldv
  int ldr, ldv;
  int W;        // columns of the strip, <= kBN
  const A* T;   // rows_out x (P + k), row pitch ldt
  int ldt;
  int P, k, rows_out;  // rows of T applied: P + k, or P (panel only)
  bool vec;     // R, vt rows 16-byte aligned at the strip: cp.async pieces
};

// Whether rows [r0, r0 + rows) need K slice s: they do unless every row
// is left of the slice inside T_rr (T[r][q] = 0 for r < q < P)
// (_launch.gemm_slice_needed, which prices the slices for the split).
__device__ __forceinline__ bool slice_needed(int r0, int rows, int s,
                                             int P) {
  const int q0 = s * kBK;
  return !(r0 + rows <= q0 && q0 + kBK <= P);
}

// Row r of the output: R rows to outR (leading dimension ldo), the rest
// (r >= P, the new V^T) to outV (ldov).
template <typename S>
__device__ __forceinline__ S* out_row(S* outR, int ldo, S* outV, int ldov,
                                      int P, int r) {
  return r < P ? outR + size_t(r) * ldo : outV + size_t(r - P) * ldov;
}

// Stage K slice s into ring buffer buf: T[r][q0 + kk] at Ts[r][kk] for
// the rows from the first 16-row tile that needs the slice to the last
// tile applied (zero past rows_out), X[q0 + kk][c] at Xs[kk][c]; zero past
// P + k and past W. Pieces that are not whole, aligned 16 bytes inside
// the data are copied element by element.
template <typename S, typename A>
__device__ __forceinline__ void load_slice(const Strip<S, A>& st, int s,
                                           unsigned char* buf) {
  A* Ts = reinterpret_cast<A*>(buf);
  S* Xs = reinterpret_cast<S*>(buf + t_stage_bytes<A>());
  const int pk = st.P + st.k;
  const int q0 = s * kBK;
  const int r_lo = (q0 + kBK <= st.P) ? q0 / kSkipRows * kSkipRows : 0;
  const int r_hi = (st.rows_out + kSkipRows - 1) / kSkipRows * kSkipRows;
  constexpr int kPerA = 16 / int(sizeof(A)), kPa = kBK / kPerA;
  const bool tvec = (reinterpret_cast<size_t>(st.T) & size_t(15)) == 0 &&
                    (size_t(st.ldt) * sizeof(A)) % 16 == 0;
  const int n_t = (r_hi - r_lo) * kPa;
  for (int e = threadIdx.x; e < n_t; e += kThreads) {
    const int r = r_lo + e / kPa, q = q0 + e % kPa * kPerA;
    A* d = Ts + r * t_pitch<A>() + (q - q0);
    const A* src = st.T + size_t(r) * st.ldt + q;
    if (tvec && r < st.rows_out && q + kPerA <= pk) {
      chol_tile::cp_async16(d, src);
    } else {
#pragma unroll
      for (int x = 0; x < kPerA; ++x) {
        d[x] = r < st.rows_out && q + x < pk ? src[x] : A(0);
      }
    }
  }
  constexpr int kPer = 16 / int(sizeof(S));  // elements a 16-byte piece
  constexpr int kPieces = kBN / kPer;
  for (int e = threadIdx.x; e < kBK * kPieces; e += kThreads) {
    const int kk = e / kPieces, c = (e % kPieces) * kPer;
    const int q = q0 + kk;
    const S* src = q < st.P ? st.R + size_t(q) * st.ldr
                   : q < pk ? st.vt + size_t(q - st.P) * st.ldv
                            : nullptr;
    S* d = Xs + kk * kXPitch + c;
    if (src != nullptr && st.vec && c + kPer <= st.W) {
      chol_tile::cp_async16(d, src + c);
    } else {
#pragma unroll
      for (int x = 0; x < kPer; ++x) {
        d[x] = (src != nullptr && c + x < st.W) ? src[c + x]
                                                : down<S>(A(0));
      }
    }
  }
}

// The ring: stage slices s_lo.. into it and call body(i, slice, buffer)
// once each slice has landed, every thread. Ends with the block
// synchronised and every read of the strip done.
template <typename S, typename A, typename Body>
__device__ __forceinline__ void ring(const Strip<S, A>& st, int s_lo,
                                     int s_hi, unsigned char* smem,
                                     Body body) {
  const int n = s_hi - s_lo;
  constexpr size_t kStage = stage_bytes<S, A>();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load_slice(st, s_lo + i, smem + i * kStage);
    chol_tile::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    chol_tile::cp_async_wait<kStages - 2>();
    __syncthreads();  // slice i landed; slice i - 1's buffer is free
    const int nxt = i + kStages - 1;
    if (nxt < n) {
      load_slice(st, s_lo + nxt, smem + (nxt % kStages) * kStage);
    }
    chol_tile::cp_async_commit();
    body(s_lo + i, smem + (i % kStages) * kStage);
  }
  chol_tile::cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores (fp32 accumulation: fp32 or bf16 storage)
// ---------------------------------------------------------------------------

// A warp's accumulators: 2 row tiles (16 rows) x 8 column tiles (8
// columns) x the m16n8 fragment (rows g, g + 8; columns 2t, 2t + 1, with
// g = lane / 4, t = lane % 4).
struct MmaAcc {
  float c[2][8][4];
};

// Head and tail of an fp32 value, each a TF32 value (the top 19 bits):
// the head is x cut to TF32, the tail the exact rest cut to TF32. Cutting
// (not rounding) costs one logic operation; its error is in the limit of
// PERF.md.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// X values: an fp32 value splits; a bf16 value is a TF32 value already.
__device__ __forceinline__ void split_x(float x, unsigned& hi,
                                       unsigned& lo) {
  split(x, hi, lo);
}
__device__ __forceinline__ void split_x(__nv_bfloat16 x, unsigned& hi,
                                        unsigned& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}

// The warp's first row: block rb of 32 rows.
__device__ __forceinline__ int warp_row0(int P, int rows_out) {
  return 32 * row_block(int(threadIdx.x) >> 5, rows_out > P);
}

template <typename S>
__device__ void accumulate_mma(const Strip<S, float>& st, int s_lo,
                               int s_hi, unsigned char* smem, MmaAcc& acc) {
  constexpr bool kXTail = sizeof(S) == 4;  // bf16 X has no tail
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0(st.P, st.rows_out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) acc.c[mt][nt][x] = 0.f;
    }
  }
  ring(st, s_lo, s_hi, smem, [&](int s, const unsigned char* buf) {
    bool need[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int rt = r0 + 16 * mt;
      need[mt] = rt < st.rows_out && slice_needed(rt, 16, s, st.P);
    }
    if (!need[0] && !need[1]) return;
    const float* Ts = reinterpret_cast<const float*>(buf);
    const S* Xs = reinterpret_cast<const S*>(buf + t_stage_bytes<float>());
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = Ts + (r0 + 16 * mt + g) * t_pitch<float>() + k8 + t;
        split(a[0], ah[mt][0], al[mt][0]);
        split(a[8 * t_pitch<float>()], ah[mt][1], al[mt][1]);
        split(a[4], ah[mt][2], al[mt][2]);
        split(a[8 * t_pitch<float>() + 4], ah[mt][3], al[mt][3]);
      }
      unsigned bh[8][2], bl[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const S* b = Xs + (k8 + t) * kXPitch + 8 * nt + g;
        split_x(b[0], bh[nt][0], bl[nt][0]);
        split_x(b[4 * kXPitch], bh[nt][1], bl[nt][1]);
      }
      // The three products of a tile accumulate into one fragment, each
      // after the other; a pass over all 16 tiles between two of them
      // hides the MMA's latency. Small terms first.
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        if (pass == 1 && !kXTail) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (!need[mt]) continue;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            mma(acc.c[mt][nt], pass == 0 ? al[mt] : ah[mt],
                pass == 1 ? bl[nt][0] : bh[nt][0],
                pass == 1 ? bl[nt][1] : bh[nt][1]);
          }
        }
      }
    }
  });
}

// Two values rounded to storage at p (n of them valid; vec: one store).
template <typename S>
__device__ __forceinline__ void store2(S* p, float a, float b, int n,
                                       bool vec) {
  if (vec && n >= 2) {
    if constexpr (sizeof(S) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    }
    return;
  }
  if (n > 0) p[0] = down<S>(a);
  if (n > 1) p[1] = down<S>(b);
}

// Store the warp's fragments (split 1).
template <typename S>
__device__ void store_mma(const MmaAcc& acc, S* outR, int ldo, S* outV,
                          int ldov, int P, int rows_out, int W, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0(P, rows_out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * mt + g + 8 * h;
      if (r >= rows_out) continue;
      S* row = out_row(outR, ldo, outV, ldov, P, r);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = 8 * nt + 2 * t;
        store2(row + c, acc.c[mt][nt][2 * h], acc.c[mt][nt][2 * h + 1],
               W - c, vec);
      }
    }
  }
}

// The warp's fragments into the partial tile red (kMaxRows rows at pitch
// kRedPitch): a half warp's 8-byte stores cover the 32 banks once.
__device__ __forceinline__ void partial_mma(const MmaAcc& acc, float* red,
                                            int P, int rows_out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0(P, rows_out);
  if (r0 >= rows_out) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float* d =
            red + (r0 + 16 * mt + g + 8 * h) * kRedPitch + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(d) =
            make_float2(acc.c[mt][nt][2 * h], acc.c[mt][nt][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The FFMA form (f64 accumulation)
// ---------------------------------------------------------------------------

// This thread's rows m0..m0+kTM-1 (its warp's row block, its row group
// within it) and column group cg; accumulator j sits at column
// 32 (j / 4) + 4 cg + j % 4.
__device__ __forceinline__ int ffma_row0(int P, int rows_out) {
  return warp_row0(P, rows_out) + ((threadIdx.x >> 3) & 3) * kTM;
}
__device__ __forceinline__ int col_of(int cg, int j) {
  return 32 * (j >> 2) + 4 * cg + (j & 3);
}

template <typename S, typename A>
__device__ void accumulate_ffma(const Strip<S, A>& st, int s_lo, int s_hi,
                                unsigned char* smem, A (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = A(0);
  }
  const int m0 = ffma_row0(st.P, st.rows_out), cg = threadIdx.x & 7;
  ring(st, s_lo, s_hi, smem, [&](int s, const unsigned char* buf) {
    if (m0 >= st.rows_out || !slice_needed(m0, kTM, s, st.P)) return;
    const A* Ts = reinterpret_cast<const A*>(buf) + m0 * t_pitch<A>();
    const S* Xs =
        reinterpret_cast<const S*>(buf + t_stage_bytes<A>()) + 4 * cg;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      A a[kTM], b[kTN];
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii) a[ii] = Ts[ii * t_pitch<A>() + kk];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        b[j] = up<A>(Xs[kk * kXPitch + 32 * (j >> 2) + (j & 3)]);
      }
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[ii][j] += a[ii] * b[j];
      }
    }
  });
}

template <typename S, typename A>
__device__ void store_ffma(const A (&acc)[kTM][kTN], S* outR, int ldo,
                           S* outV, int ldov, int P, int rows_out, int W) {
  const int m0 = ffma_row0(P, rows_out), cg = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + i;
    if (r >= rows_out) break;
    S* row = out_row(outR, ldo, outV, ldov, P, r);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col_of(cg, j);
      if (c < W) row[c] = down<S>(acc[i][j]);
    }
  }
}

template <typename A>
__device__ __forceinline__ void partial_ffma(const A (&acc)[kTM][kTN],
                                             A* red, int P, int rows_out) {
  const int m0 = ffma_row0(P, rows_out), cg = threadIdx.x & 7;
  if (m0 >= rows_out) return;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      red[(m0 + i) * kRedPitch + col_of(cg, j)] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The tile: accumulate, then store or reduce over the cluster
// ---------------------------------------------------------------------------

// Four values of a partial tile (16-byte aligned) into registers.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// Four values rounded to storage at p (n of them valid; vec: p is 8-byte
// aligned for bf16, 16-byte otherwise, and two stores at most).
template <typename S, typename A>
__device__ __forceinline__ void store4(S* p, const A (&v)[4], int n,
                                       bool vec) {
  if (vec && n >= 4) {
    if constexpr (sizeof(S) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (sizeof(S) == 2) {
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
      q[0] = __floats2bfloat162_rn(v[0], v[1]);
      q[1] = __floats2bfloat162_rn(v[2], v[3]);
    } else {
      double2* q = reinterpret_cast<double2*>(p);
      q[0] = make_double2(v[0], v[1]);
      q[1] = make_double2(v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (x < n) p[x] = down<S>(v[x]);
  }
}

// Split K: the partial tiles are in every rank's red (kMaxRows rows at
// pitch kRedPitch); sum them in rank order and store this rank's share
// (quads [rank n / kSplit, (rank + 1) n / kSplit) of the rows_out x kBN
// tile, n = rows_out kBN / 4).
template <int kSplit, typename S, typename A>
__device__ void reduce_store(const A* red, S* outR, int ldo, S* outV,
                             int ldov, int P, int rows_out, int W,
                             bool vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial written; every read of the strip done
  const int rank = int(cluster.block_rank());
  constexpr int kQuads = kBN / 4;  // a row's quads
  const int n4 = rows_out * kQuads;
  const int lo = rank * n4 / kSplit, hi = (rank + 1) * n4 / kSplit;
  const A* part[kSplit];
#pragma unroll
  for (int j = 0; j < kSplit; ++j) {
    part[j] = cluster.map_shared_rank(red, j);
  }
  for (int e = lo + int(threadIdx.x); e < hi; e += kThreads) {
    const int r = e / kQuads, c = e % kQuads * 4;
    A v[kSplit][4];
#pragma unroll
    for (int j = 0; j < kSplit; ++j) load4(part[j] + r * kRedPitch + c, v[j]);
#pragma unroll
    for (int j = 1; j < kSplit; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) v[0][x] += v[j][x];
    }
    store4(out_row(outR, ldo, outV, ldov, P, r) + c, v[0], W - c, vec);
  }
  cluster.sync();  // no CTA leaves while a peer reads its partials
}

// K slices [lo, hi) of cluster rank `rank` of `split`: the split - 1 inner
// boundaries, ascending, one byte each from the lowest (_launch
// .gemm_pack_bounds).
__device__ __forceinline__ void rank_slices(int n_slices, int split,
                                            int rank, unsigned bounds,
                                            int& lo, int& hi) {
  lo = rank == 0 ? 0 : int((bounds >> (8 * (rank - 1))) & 255u);
  hi = rank == split - 1 ? n_slices : int((bounds >> (8 * rank)) & 255u);
}

// out = T[rows_out rows, :] [R; vt] on the strip, K slices [s_lo, s_hi)
// summed here and, with split > 1, the cluster's ranks' shares added.
// kFfma: fp32 accumulation in the FFMA form (exact fp32 products, one
// rounding a multiply-add) in place of 3xTF32, for products too short for
// the tensor cores to pay (panel_kernels.cu, kFfmaRows).
template <typename S, typename A, bool kFfma = false>
__device__ void apply(const Strip<S, A>& st, int s_lo, int s_hi, int split,
                      unsigned char* smem, S* outR, int ldo, S* outV,
                      int ldov, bool vec_out) {
  if constexpr (sizeof(A) == 4 && !kFfma) {
    MmaAcc acc;
    accumulate_mma(st, s_lo, s_hi, smem, acc);
    if (split == 1) {
      store_mma(acc, outR, ldo, outV, ldov, st.P, st.rows_out, st.W,
                vec_out);
      return;
    }
    partial_mma(acc, reinterpret_cast<float*>(smem), st.P, st.rows_out);
  } else {
    A acc[kTM][kTN];
    accumulate_ffma(st, s_lo, s_hi, smem, acc);
    if (split == 1) {
      store_ffma(acc, outR, ldo, outV, ldov, st.P, st.rows_out, st.W);
      return;
    }
    partial_ffma(acc, reinterpret_cast<A*>(smem), st.P, st.rows_out);
  }
  const A* red = reinterpret_cast<const A*>(smem);
  if (split == 2) {
    reduce_store<2>(red, outR, ldo, outV, ldov, st.P, st.rows_out, st.W,
                    vec_out);
  } else {
    reduce_store<kMaxSplit>(red, outR, ldo, outV, ldov, st.P, st.rows_out,
                            st.W, vec_out);
  }
}

// Whether a pointer and a leading dimension keep every row 16-byte aligned.
template <typename S>
__device__ __forceinline__ bool aligned_rows(const S* p, int ld) {
  return (reinterpret_cast<size_t>(p) & size_t(15)) == 0 &&
         (size_t(ld) * sizeof(S)) % 16 == 0;
}

}  // namespace gemm_tile
