// Times the diagonal-block sweeps on their own, and the phases of one
// diag_tile row.
//
// One block sweeps a P x P upper tile with k rotations per row and reads
// clock64() around the sweep; the best of three runs is printed as SM
// cycles per row, for P in {256, 128, 100} and k in {1, 16, 32}, three
// forms side by side:
//   scan        chol_tile::diag_tile<kRef = false> (the block chain's CTA
//               route below 256 rows: two columns a thread, a warp scan
//               for a row's rotations, a block barrier a row);
//   ref         diag_tile<kRef = true> (the reference's operations: a
//               row's k rotations one after another on one lane, then
//               each column's k rotations, a block barrier a row);
//   wavefront   chol_tile::sweep_wavefront (the reference's operations
//               scheduled by anti-diagonals of (row, rotation): what
//               diag_block_kernel and fused_chain_kernel run).
// Each run writes D_new, T, c and s; the wavefront's are compared byte for
// byte with ref's ("equal" / "DIFFER"), in fp32 and, at P = 256, k = 16
// and P = 100, k = 32, in f64. Before them, the wavefront's branch-free
// division (chol_tile::div_pre) against __fdiv_rn on 1.1e9 random operand
// pairs; after them, the wavefront's timeline: each phase of a tick, for
// the warp that publishes and for the others. Then the one-warp sweep
// (chol_tile::sweep_warp, the block chain's route for P + k <= 32) at P in
// {4, 16, 31}.
//
// Then each phase of a diag_tile row alone, P = 256 rows, cycles per row:
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
// file; it is a measurement aid. It exits 1 if a wavefront's outputs differ
// from ref's or a launch fails.
//
// Build and run on a machine with the CUDA toolkit and a Hopper card
// (REPRO_WAVE_WATCHDOG: a wavefront wait that never completes traps
// instead of hanging):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -DREPRO_WAVE_WATCHDOG -o diag_sweep \
//        src/repro_torch/kernels/probes/diag_sweep.cu
//   ./diag_sweep
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../csrc/chol_tile.cuh"

using namespace chol_tile;

// Sweep forms: diag_tile's scan and reference arithmetic, the wavefront.
enum Form { kScan = 0, kRefForm = 1, kWave = 2 };

// The wavefront's timeline: lane 0 of each warp stamps clock64() at each
// phase of each tick. Owner warps: 0 tick start, 1 the anti-diagonal it
// applies is published, 2 applied and released, 3 committed and staged.
// The chain warp: 0 tick start, 1 its V values staged, 2 computed and its
// slot free, 3 published.
struct Timeline {
  long long* tl;
  int ticks;
  __device__ void operator()(int t, int phase) const {
    if ((threadIdx.x & 31) == 0 && t < ticks) {
      tl[(size_t(threadIdx.x >> 5) * ticks + t) * 4 + phase] = clock64();
    }
  }
};

template <int KM>
__global__ void __launch_bounds__(kWaveThreads)
wave_timeline(float* D, int ld, const float* vt, float* T, float* c,
              float* s, int P, int k, long long* tl, int ticks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) WaveSmem<float> ws;
  float* slab = reinterpret_cast<float*>(smem);
  for (int e = threadIdx.x; e < k * P; e += kWaveThreads) slab[e] = vt[e];
  __syncthreads();
  sweep_wavefront<KM, float, float, float>(D, ld, slab, ws, T, c, s, P, k,
                                           1.f, Timeline{tl, ticks});
}

template <int KM, typename A, int kForm>
__global__ void __launch_bounds__(kWaveThreads)
sweep(A* D, int ld, const A* vt, A* T, A* c, A* s, int P, int k,
      long long* cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) A rot[kRotElems];
  __shared__ A vnext[kNextElems];
  __shared__ A dg[kMaxPanel];
  __shared__ __align__(16) WaveSmem<A> ws;
  A* slab = reinterpret_cast<A*>(smem);
  for (int e = threadIdx.x; e < k * P; e += blockDim.x) slab[e] = vt[e];
  __syncthreads();
  const long long t0 = clock64();
  if constexpr (kForm == kWave) {
    sweep_wavefront<KM, A, A>(D, ld, slab, ws, T, c, s, P, k, A(1));
  } else {
    diag_tile<KM, A, A, kForm == kRefForm>(D, ld, slab, rot, vnext, dg, T,
                                           c, s, P, k, A(1));
  }
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

// div_pre against __fdiv_rn on random operands: a with exponents in
// [-70, 70] and either sign (one in 64 a signed zero), b > 0 with exponents
// in [-35, 35]; counts the results div_pre does not flag that differ in a
// single bit from __fdiv_rn's (out[0]), and the flagged ones (out[1]).
__global__ void div_check(unsigned seed, int iters,
                          unsigned long long* out) {
  unsigned x = seed ^ (blockIdx.x * 2654435761u + threadIdx.x * 40503u);
  auto next = [&]() {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    return x;
  };
  unsigned long long wrong = 0, flagged = 0;
  for (int it = 0; it < iters; ++it) {
    const unsigned ra = next(), rb = next(), re = next();
    const int ea = int(re % 141u) - 70, eb = int((re >> 8) % 71u) - 35;
    float a = __int_as_float(int(((ea + 127) << 23) | (ra & 0x7fffffu)) |
                             int(ra & 0x80000000u));
    if ((re >> 24) % 64u == 0) a = (ra & 1u) ? -0.f : 0.f;
    const float b = __int_as_float(((eb + 127) << 23) | (rb & 0x7fffffu));
    bool bad = false;
    const float q = div_pre(a, b, recip_pre(b), bad);
    const float ref = __fdiv_rn(a, b);
    if (bad) {
      ++flagged;
    } else if (__float_as_int(q) != __float_as_int(ref)) {
      ++wrong;
    }
  }
  atomicAdd(out, wrong);
  atomicAdd(out + 1, flagged);
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

// Buffers of one sweep's inputs and outputs, in A.
template <typename A>
struct Bufs {
  A *D, *vt, *T, *c, *s;
  size_t nT, nc;
};

template <typename A>
Bufs<A> alloc_bufs(const std::vector<float>& v) {
  Bufs<A> b;
  const int n = kMaxPanel;
  b.nT = size_t(n + kMaxK) * t_pitch(n, kMaxK);
  b.nc = size_t(n) * kMaxK;
  cudaMalloc(&b.D, sizeof(A) * n * n);
  cudaMalloc(&b.vt, sizeof(A) * kMaxK * n);
  cudaMalloc(&b.T, sizeof(A) * b.nT);
  cudaMalloc(&b.c, sizeof(A) * b.nc);
  cudaMalloc(&b.s, sizeof(A) * b.nc);
  std::vector<A> w(v.begin(), v.end());
  cudaMemcpy(b.vt, w.data(), sizeof(A) * w.size(), cudaMemcpyHostToDevice);
  return b;
}

// D_new (upper triangle of the P x P tile), T ((P+k) x t_pitch) and c, s
// (P x k) of the last run, as bytes.
template <typename A>
std::vector<unsigned char> outputs(const Bufs<A>& b, int P, int k) {
  const int n = kMaxPanel;
  const size_t tp = t_pitch(P, k);
  std::vector<A> D(size_t(n) * n), T(size_t(P + k) * tp), c(size_t(P) * k),
      s(size_t(P) * k);
  cudaMemcpy(D.data(), b.D, sizeof(A) * D.size(), cudaMemcpyDeviceToHost);
  cudaMemcpy(T.data(), b.T, sizeof(A) * T.size(), cudaMemcpyDeviceToHost);
  cudaMemcpy(c.data(), b.c, sizeof(A) * c.size(), cudaMemcpyDeviceToHost);
  cudaMemcpy(s.data(), b.s, sizeof(A) * s.size(), cudaMemcpyDeviceToHost);
  std::vector<A> all;
  for (int i = 0; i < P; ++i) {
    for (int j = i; j < P; ++j) all.push_back(D[size_t(i) * n + j]);
  }
  for (int i = 0; i < P + k; ++i) {
    for (int j = 0; j < P + k; ++j) all.push_back(T[i * tp + j]);
  }
  all.insert(all.end(), c.begin(), c.end());
  all.insert(all.end(), s.begin(), s.end());
  const unsigned char* p = reinterpret_cast<const unsigned char*>(all.data());
  return std::vector<unsigned char>(p, p + sizeof(A) * all.size());
}

int differ_count = 0;

// Best of three runs of one form, cycles; the outputs of its last run.
template <int KM, typename A, int kForm>
long long run_form(const std::vector<float>& tile, const Bufs<A>& b, int P,
                   int k, long long* cycles,
                   std::vector<unsigned char>* out) {
  const size_t smem = sizeof(A) * k * P;
  cudaFuncSetAttribute(sweep<KM, A, kForm>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  std::vector<A> t(tile.begin(), tile.end());
  long long best = -1;
  for (int rep = 0; rep < 3; ++rep) {
    cudaMemcpy(b.D, t.data(), sizeof(A) * t.size(), cudaMemcpyHostToDevice);
    cudaMemset(b.T, 0xff, sizeof(A) * b.nT);
    sweep<KM, A, kForm><<<1, kForm == kWave ? kWaveThreads : kThreads,
                          smem>>>(b.D, kMaxPanel, b.vt, b.T, b.c, b.s, P, k,
                                  cycles);
    const long long c = read_cycles("sweep", cycles);
    if (best < 0 || c < best) best = c;
  }
  if (out != nullptr) *out = outputs(b, P, k);
  return best;
}

template <int KM, typename A>
void run(const std::vector<float>& tile, const Bufs<A>& b, int P, int k,
         long long* cycles, const char* type) {
  std::vector<unsigned char> ref, wave;
  const long long c_scan =
      run_form<KM, A, kScan>(tile, b, P, k, cycles, nullptr);
  const long long c_ref =
      run_form<KM, A, kRefForm>(tile, b, P, k, cycles, &ref);
  const long long c_wave = run_form<KM, A, kWave>(tile, b, P, k, cycles,
                                                  &wave);
  const bool same = ref == wave;
  if (!same) ++differ_count;
  std::printf("%s P=%3d k=%2d cycles per row: scan %7.1f ref %7.1f "
              "wavefront %7.1f (ref / wavefront %.2fx, scan / wavefront "
              "%.2fx); wavefront vs ref %s\n",
              type, P, k, double(c_scan) / P, double(c_ref) / P,
              double(c_wave) / P, double(c_ref) / double(c_wave),
              double(c_scan) / double(c_wave), same ? "equal" : "DIFFER");
}

// The wavefront's phases per tick, P x P tile, k rotations, fp32: mean
// cycles of each phase for the warps publishing the tick's anti-diagonal
// and for the others, and the mean tick.
template <int KM>
void timeline(const std::vector<float>& tile, const Bufs<float>& b, int P,
              int k) {
  const int ticks = P + KM;
  const int nw = kWaveThreads / 32;
  long long* tl;
  cudaMalloc(&tl, sizeof(long long) * nw * ticks * 4);
  cudaMemset(tl, 0, sizeof(long long) * nw * ticks * 4);
  const size_t smem = sizeof(float) * k * P;
  cudaFuncSetAttribute(wave_timeline<KM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  cudaMemcpy(b.D, tile.data(), sizeof(float) * tile.size(),
             cudaMemcpyHostToDevice);
  wave_timeline<KM><<<1, kWaveThreads, smem>>>(b.D, kMaxPanel, b.vt, b.T,
                                               b.c, b.s, P, k, tl, ticks);
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    std::printf("timeline: %s\n", cudaGetErrorString(err));
    std::exit(1);
  }
  std::vector<long long> h(size_t(nw) * ticks * 4);
  cudaMemcpy(h.data(), tl, sizeof(long long) * h.size(),
             cudaMemcpyDeviceToHost);
  cudaFree(tl);
  const int n_warps = (P + k + 31) / 32;
  auto at = [&](int w, int t, int ph) {
    return double(h[(size_t(w) * ticks + t) * 4 + ph]);
  };
  // Owners over ticks 1 .. P + k - 2 (anti-diagonals it applies exist),
  // the chain over its ticks 1 .. P + k - 3.
  double o[4] = {}, c[4] = {}, no = 0, nc = 0;
  for (int w = 0; w < n_warps; ++w) {
    for (int t = 1; t + 1 < P + k - 1; ++t) {
      o[0] += at(w, t, 1) - at(w, t, 0);
      o[1] += at(w, t, 2) - at(w, t, 1);
      o[2] += at(w, t, 3) - at(w, t, 2);
      o[3] += at(w, t + 1, 0) - at(w, t, 0);
      no += 1;
    }
  }
  for (int t = 1; t + 1 < P + k - 1; ++t) {
    c[0] += at(kWarps, t, 1) - at(kWarps, t, 0);
    c[1] += at(kWarps, t, 2) - at(kWarps, t, 1);
    c[2] += at(kWarps, t, 3) - at(kWarps, t, 2);
    c[3] += at(kWarps, t + 1, 0) - at(kWarps, t, 0);
    nc += 1;
  }
  std::printf("timeline P=%3d k=%2d per owner warp (scheduler), wait / "
              "tick:", P, k);
  for (int w = 0; w < n_warps; ++w) {
    double wt = 0, tk = 0, n = 0;
    for (int t = 1; t + 1 < P + k - 1; ++t) {
      wt += at(w, t, 1) - at(w, t, 0);
      tk += at(w, t + 1, 0) - at(w, t, 0);
      n += 1;
    }
    std::printf(" %d(%d) %.0f/%.0f", w, w % 4, wt / n, tk / n);
  }
  std::printf("\n");
  std::printf("timeline P=%3d k=%2d owners: tick %7.1f = wait %7.1f apply "
              "%7.1f commit and stage %6.1f rest %6.1f; chain: tick %7.1f = "
              "wait %7.1f compute %6.1f publish %6.1f cycles\n",
              P, k, o[3] / no, o[0] / no, o[1] / no, o[2] / no,
              (o[3] - o[0] - o[1] - o[2]) / no, c[3] / nc, c[0] / nc,
              c[1] / nc, c[2] / nc);
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
  float* out;
  long long* cycles;
  cudaMalloc(&out, sizeof(float) * kThreads);
  cudaMalloc(&cycles, sizeof(long long));
  Bufs<float> b = alloc_bufs<float>(v);
  Bufs<double> b64 = alloc_bufs<double>(v);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  std::printf("SM clock (attribute) %d kHz\n", khz);
  // The wavefront's two floors at P = 256, k = 16: its dependent chain,
  // P + k - 1 steps of ~220 cycles (a square root, two divisions, one
  // rotation and a shared-memory hand-off), and one SM's issue rate: the
  // sweep takes P k (P + k + 1) rotations (each row's live columns), at
  // ~15 instructions each, on 4 schedulers of one warp instruction a
  // cycle.
  {
    const double P = 256, k = 16, ghz = khz * 1e-6;
    const double rot = P * k * (P + k + 1);
    std::printf("floors P=256 k=16 at %.3f GHz: chain %.0f steps x 220 "
                "cycles = %.1f us; issue %.0f rotations x 15 / (32 x 4) = "
                "%.0f cycles = %.1f us\n",
                ghz, P + k - 1, (P + k - 1) * 220 / ghz * 1e-3, rot,
                rot * 15 / 128, rot * 15 / 128 / ghz * 1e-3);
  }
  {
    unsigned long long* dc;
    cudaMalloc(&dc, 2 * sizeof(unsigned long long));
    cudaMemset(dc, 0, 2 * sizeof(unsigned long long));
    const int blocks = 1056, threads = 256, iters = 4096;
    div_check<<<blocks, threads>>>(12345u, iters, dc);
    unsigned long long h[2] = {0, 0};
    cudaMemcpy(h, dc, sizeof(h), cudaMemcpyDeviceToHost);
    const double n = double(blocks) * threads * iters;
    std::printf("div_pre vs __fdiv_rn: %.0f operand pairs, %llu unflagged "
                "results differ, %llu flagged (%.4f %%)\n",
                n, h[0], h[1], 100.0 * double(h[1]) / n);
    if (h[0] != 0) ++differ_count;
    cudaFree(dc);
  }
  for (int P : {256, 128, 100}) {
    run<16>(tile, b, P, 16, cycles, "fp32");
    run<8>(tile, b, P, 1, cycles, "fp32");
    run<32>(tile, b, P, 32, cycles, "fp32");
  }
  run<16>(tile, b64, 256, 16, cycles, "f64 ");
  run<32>(tile, b64, 100, 32, cycles, "f64 ");
  timeline<16>(tile, b, 256, 16);
  timeline<8>(tile, b, 256, 1);
  timeline<32>(tile, b, 256, 32);
  float* D = b.D;
  float* vt = b.vt;
  float* T = b.T;
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
  if (differ_count > 0) {
    std::printf("%d wavefront run(s) differ from ref\n", differ_count);
    return 1;
  }
  return 0;
}
