// Selective state-space scan (mamba1), forward, on Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan_chunked (Pallas, TPU):
//   x_t = exp(delta_t * A) * x_{t-1} + (delta_t * u_t) * B_t
//   y_t = sum_n C_t[n] * x_t[:, n]
// Inputs, float32 and contiguous: u, delta [Bt, L, D], A [D, N], B, C
// [Bt, L, N].  Outputs: y [Bt, L, D] and the final state [Bt, D, N].
//
// What bounds it on this card: one exp per (b, t, d, n), and about as much
// time for the bytes of u, delta and y (12 per (b, t, d)).  The exp is
// expf, the function the plain version's torch.exp runs: a range reduction
// of 7 instructions around one MUFU.EX2.  With the recurrence an
// element takes 15.75 instructions in the round loop (FFMA 5, FMUL 4.25,
// FADD 2.2, LDS, SHF, MUFU 1 each), so instruction issue, not the SFU,
// sets the arithmetic's floor; at falcon-mamba-7b's mixer (B 1, D 8,192,
// N 16) the kernel also has only 8 warps an SM to hide latency with
// (tools/ssm_scan_probe.py measures both, PERF.md section 6).  A bare
// ex2.approx of dt * a * log2(e), one instruction, left rtol = atol =
// 1e-4 of the plain version at that width, so it is not used.
//
// The design:
//
// - The recurrence rounds as the plain version does.  x_t = e * x + b is
//   a multiply and an add, each rounded (no fused multiply-add), with
//   e = expf(dt * a) and b = (dt * u) * B rounded as the plain version
//   rounds them, so the state walks the plain version's float32 values
//   step by step and only y's short sum over the states is ordered
//   differently.  Over thousands of steps with decays near 1 (small
//   |A| dt, a trained mamba's regime) any other order drifts: a scan of
//   the steps' affine maps along L (lanes composing (exp(dt A), dt u B)
//   and combining them by shuffles) left 1e-4 of plain there, and was
//   removed.
// - States in registers.  A thread owns one channel d and kS of its
//   states (kS = REPRO_SSM_STATES, set by kernels/ssm_scan.py); G lanes (a
//   power of two, ceil(N / kS) rounded up, at most 32) cover a channel's
//   states.  A state dimension above kS * 32 runs in passes, each pass
//   adding its part of y.  The parallelism is channels x state groups: kS
//   sets how many lanes a channel takes, so it trades warps on the card
//   against the per-step work a lane repeats (dt, u, dt * u, the y sums).
// - Rounds of kT steps (REPRO_SSM_ROUND, set by kernels/ssm_scan.py): a
//   round's exps and (dt u) B first (independent of x), then its state
//   updates and y partials, so no step's chain of dependent instructions
//   holds up the next step's loads and exps.  The round's kT partials are
//   then summed over the G lanes by halving: at each shuffle level a lane
//   keeps half the steps and sends the other half to its partner, so the
//   G lanes end with kT / G steps' sums each and every y is stored once
//   (kT - 1 shuffles a round where G <= kT, against kT log2(G)).
// - Overlapped staging.  A block of 128 threads takes 128 / G channels of
//   one batch row (and one pass of states); it stages CH steps of u and
//   delta for its channels (rows of 16-byte cp.async.cg copies) and of B
//   and C for the pass's states (cp.async.ca: every block of the row reads
//   them, so they stay in L1) into a ring of kStages buffers in shared
//   memory, kStages - 1 chunks ahead of the one it computes, with one
//   __syncthreads per chunk.  B and C are read as broadcast vector loads;
//   steps past L are zero-filled (dt = 0: the identity map) and store
//   nothing.  y goes out with streaming stores.
// - G is a template parameter (6 instantiations), and so are the first
//   pass (stores; later passes add) and a chunk that runs past L (stores
//   under a bound), so the chunk length, the staged strides and every
//   shuffle are constants and a full chunk's rounds carry no branch.
//
// REPRO_SSM_SPLIT (diagnostics, tools/ssm_scan_probe.py; 0 in the
// library): 1 drops the recurrence (y_t = dt * u, staging and stores
// stay), 2 drops the staging (the recurrence runs on the ring as it
// stands), so the probe can say which share of the time each part takes.
//
// The grid is one block per (batch row, channel block): the batch and the
// channels are one flat grid dimension, so neither has a limit of its own
// (the grid takes up to 2^31 - 1 blocks).

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_grid.cuh"

#ifndef REPRO_SSM_STATES
#define REPRO_SSM_STATES 4
#endif
#ifndef REPRO_SSM_SPLIT
#define REPRO_SSM_SPLIT 0
#endif
#ifndef REPRO_SSM_ROUND
#define REPRO_SSM_ROUND 8
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kS = REPRO_SSM_STATES;   // states a thread holds
constexpr int kSplit = REPRO_SSM_SPLIT;
constexpr int kT = REPRO_SSM_ROUND;    // steps of a round
constexpr int kStages = 4;             // chunks in the shared-memory ring
constexpr int kPad = 4;                // floats past each staged row
constexpr int kMaxChunk = 64;          // steps a chunk stages at most
constexpr int kStageFloats = 4096;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kS == 1 || kS == 2 || kS == 4 || kS == 8,
              "REPRO_SSM_STATES must be 1, 2, 4 or 8");
static_assert(kT == 2 || kT == 4 || kT == 8 || kT == 16,
              "REPRO_SSM_ROUND must be 2, 4, 8 or 16");

// the most steps (a power of two, at most kMaxChunk) whose staged rows of
// `row` floats fit kStageFloats
__host__ __device__ constexpr int chunk_fit(int row) {
  int ch = 1;
  while (ch * 2 <= kMaxChunk && ch * 2 * row <= kStageFloats) ch *= 2;
  return ch;
}

// The block's layout for G state lanes a channel.
template <int G>
struct Shape {
  static constexpr int kCb = kThreads / G;         // channels a block
  static constexpr int kSd = kCb + kPad;           // staged dt / u row
  static constexpr int kW = kS * G;                // states a pass
  static constexpr int kSb = kW + kPad;            // staged B / C row
  static constexpr int kRow = 2 * (kSd + kSb);     // floats a step
  // steps a chunk, at least a round
  static constexpr int kCh = chunk_fit(kRow) < kT ? kT : chunk_fit(kRow);
  static constexpr int kStage = kCh * kRow;        // floats a stage
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kCh % kT == 0, "a chunk holds whole rounds");
};

struct Params {
  const float* u;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* state;
  int L, D, N;
  int d_blocks;       // D / channels a block
  int passes;         // of kS * G states
  bool vec_bc;        // B and C rows on 16-byte lines (N % 4 == 0)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, L2 only; zero-filled when !valid
__device__ __forceinline__ void cp16_cg(float* dst, const float* src,
                                        bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 16 or 4 bytes into shared memory through L1; zero-filled when !valid
__device__ __forceinline__ void cp16_ca(float* dst, const float* src,
                                        bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4_ca(float* dst, const float* src,
                                       bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage chunk k (steps k*CH .. k*CH+CH-1) of batch row b, channels d0 ..
// d0+Cb-1 and states n0 .. n0+kW-1 into `buf`: dt [CH][Sd], u [CH][Sd],
// B [CH][Sb], C [CH][Sb].
template <int G>
__device__ __forceinline__ void stage_chunk(const Params& p, float* buf,
                                            int64_t b, int d0, int n0,
                                            int k) {
  using S = Shape<G>;
  if constexpr (kSplit == 2) return;
  const int t0 = k * S::kCh;
  float* s_dt = buf;
  float* s_u = buf + S::kCh * S::kSd;
  float* s_b = buf + 2 * S::kCh * S::kSd;
  float* s_c = s_b + S::kCh * S::kSb;
  constexpr int q = S::kCb / 4;                // 16-byte pieces a row
#pragma unroll
  for (int i = threadIdx.x; i < S::kCh * q; i += kThreads) {
    const int r = i / q, j = (i % q) * 4;
    const bool ok = t0 + r < p.L;
    const int64_t off = (b * p.L + (ok ? t0 + r : 0)) * p.D + d0 + j;
    cp16_cg(s_dt + r * S::kSd + j, p.dt + off, ok);
    cp16_cg(s_u + r * S::kSd + j, p.u + off, ok);
  }
  constexpr int w = S::kW;
  if constexpr (w % 4 == 0) {
    if (p.vec_bc) {
      constexpr int qb = w / 4;
#pragma unroll
      for (int i = threadIdx.x; i < S::kCh * qb; i += kThreads) {
        const int r = i / qb, j = (i % qb) * 4;
        const bool ok = t0 + r < p.L && n0 + j < p.N;
        const int64_t off = ok ? (b * p.L + t0 + r) * p.N + n0 + j : 0;
        cp16_ca(s_b + r * S::kSb + j, p.B + off, ok);
        cp16_ca(s_c + r * S::kSb + j, p.C + off, ok);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < S::kCh * w; i += kThreads) {
    const int r = i / w, j = i % w;
    const bool ok = t0 + r < p.L && n0 + j < p.N;
    const int64_t off = ok ? (b * p.L + t0 + r) * p.N + n0 + j : 0;
    cp4_ca(s_b + r * S::kSb + j, p.B + off, ok);
    cp4_ca(s_c + r * S::kSb + j, p.C + off, ok);
  }
}

// a lane's kS staged states of one step, as one or two vector loads
__device__ __forceinline__ void load_states(const float* s, float (&v)[kS]) {
  if constexpr (kS == 8) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 c = *reinterpret_cast<const float4*>(s + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  } else if constexpr (kS == 4) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (kS == 2) {
    const float2 a = *reinterpret_cast<const float2*>(s);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *s;
  }
}

// The lanes along a channel's states that hold a step's y sum after
// reduce_steps: kT / G steps a lane where G <= kT, else one step a group
// of G / kT lanes, of which the lowest stores it.
template <int G>
struct Own {
  static constexpr int kSteps = G >= kT ? 1 : kT / G;
};

// the first of the steps a lane holds after reduce_steps
template <int G>
__device__ __forceinline__ int own_first(int g) {
  int off = 0;
#pragma unroll
  for (int m = 1; m < G && m < kT; m <<= 1)
    if (g & m) off += kT / (2 * m);
  return off;
}

// Sums the round's kT partials of y over the G lanes of a channel,
// halving the steps a lane keeps at each level (it sends the other half
// to its partner lane): lane g ends with the sums of steps own_first(g) ..
// own_first(g) + Own<G>::kSteps - 1 in v[0 ..], after log2(G) shuffle
// levels of kT / 2, kT / 4, ... shuffles (then 1 a level past kT lanes).
template <int M, int G, int HAVE>
__device__ __forceinline__ void reduce_steps(float (&v)[kT], int g) {
  if constexpr (M < G) {
    if constexpr (HAVE > 1) {
      constexpr int n = HAVE / 2;
      const bool upper = (g & M) != 0;
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const float send = upper ? v[j] : v[j + n];
        const float keep = upper ? v[j + n] : v[j];
        v[j] = keep + __shfl_xor_sync(kFull, send, M);
      }
      reduce_steps<M * 2, G, n>(v, g);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], M);
      reduce_steps<M * 2, G, 1>(v, g);
    }
  }
}

// One staged chunk's rounds for a lane.  FIRST: the first pass of states,
// which stores y (later passes add theirs with one atomicAdd an address,
// after the block barrier that ends the pass before); TAIL: the chunk
// runs past L, so a step at or past `left` (steps from the lane's first
// own step to L) stores nothing.  yp: y at the lane's first own step of
// the chunk; `step`: D, y's stride from one step to the next.
template <int G, bool FIRST, bool TAIL>
__device__ __forceinline__ void run_chunk(
    const float* s_dt, const float* s_u, const float* s_b, const float* s_c,
    const float (&a)[kS], float (&x)[kS], float* yp, int64_t step,
    int left, int c, int g) {
  using S = Shape<G>;
  constexpr int Sd = S::kSd, Sb = S::kSb, CH = S::kCh;
  const bool lead = G <= kT || g < kT;
#pragma unroll 1
  for (int r0 = 0; r0 < CH; r0 += kT) {
    float py[kT];
    if constexpr (kSplit == 1) {
#pragma unroll
      for (int i = 0; i < kT; ++i)
        py[i] = s_dt[(r0 + i) * Sd + c] * s_u[(r0 + i) * Sd + c];
    } else {
      // the round's exps and (dt u) B first (independent of x), then its
      // state updates and y partials
      float ea[kT][kS], eb[kT][kS];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const float dtv = s_dt[(r0 + i) * Sd + c];
        const float dtu = dtv * s_u[(r0 + i) * Sd + c];
        float bv[kS];
        load_states(s_b + (r0 + i) * Sb, bv);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          ea[i][s] = expf(dtv * a[s]);
          eb[i][s] = dtu * bv[s];
        }
      }
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        float cv[kS];
        load_states(s_c + (r0 + i) * Sb, cv);
        py[i] = 0.f;
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          // rounded as the plain version rounds: no fused multiply-add
          x[s] = __fadd_rn(__fmul_rn(ea[i][s], x[s]), eb[i][s]);
          py[i] = fmaf(cv[s], x[s], py[i]);
        }
      }
    }
    reduce_steps<1, G, kT>(py, g);
#pragma unroll
    for (int j = 0; j < Own<G>::kSteps; ++j) {
      float* dst = yp + j * step;
      if (lead && (!TAIL || r0 + j < left)) {
        if constexpr (FIRST)
          __stcs(dst, py[j]);
        else
          atomicAdd(dst, py[j]);
      }
    }
    yp += kT * step;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(Params p) {
  using S = Shape<G>;
  constexpr int Sd = S::kSd, Sb = S::kSb, CH = S::kCh;
  extern __shared__ __align__(16) float smem[];
  const int64_t b = blockIdx.x / p.d_blocks;
  const int d0 = static_cast<int>(blockIdx.x % p.d_blocks) * S::kCb;
  const int g = threadIdx.x % G;
  const int c = threadIdx.x / G;
  const int d = d0 + c;
  const int off = own_first<G>(g);
  const int n_chunks = (p.L + CH - 1) / CH;

  for (int pass = 0; pass < p.passes; ++pass) {
    const int n0 = pass * S::kW;
    float a[kS], x[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int n = n0 + g * kS + s;
      a[s] = n < p.N ? p.A[int64_t(d) * p.N + n] : 0.f;
      x[s] = 0.f;
    }
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_chunks) stage_chunk<G>(p, smem + k * S::kStage, b, d0, n0, k);
      cp_commit();
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_wait<kStages - 2>();
      __syncthreads();
      const int nk = ch + kStages - 1;
      if (nk < n_chunks)
        stage_chunk<G>(p, smem + (nk % kStages) * S::kStage, b, d0, n0, nk);
      cp_commit();

      const float* s_dt = smem + (ch % kStages) * S::kStage;
      const float* s_u = s_dt + CH * Sd;
      const float* s_b = s_dt + 2 * CH * Sd + g * kS;
      const float* s_c = s_b + CH * Sb;
      const int t0 = ch * CH;
      float* yp = p.y + (b * p.L + t0 + off) * p.D + d;
      const int left = p.L - t0 - off;
      const int64_t step = p.D;
      if (pass == 0) {
        if (t0 + CH > p.L)
          run_chunk<G, true, true>(s_dt, s_u, s_b, s_c, a, x, yp, step, left,
                                   c, g);
        else
          run_chunk<G, true, false>(s_dt, s_u, s_b, s_c, a, x, yp, step,
                                    left, c, g);
      } else {
        if (t0 + CH > p.L)
          run_chunk<G, false, true>(s_dt, s_u, s_b, s_c, a, x, yp, step,
                                    left, c, g);
        else
          run_chunk<G, false, false>(s_dt, s_u, s_b, s_c, a, x, yp, step,
                                     left, c, g);
      }
    }
    cp_wait<0>();
    __syncthreads();   // the next pass refills the ring
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int n = n0 + g * kS + s;
      if (n < p.N) p.state[(b * p.D + d) * int64_t(p.N) + n] = x[s];
    }
  }
}

// One launch at G; raises the kernel's dynamic shared-memory limit once on
// each card where its ring needs more than the default 48 KB (the first
// call of a shape on a card runs outside any CUDA graph capture).
template <int G>
int launch(Params p, int64_t bt, cudaStream_t s) {
  using S = Shape<G>;
  if constexpr (S::kSmem > (48 << 10)) {
    const cudaError_t err =
        repro::raise_smem_once<ssm_scan_kernel<G>, S::kSmem>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.D % S::kCb) return static_cast<int>(cudaErrorInvalidValue);
  p.d_blocks = p.D / S::kCb;
  p.passes = (p.N + S::kW - 1) / S::kW;
  const int64_t blocks = bt * p.d_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_kernel<G><<<static_cast<unsigned>(blocks), kThreads, S::kSmem,
                       s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G: lanes per channel over its states (a power of two, kS states a lane
// per pass, at most 32).  The host chooses it
// (kernels/ssm_scan.py::scan_layout).
extern "C" int repro_ssm_scan(const void* u, const void* delta, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, int64_t bt, int L, int D, int N,
                              int G, void* stream) {
  if (N < 1 || reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(delta) % 16 ||
      reinterpret_cast<uintptr_t>(Bm) % 16 ||
      reinterpret_cast<uintptr_t>(Cm) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.u = static_cast<const float*>(u);
  p.dt = static_cast<const float*>(delta);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(Bm);
  p.C = static_cast<const float*>(Cm);
  p.y = static_cast<float*>(y);
  p.state = static_cast<float*>(state);
  p.L = L;
  p.D = D;
  p.N = N;
  p.d_blocks = 0;
  p.passes = 0;
  p.vec_bc = N % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<1>(p, bt, s);
    case 2: return launch<2>(p, bt, s);
    case 4: return launch<4>(p, bt, s);
    case 8: return launch<8>(p, bt, s);
    case 16: return launch<16>(p, bt, s);
    case 32: return launch<32>(p, bt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
