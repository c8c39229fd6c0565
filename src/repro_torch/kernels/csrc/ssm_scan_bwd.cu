// Selective state-space scan (mamba1), backward, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package trains through XLA's autodiff
// of the scan's lax.scan (src/repro/models/ssm.py::selective_scan_seq and
// selective_scan_chunked), and this kernel computes that gradient for the
// function csrc/ssm_scan.cu computes forward.  With a_t = exp(delta_t A),
// x_t = a_t x_{t-1} + (delta_t u_t) B_t and y_t = sum_n C_t x_t, for dy
// over y (no gradient for the final state, which the model drops):
//
//   g_t      = dy_t C_t + a_{t+1} g_{t+1}                  [b, d, n]
//   dC_t     = sum_d dy_t x_t                               [b, n]
//   dB_t     = sum_d g_t delta_t u_t                        [b, n]
//   du_t     = delta_t sum_n g_t B_t                        [b, d]
//   ddelta_t = sum_n A q_t + u_t sum_n g_t B_t              [b, d]
//   dA       = sum_{b, t} q_t delta_t, q_t = g_t a_t x_{t-1} [d, n]
//
// Inputs: u, delta [Bt, L, D] and B, C [Bt, L, N] (rows of N on a stride
// of their own), all four float32 or all four bf16, read as they come and
// widened in registers (exact, so bf16 operands give the bits of their
// float32 copies); dy [Bt, L, D] and A [D, N] float32.  Outputs, float32:
// du, ddelta [Bt, L, D], dA [D, N], dB, dC [Bt, L, N].
//
// What bounds it on this card: two exps a (b, t, d, n) (the checkpoint
// walk and the recompute each take one), or the bytes of u, delta, dy,
// du and ddelta.  Beside the exps an element costs about 45 instructions
// over three walks, so the instruction rate and the latency between a
// round's dependent steps set the time: hymba-1.5b's 102,400 (b, d, n)
// chains at batch 2 make 800 warps of 4 states a lane, so the busiest
// schedulers hold two warps.  The first design (one state a thread,
// operands read from device memory inside the step chain,
// partials of 8 channels, float32 copies of bf16 operands) ran at 57-63x
// the bound, held by the latency of each step's loads.  This one takes
// its four causes in turn:
//
// - Staged operands.  A block stages chunks of kCh steps in a ring of two
//   buffers in shared memory by cp.async, a chunk ahead of the one it
//   walks: u and delta (as they come) and dy for its channels, B and C for
//   the pass's states.  The checkpoint walk streams the chunks forward;
//   the reverse pass takes them last to first, each staged once for both
//   its recompute and its reverse walk.  No walk reads device memory
//   inside its step chain; a segment's checkpoint is loaded a segment
//   ahead.  bf16 B and C are widened once a chunk, by the whole block,
//   into float32 tiles; u and delta are widened as a lane reads them.
//   The operands are read in the layouts the mamba block hands over: B
//   and C as strided slices of one projection, u laid out steps first
//   (the causal conv's transpose), staged a channel's steps a row with
//   its 16-byte pieces swizzled by the channel (u_swizzle).
// - Several states a lane.  A thread owns one channel d and kS states
//   (REPRO_SSM_BWD_STATES); G lanes (a power of two, ceil(N / kS), at most
//   32) cover a channel's states, and past kS * 32 states the kernel runs
//   passes.  A lane's loads of dt, u and dy, its dt u, and the du and
//   ddelta partials (summed over its own states first) serve kS states,
//   and its kS chains give the scheduler independent work.
// - Rounds of steps.  Checkpoints of the state every kR steps
//   (REPRO_SSM_BWD_STEPS) go to a device scratch, written once by the
//   checkpoint walk and read once, a segment ahead, by the reverse pass,
//   so a block's shared memory is the same at every L.  A segment of kR
//   steps is recomputed from its
//   checkpoint, its exps and (dt u) B first, then the chain, the states
//   into registers and the decays into shared memory (the thread's own
//   slots: registers held both spilled), then walked backwards in rounds
//   of kT steps (REPRO_SSM_BWD_ROUND): du and ddelta are summed over the G
//   lanes by halving, as the forward sums y (a lane keeps half the
//   round's steps at each shuffle level), and dB and dC over the block's
//   channels through shared memory after each round (kP threads a
//   column, each over every kP-th channel, the columns swizzled by
//   channel so the sum reads no bank twice).
// - Fewer, smaller partials.  A block of kThreads threads
//   (REPRO_SSM_BWD_THREADS) takes kThreads / G channels (32 at N 16, four
//   times the first design's), so dB and dC leave D / 32 partials a
//   (b, t, n); a second kernel in the same call sums them, and dA's batch
//   rows, in a fixed order (no torch reductions, no copies: on the
//   model path the wrapper launches nothing else).  kMinBlocks (REPRO_SSM_BWD_BLOCKS)
//   caps the registers so that falcon-mamba-7b's 512 blocks at batch 2
//   run in one wave.
//
// The recompute rounds as the forward kernel and the plain version round:
// x_t = e x + (dt u) B as a multiply and an add, each rounded (no fused
// multiply-add), e = expf(dt a), so the recomputed states are the
// forward's bit for bit, and neither recurrence is reordered along L (a
// scan of the steps' affine maps left 1e-4 of plain for the forward where
// decays are near 1).  No float atomics: every sum runs in a fixed order,
// so a rerun gives the same bits.  Steps past L are staged as zeros: dt 0
// is the identity map, dy 0 and C 0 add nothing, and nothing is stored.
//
// Measured on an H100 (tools/ssm_scan_bwd_probe.py, chip_smoke.py's
// train (c); PERF.md section 6, row 13): at hymba-1.5b's first layer in
// training (B 2, L 1,024, D 3,200, N 16, bf16, B and C read in place as
// the projection's slices) 0.49 ms cold against the first design's 2.8
// ms and a 0.050 ms bound, at falcon-mamba-7b's width (D 8,192) 0.82 ms
// (0.46-0.47 and 0.79 on contiguous B and C); 128 registers and no
// spills at N 16 (G 4), 8-300 bytes at other lane counts.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch_grid.cuh"

#ifndef REPRO_SSM_BWD_STATES
#define REPRO_SSM_BWD_STATES 4
#endif
#ifndef REPRO_SSM_BWD_STEPS
#define REPRO_SSM_BWD_STEPS 8
#endif
#ifndef REPRO_SSM_BWD_ROUND
#define REPRO_SSM_BWD_ROUND 4
#endif
#ifndef REPRO_SSM_BWD_THREADS
#define REPRO_SSM_BWD_THREADS 128
#endif
#ifndef REPRO_SSM_BWD_BLOCKS
#define REPRO_SSM_BWD_BLOCKS 4
#endif

namespace {

constexpr int kThreads = REPRO_SSM_BWD_THREADS;
constexpr int kS = REPRO_SSM_BWD_STATES;   // states a lane
constexpr int kR = REPRO_SSM_BWD_STEPS;    // steps between checkpoints
constexpr int kT = REPRO_SSM_BWD_ROUND;    // steps a round of the reverse walk
constexpr int kCh = 32;                    // steps a staged chunk
constexpr int kSegs = kCh / kR;            // checkpoints a chunk
// blocks an SM must hold by registers (4 of 128 threads: at most 128
// registers a thread)
constexpr int kMinBlocks = REPRO_SSM_BWD_BLOCKS;
constexpr int kMaxSmem = 232448;           // 227 KB, a block's most
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kS == 1 || kS == 2 || kS == 4 || kS == 8,
              "REPRO_SSM_BWD_STATES must be 1, 2, 4 or 8");
static_assert(kR == 4 || kR == 8 || kR == 16, "REPRO_SSM_BWD_STEPS: 4, 8, 16");
static_assert(kT >= 2 && kT <= kR && kR % kT == 0,
              "REPRO_SSM_BWD_ROUND must divide REPRO_SSM_BWD_STEPS");
static_assert(kThreads == 128 || kThreads == 256,
              "REPRO_SSM_BWD_THREADS must be 128 or 256");
static_assert(kMinBlocks >= 1 && kMinBlocks * kThreads <= 2048,
              "REPRO_SSM_BWD_BLOCKS: 1 .. 2048 / threads");

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The block's layout for element type T of u, delta, B, C and G lanes a
// channel; byte sizes of the shared-memory regions.
template <typename T, int G>
struct Shape {
  static constexpr int kE = sizeof(T);
  static constexpr int kCb = kThreads / G;          // channels a block
  static constexpr int kW = kS * G;                 // states a pass
  // dt or u of a chunk: [kCh][kCb], or for u laid out steps first
  // [kCb][kCh] with each channel's 16-byte pieces swizzled (u_swizzle)
  static constexpr int kDt = kCh * kCb * kE;
  static constexpr int kDy = kCh * kCb * 4;         // dy of a chunk
  static constexpr int kBc = kCh * kW * kE;         // B or C of a chunk
  static constexpr int kStage = 2 * kDt + kDy + 2 * kBc;
  static constexpr bool kWiden = kE != 4;
  static constexpr int kWide = kWiden ? 2 * kCh * kW * 4 : 0;
  // dB and dC of a round before the block's sum: [kT][2][kCb][kW]
  static constexpr int kRed = kT * 2 * kCb * kW * 4;
  // a segment's recomputed decays, a lane's kS states a step: [kR][kCb][kW]
  static constexpr int kEs = kR * kCb * kW * 4;
  // the block's dynamic shared memory, the same at every L
  static constexpr int kSmem = 2 * kStage + kWide + kRed + kEs;
  // the block's sum: columns of kV states, an item (step, dB or dC,
  // column) summed by kP threads over interleaved channels
  static constexpr int kV = kW < 4 ? kW : 4;
  static constexpr int kCols = kW / kV;
  static constexpr int kItems = kT * 2 * kCols;
  static constexpr int kP = kItems >= kThreads
                                ? 1 : cmin(32, cmin(kThreads / kItems, kCb));
  static_assert(kStage % 16 == 0 && kRed % 16 == 0, "16-byte regions");
  static_assert(kSmem <= kMaxSmem, "a block's shared memory past 227 KB");
};

struct Params {
  const void* u;
  const void* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* dy;
  float* ck;        // [Bt, segments, D, kW]: the checkpoints
  float* du;        // [Bt, L, D]
  float* ddt;       // [Bt, L, D]
  float* dA_part;   // [Bt, D, N]
  float* dB_part;   // [d_blocks, Bt, L, N]
  float* dC_part;   // [d_blocks, Bt, L, N]
  int64_t sb, st;   // B and C: a batch row's and a step's stride, elements
  int64_t bt;       // batch rows
  int L, D, N;
  int d_blocks;     // D / channels a block
  int n_chunks;     // ceil(L / kCh)
  int passes;       // of kW states
  bool vec_bc;      // B and C rows copied in 16-byte pieces
  bool u_cols;      // u laid out steps first: u[b, t, d] at (b D + d) L + t
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// kBytes (4, 8 or 16) into shared memory, the first src_bytes of them
// from src and the rest zeros; 16-byte rows of the [Bt, L, D] streams
// skip L1 (.cg), B and C rows, which every block of a batch row reads, go
// through it (.ca)
template <int kBytes, bool kL1>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16 && !kL1)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(kBytes),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// For u laid out steps first, staged as [kCb][kCh]: the step r of channel
// c sits at c kCh + (r ^ u_swizzle(c)), its 16-byte piece moved by the
// channel, so the lanes' reads of one step (8 channels a warp at 4 lanes
// a channel) fall in 8 different bank groups.
template <typename T>
__host__ __device__ constexpr int u_swizzle(int c) {
  constexpr int per = 16 / int(sizeof(T));    // steps a piece
  constexpr int pieces = kCh / per;           // pieces a channel
  return ((c / (8 / pieces)) % pieces) * per;
}

// Stage chunk k (steps k kCh .. k kCh + kCh - 1) of batch row b, channels
// d0 .. d0 + kCb - 1 and states n0 .. n0 + kW - 1 into the buffer `buf`:
// dt [kCh][kCb] (T), u [kCh][kCb] or (u_cols) [kCb][kCh] swizzled (T), dy
// [kCh][kCb] (REV only), B [kCh][kW] and (REV only) C [kCh][kW] (T).
template <typename T, int G, bool REV>
__device__ __forceinline__ void stage_chunk(const Params& p,
                                            unsigned char* buf, int64_t b,
                                            int d0, int n0, int k) {
  using S = Shape<T, G>;
  const int t0 = k * kCh;
  {
    constexpr int row = S::kCb * S::kE;
    constexpr int pc = row % 16 == 0 ? 16 : 8;
    constexpr int q = row / pc;
    const auto* dt = static_cast<const unsigned char*>(p.dt);
    const auto* u = static_cast<const unsigned char*>(p.u);
#pragma unroll 4
    for (int i = threadIdx.x; i < kCh * q; i += kThreads) {
      const int r = i / q, j = i % q;
      const bool ok = t0 + r < p.L;
      const int64_t off =
          ((b * p.L + (ok ? t0 + r : 0)) * p.D + d0) * S::kE + j * pc;
      cp_async<pc, false>(buf + r * row + j * pc, dt + off, ok ? pc : 0);
      if (!p.u_cols)
        cp_async<pc, false>(buf + S::kDt + r * row + j * pc, u + off,
                            ok ? pc : 0);
    }
    if (p.u_cols) {   // a channel's kCh steps, the part past L zero-filled
      constexpr int per = 16 / S::kE, q = kCh / per;
      for (int i = threadIdx.x; i < S::kCb * q; i += kThreads) {
        const int c = i / q, j = i % q;
        const int t = t0 + j * per;
        const int left = (p.L - t) * S::kE;
        const int n = left < 0 ? 0 : left > 16 ? 16 : left;
        const int64_t off =
            ((b * p.D + d0 + c) * p.L + (n ? t : 0)) * S::kE;
        cp_async<16, false>(
            buf + S::kDt + (c * kCh + ((j * per) ^ u_swizzle<T>(c))) * S::kE,
            u + off, n);
      }
    }
  }
  if constexpr (REV) {
    constexpr int row = S::kCb * 4;
    constexpr int q = row / 16;
    const auto* dy = reinterpret_cast<const unsigned char*>(p.dy);
#pragma unroll 4
    for (int i = threadIdx.x; i < kCh * q; i += kThreads) {
      const int r = i / q, j = i % q;
      const bool ok = t0 + r < p.L;
      const int64_t off =
          ((b * p.L + (ok ? t0 + r : 0)) * p.D + d0) * 4 + j * 16;
      cp_async<16, false>(buf + 2 * S::kDt + r * row + j * 16, dy + off,
                          ok ? 16 : 0);
    }
  }
  constexpr int row = S::kW * S::kE;
  unsigned char* sb = buf + 2 * S::kDt + S::kDy;
  const auto* B = static_cast<const unsigned char*>(p.B);
  const auto* C = static_cast<const unsigned char*>(p.C);
  if constexpr (row % 16 == 0) {
    if (p.vec_bc) {
      constexpr int q = row / 16;
      for (int i = threadIdx.x; i < kCh * q; i += kThreads) {
        const int r = i / q, j = i % q;
        const int n = n0 + j * (16 / S::kE);
        const bool ok = t0 + r < p.L && n < p.N;
        const int64_t off = ok ? (b * p.sb + int64_t(t0 + r) * p.st + n) *
                                     S::kE : 0;
        cp_async<16, true>(sb + r * row + j * 16, B + off, ok ? 16 : 0);
        if constexpr (REV)
          cp_async<16, true>(sb + S::kBc + r * row + j * 16, C + off,
                             ok ? 16 : 0);
      }
      return;
    }
  }
  if constexpr (row % 4 == 0) {   // the host sends bf16 only for even N
    constexpr int q = row / 4;
    for (int i = threadIdx.x; i < kCh * q; i += kThreads) {
      const int r = i / q, j = i % q;
      const int n = n0 + j * (4 / S::kE);
      const bool ok = t0 + r < p.L && n < p.N;
      const int64_t off = ok ? (b * p.sb + int64_t(t0 + r) * p.st + n) *
                                   S::kE : 0;
      cp_async<4, true>(sb + r * row + j * 4, B + off, ok ? 4 : 0);
      if constexpr (REV)
        cp_async<4, true>(sb + S::kBc + r * row + j * 4, C + off,
                          ok ? 4 : 0);
    }
  }
}

// a lane's kS states at `s`, as one or two vector accesses (s on a
// 4 kS-byte line, up to 16)
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

__device__ __forceinline__ void store_states(float* s, const float (&v)[kS]) {
  if constexpr (kS == 8) {
    *reinterpret_cast<float4*>(s) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(s + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (kS == 4) {
    *reinterpret_cast<float4*>(s) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kS == 2) {
    *reinterpret_cast<float2*>(s) = make_float2(v[0], v[1]);
  } else {
    *s = v[0];
  }
}

// Where state n of channel c sits in a [kCb][kW] slice of the round's dB
// and dC sums: its column of kV states swizzled by the channel, so the
// block's sum reads channels side by side without bank conflicts.
template <typename T, int G>
__device__ __forceinline__ int red_index(int c, int n) {
  using S = Shape<T, G>;
  const int col = (n / S::kV) ^ (c % S::kCols);
  return c * S::kW + col * S::kV + n % S::kV;
}

// a lane's kS products into the round's [kCb][kW] slice, a column at a time
template <typename T, int G>
__device__ __forceinline__ void store_red(float* base, int c, int g,
                                          const float (&v)[kS]) {
  using S = Shape<T, G>;
  if constexpr (kS <= S::kV) {
    store_states(base + red_index<T, G>(c, g * kS), v);
  } else {
#pragma unroll
    for (int q = 0; q < kS; q += 4)
      *reinterpret_cast<float4*>(base + red_index<T, G>(c, g * kS + q)) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}

// Sums a round's kT partials over the G lanes of a channel by halving (a
// lane sends half its steps to its partner at each level): lane g ends
// with the sums of steps own_first(g) .. own_first(g) + Own<G>::kSteps - 1
// in v[0 ..].  As the forward kernel's reduce_steps.
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

template <int G>
struct Own {
  static constexpr int kSteps = G >= kT ? 1 : kT / G;
};

template <int G>
__device__ __forceinline__ int own_first(int g) {
  int off = 0;
#pragma unroll
  for (int m = 1; m < G && m < kT; m <<= 1)
    if (g & m) off += kT / (2 * m);
  return off;
}

// kR steps of the forward recurrence from staged row r0, rounded as the
// plain version rounds: the states after each step into xs, x advanced
// past the last, and (with es_out) the decays to es_out, a step's kS at
// every kCb kW floats.  The lane's u of row r is s_u[(r ^ um) * us].
template <typename T, int G>
__device__ __forceinline__ void advance(const T* s_dt, const T* s_u, int um,
                                        int us, const float* s_b, int r0,
                                        int c,
                                        const float (&a)[kS], float (&x)[kS],
                                        float (&xs)[kR][kS],
                                        float* es_out = nullptr) {
  using S = Shape<T, G>;
  float es[kR][kS];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float dtv = widen(s_dt[(r0 + i) * S::kCb + c]);
    const float dtu = __fmul_rn(dtv, widen(s_u[((r0 + i) ^ um) * us]));
    float bv[kS];
    load_states(s_b + (r0 + i) * S::kW, bv);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      es[i][s] = expf(__fmul_rn(dtv, a[s]));
      xs[i][s] = __fmul_rn(dtu, bv[s]);
    }
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      x[s] = __fadd_rn(__fmul_rn(es[i][s], x[s]), xs[i][s]);
      xs[i][s] = x[s];
    }
    if (es_out) store_states(es_out + i * S::kCb * S::kW, es[i]);
  }
}

// The block's sum of a round's dB and dC over its channels (kP threads an
// item, each over every kP-th channel, then shuffles), stored as the
// block's partial for steps t0 + r .. t0 + r + kT - 1 below L.
template <typename T, int G>
__device__ __forceinline__ void block_sum(const Params& p, const float* red,
                                          int64_t b, int blk, int n0,
                                          int t) {
  using S = Shape<T, G>;
  constexpr int P = S::kP, V = S::kV;
  constexpr int active = S::kItems * P;
  constexpr unsigned mask = active >= 32 ? kFull : (1u << active) - 1u;
  for (int i = threadIdx.x; i < active; i += kThreads) {
    const int part = i % P, item = i / P;
    const int j = item / (2 * S::kCols);
    const int kind = (item / S::kCols) % 2;
    const int col = item % S::kCols;
    const float* base = red + (j * 2 + kind) * S::kCb * S::kW;
    float v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = 0.f;
#pragma unroll
    for (int m = 0; m < S::kCb / P; ++m) {
      const float* src = base + red_index<T, G>(part + m * P, col * V);
      if constexpr (V == 4) {
        const float4 w = *reinterpret_cast<const float4*>(src);
        v[0] += w.x; v[1] += w.y; v[2] += w.z; v[3] += w.w;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] += src[e];
      }
    }
#pragma unroll
    for (int m = 1; m < P; m <<= 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] += __shfl_xor_sync(mask, v[e], m);
    }
    if (part == 0 && t + j < p.L) {
      float* dst = (kind ? p.dC_part : p.dB_part) +
                   ((int64_t(blk) * p.bt + b) * p.L + t + j) * p.N;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int n = n0 + col * V + e;
        if (n < p.N) dst[n] = v[e];
      }
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssm_scan_bwd_kernel(Params p) {
  using S = Shape<T, G>;
  constexpr int Cb = S::kCb, W = S::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_wide = reinterpret_cast<float*>(smem + 2 * S::kStage);
  float* red = reinterpret_cast<float*>(smem + 2 * S::kStage + S::kWide);
  float* s_es = reinterpret_cast<float*>(smem + 2 * S::kStage + S::kWide +
                                         S::kRed) + threadIdx.x * kS;
  const int64_t b = blockIdx.x / p.d_blocks;
  const int blk = static_cast<int>(blockIdx.x % p.d_blocks);
  const int g = threadIdx.x % G;
  const int c = threadIdx.x / G;
  const int d0 = blk * Cb;
  const int d = d0 + c;
  const int own = own_first<G>(g);
  const bool lead = G <= kT || g < kT;
  const int segs = p.n_chunks * kSegs;
  // this lane's u in a staged chunk: row r at s_u + uo + (r ^ um) us
  const int uo = p.u_cols ? c * kCh : c;
  const int um = p.u_cols ? u_swizzle<T>(c) : 0;
  const int us = p.u_cols ? 1 : Cb;
  // this thread's checkpoints: segment s at ck + s * ck_step
  float* ck = p.ck + (b * segs * p.D + d) * W + g * kS;
  const int64_t ck_step = int64_t(p.D) * W;
  // staged B and C as float32: the bf16 tiles widened, or the stage itself
  auto tiles = [&](unsigned char* buf, const float*& sbw, const float*& scw) {
    if constexpr (S::kWiden) {
      sbw = s_wide;
      scw = s_wide + kCh * W;
    } else {
      sbw = reinterpret_cast<const float*>(buf + 2 * S::kDt + S::kDy);
      scw = sbw + kCh * W;
    }
  };
  auto widen_tiles = [&](unsigned char* buf, bool with_c) {
    if constexpr (S::kWiden) {
      const T* sb = reinterpret_cast<const T*>(buf + 2 * S::kDt + S::kDy);
      for (int i = threadIdx.x; i < kCh * W; i += kThreads) {
        s_wide[i] = widen(sb[i]);
        if (with_c) s_wide[kCh * W + i] = widen(sb[kCh * W + i]);
      }
      __syncthreads();
    }
  };

  for (int pass = 0; pass < p.passes; ++pass) {
    const int n0 = pass * W;
    float a[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int n = n0 + g * kS + s;
      a[s] = n < p.N ? p.A[int64_t(d) * p.N + n] : 0.f;
    }

    // walk 1: forward, the state before every segment
    {
      float x[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) x[s] = 0.f;
      stage_chunk<T, G, false>(p, smem, b, d0, n0, 0);
      cp_commit();
      for (int k = 0; k < p.n_chunks; ++k) {
        cp_wait_all();
        __syncthreads();
        if (k + 1 < p.n_chunks)
          stage_chunk<T, G, false>(p, smem + ((k + 1) & 1) * S::kStage, b,
                                   d0, n0, k + 1);
        cp_commit();
        unsigned char* buf = smem + (k & 1) * S::kStage;
        widen_tiles(buf, false);
        const float *sbw, *scw;
        tiles(buf, sbw, scw);
        const T* s_dt = reinterpret_cast<const T*>(buf);
        const T* s_u = reinterpret_cast<const T*>(buf + S::kDt) + uo;
#pragma unroll 1
        for (int i = 0; i < kSegs; ++i) {
          store_states(ck + (int64_t(k) * kSegs + i) * ck_step, x);
          float xs[kR][kS];
          advance<T, G>(s_dt, s_u, um, us, sbw + g * kS, i * kR, c, a, x,
                        xs);
        }
      }
      cp_wait_all();
      __syncthreads();   // walk 2 refills the ring
    }

    // walk 2: the chunks last to first, each recomputed from its
    // checkpoints a segment at a time and walked backwards
    float carry[kS], dA[kS], nx[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) carry[s] = dA[s] = 0.f;
    load_states(ck + int64_t(segs - 1) * ck_step, nx);
    stage_chunk<T, G, true>(p, smem + ((p.n_chunks - 1) & 1) * S::kStage, b,
                            d0, n0, p.n_chunks - 1);
    cp_commit();
    for (int k = p.n_chunks - 1; k >= 0; --k) {
      cp_wait_all();
      __syncthreads();
      if (k > 0)
        stage_chunk<T, G, true>(p, smem + ((k - 1) & 1) * S::kStage, b, d0,
                                n0, k - 1);
      cp_commit();
      unsigned char* buf = smem + (k & 1) * S::kStage;
      widen_tiles(buf, true);
      const float *sbw, *scw;
      tiles(buf, sbw, scw);
      sbw += g * kS;
      scw += g * kS;
      const T* s_dt = reinterpret_cast<const T*>(buf);
      const T* s_u = reinterpret_cast<const T*>(buf + S::kDt) + uo;
      const float* s_dy = reinterpret_cast<const float*>(buf + 2 * S::kDt);
#pragma unroll 1
      for (int i = kSegs - 1; i >= 0; --i) {
        const int seg = k * kSegs + i;
        float x0[kS];
#pragma unroll
        for (int s = 0; s < kS; ++s) x0[s] = nx[s];
        if (seg > 0) load_states(ck + int64_t(seg - 1) * ck_step, nx);
        float xs[kR][kS], xe[kS];
#pragma unroll
        for (int s = 0; s < kS; ++s) xe[s] = x0[s];
        advance<T, G>(s_dt, s_u, um, us, sbw, i * kR, c, a, xe, xs, s_es);
#pragma unroll
        for (int rr = kR / kT - 1; rr >= 0; --rr) {
          const int r0 = i * kR + rr * kT;   // the round's first row
          float sgb[kT], sq[kT];
#pragma unroll
          for (int j = kT - 1; j >= 0; --j) {
            const int ii = rr * kT + j, r = r0 + j;
            const float dyv = s_dy[r * Cb + c];
            const float dtv = widen(s_dt[r * Cb + c]);
            const float dtu = __fmul_rn(dtv, widen(s_u[(r ^ um) * us]));
            float bv[kS], cv[kS], vb[kS], vc[kS], e[kS];
            load_states(sbw + r * W, bv);
            load_states(scw + r * W, cv);
            load_states(s_es + ii * Cb * W, e);
            sgb[j] = sq[j] = 0.f;
#pragma unroll
            for (int s = 0; s < kS; ++s) {
              const float xp = ii > 0 ? xs[ii - 1][s] : x0[s];
              const float gg = fmaf(dyv, cv[s], carry[s]);
              const float q = __fmul_rn(gg, __fmul_rn(e[s], xp));
              sgb[j] = fmaf(gg, bv[s], sgb[j]);
              sq[j] = fmaf(a[s], q, sq[j]);
              dA[s] = fmaf(q, dtv, dA[s]);
              vb[s] = __fmul_rn(gg, dtu);
              vc[s] = __fmul_rn(dyv, xs[ii][s]);
              carry[s] = __fmul_rn(e[s], gg);
            }
            float* rb = red + (j * 2) * Cb * W;
            store_red<T, G>(rb, c, g, vb);
            store_red<T, G>(rb + Cb * W, c, g, vc);
          }
          // du and ddelta over the channel's G lanes
          reduce_steps<1, G, kT>(sgb, g);
          reduce_steps<1, G, kT>(sq, g);
          const int t = k * kCh + r0;
#pragma unroll
          for (int m = 0; m < Own<G>::kSteps; ++m) {
            const int j = own + m;
            if (lead && t + j < p.L) {
              const int r = r0 + j;
              const float dtv = widen(s_dt[r * Cb + c]);
              const float uv = widen(s_u[(r ^ um) * us]);
              const int64_t o = (b * p.L + t + j) * p.D + d;
              const float vdu = __fmul_rn(dtv, sgb[m]);
              const float vdd = fmaf(uv, sgb[m], sq[m]);
              if (pass == 0) {
                p.du[o] = vdu;
                p.ddt[o] = vdd;
              } else {
                p.du[o] += vdu;
                p.ddt[o] += vdd;
              }
            }
          }
          __syncthreads();
          block_sum<T, G>(p, red, b, blk, n0, t);
          __syncthreads();   // the next round rewrites the sums
        }
      }
    }
    cp_wait_all();
    __syncthreads();   // the next pass refills the ring
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int n = n0 + g * kS + s;
      if (n < p.N) p.dA_part[(b * p.D + d) * int64_t(p.N) + n] = dA[s];
    }
  }
}

// dB, dC [m = Bt L N]: the blocks' partials summed in block order; dA
// [dn = D N]: the batch rows' partials summed in row order.
__global__ void ssm_scan_bwd_sum_kernel(const float* dB_part,
                                        const float* dC_part,
                                        const float* dA_part, float* dB,
                                        float* dC, float* dA, int64_t m,
                                        int parts, int64_t dn, int64_t bt) {
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  const int64_t i0 = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = i0; i < m; i += step) {
    float sb = 0.f, sc = 0.f;
#pragma unroll 8
    for (int k = 0; k < parts; ++k) {
      sb += dB_part[k * m + i];
      sc += dC_part[k * m + i];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  for (int64_t i = i0; i < dn; i += step) {
    float s = 0.f;
    for (int64_t r = 0; r < bt; ++r) s += dA_part[r * dn + i];
    dA[i] = s;
  }
}

template <typename T, int G>
int launch(Params p, int64_t bt, float* dA, float* dB, float* dC,
           cudaStream_t s) {
  using S = Shape<T, G>;
  if (p.D % S::kCb) return static_cast<int>(cudaErrorInvalidValue);
  p.d_blocks = p.D / S::kCb;
  p.passes = (p.N + S::kW - 1) / S::kW;
  constexpr int smem = S::kSmem;
  // past 48 KB, the limit raised once on each card (the attribute is a
  // card's; the first call on a card runs outside any CUDA graph capture)
  if constexpr (smem > (48 << 10)) {
    const cudaError_t err =
        repro::raise_smem_once<ssm_scan_bwd_kernel<T, G>, smem>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t grid = bt * p.d_blocks;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_bwd_kernel<T, G><<<static_cast<unsigned>(grid), kThreads, smem,
                              s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t m = bt * p.L * int64_t(p.N), dn = int64_t(p.D) * p.N;
  const int64_t most = m > dn ? m : dn;
  const int blocks = static_cast<int>(most / 256 + 1 < 1056 ? most / 256 + 1
                                                            : 1056);
  ssm_scan_bwd_sum_kernel<<<blocks, 256, 0, s>>>(
      p.dB_part, p.dC_part, p.dA_part, dB, dC, dA, m, p.d_blocks, dn, bt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int G, Params p, int64_t bt, float* dA, float* dB, float* dC,
             cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, 1>(p, bt, dA, dB, dC, s);
    case 2: return launch<T, 2>(p, bt, dA, dB, dC, s);
    case 4: return launch<T, 4>(p, bt, dA, dB, dC, s);
    case 8: return launch<T, 8>(p, bt, dA, dB, dC, s);
    case 16: return launch<T, 16>(p, bt, dA, dB, dC, s);
    case 32: return launch<T, 32>(p, bt, dA, dB, dC, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* ptr, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// u, delta [Bt, L, D] (u laid out steps first with u_cols: the transpose
// of a contiguous [Bt, D, L], L of 16 bytes' worth), B, C [Bt, L, N] with
// strides (sb, st, 1): all bf16 (bf16 != 0, N even) or all float32; A
// [D, N], dy [Bt, L, D] float32.  G lanes a channel come from the host
// (kernels/ssm_scan.py::bwd_layout).  Scratch: ck, the checkpoints [Bt,
// ceil(L / kCh) kCh / kR, D, kS G]; the partials dA_part [Bt, D, N],
// dB_part and dC_part [D / (kThreads / G), Bt, L, N].
extern "C" int repro_ssm_scan_bwd(
    const void* u, const void* delta, const void* A, const void* Bm,
    const void* Cm, const void* dy, void* ck, void* du, void* ddelta,
    void* dA_part, void* dB_part, void* dC_part, void* dA, void* dB,
    void* dC, int64_t bt, int L, int D, int N, int64_t sb, int64_t st,
    int bf16, int u_cols, int G, void* stream) {
  const int64_t e = bf16 ? 2 : 4;
  if (N < 1 || L < 1 || (bf16 && N % 2) || !aligned(u, 16) ||
      !aligned(delta, 16) || !aligned(dy, 16) || !aligned(Bm, 4) ||
      !aligned(Cm, 4) || (sb * e) % 4 || (st * e) % 4 ||
      (u_cols && (L * e) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.u = u;
  p.dt = delta;
  p.A = static_cast<const float*>(A);
  p.B = Bm;
  p.C = Cm;
  p.dy = static_cast<const float*>(dy);
  p.ck = static_cast<float*>(ck);
  p.du = static_cast<float*>(du);
  p.ddt = static_cast<float*>(ddelta);
  p.dA_part = static_cast<float*>(dA_part);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.sb = sb;
  p.st = st;
  p.bt = bt;
  p.L = L;
  p.D = D;
  p.N = N;
  p.d_blocks = 0;
  p.n_chunks = (L + kCh - 1) / kCh;
  p.passes = 0;
  const int64_t w = int64_t(kS) * G * e;   // bytes of a pass's B row
  p.vec_bc = aligned(Bm, 16) && aligned(Cm, 16) && (sb * e) % 16 == 0 &&
             (st * e) % 16 == 0 && (N * e) % 16 == 0 && w % 16 == 0;
  p.u_cols = u_cols != 0;
  float* fA = static_cast<float*>(dA);
  float* fB = static_cast<float*>(dB);
  float* fC = static_cast<float*>(dC);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(G, p, bt, fA, fB, fC, s)
              : dispatch<float>(G, p, bt, fA, fB, fC, s);
}
