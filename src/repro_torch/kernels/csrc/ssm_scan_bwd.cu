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
//   du_t     = sum_n g_t delta_t B_t                        [b, d]
//   ddelta_t = sum_n g_t (A a_t x_{t-1} + u_t B_t)          [b, d]
//   dA       = sum_{b, t} g_t delta_t a_t x_{t-1}           [d, n]
//
// Inputs, float32 and contiguous: u, delta, dy [Bt, L, D], A [D, N], B, C
// [Bt, L, N].  Outputs: du, ddelta [Bt, L, D]; per-block partials of dB
// and dC [Bt, L, D / channels a block, N] and of dA [Bt, D, N], which the
// wrapper (kernels/ssm_scan.py::ssm_scan_bwd) sums in a fixed order.
//
// What bounds it on this card: two exps per (b, t, d, n) (the forward
// recompute and the reverse walk each take one), or the bytes of u,
// delta, dy, du and ddelta; the partials add 8 bytes a (b, t, n) per block
// of channels.  A simple design that is right first:
//
// - A thread owns one channel d and one state n (G lanes a channel, G the
//   power of two >= N, at most 32; past 32 states the kernel runs passes
//   of 32).  A block of 128 threads takes 128 / G channels of one batch
//   row; the grid is one block per (batch row, channel block).
// - Checkpoints.  A forward walk writes the state before every chunk of
//   kK steps to a global scratch (each thread its own states, read back
//   by the same thread), rounding as the forward kernel and the plain
//   version round (no fused multiply-add in the update).  The reverse
//   walk then takes the chunks last to first: it recomputes the chunk's
//   kK states and decays into registers from its checkpoint and walks
//   them backwards, carrying a_{t+1} g_{t+1}.
// - No float atomics, so a replayed step gives the same bits.  du and
//   ddelta are summed over a channel's G lanes by shuffles and stored by
//   its first lane (a later pass of states adds to what the earlier one
//   stored: the same thread, in order).  dB and dC are summed over a
//   warp's channels by shuffles, kept a chunk at a time in shared memory
//   per warp, and summed over the block's 4 warps in warp order after the
//   chunk; the wrapper sums the blocks' partials with one torch reduction.
//   dA is a thread's own sum over t, written per batch row and summed over
//   the rows by the wrapper.
// - The operands are read through the read-only path (__ldg), so the
//   compiler may issue an unrolled chunk's loads ahead of its stores.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef REPRO_SSM_BWD_STEPS
#define REPRO_SSM_BWD_STEPS 16
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kK = REPRO_SSM_BWD_STEPS;   // steps between checkpoints
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kK >= 1 && kK <= 32, "REPRO_SSM_BWD_STEPS must be 1 .. 32");

struct Params {
  const float* u;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* dy;
  float* ck;        // [Bt, n_chunks, D, N]: the state before each chunk
  float* du;        // [Bt, L, D]
  float* ddt;       // [Bt, L, D]
  float* dA_part;   // [Bt, D, N]
  float* dB_part;   // [Bt, L, d_blocks, N]
  float* dC_part;   // [Bt, L, d_blocks, N]
  int L, D, N;
  int d_blocks;     // D / channels a block
  int n_chunks;     // ceil(L / kK)
  int passes;       // of G states
};

// one step of the forward recurrence, rounded as the plain version rounds
__device__ __forceinline__ float step(float e, float x, float dtu, float b) {
  return __fadd_rn(__fmul_rn(e, x), __fmul_rn(dtu, b));
}

template <int G>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(Params p) {
  constexpr int kCb = kThreads / G;          // channels a block
  __shared__ float s_db[kWarps][kK][G];
  __shared__ float s_dc[kWarps][kK][G];
  const int64_t b = blockIdx.x / p.d_blocks;
  const int blk = static_cast<int>(blockIdx.x % p.d_blocks);
  const int g = threadIdx.x % G;
  const int d = blk * kCb + threadIdx.x / G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool lead = g == 0;                  // stores du and ddelta
  const bool first = lane < G;               // the warp's first channel
  const int64_t L = p.L, D = p.D, N = p.N;

  for (int pass = 0; pass < p.passes; ++pass) {
    const int n = pass * G + g;
    const bool on = n < p.N;
    const float a = on ? __ldg(p.A + d * N + n) : 0.f;

    // forward walk: the state before every chunk
    float x = 0.f;
    for (int c = 0; c < p.n_chunks; ++c) {
      if (on) p.ck[((b * p.n_chunks + c) * D + d) * N + n] = x;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int64_t t = int64_t(c) * kK + j;
        if (t < L) {
          const int64_t o = (b * L + t) * D + d;
          const float dtv = __ldg(p.dt + o);
          const float bv = on ? __ldg(p.B + (b * L + t) * N + n) : 0.f;
          x = step(expf(dtv * a), x, __fmul_rn(dtv, __ldg(p.u + o)), bv);
        }
      }
    }

    // reverse walk, chunk by chunk
    float carry = 0.f;   // a_{t+1} g_{t+1}
    float dA = 0.f;
    for (int c = p.n_chunks - 1; c >= 0; --c) {
      const float x0 = on ? p.ck[((b * p.n_chunks + c) * D + d) * N + n] : 0.f;
      float xs[kK], es[kK];
      float xp = x0;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int64_t t = int64_t(c) * kK + j;
        if (t < L) {
          const int64_t o = (b * L + t) * D + d;
          const float dtv = __ldg(p.dt + o);
          const float bv = on ? __ldg(p.B + (b * L + t) * N + n) : 0.f;
          es[j] = expf(dtv * a);
          xp = step(es[j], xp, __fmul_rn(dtv, __ldg(p.u + o)), bv);
        } else {
          es[j] = 0.f;
        }
        xs[j] = xp;
      }
#pragma unroll
      for (int j = kK - 1; j >= 0; --j) {
        const int64_t t = int64_t(c) * kK + j;
        const bool valid = t < L;   // the same for the whole block
        float dyv = 0.f, dtv = 0.f, uv = 0.f, bv = 0.f, cv = 0.f;
        if (valid) {
          const int64_t o = (b * L + t) * D + d;
          dyv = __ldg(p.dy + o);
          dtv = __ldg(p.dt + o);
          uv = __ldg(p.u + o);
          if (on) {
            bv = __ldg(p.B + (b * L + t) * N + n);
            cv = __ldg(p.C + (b * L + t) * N + n);
          }
        }
        const float xprev = j > 0 ? xs[j - 1] : x0;
        const float gg = dyv * cv + carry;
        const float ax = a * es[j] * xprev;
        float v_du = gg * (dtv * bv);
        float v_ddt = gg * (ax + uv * bv);
        float v_dc = dyv * xs[j];
        float v_db = gg * (dtv * uv);
        dA += gg * dtv * es[j] * xprev;
        carry = es[j] * gg;
        // du, ddelta: over the channel's G lanes
#pragma unroll
        for (int m = 1; m < G; m <<= 1) {
          v_du += __shfl_xor_sync(kFull, v_du, m);
          v_ddt += __shfl_xor_sync(kFull, v_ddt, m);
        }
        // dB, dC: over the warp's channels
#pragma unroll
        for (int m = G; m < 32; m <<= 1) {
          v_db += __shfl_xor_sync(kFull, v_db, m);
          v_dc += __shfl_xor_sync(kFull, v_dc, m);
        }
        if (valid) {
          if (lead) {
            const int64_t o = (b * L + t) * D + d;
            if (pass == 0) {
              p.du[o] = v_du;
              p.ddt[o] = v_ddt;
            } else {
              p.du[o] += v_du;
              p.ddt[o] += v_ddt;
            }
          }
          if (first) {
            s_db[warp][j][g] = v_db;
            s_dc[warp][j][g] = v_dc;
          }
        }
      }
      __syncthreads();
      // the block's partial: the warps summed in order
      for (int i = threadIdx.x; i < kK * G; i += kThreads) {
        const int j = i / G, gi = i % G;
        const int64_t t = int64_t(c) * kK + j;
        const int ni = pass * G + gi;
        if (t < L && ni < p.N) {
          float sb = 0.f, sc = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            sb += s_db[w][j][gi];
            sc += s_dc[w][j][gi];
          }
          const int64_t o = ((b * L + t) * p.d_blocks + blk) * N + ni;
          p.dB_part[o] = sb;
          p.dC_part[o] = sc;
        }
      }
      __syncthreads();   // the next chunk rewrites the shared sums
    }
    if (on) p.dA_part[(b * D + d) * N + n] = dA;
  }
}

template <int G>
int launch(Params p, int64_t bt, cudaStream_t s) {
  constexpr int kCb = kThreads / G;
  if (p.D % kCb) return static_cast<int>(cudaErrorInvalidValue);
  p.d_blocks = p.D / kCb;
  p.passes = (p.N + G - 1) / G;
  const int64_t blocks = bt * p.d_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_bwd_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G: lanes a channel over its states (a power of two, at most 32); the
// host chooses it (kernels/ssm_scan.py::bwd_layout) and sizes the
// partials with D / (128 / G) channel blocks and ceil(L / kK) checkpoints.
extern "C" int repro_ssm_scan_bwd(const void* u, const void* delta,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* dy, void* ck,
                                  void* du, void* ddelta, void* dA_part,
                                  void* dB_part, void* dC_part, int64_t bt,
                                  int L, int D, int N, int G, void* stream) {
  if (N < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.u = static_cast<const float*>(u);
  p.dt = static_cast<const float*>(delta);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(Bm);
  p.C = static_cast<const float*>(Cm);
  p.dy = static_cast<const float*>(dy);
  p.ck = static_cast<float*>(ck);
  p.du = static_cast<float*>(du);
  p.ddt = static_cast<float*>(ddelta);
  p.dA_part = static_cast<float*>(dA_part);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.L = L;
  p.D = D;
  p.N = N;
  p.d_blocks = 0;
  p.n_chunks = (L + kK - 1) / kK;
  p.passes = 0;
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
