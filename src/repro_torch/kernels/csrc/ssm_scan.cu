// Selective state-space scan (mamba1), forward, on Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan_chunked (Pallas, TPU):
//   x_t = exp(delta_t * A) * x_{t-1} + (delta_t * u_t) * B_t
//   y_t = sum_n C_t[n] * x_t[:, n]
// Inputs, float32 and contiguous: u, delta [Bt, L, D], A [D, N], B, C
// [Bt, L, N].  Outputs: y [Bt, L, D] and the final state [Bt, D, N].
//
// The TPU kernel keeps a (128 channels, N) state tile in VMEM and walks the
// chunks of L along its sequential grid axis.  Here one thread holds one
// state element x[b, d, n] in a register for the whole sequence: a group of
// G lanes (N rounded up to a power of two, at most a warp) carries one
// channel d, and its lanes reduce y_t with __shfl_xor_sync.  A block of
// 256 threads takes 256 / G channels of one batch row and walks L in stages
// of up to 32 steps: each stage's u and delta for its channels, and B_t and
// C_t, are staged in shared memory with coalesced loads, and the stage's
// y is written back from shared memory the same way.  Lanes past N carry
// A = B = C = 0, so their x stays 0 and adds nothing to y.
//
// Bound: memory, 12 bytes per (t, d) for u, delta and y (B, C, A and the
// state are small at mamba widths), against the card's exp rate: one expf
// per (t, d, n).  expf, not __expf: the fast intrinsic would give up the
// tolerance the plain version is held to.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ state, int L, int D, int N) {
  constexpr int DB = kThreads / G;                         // channels a block
  constexpr int STAGE = 2048 / DB < 32 ? 2048 / DB : 32;   // steps a stage
  __shared__ float s_u[STAGE][DB], s_dt[STAGE][DB], s_y[STAGE][DB];
  __shared__ float s_b[STAGE][G], s_c[STAGE][G];

  const int64_t b = blockIdx.y;
  const int d0 = blockIdx.x * DB;
  const int dl = threadIdx.x / G;
  const int n = threadIdx.x % G;
  const int d = d0 + dl;
  const bool active = d < D && n < N;
  const float a = active ? A[int64_t(d) * N + n] : 0.f;
  float x = 0.f;

  for (int t0 = 0; t0 < L; t0 += STAGE) {
    const int steps = L - t0 < STAGE ? L - t0 : STAGE;
    for (int i = threadIdx.x; i < steps * DB; i += kThreads) {
      const int t = i / DB, j = i % DB;
      const int64_t off = (b * L + t0 + t) * D + d0 + j;
      const bool in = d0 + j < D;
      s_u[t][j] = in ? u[off] : 0.f;
      s_dt[t][j] = in ? delta[off] : 0.f;
    }
    for (int i = threadIdx.x; i < steps * G; i += kThreads) {
      const int t = i / G, j = i % G;
      const int64_t off = (b * L + t0 + t) * N + j;
      s_b[t][j] = j < N ? Bm[off] : 0.f;
      s_c[t][j] = j < N ? Cm[off] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dt = s_dt[t][dl];
      x = expf(dt * a) * x + (dt * s_u[t][dl]) * s_b[t][n];
      float p = x * s_c[t][n];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xFFFFFFFFu, p, off);
      if (n == 0) s_y[t][dl] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * DB; i += kThreads) {
      const int t = i / DB, j = i % DB;
      if (d0 + j < D) y[(b * L + t0 + t) * D + d0 + j] = s_y[t][j];
    }
  }
  if (active) state[(b * D + d) * N + n] = x;
}

template <int G>
int launch(const float* u, const float* delta, const float* A, const float* Bm,
           const float* Cm, float* y, float* state, int64_t bt, int L, int D,
           int N, cudaStream_t stream) {
  constexpr int DB = kThreads / G;
  const dim3 grid(static_cast<unsigned>((D + DB - 1) / DB),
                  static_cast<unsigned>(bt));
  ssm_scan_kernel<G><<<grid, kThreads, 0, stream>>>(u, delta, A, Bm, Cm, y,
                                                    state, L, D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssm_scan(const void* u, const void* delta, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, int64_t bt, int L, int D, int N,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pu = static_cast<const float*>(u);
  const auto* pd = static_cast<const float*>(delta);
  const auto* pa = static_cast<const float*>(A);
  const auto* pb = static_cast<const float*>(Bm);
  const auto* pc = static_cast<const float*>(Cm);
  auto* py = static_cast<float*>(y);
  auto* ps = static_cast<float*>(state);
  if (N <= 1) return launch<1>(pu, pd, pa, pb, pc, py, ps, bt, L, D, N, s);
  if (N <= 2) return launch<2>(pu, pd, pa, pb, pc, py, ps, bt, L, D, N, s);
  if (N <= 4) return launch<4>(pu, pd, pa, pb, pc, py, ps, bt, L, D, N, s);
  if (N <= 8) return launch<8>(pu, pd, pa, pb, pc, py, ps, bt, L, D, N, s);
  if (N <= 16) return launch<16>(pu, pd, pa, pb, pc, py, ps, bt, L, D, N, s);
  if (N <= 32) return launch<32>(pu, pd, pa, pb, pc, py, ps, bt, L, D, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
