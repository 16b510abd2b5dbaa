// RG-LRU linear recurrence for sm_90a, plain C interface.
//
// Replaces the TPU kernel `_rg_lru_kernel` / `rg_lru_bsw` of
// src/repro/kernels/rg_lru.py.  Same function: h_t = a_t * h_{t-1} + x_t over
// (B, S, W) f32, h_{-1} = 0, the whole trajectory h written out (the caller
// folds an initial state into x[:, 0]).
//
// Bound on an H100: bytes (a and x read once, h written once: 12 bytes per
// element for 2 FLOP).  The recurrence is sequential in S and independent per
// (batch, channel), so one thread per channel walking all of S would leave the
// card with B*W threads (2,560 at B=1 on recurrentgemma-2b), each a chain of S
// dependent steps with a memory round trip every few steps.  So S is split
// into SEGS segments inside a block, one warp per segment, lane = channel
// (neighbouring lanes read neighbouring addresses of a time row):
//   1. each warp scans its segment from h = 0 and keeps the segment's end value
//      and the product of its a's;
//   2. warp 0 chains the SEGS segments per channel: the state entering segment
//      s is prod_{s-1} * carry_{s-1} + end_{s-1};
//   3. each warp scans its segment again from that carry and writes h.
// a and x are read twice (the second pass mostly misses the 50 MB L2 at the
// path's sizes), h once: 5/3 of the byte bound at most.  Each step loads U
// time rows before it uses them, so U loads per thread are in flight.  Any S
// and any W: the ragged channel tile is masked, short segments are padded with
// a = 1, x = 0 (which leave h and the product unchanged).
#include "common.cuh"

namespace {

constexpr int CH = 32;              // channels per block, one per lane
constexpr int SEGS = 32;            // segments of S per block, one per warp
constexpr int THREADS = CH * SEGS;
constexpr int U = 8;                // time steps loaded ahead

struct Params {
  const float* a;
  const float* x;
  float* h;
  int S, W;
  long long a_sb, a_ss, x_sb, x_ss, h_sb, h_ss;   // strides in elements; W has stride 1
};

// Loads U time rows of a and x starting at t (padding past `end`).
__device__ __forceinline__ void load_rows(const Params& p, const float* ap,
                                          const float* xp, int t, int end,
                                          float (&av)[U], float (&xv)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = t + u < end;
    av[u] = in ? __ldg(ap + (long long)(t + u) * p.a_ss) : 1.f;
    xv[u] = in ? __ldg(xp + (long long)(t + u) * p.x_ss) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) rg_lru_kernel(const Params p) {
  __shared__ float s_prod[SEGS][CH];
  __shared__ float s_carry[SEGS][CH];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int w = blockIdx.x * CH + lane;
  const int b = blockIdx.y;
  const int len = (p.S + SEGS - 1) / SEGS;
  const int t0 = min(p.S, seg * len), t1 = min(p.S, t0 + len);
  const bool live = w < p.W;
  const float* ap = p.a + b * p.a_sb + w;
  const float* xp = p.x + b * p.x_sb + w;

  float prod = 1.f, h = 0.f;
  if (live) {
    for (int t = t0; t < t1; t += U) {
      float av[U], xv[U];
      load_rows(p, ap, xp, t, t1, av, xv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        h = fmaf(av[u], h, xv[u]);
        prod *= av[u];
      }
    }
  }
  s_prod[seg][lane] = prod;
  s_carry[seg][lane] = h;
  __syncthreads();
  if (seg == 0) {            // the state entering each segment, in order
    float carry = 0.f;
    for (int s = 0; s < SEGS; ++s) {
      const float end = s_carry[s][lane];
      s_carry[s][lane] = carry;
      carry = fmaf(s_prod[s][lane], carry, end);
    }
  }
  __syncthreads();
  if (!live) return;

  h = s_carry[seg][lane];
  float* hp = p.h + b * p.h_sb + w;
  for (int t = t0; t < t1; t += U) {
    float av[U], xv[U];
    load_rows(p, ap, xp, t, t1, av, xv);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = fmaf(av[u], h, xv[u]);
      if (t + u < t1) hp[(long long)(t + u) * p.h_ss] = h;
    }
  }
}

}  // namespace

// a, x, h: (B, S, W) f32 through strides (the last dim contiguous).  Returns 0
// or a cudaError_t.
extern "C" int repro_rg_lru(const void* a, const void* x, void* h,
                            int B, int S, int W,
                            long long a_sb, long long a_ss,
                            long long x_sb, long long x_ss,
                            long long h_sb, long long h_ss, void* stream) {
  Params p;
  p.a = static_cast<const float*>(a);
  p.x = static_cast<const float*>(x);
  p.h = static_cast<float*>(h);
  p.S = S; p.W = W;
  p.a_sb = a_sb; p.a_ss = a_ss; p.x_sb = x_sb; p.x_ss = x_ss;
  p.h_sb = h_sb; p.h_ss = h_ss;
  const dim3 grid((W + CH - 1) / CH, B);
  rg_lru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_rg_lru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
