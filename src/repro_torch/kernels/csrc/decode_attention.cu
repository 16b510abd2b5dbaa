// Flash-decode for sm_90a, plain C interface: one query token against a KV cache.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_bhd` of
// src/repro/kernels/decode_attention.py.  Same function: softmax(softcap(
// q·scale @ kᵀ) under a per-slot `valid` mask) @ v, grouped-query heads reading
// their KV head as h / (H/KV), f32 inside, rows with no valid slot giving 0.
// The mask covers full caches (slots <= pos) and ring buffers alike; the caller
// computes it.
//
// Bound on an H100: bytes.  Every valid K and V row is read once, and at a batch
// of a few slots that is all the work there is.  So the design is about keeping
// the whole card loading:
//   * the cache length L is SPLIT across blocks (grid: split x (kv head, head
//     group) x batch), since batch x kv heads alone would fill a small part of
//     the 132 SMs.  Each block reduces its chunk to a partial (m, l, acc) per
//     query head, and a second small kernel merges the partials (blocks run in
//     no order, so nothing can be carried from one chunk to the next as the TPU
//     kernel's sequential grid did);
//   * one block serves all query heads of its KV head (up to 4 at a time) from
//     ONE pass over K/V;
//   * a warp takes 16 consecutive keys at a time and requests ALL their K and V
//     rows at once with 16-byte asynchronous copies into shared memory
//     (cp.async, lanes on neighbouring addresses), so a step costs one trip to
//     memory, not one per row, and up to 64 KB per block are in flight;
//   * the score of key j ends up in lane j, so softcap, max, exp and sum are
//     computed once per key (one key per lane), not once per lane;
//   * keys whose `valid` byte is 0 are not loaded at all, so a cache that is
//     mostly empty costs what its filled part costs.
// K/V are read through their strides: the (B,L,KV,Dh) cache layout of the model
// needs no transpose.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MERGE_THREADS = 128;

struct Params {
  const void* q;            // (B, H, Dh) through strides
  const void* k;            // (B, L, KV, Dh) through strides
  const void* v;
  const unsigned char* valid;   // (B, L) bytes, non-zero = attend
  void* o;                  // (B, H, Dh) through strides
  float* part_acc;          // (B, H, NS, Dh)
  float* part_m;            // (B, H, NS)
  float* part_l;            // (B, H, NS)
  int B, H, KV, L, chunk, NS;
  long long q_sb, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long valid_sb, valid_sl;
  long long o_sb, o_sh;
  float softcap;            // 0: none
  float scale;
};

// 16 bytes global -> shared without passing through registers (L2 only).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Keys a warp stages per step: its K and V rows fill 16 KB of shared memory.
template <typename T, int DH>
__host__ __device__ constexpr int keys_per_step() { return DH * (int)sizeof(T) > 512 ? 8 : 16; }

template <typename T, int DH>
__host__ __device__ constexpr int split_smem_bytes() {
  return WARPS * 2 * keys_per_step<T, DH>() * DH * (int)sizeof(T);
}

template <typename T, int DH, int GT>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(const Params p) {
  constexpr int EPL = DH >= 32 ? DH / 32 : 1;   // contiguous elements per lane
  constexpr int LANES = DH >= 32 ? 32 : DH;     // lanes that hold data
  constexpr int KS = keys_per_step<T, DH>();
  constexpr int VEC = 16 / (int)sizeof(T);      // elements per 16-byte copy
  constexpr int CPR = DH / VEC;                 // such copies per row
  // per warp: KS rows of K, then KS rows of V, as they lie in the cache; after
  // the loop the same memory holds the warps' partial accumulators
  extern __shared__ uint4 smem16[];
  static_assert(WARPS * GT * DH * (int)sizeof(float) <= split_smem_bytes<T, DH>(),
                "the merge scratch must fit the staging buffers");
  __shared__ float sm_m[WARPS][GT];
  __shared__ float sm_l[WARPS][GT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.H / p.KV;
  const int ngrp = (G + GT - 1) / GT;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / ngrp, grp = blockIdx.y % ngrp;
  const int b = blockIdx.z;
  const int g0 = grp * GT;
  const int ng = min(GT, G - g0);
  const int h0 = kvh * G + g0;
  const int l0 = split * p.chunk;
  const int l1 = min(p.L, l0 + p.chunk);

  const bool active = lane < LANES;
  const int d0 = lane * EPL;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const unsigned char* valid = p.valid + b * p.valid_sb;
  T* sk = reinterpret_cast<T*>(smem16) + warp * 2 * KS * DH;   // [KS][DH]
  T* sv = sk + KS * DH;                                        // [KS][DH]

  float qr[GT][EPL], acc[GT][EPL], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { qr[g][e] = 0.f; acc[g][e] = 0.f; }
    if (g < ng && active) {
      const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + (h0 + g) * p.q_sh + d0;
      load_f32<T, EPL>(qg, qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= p.scale;
    }
  }

  // The block's keys are dealt to its warps KS at a time; lane j answers for
  // key j of the step.
  for (int seg = l0 + warp * KS; seg < l1; seg += WARPS * KS) {
    const int key = seg + lane;
    const bool okl = lane < KS && key < l1 && valid[(long long)key * p.valid_sl] != 0;
    const unsigned mask = __ballot_sync(FULL_MASK, okl);
    if (mask == 0) continue;   // warp-uniform: none of these rows is loaded

    // every valid K and V row of the step is requested at once
    for (int c = lane; c < KS * CPR; c += 32) {
      const int j = c / CPR, d = (c % CPR) * VEC;
      if ((mask >> j) & 1u) {
        cp_async16(sk + j * DH + d, kg + (long long)(seg + j) * p.k_sl + d);
        cp_async16(sv + j * DH + d, vg + (long long)(seg + j) * p.v_sl + d);
      }
    }
    cp_async_wait_all();
    __syncwarp();

    // scores: the lanes split Dh; the sum of key j is kept by lane j
    float sc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) sc[g] = NEG_INF;
#pragma unroll 4
    for (int j = 0; j < KS; ++j) {
      if (!((mask >> j) & 1u)) continue;
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = 0.f;
      if (active) load_f32<T, EPL>(sk + j * DH + d0, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g >= ng) continue;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kf[e], part);
        const float sum = warp_sum(part);
        if (lane == j) sc[g] = sum;
      }
    }

    // online softmax, one key per lane: softcap and exp are computed once
    float pr[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      pr[g] = 0.f;
      if (g >= ng) continue;
      float s = sc[g];
      if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
      s = okl ? s : NEG_INF;
      const float mx = fmaxf(m[g], warp_max(s));
      const float alpha = expf(m[g] - mx);
      pr[g] = okl ? expf(s - mx) : 0.f;
      l[g] = l[g] * alpha + warp_sum(pr[g]);
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }

    // PV: p of key j is broadcast from lane j
#pragma unroll 4
    for (int j = 0; j < KS; ++j) {
      if (!((mask >> j) & 1u)) continue;
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = 0.f;
      if (active) load_f32<T, EPL>(sv + j * DH + d0, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g >= ng) continue;
        const float pj = __shfl_sync(FULL_MASK, pr[g], j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
      }
    }
    __syncwarp();   // all lanes are done with the rows before the next copies
  }

  // merge the block's warps, write one partial per (query head, split)
  __syncthreads();   // the staging buffers are free: reuse them
  float* sm_acc = reinterpret_cast<float*>(smem16);   // [WARPS][GT][DH]
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
    if (active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[(warp * GT + g) * DH + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < ng * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float mx = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wgt = expf(sm_m[w][g] - mx);
      num = fmaf(wgt, sm_acc[(w * GT + g) * DH + d], num);
      den = fmaf(wgt, sm_l[w][g], den);
    }
    const long long row = ((long long)b * p.H + h0 + g) * p.NS + split;
    p.part_acc[row * DH + d] = num;
    if (d == 0) { p.part_m[row] = mx; p.part_l[row] = den; }
  }
}

// One block per (head, batch): out = Σ_s w_s·acc_s / Σ_s w_s·l_s, w_s = exp(m_s - max m).
template <typename T, int DH>
__global__ void __launch_bounds__(MERGE_THREADS) decode_merge_kernel(const Params p) {
  extern __shared__ float wgt[];   // [NS]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long row0 = ((long long)b * p.H + h) * p.NS;
  float mx = NEG_INF;
  for (int s = 0; s < p.NS; ++s) mx = fmaxf(mx, p.part_m[row0 + s]);
  for (int s = tid; s < p.NS; s += MERGE_THREADS) wgt[s] = expf(p.part_m[row0 + s] - mx);
  __syncthreads();
  float den = 0.f;
  for (int s = 0; s < p.NS; ++s) den = fmaf(wgt[s], p.part_l[row0 + s], den);
  const float safe = den > 0.f ? den : 1.f;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int d = tid; d < DH; d += MERGE_THREADS) {
    float num = 0.f;
    for (int s = 0; s < p.NS; ++s) num = fmaf(wgt[s], p.part_acc[(row0 + s) * DH + d], num);
    from_f32(og + d, num / safe);
  }
}

template <typename T, int DH, int GT>
cudaError_t launch_split(const Params& p, dim3 grid, cudaStream_t stream) {
  auto kern = decode_split_kernel<T, DH, GT>;
  constexpr int smem = split_smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int G = p.H / p.KV;
  // GT query heads of a KV head share a block (and its pass over K/V)
  const int gt = G >= 4 ? 4 : (G >= 2 ? 2 : 1);
  const dim3 grid(p.NS, p.KV * ((G + gt - 1) / gt), p.B);
  cudaError_t err;
  if (gt == 4) err = launch_split<T, DH, 4>(p, grid, stream);
  else if (gt == 2) err = launch_split<T, DH, 2>(p, grid, stream);
  else err = launch_split<T, DH, 1>(p, grid, stream);
  if (err != cudaSuccess) return err;
  const dim3 mgrid(p.H, p.B);
  decode_merge_kernel<T, DH><<<mgrid, MERGE_THREADS, sizeof(float) * p.NS, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return (int)launch<T, 16>(p, stream);
    case 32: return (int)launch<T, 32>(p, stream);
    case 64: return (int)launch<T, 64>(p, stream);
    case 128: return (int)launch<T, 128>(p, stream);
    case 256: return (int)launch<T, 256>(p, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `chunk` keys per split, NS = ceil(L/chunk)
// splits; part_* are f32 scratch of (B,H,NS,Dh), (B,H,NS), (B,H,NS).  Returns 0,
// a cudaError_t, or -1 for a head_dim / dtype the kernel was not built for.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part_acc, void* part_m, void* part_l, int dtype,
    int B, int H, int KV, int L, int Dh, int chunk, int NS,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long valid_sb, long long valid_sl,
    long long o_sb, long long o_sh,
    float softcap, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.valid = static_cast<const unsigned char*>(valid);
  p.o = o;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.B = B; p.H = H; p.KV = KV; p.L = L; p.chunk = chunk; p.NS = NS;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.valid_sb = valid_sb; p.valid_sl = valid_sl;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, Dh, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, Dh, st);
  return -1;
}

extern "C" const char* repro_decode_attention_error(int code) {
  if (code == -1) return "unsupported head_dim or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
