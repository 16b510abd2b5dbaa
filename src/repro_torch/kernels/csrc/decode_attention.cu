// Flash-decode for sm_90a, plain C interface: one query token against a KV cache.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_bhd` of
// src/repro/kernels/decode_attention.py.  Same function: softmax(softcap(
// q·scale @ kᵀ) under a per-slot `valid` mask) @ v, grouped-query heads reading
// their KV head as h / (H/KV), f32 softmax state, rows with no valid slot
// giving 0.  The mask covers full caches (slots <= pos) and ring buffers alike;
// the caller computes it.
//
// Bound on an H100: bytes.  Every valid K and V row is read once, and at a batch
// of a few slots that is all the work there is.  So the design is about reading
// each row once and keeping the whole card loading:
//   * ONE block serves ALL G <= 16 query heads of its KV head, so K/V are read in
//     one pass whatever the grouping (recurrentgemma-2b: 10 heads on 1 KV head);
//   * the cache length L is SPLIT across blocks (grid: split x kv head x batch),
//     since batch x kv heads alone would fill a small part of the 132 SMs.  Each
//     block reduces its chunk to a partial (m, l, acc) per query head; the LAST
//     block of a (batch, kv head) to finish, found by an atomic counter after a
//     `__threadfence`, merges the partials into the output and resets its
//     counter to 0.  One launch per call (blocks run in no order, so nothing can
//     be carried from chunk to chunk as the TPU kernel's sequential grid did);
//   * a warp takes 16 consecutive keys at a time and requests ALL their valid K
//     and V rows at once with 16-byte asynchronous copies into shared memory
//     (cp.async, lanes on neighbouring addresses), so a step costs one trip to
//     memory, not one per row; keys whose `valid` byte is 0 are not loaded at
//     all (their rows are zero-filled in shared memory), so a cache that is
//     mostly empty costs what its filled part costs;
//   * bf16: the group's queries are the 16 rows (zero-padded) of an m16n8k16
//     tensor-core tile; q·kᵀ over the 16 staged keys and p·v run as `mma.sync`
//     with f32 accumulators, the online softmax on the fragments (the same
//     fragment code as the flash-attention kernel).  f32: the group's (scaled)
//     queries sit in shared memory, lanes split Dh, the score of key j ends up in
//     lane j; f32 FMAs on the CUDA cores, which hold 2e-5.
// K/V are read through their strides: the (B,L,KV,Dh) cache layout of the model
// needs no transpose.  The counters are (B·KV) ints that the caller zeroes once;
// two calls must not run concurrently on one counter buffer.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GROUP = 16;   // query heads per KV head a block serves

struct Params {
  const void* q;            // (B, H, Dh) through strides
  const void* k;            // (B, L, KV, Dh) through strides
  const void* v;
  const unsigned char* valid;   // (B, L) bytes, non-zero = attend
  void* o;                  // (B, H, Dh) through strides
  float* part_acc;          // (B, H, NS, Dh)
  float* part_m;            // (B, H, NS)
  float* part_l;            // (B, H, NS)
  int* counters;            // (B, KV), zero between calls
  int B, H, KV, L, chunk, NS;
  long long q_sb, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long valid_sb, valid_sl;
  long long o_sb, o_sh;
  float softcap;            // 0: none
  float scale;
};

// After the warps' states (m, l, acc for R rows each; m in log2 units if LOG2)
// are in shared memory: merge them into this block's partial for each of its
// ng query heads (partials in natural units); then the last block of the
// (batch, kv head) merges all NS partials into the output.
constexpr int MERGE_S = 32;   // splits whose weights the last block holds at once

template <typename T, int DH, int R, bool LOG2>
__device__ __forceinline__ void finish(const Params& p, const float* sm_acc,
                                       const float* sm_m, const float* sm_l,
                                       int b, int kvh, int split) {
  __shared__ int last;
  __shared__ float wgt[MERGE_S][MAX_GROUP];   // by warp here, by split below
  __shared__ float head_m[MAX_GROUP], head_den[MAX_GROUP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = p.H / p.KV, h0 = kvh * ng;
  constexpr float UNIT = LOG2 ? 1.f / LOG2E : 1.f;   // m back to natural units

  if (tid < ng) {   // one thread per head: the warps' weights and the sums
    const int g = tid;
    float mx = sm_m[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * R + g]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float x = sm_m[w * R + g] - mx;
      wgt[w][g] = LOG2 ? exp2f(x) : expf(x);
      den = fmaf(wgt[w][g], sm_l[w * R + g], den);
    }
    const long long row = ((long long)b * p.H + h0 + g) * p.NS + split;
    p.part_m[row] = mx == NEG_INF ? NEG_INF : mx * UNIT;
    p.part_l[row] = den;
  }
  __syncthreads();
  for (int idx = tid; idx < ng * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) num = fmaf(wgt[w][g], sm_acc[(w * R + g) * DH + d], num);
    p.part_acc[(((long long)b * p.H + h0 + g) * p.NS + split) * DH + d] = num;
  }
  __threadfence();   // this block's partials are visible before it is counted
  __syncthreads();
  int* counter = p.counters + b * p.KV + kvh;
  if (tid == 0) last = atomicAdd(counter, 1) == p.NS - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // out = Σ_s w_s·acc_s / Σ_s w_s·l_s, w_s = exp(m_s - max m).  A warp per head
  // for the max and the denominator; then each thread owns 4 consecutive
  // output dims of a head and streams the splits' rows with 16-byte loads,
  // PER rows' loads in flight.  Reads go to L2 (__ldcg): other blocks wrote them.
  for (int g = warp; g < ng; g += WARPS) {
    const long long row0 = ((long long)b * p.H + h0 + g) * p.NS;
    float mx = NEG_INF;
    for (int s = lane; s < p.NS; s += 32) mx = fmaxf(mx, __ldcg(p.part_m + row0 + s));
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < p.NS; s += 32)
      den = fmaf(expf(__ldcg(p.part_m + row0 + s) - mx), __ldcg(p.part_l + row0 + s), den);
    den = warp_sum(den);
    if (lane == 0) { head_m[g] = mx; head_den[g] = den > 0.f ? den : 1.f; }
  }
  constexpr int V4 = DH / 4;                          // 16-byte pieces of a row
  constexpr int PER = (R * V4 + THREADS - 1) / THREADS;
  float4 num[PER];
  const float4* src[PER];
  int gk[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = min(tid + k * THREADS, ng * V4 - 1);   // a spare slot repeats the last
    gk[k] = idx / V4;
    src[k] = reinterpret_cast<const float4*>(
        p.part_acc + ((long long)b * p.H + h0 + gk[k]) * p.NS * DH) + idx % V4;
    num[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s0 = 0; s0 < p.NS; s0 += MERGE_S) {
    const int n = min(MERGE_S, p.NS - s0);
    __syncthreads();   // head_m is ready / the last piece's weights are used
    for (int i = tid; i < ng * MERGE_S; i += THREADS) {
      const int g = i / MERGE_S, s = i % MERGE_S;
      const long long row = ((long long)b * p.H + h0 + g) * p.NS + s0 + s;
      wgt[s][g] = s < n ? expf(__ldcg(p.part_m + row) - head_m[g]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const float w = wgt[s][gk[k]];
        const float4 x = __ldcg(src[k] + (long long)(s0 + s) * V4);
        num[k].x = fmaf(w, x.x, num[k].x);
        num[k].y = fmaf(w, x.y, num[k].y);
        num[k].z = fmaf(w, x.z, num[k].z);
        num[k].w = fmaf(w, x.w, num[k].w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * THREADS;
    if (idx >= ng * V4) continue;
    const int g = idx / V4, d = (idx % V4) * 4;
    const float inv = __fdividef(1.f, head_den[g]);
    T* og = static_cast<T*>(p.o) + b * p.o_sb + (h0 + g) * p.o_sh + d;
    from_f32(og, num[k].x * inv);
    from_f32(og + 1, num[k].y * inv);
    from_f32(og + 2, num[k].z * inv);
    from_f32(og + 3, num[k].w * inv);
  }
  if (tid == 0) *counter = 0;   // ready for the next call
}

// ------------------------------------------------------------ bf16, tensor cores

constexpr int MMA_KS = 16;   // keys a warp stages per step: one k-step of P·V

template <int DH>
constexpr int mma_smem_bytes() {   // q tile, then per warp KS rows of K and of V
  return 2 * (DH + 8) * (16 + WARPS * 2 * MMA_KS);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) decode_mma_kernel(const Params p) {
  using T = __nv_bfloat16;
  constexpr int LD = DH + 8;     // row stride in elements: no ldmatrix bank conflicts
  constexpr int CPR = DH / 8;    // 16-byte chunks per row
  constexpr int DT = DH / 8;     // 8-wide n-tiles of the output
  static_assert(WARPS * 16 * DH * 4 <= WARPS * 2 * MMA_KS * LD * 2,
                "the warps' states must fit the staging buffers");
  extern __shared__ uint4 smem16[];
  __shared__ float sm_m[WARPS * 16], sm_l[WARPS * 16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* sq = reinterpret_cast<T*>(smem16);          // [16][LD]
  T* stage = sq + 16 * LD;
  T* sk = stage + warp * 2 * MMA_KS * LD;        // [KS][LD]
  T* sv = sk + MMA_KS * LD;                      // [KS][LD]

  const int G = p.H / p.KV;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int l0 = split * p.chunk;
  const int l1 = min(p.L, l0 + p.chunk);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + kvh * G * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const unsigned char* valid = p.valid + b * p.valid_sb;

  // The block's keys are dealt to its warps KS at a time: a warp's steps are
  // seg = l0 + warp·KS + i·WARPS·KS; a step with no valid key is skipped
  // (warp-uniform).  `mask` bit j: key seg + j is valid.
  auto step_mask = [&](int seg) -> unsigned {
    const int key = seg + lane;
    return __ballot_sync(FULL_MASK, lane < MMA_KS && key < l1 &&
                                        valid[(long long)key * p.valid_sl] != 0);
  };
  auto next_step = [&](int seg, unsigned& mask) -> int {   // l1: none left
    for (; seg < l1; seg += WARPS * MMA_KS)
      if ((mask = step_mask(seg)) != 0) return seg;
    return l1;
  };
  // request the valid rows of a step (one commit group); the others are
  // zero-filled without a read
  auto request = [&](T* dst, const T* src, long long stride, int seg, unsigned mask) {
    for (int c = lane; c < MMA_KS * CPR; c += 32) {
      const int j = c / CPR, d = (c % CPR) * 8;
      const bool ok = (mask >> j) & 1u;
      cp_async16(dst + j * LD + d, src + (ok ? (long long)(seg + j) : 0) * stride + d, ok);
    }
    cp_async_commit();
  };
  unsigned mask = 0;
  int seg = next_step(l0 + warp * MMA_KS, mask);
  if (seg < l1) {   // the first step's rows travel while q is staged
    request(sk, kg, p.k_sl, seg, mask);
    request(sv, vg, p.v_sl, seg, mask);
  }

  for (int c = tid; c < 16 * CPR; c += THREADS) {   // the group's q; rows past G zero
    const int r = c / CPR, d = (c % CPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < G) val = *reinterpret_cast<const uint4*>(qg + r * p.q_sh + d);
    *reinterpret_cast<uint4*>(sq + r * LD + d) = val;
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // rows g, g+8; l: this lane's share; scores in log2 units (softmax by exp2)
  float m0 = NEG_INF, m1 = NEG_INF, l0s = 0.f, l1s = 0.f;
  const float qk_scale = p.softcap > 0.f ? __fdividef(p.scale, p.softcap) : p.scale * LOG2E;
  const float cap_scale = p.softcap * LOG2E;
  const unsigned q_addr = smem_addr(sq + (lane & 15) * LD + (lane >> 4) * 8);
  const unsigned kb = smem_addr(sk + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  const unsigned vb = smem_addr(sv + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8);

  // A pipeline of one step per warp: the next step's K rows load during this
  // step's softmax and P·V, its V rows during its own q·kᵀ.  Commit groups, in
  // order: K, V of the first step, then per step the next K, the next V
  // (empty groups where there is no next step), so waiting until one group is
  // left in flight is always the buffer that is needed.
  while (seg < l1) {
    unsigned next_mask = 0;   // its `valid` bytes are read while K lands
    const int next = next_step(seg + WARPS * MMA_KS, next_mask);
    cp_async_wait<1>();   // this step's K
    __syncwarp();
    float s[2][2][4] = {};   // [n-tile][even/odd k-step]: shorter mma chains
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
      unsigned a[4], kf[4];
      ldmatrix_x4(a, q_addr + kd * 32);
      ldmatrix_x4(kf, kb + kd * 32);
      mma_bf16(s[0][kd & 1], a, kf[0], kf[1]);
      mma_bf16(s[1][kd & 1], a, kf[2], kf[3]);
    }
    __syncwarp();   // every lane has read this step's K
    if (next < l1) request(sk, kg, p.k_sl, next, next_mask);
    else cp_async_commit();

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[n][0][e] + s[n][1][e]) * qk_scale;
        if (p.softcap > 0.f) x = tanh_fast(x) * cap_scale;
        x = (mask >> (n * 8 + 2 * t + (e & 1))) & 1u ? x : NEG_INF;
        s[n][0][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float al0 = exp2_approx(m0 - mx0), al1 = exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    unsigned pa[4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float p0 = s[n][0][0] == NEG_INF ? 0.f : exp2_approx(s[n][0][0] - mx0);
      const float p1 = s[n][0][1] == NEG_INF ? 0.f : exp2_approx(s[n][0][1] - mx0);
      const float p2 = s[n][0][2] == NEG_INF ? 0.f : exp2_approx(s[n][0][2] - mx1);
      const float p3 = s[n][0][3] == NEG_INF ? 0.f : exp2_approx(s[n][0][3] - mx1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[n * 2] = pack_bf16(p0, p1);
      pa[n * 2 + 1] = pack_bf16(p2, p3);
    }
    l0s = l0s * al0 + ps0;
    l1s = l1s * al1 + ps1;
    if (__any_sync(FULL_MASK, al0 != 1.f || al1 != 1.f)) {   // a row max moved
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= al0; o[d][1] *= al0; o[d][2] *= al1; o[d][3] *= al1;
      }
    }
    cp_async_wait<1>();   // this step's V (the next K may still travel)
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      unsigned vf[4];
      ldmatrix_x4_trans(vf, vb + d * 16);
      mma_bf16(o[d], pa, vf[0], vf[1]);
      mma_bf16(o[d + 1], pa, vf[2], vf[3]);
    }
    __syncwarp();   // every lane has read this step's V
    if (next < l1) request(sv, vg, p.v_sl, next, next_mask);
    else cp_async_commit();
    seg = next;
    mask = next_mask;
  }

  // the warps' states into shared memory (the staging buffers are free)
  l0s = quad_sum(l0s);
  l1s = quad_sum(l1s);
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(stage);   // [WARPS][16][DH]
  const int ra = warp * 16 + g, rb = ra + 8;   // rows g and g+8 (heads past G unused)
  if (t == 0) { sm_m[ra] = m0; sm_l[ra] = l0s; sm_m[rb] = m1; sm_l[rb] = l1s; }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (g < G) *reinterpret_cast<float2*>(sm_acc + ra * DH + col) = make_float2(o[d][0], o[d][1]);
    if (g + 8 < G) *reinterpret_cast<float2*>(sm_acc + rb * DH + col) = make_float2(o[d][2], o[d][3]);
  }
  __syncthreads();
  finish<T, DH, 16, true>(p, sm_acc, sm_m, sm_l, b, kvh, split);
}

// ------------------------------------------------------------ f32, CUDA cores

// N consecutive floats of shared memory, 16 or 8 bytes at a time where N allows
// (`p` aligned to that), straight into registers.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = p[e];
  }
}

// Keys a warp stages per step: its K and V rows fill 16 KB of shared memory.
template <int DH>
__host__ __device__ constexpr int f32_keys_per_step() { return DH * 4 > 512 ? 8 : 16; }

template <int DH, int GT>
constexpr int f32_smem_bytes() {   // scaled q of GT heads, then the warps' staging
  return 4 * DH * (GT + WARPS * 2 * f32_keys_per_step<DH>());
}

template <int DH, int GT>
__global__ void __launch_bounds__(THREADS) decode_f32_kernel(const Params p) {
  constexpr int EPL = DH >= 32 ? DH / 32 : 1;   // contiguous elements per lane
  constexpr int LANES = DH >= 32 ? 32 : DH;     // lanes that hold data
  constexpr int KS = f32_keys_per_step<DH>();
  constexpr int CPR = DH / 4;                   // 16-byte copies per row
  static_assert(GT <= 2 * KS, "the warps' states must fit the staging buffers");
  extern __shared__ uint4 smem16[];
  __shared__ float sm_m[WARPS * GT], sm_l[WARPS * GT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* sq = reinterpret_cast<float*>(smem16);   // [GT][DH], pre-scaled
  float* stage = sq + GT * DH;
  float* sk = stage + warp * 2 * KS * DH;         // [KS][DH]
  float* sv = sk + KS * DH;                       // [KS][DH]

  const int G = p.H / p.KV;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int l0 = split * p.chunk;
  const int l1 = min(p.L, l0 + p.chunk);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + kvh * G * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const unsigned char* valid = p.valid + b * p.valid_sb;

  for (int idx = tid; idx < GT * DH; idx += THREADS) {
    const int g = idx / DH, d = idx % DH;
    sq[idx] = g < G ? qg[g * p.q_sh + d] * p.scale : 0.f;
  }
  __syncthreads();

  const bool active = lane < LANES;
  const float inv_cap = p.softcap > 0.f ? __fdividef(1.f, p.softcap) : 0.f;
  const int d0 = lane * EPL;
  // the running max and sum of head g live in lane g (warp-uniform values;
  // one register each instead of GT)
  float acc[GT][EPL], m_lane = NEG_INF, l_lane = 0.f;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int seg = l0 + warp * KS; seg < l1; seg += WARPS * KS) {
    const int key = seg + lane;
    const bool okl = lane < KS && key < l1 && valid[(long long)key * p.valid_sl] != 0;
    const unsigned mask = __ballot_sync(FULL_MASK, okl);
    if (mask == 0) continue;   // warp-uniform: none of these rows is loaded

    for (int c = lane; c < KS * CPR; c += 32) {
      const int j = c / CPR, d = (c % CPR) * 4;
      if ((mask >> j) & 1u) {
        cp_async16(sk + j * DH + d, kg + (long long)(seg + j) * p.k_sl + d);
        cp_async16(sv + j * DH + d, vg + (long long)(seg + j) * p.v_sl + d);
      }
    }
    cp_async_wait_all();
    __syncwarp();

    // scores: the lanes split Dh; the sum of key j is kept by lane j.  All GT
    // heads are computed (the rows past G hold zeros and are never written):
    // skipping them by a branch made ptxas spill in some instantiations.
    float sc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) sc[g] = NEG_INF;
#pragma unroll 2
    for (int j = 0; j < KS; ++j) {
      if (!((mask >> j) & 1u)) continue;
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = 0.f;
      if (active) load_floats(sk + j * DH + d0, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float qf[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) qf[e] = 0.f;
        if (active) load_floats(sq + g * DH + d0, qf);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qf[e], kf[e], part);
        const float sum = warp_sum(part);
        if (lane == j) sc[g] = sum;
      }
    }

    // online softmax, one key per lane: softcap and exp are computed once
    float pr[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      pr[g] = 0.f;
      float s = sc[g];
      if (p.softcap > 0.f) s = tanhf(s * inv_cap) * p.softcap;
      s = okl ? s : NEG_INF;
      const float mg = __shfl_sync(FULL_MASK, m_lane, g);
      const float mx = fmaxf(mg, warp_max(s));
      const float alpha = expf(mg - mx);
      pr[g] = okl ? expf(s - mx) : 0.f;
      const float psum = warp_sum(pr[g]);
      if (lane == g) { l_lane = l_lane * alpha + psum; m_lane = mx; }
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }

    // PV: p of key j is broadcast from lane j
#pragma unroll 2
    for (int j = 0; j < KS; ++j) {
      if (!((mask >> j) & 1u)) continue;
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = 0.f;
      if (active) load_floats(sv + j * DH + d0, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pj = __shfl_sync(FULL_MASK, pr[g], j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
      }
    }
    __syncwarp();   // all lanes are done with the rows before the next copies
  }

  __syncthreads();   // the staging buffers are free: reuse them
  float* sm_acc = stage;   // [WARPS][GT][DH]
  if (lane < GT) { sm_m[warp * GT + lane] = m_lane; sm_l[warp * GT + lane] = l_lane; }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[(warp * GT + g) * DH + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  finish<float, DH, GT, false>(p, sm_acc, sm_m, sm_l, b, kvh, split);
}

// ------------------------------------------------------------ launch

template <typename Kern>
cudaError_t launch_kernel(Kern kern, int smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.NS, p.KV, p.B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_kernel(decode_mma_kernel<DH>, mma_smem_bytes<DH>(), p, stream);
  // f32: the smallest head-group size of {1, 2, 4, 8, 16} that holds G
  const int G = p.H / p.KV;
  if (G <= 1) return launch_kernel(decode_f32_kernel<DH, 1>, f32_smem_bytes<DH, 1>(), p, stream);
  if (G <= 2) return launch_kernel(decode_f32_kernel<DH, 2>, f32_smem_bytes<DH, 2>(), p, stream);
  if (G <= 4) return launch_kernel(decode_f32_kernel<DH, 4>, f32_smem_bytes<DH, 4>(), p, stream);
  if (G <= 8) return launch_kernel(decode_f32_kernel<DH, 8>, f32_smem_bytes<DH, 8>(), p, stream);
  return launch_kernel(decode_f32_kernel<DH, 16>, f32_smem_bytes<DH, 16>(), p, stream);
}

int dispatch(const Params& p, int dtype, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return (int)launch<16>(p, dtype, stream);
    case 32: return (int)launch<32>(p, dtype, stream);
    case 64: return (int)launch<64>(p, dtype, stream);
    case 128: return (int)launch<128>(p, dtype, stream);
    case 256: return (int)launch<256>(p, dtype, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `chunk` keys per split, NS = ceil(L/chunk)
// splits; part_* are f32 scratch of (B,H,NS,Dh), (B,H,NS), (B,H,NS); counters
// (B,KV) ints, zero on entry and on return.  Returns 0, a cudaError_t, -1 for a
// head_dim / dtype the kernel was not built for, -2 for more than 16 query heads
// per KV head.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part_acc, void* part_m, void* part_l, void* counters, int dtype,
    int B, int H, int KV, int L, int Dh, int chunk, int NS,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long valid_sb, long long valid_sl,
    long long o_sb, long long o_sh,
    float softcap, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (H / KV > MAX_GROUP) return -2;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.valid = static_cast<const unsigned char*>(valid);
  p.o = o;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.counters = static_cast<int*>(counters);
  p.B = B; p.H = H; p.KV = KV; p.L = L; p.chunk = chunk; p.NS = NS;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.valid_sb = valid_sb; p.valid_sl = valid_sl;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.softcap = softcap; p.scale = scale;
  return dispatch(p, dtype, Dh, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_decode_attention_error(int code) {
  if (code == -1) return "unsupported head_dim or dtype";
  if (code == -2) return "more than 16 query heads per KV head";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
