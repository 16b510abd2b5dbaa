// Causal / sliding-window flash attention for sm_90a, plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_bhsd` of
// src/repro/kernels/flash_attention.py.  It computes the same function:
// softmax(softcap(q·scale @ kᵀ) under the causal/window mask) @ v, grouped-query
// heads reading their KV head as h / (H/KV), f32 inside, output in the input
// type, fully masked rows giving 0.
//
// Design.  One block owns a tile of BQ = 32 query rows of one (batch, head) and
// LOOPS over key tiles of BK = 32 from max(0, q_start - window + 1) to the
// causal edge: the loop bounds are the TPU kernel's "skip fully masked blocks",
// and the loop replaces its sequential innermost grid dimension.  Q (pre-scaled),
// K and V tiles sit in shared memory as f32; the online-softmax state
// (m, l, acc) of each row lives in registers.  A warp owns RW = 4 rows:
//   * scores: lane j owns key j of the tile and dots it with the warp's 4 query
//     rows (K row read once per 4 rows, float4 reads, K rows padded by 4 floats
//     so the reads are bank-conflict free);
//   * softmax: max and sum across the 32 lanes by shuffles;
//   * PV: lane owns output dims {lane, lane+32, ...}; p_j is broadcast by shuffle.
// Tensors are read through their strides, so the (B,S,H,Dh) layout of the model
// needs no transpose; K and V rows are fetched with 16-byte loads, so their
// base must be 16-byte aligned and their strides multiples of 16 bytes.  Any
// S >= 1: the ragged edge is masked here.
//
// Bound on an H100: operations (4·B·H·Dh·Σ_rows keys attended FLOP) at long S.
// This first version runs them on the f32 CUDA cores, not the tensor cores
// (f32 inputs must hold 2e-5 against the plain version); a tensor-core (wgmma)
// path for bf16 is later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int WARPS = 8;
constexpr int RW = 4;             // query rows per warp
constexpr int BQ = WARPS * RW;    // query rows per block
constexpr int BK = 32;            // keys per tile, one per lane
constexpr int THREADS = WARPS * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, S;
  long long q_sb, q_ss, q_sh;   // strides in elements; the last dim has stride 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;      // 0: no window
  float softcap;   // 0: no softcap
  float scale;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * DH + BK * (DH + 4) + BK * DH);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 2) flash_kernel(const Params p) {
  constexpr int KST = DH + 4;             // K row stride in floats
  constexpr int DPL = (DH + 31) / 32;     // output dims per lane
  constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16-byte global load
  constexpr int CPR = DH / VEC;              // such chunks per K/V row
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // [BQ][DH]
  float* sk = sq + BQ * DH;                      // [BK][KST]
  float* sv = sk + BK * KST;                     // [BK][DH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;     // late (long) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int S = p.S;
  const int q0 = qt * BQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int row = q0 + r;
    sq[idx] = row < S ? to_f32(qg[(long long)row * p.q_ss + d]) * p.scale : 0.f;
  }

  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int row_first = q0 + warp * RW;          // this warp's rows
  const int row_last = row_first + RW - 1;

  const int k_end = p.causal ? min(S, q0 + BQ) : S;
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed (first pass: Q is staged)
    for (int c = tid; c < BK * CPR; c += THREADS) {   // one 16-byte chunk each
      const int j = c / CPR, d = (c % CPR) * VEC;
      const int key = k0 + j;
      float kf[VEC], vf[VEC];
      if (key < S) {
        load_f32<T, VEC>(kg + (long long)key * p.k_ss + d, kf);
        load_f32<T, VEC>(vg + (long long)key * p.v_ss + d, vf);
      } else {   // rows past the end are zero, never garbage
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(sk + j * KST + d + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(sv + j * DH + d + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    // warp-uniform skip of a tile that is fully masked for all of its rows
    if (p.causal && k0 > row_last) continue;
    if (p.window > 0 && k0 + BK - 1 <= row_first - p.window) continue;

    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float4* kp = reinterpret_cast<const float4*>(sk + lane * KST);
    const float4* qp = reinterpret_cast<const float4*>(sq + warp * RW * DH);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 kk = kp[d4];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qq = qp[r * (DH / 4) + d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int key = k0 + lane;
    float pj[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = row_first + r;
      float sr = s[r];
      if (p.softcap > 0.f) sr = tanhf(sr / p.softcap) * p.softcap;
      bool ok = key < S;
      if (p.causal) ok = ok && key <= row;
      if (p.window > 0) ok = ok && key > row - p.window;
      sr = ok ? sr : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      const float pr = ok ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      pj[r] = pr;
    }

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) pv[r] = __shfl_sync(FULL_MASK, pj[r], j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = i * 32 + lane;
        if (d < DH) {
          const float vv = sv[j * DH + d];
#pragma unroll
          for (int r = 0; r < RW; ++r) acc[r][i] = fmaf(pv[r], vv, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = row_first + r;
    if (row >= S) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = i * 32 + lane;
      if (d < DH) from_f32(og + (long long)row * p.o_ss + d, acc[r][i] / safe);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = flash_kernel<T, DH>;
  const int smem = (int)smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, THREADS, smem, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or -1 for a
// head_dim / dtype the kernel was not built for.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KV, int S, int Dh,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.KV = KV; p.S = S;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, Dh, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, Dh, st);
  return -1;
}

extern "C" const char* repro_flash_attention_error(int code) {
  if (code == -1) return "unsupported head_dim or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
