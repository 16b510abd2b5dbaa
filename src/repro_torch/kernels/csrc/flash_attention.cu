// Causal / sliding-window flash attention for sm_90a, plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_bhsd` of
// src/repro/kernels/flash_attention.py.  It computes the same function:
// softmax(softcap(q·scale @ kᵀ) under the causal/window mask) @ v, grouped-query
// heads reading their KV head as h / (H/KV), f32 softmax state, output in the
// input type, fully masked rows giving 0 (masked scores sit at the finite -1e30
// and their probabilities are forced to 0).
//
// Bound on an H100: operations, 4·B·H·Dh·Σ_rows(keys attended) FLOP, at long S
// (S=5000: ~100 GFLOP against ~40 MB of Q, K, V and O).  Two kernels, picked by
// the input type:
//
// bf16 -> `flash_mma_kernel`, on the tensor cores.  A block of 4 warps owns
// BQ = 64 query rows of one (batch, head), 16 rows a warp, and loops over key
// tiles of BK keys from the window's lower edge to the causal edge (the TPU
// kernel's "skip fully masked blocks"; the loop replaces its sequential
// innermost grid dimension); late, long tiles are scheduled first.  Q, K and V
// stay bf16 in shared memory, rows padded by 16 bytes so that `ldmatrix` is
// free of bank conflicts; K/V tiles arrive by 16-byte `cp.async` copies into a
// double-buffered ring, so tile j+1 loads while tile j computes.  S = Q·Kᵀ and
// O += P·V are `mma.sync.m16n8k16` bf16 products with f32 accumulators; the
// operands come from `ldmatrix` (V through `.trans`).  Softcap, the mask (only
// on tiles that cross an edge) and the online softmax run on the accumulator
// fragments in registers (tanh from the SFU's 2^x and a fast division, 2^-20
// absolute error; 2^x on the SFU; O is rescaled only when a row max moved),
// row max and sum across the 4 lanes of a quad; P is rounded to bf16 and fed
// back as the A operand (the C layout of two m16n8 tiles is the A layout of one
// m16n8k16).  O stays in registers (Dh/2 floats a thread) until the epilogue.
// Keys per tile: BK = 64, or 32 at head_dim 256, where the caller picks by the
// grid (`key_tile` in flash_attention.py): K+V double-buffered at BK=32 take
// 101 KB, so two blocks share an SM and hide each other's softmax, while at
// BK=64 (169 KB, one block an SM) a block crosses half as many barriers.
//
// f32 -> `flash_kernel`, on the CUDA cores (f32 inputs must hold 2e-5 against
// the plain version; TF32 or bf16 products cannot).  A block owns 32 query rows,
// keys in tiles of 32; Q (pre-scaled), K and V sit in shared memory as f32; a
// warp owns 4 rows: lane j scores key j (float4 reads, K rows padded by 4
// floats), max and sum by warp shuffles, lane owns output dims {lane, lane+32,
// ...} for P·V.  Bound by instruction throughput, at ~27% of the f32 FMA peak.
//
// Both read the tensors through their strides, so the (B,S,H,Dh) layout of the
// model needs no transpose.  Rows are fetched 16 bytes at a time: the bases
// must be 16-byte aligned and the strides multiples of 16 bytes.  Any S >= 1:
// the ragged edge is masked and rows past S are zero-filled.
#include "common.cuh"

namespace {

using namespace repro;

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

// ------------------------------------------------------------ bf16, tensor cores

constexpr int MMA_WARPS = 4;
constexpr int MMA_BQ = MMA_WARPS * 16;   // query rows per block, 16 a warp
constexpr int MMA_THREADS = MMA_WARPS * 32;

template <int DH, int BK>
constexpr size_t mma_smem_bytes() {   // Q, then K and V rings of 2 tiles
  return sizeof(__nv_bfloat16) * (size_t)(DH + 8) * (MMA_BQ + 4 * BK);
}

template <int DH, int BK>
__global__ void __launch_bounds__(MMA_THREADS) flash_mma_kernel(const Params p) {
  using T = __nv_bfloat16;
  constexpr int LD = DH + 8;     // row stride in elements: +16 bytes, no bank conflicts
  constexpr int CPR = DH / 8;    // 16-byte chunks per row
  constexpr int NT = BK / 8;     // 8-key n-tiles of S
  constexpr int DT = DH / 8;     // 8-wide n-tiles of O
  static_assert(NT % 2 == 0 && DT % 2 == 0, "tiles are loaded in pairs");
  extern __shared__ uint4 smem16[];
  T* sq = reinterpret_cast<T*>(smem16);   // [BQ][LD]
  T* sk = sq + MMA_BQ * LD;               // [2][BK][LD]
  T* sv = sk + 2 * BK * LD;               // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;   // late (long) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int S = p.S;
  const int q0 = qt * MMA_BQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int c = tid; c < MMA_BQ * CPR; c += MMA_THREADS) {
    const int r = c / CPR, d = (c % CPR) * 8;
    const int row = q0 + r;
    cp_async16(sq + r * LD + d, qg + (long long)(row < S ? row : 0) * p.q_ss + d, row < S);
  }

  const int k_end = p.causal ? min(S, q0 + MMA_BQ) : S;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const int ntiles = (k_end - k_begin + BK - 1) / BK;

  // rows past S are zero, never garbage (0·NaN would reach O)
  auto load_kv = [&](int tile, int buf) {
    const int k0 = k_begin + tile * BK;
    T* dk = sk + buf * BK * LD;
    T* dv = sv + buf * BK * LD;
    for (int c = tid; c < BK * CPR; c += MMA_THREADS) {
      const int j = c / CPR, d = (c % CPR) * 8;
      const bool ok = k0 + j < S;
      const long long key = ok ? k0 + j : 0;
      cp_async16(dk + j * LD + d, kg + key * p.k_ss + d, ok);
      cp_async16(dv + j * LD + d, vg + key * p.v_ss + d, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();   // group 0: Q and the first K/V tile

  const int g = lane >> 2, t = lane & 3;
  const int row_first = q0 + warp * 16, row_last = row_first + 15;
  const int r0 = row_first + g, r1 = r0 + 8;   // this thread's two rows
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // scores in log2 units, softmax by exp2; a softcap takes tanh of the scaled
  // score first
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this lane's share
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * LOG2E;
  const float cap_scale = p.softcap * LOG2E;

  // ldmatrix row addresses.  Q (A): row lane % 16, columns (lane / 16)·8.
  // K (B of two key n-tiles): key (lane & 7) + (lane / 16)·8, dims (lane / 8 & 1)·8.
  // V (B of two d n-tiles, transposed): key (lane & 7) + (lane / 8 & 1)·8, dims (lane / 16)·8.
  const unsigned q_addr = smem_addr(sq + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {   // the next tile loads while this one computes
      load_kv(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int k0 = k_begin + it * BK;
    // warp-uniform: skip a tile that is fully masked for all 16 rows
    const bool skip = (p.causal && k0 > row_last) ||
                      (p.window > 0 && k0 + BK - 1 <= row_first - p.window);
    if (!skip) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const unsigned kb = smem_addr(sk + buf * BK * LD + k_off);
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        unsigned a[4];
        ldmatrix_x4(a, q_addr + kd * 32);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          unsigned kf[4];
          ldmatrix_x4(kf, kb + (n * 8 * LD + kd * 16) * 2);
          mma_bf16(s[n], a, kf[0], kf[1]);
          mma_bf16(s[n + 1], a, kf[2], kf[3]);
        }
      }

      // softcap and mask on the fragments; the mask only where a tile crosses
      // the causal edge, the window's edge or the end of the sequence
      const bool edge = (p.causal && k0 + BK - 1 > row_first) ||
                        (p.window > 0 && k0 <= row_last - p.window) || k0 + BK > S;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * qk_scale;
          if (p.softcap > 0.f) x = tanh_fast(x) * cap_scale;
          if (edge) {
            const int key = k0 + n * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            bool ok = key < S;
            if (p.causal) ok = ok && key <= row;
            if (p.window > 0) ok = ok && key > row - p.window;
            x = ok ? x : NEG_INF;
          }
          s[n][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float al0 = exp2_approx(m0 - mx0), al1 = exp2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;

      // P in bf16 as the A operand of P·V: k-step kk takes n-tiles 2kk, 2kk+1
      unsigned pa[NT / 2][4];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = s[n][0] == NEG_INF ? 0.f : exp2_approx(s[n][0] - mx0);
        const float p1 = s[n][1] == NEG_INF ? 0.f : exp2_approx(s[n][1] - mx0);
        const float p2 = s[n][2] == NEG_INF ? 0.f : exp2_approx(s[n][2] - mx1);
        const float p3 = s[n][3] == NEG_INF ? 0.f : exp2_approx(s[n][3] - mx1);
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);       // row g
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);   // row g+8
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      // O is rescaled only when a row max of the warp moved (rarer as the
      // tiles go on)
      if (__any_sync(FULL_MASK, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][0] *= al0; o[d][1] *= al0;
          o[d][2] *= al1; o[d][3] *= al1;
        }
      }

      const unsigned vb = smem_addr(sv + buf * BK * LD + v_off);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          unsigned vf[4];
          ldmatrix_x4_trans(vf, vb + (kk * 16 * LD + d * 8) * 2);
          mma_bf16(o[d], pa[kk], vf[0], vf[1]);
          mma_bf16(o[d + 1], pa[kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // this buffer is consumed: the next iteration refills it
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<unsigned*>(og + (long long)r0 * p.o_ss + col) =
          pack_bf16(o[d][0] / d0, o[d][1] / d0);
    if (r1 < S)
      *reinterpret_cast<unsigned*>(og + (long long)r1 * p.o_ss + col) =
          pack_bf16(o[d][2] / d1, o[d][3] / d1);
  }
}

template <int DH, int BK>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  auto kern = flash_mma_kernel<DH, BK>;
  constexpr int smem = (int)mma_smem_bytes<DH, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + MMA_BQ - 1) / MMA_BQ, p.H, p.B);
  kern<<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ f32, CUDA cores

constexpr int WARPS = 8;
constexpr int RW = 4;             // query rows per warp
constexpr int BQ = WARPS * RW;    // query rows per block
constexpr int BK = 32;            // keys per tile, one per lane
constexpr int THREADS = WARPS * 32;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * DH + BK * (DH + 4) + BK * DH);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2) flash_kernel(const Params p) {
  constexpr int KST = DH + 4;             // K row stride in floats
  constexpr int DPL = (DH + 31) / 32;     // output dims per lane
  constexpr int VEC = 4;                  // floats per 16-byte global load
  constexpr int CPR = DH / VEC;           // such chunks per K/V row
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

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int row = q0 + r;
    sq[idx] = row < S ? qg[(long long)row * p.q_ss + d] * p.scale : 0.f;
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
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;   // rows past the end are zero
      if (key < S) {
        kf = *reinterpret_cast<const float4*>(kg + (long long)key * p.k_ss + d);
        vf = *reinterpret_cast<const float4*>(vg + (long long)key * p.v_ss + d);
      }
      *reinterpret_cast<float4*>(sk + j * KST + d) = kf;
      *reinterpret_cast<float4*>(sv + j * DH + d) = vf;
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
      if (d < DH) og[(long long)row * p.o_ss + d] = acc[r][i] / safe;
    }
  }
}

template <int DH>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  auto kern = flash_kernel<DH>;
  const int smem = (int)smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the kernel by input type: f32 on the CUDA cores, bf16 on the tensor cores
// with BK keys a tile (64, or 32 at head_dim 256)
template <int DH>
int launch(const Params& p, int dtype, int bk, cudaStream_t stream) {
  if (dtype == 0) return (int)launch_f32<DH>(p, stream);
  if (bk == 64) return (int)launch_mma<DH, 64>(p, stream);
  if constexpr (DH == 256) {
    if (bk == 32) return (int)launch_mma<DH, 32>(p, stream);
  }
  return -1;
}

int dispatch(const Params& p, int dtype, int Dh, int bk, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<16>(p, dtype, bk, stream);
    case 32: return launch<32>(p, dtype, bk, stream);
    case 64: return launch<64>(p, dtype, bk, stream);
    case 128: return launch<128>(p, dtype, bk, stream);
    case 256: return launch<256>(p, dtype, bk, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; bk: keys per tile of the bf16 kernel (64,
// or 32 at head_dim 256; float32 ignores it).  Returns 0, a cudaError_t, or -1
// for a head_dim / dtype / bk the kernel was not built for.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KV, int S, int Dh, int bk,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.H = H; p.KV = KV; p.S = S;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.softcap = softcap; p.scale = scale;
  return dispatch(p, dtype, Dh, bk, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_flash_attention_error(int code) {
  if (code == -1) return "unsupported head_dim, dtype or key tile";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
