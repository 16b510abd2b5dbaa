// Mamba2 SSD chunk scan for sm_90a, plain C interface.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_bhzc` of
// src/repro/kernels/ssd_scan.py.  Same function, per (batch b, head h) over
// chunks z of c steps (cs = inclusive cumsum of A*dt inside the chunk):
//   y_z      = (C_z * e^{cs}) @ state_zᵀ + tril(C_z B_zᵀ ⊙ e^{cs_i - cs_j} ⊙ dt_j) @ x_z
//   state_z+1 = state_z * e^{cs_last} + (x_z ⊙ e^{cs_last - cs} dt)ᵀ B_z
// returning y (in x's type) and the final state (f32).
//
// The TPU kernel walks the chunks of a (b, h) in order, carrying the P x N
// state in scratch from one grid step to the next.  CUDA blocks run in no
// order, and one block per (b, h) would be 24 blocks on mamba2-130m at B=1.
// So the work is split as the reference's own einsum path splits it
// (src/repro/models/ssm.py:97-129), in three launches:
//   1. chunk states, one block per (b, h, z): the chunk's own contribution
//      S_z = (x ⊙ e^{cs_last - cs} dt)ᵀ B, into f32 scratch laid out (N, P);
//   2. ssd_carry_kernel, one thread per (b, h, n, p): the serial pass over the
//      nc chunks, replacing each S_z in place by the state ENTERING chunk z and
//      writing the final state;
//   3. outputs, one block per (b, h, z, 64-row tile of the chunk):
//      y = e^{cs_i} C_i · state_z + Σ_{j <= i} (C_i · B_j) e^{cs_i - cs_j} dt_j x_j,
//      the j loop over 64-key tiles up to the diagonal tile only.
// e^{cs_i - cs_j} is evaluated only where j <= i (and i < c): above the
// diagonal the exponent is positive and could overflow, and inf * 0 would
// poison y.  All inputs are read through their strides: x (B,nc,c,H,P), dt/cs
// (B,nc,c,H) and B/C (B,nc,c,N) are views of the model's tensors, no copies.
// P <= 64 and N <= 128 (every mamba2 config of the repo: P 64, N 128).
//
// Bound on an H100: at mamba2-130m's bf16 shapes the bytes (x, B, C, y once:
// 0.0086 ms at S=4096) and the least operations (C·Bᵀ once per chunk, not per
// head: 0.0049 ms on the tensor cores) are close (PERF.md).  Two paths, by type:
//
// bf16 -> `ssd_state_mma_kernel` and `ssd_output_mma_kernel`, on the tensor
// cores (`mma.sync` m16n8k16, f32 accumulators, the fragment code of K2's
// flash_mma_kernel).  4 warps a block, 16 rows a warp.  Operands stay bf16 in
// shared memory, rows padded by 16 bytes so that `ldmatrix` has no bank
// conflicts; key tiles of 64 arrive by `cp.async` into a double-buffered ring
// (rows past c zero-filled: 0 · a garbage NaN would reach y).
//   - States: S_z as (P x c)·(c x N), warp w owning p in [16w, 16w+16).  The A
//     operand (x rows read by `ldmatrix.trans`) is scaled by seg in registers
//     and rounded to bf16 once, as the reference's einsum path rounds seg·x.
//   - Outputs: K2's structure with Q = C, K = B, V = x_h.  C's fragments are
//     loaded once; G = C·Bᵀ (k = N) lands in C fragments; W = G ⊙ e^{cs_i -
//     cs_j} dt_j is formed there in f32 (2^x on the SFU) and fed back as the A
//     operand of W·x (the C layout of two m16n8 tiles is the A layout of one
//     m16n8k16).  The inter-chunk term runs only for z > 0 (the state entering
//     chunk 0 is zero): the entering state is the B operand of C·state, and
//     e^{cs_i} scales the f32 accumulator rows.  W and the state go in as two
//     bf16 operands each, hi = bf16(v) and lo = bf16(v - hi), two products
//     summed in f32: one bf16 rounding of W misses the 2e-2 that the plain
//     version holds the kernel to (0.0217 of 1 + |y| at mamba2-130m's S=4096;
//     0.0069 with the pairs: tools/ssd_bf16_rounding.py), for a third more
//     products.  On the diagonal tile a warp skips the keys past its last row;
//     late row tiles are scheduled first.  The state borrows the space of C
//     and of the second ring buffers (71 KB a block at P = 64, N = 128: three
//     blocks an SM, faster from S=2048 on than with a space of its own:
//     PERF.md).  P and N must be multiples of 16, and x, B and C need 16-byte
//     aligned rows (the wrapper checks).
//   C·Bᵀ is computed once per head (24 times per chunk at mamba2-130m):
//   sharing it between two heads of a block was measured and gained at most
//   2%, losing 3% at S=2048 (a block then holds twice the accumulators: two
//   blocks an SM, not three).  `mma.sync` from 4-warp blocks is far from
//   `wgmma`'s rate.
//
// f32 -> `ssd_state_kernel` / `ssd_output_kernel`, on the CUDA cores (f32
// inputs hold 2e-3 against the plain version; TF32 products would put that at
// risk).  All products are f32 FMAs from shared memory, 4 x 4 outputs per
// thread.  A 256-step chunk does not fit a block's 227 KB in f32 (x 64 KB + B
// 128 KB + C 128 KB + the 256 x 256 score tile), so rows and keys are tiled by
// 64: C (64 x N) and one B/x key tile are resident, the 64 x 64 weight tile is
// rebuilt per key tile.  (Staging each tile's loads in registers with the next
// tile's in flight was measured and was slower: it spills at 128 registers.
// PERF.md.)  Bound by instruction issue: 75x its byte bound at S=4096.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;     // 16 x 16
constexpr int T = 64;            // rows / keys per tile
constexpr int TS = T + 4;        // k-major tile row stride (floats), 16-byte rows
constexpr int P_MAX = 64;
constexpr int N_MAX = 128;

struct Params {
  const void* x;        // (B,nc,c,H,P)
  const float* dt;      // (B,nc,c,H)
  const float* cs;      // (B,nc,c,H)
  const void* bm;       // (B,nc,c,N)
  const void* cm;       // (B,nc,c,N)
  void* y;              // (B,nc,c,H,P)
  float* h_last;        // (B,H,P,N) contiguous
  float* st;            // (B,H,nc,N,P) contiguous scratch
  int B, nc, c, H, P, N;
  long long x_sb, x_sz, x_si, x_sh;
  long long dt_sb, dt_sz, dt_si, dt_sh;
  long long cs_sb, cs_sz, cs_si, cs_sh;
  long long b_sb, b_sz, b_si;
  long long c_sb, c_sz, c_si;
  long long y_sb, y_sz, y_si, y_sh;
};

__device__ __forceinline__ float cs_at(const Params& p, int b, int z, int i, int h) {
  return p.cs[b * p.cs_sb + z * p.cs_sz + i * p.cs_si + h * p.cs_sh];
}
__device__ __forceinline__ float dt_at(const Params& p, int b, int z, int i, int h) {
  return p.dt[b * p.dt_sb + z * p.dt_sz + i * p.dt_si + h * p.dt_sh];
}
__device__ __forceinline__ long long st_base(const Params& p, int b, int h, int z) {
  return (((long long)b * p.H + h) * p.nc + z) * (long long)p.N * p.P;
}

// ---------------------------------------------------------------- 1. states
// S_z[n][p] = Σ_j seg_j x[j][p] B[j][n], seg_j = e^{cs_last - cs_j} dt_j.
// Thread (ty, tx) owns n in [8ty, 8ty+8), p in [4tx, 4tx+4).
template <typename T_>
__global__ void __launch_bounds__(THREADS) ssd_state_kernel(const Params p) {
  constexpr int SJ = 32;           // keys per tile
  __shared__ __align__(16) float xs[SJ][P_MAX];
  __shared__ __align__(16) float bs[SJ][N_MAX];
  __shared__ float seg[SJ];
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T_* xg = static_cast<const T_*>(p.x) + b * p.x_sb + z * p.x_sz + h * p.x_sh;
  const T_* bg = static_cast<const T_*>(p.bm) + b * p.b_sb + z * p.b_sz;
  const float cs_last = cs_at(p, b, z, p.c - 1, h);
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
  for (int j0 = 0; j0 < p.c; j0 += SJ) {
    __syncthreads();
    if (tid < SJ) {
      const int j = j0 + tid;
      seg[tid] = j < p.c ? expf(cs_last - cs_at(p, b, z, j, h)) * dt_at(p, b, z, j, h) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < SJ * P_MAX; idx += THREADS) {
      const int j = idx / P_MAX, pp = idx % P_MAX;
      xs[j][pp] = (j0 + j < p.c && pp < p.P)
                      ? to_f32(xg[(long long)(j0 + j) * p.x_si + pp]) * seg[j] : 0.f;
    }
    for (int idx = tid; idx < SJ * N_MAX; idx += THREADS) {
      const int j = idx / N_MAX, n = idx % N_MAX;
      bs[j][n] = (j0 + j < p.c && n < p.N)
                     ? to_f32(bg[(long long)(j0 + j) * p.b_si + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < SJ; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[j][tx * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[j][ty * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[j][ty * 8 + 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(bv[a], xq[q], acc[a][q]);
    }
  }
  float* out = p.st + st_base(p, b, h, z);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int n = ty * 8 + a;
    if (n >= p.N) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tx * 4 + q;
      if (pp < p.P) out[(long long)n * p.P + pp] = acc[a][q];
    }
  }
}

// ---------------------------------------------------------------- 2. carry
// In place: st[z] <- state entering chunk z; h_last <- state after the last.
__global__ void __launch_bounds__(THREADS) ssd_carry_kernel(const Params p) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int NP = p.N * p.P;
  if (e >= NP) return;
  float state = 0.f;
  for (int z = 0; z < p.nc; ++z) {
    float* cell = p.st + st_base(p, b, h, z) + e;
    const float s = *cell;
    *cell = state;
    state = fmaf(state, expf(cs_at(p, b, z, p.c - 1, h)), s);
  }
  const int n = e / p.P, pp = e % p.P;
  p.h_last[(((long long)b * p.H + h) * p.P + pp) * p.N + n] = state;
}

// ---------------------------------------------------------------- 3. output
// Thread (ty, tx) owns rows i in [4ty, 4ty+4) of the tile and p in [4tx, 4tx+4)
// (for the score tile: keys j in [4tx, 4tx+4)).
__host__ __device__ constexpr size_t out_smem_floats(int N) {
  return (size_t)N * TS * 2      // C (k-major), B or the entering state (k-major)
         + (size_t)T * P_MAX     // x tile
         + (size_t)T * TS        // weight tile, key-major
         + 3 * T;                // cs_i, cs_j, dt_j
}

template <typename T_>
__global__ void __launch_bounds__(THREADS) ssd_output_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);
  float* bt = ct + p.N * TS;
  float* xs = bt + p.N * TS;
  float* wt = xs + T * P_MAX;
  float* cs_i = wt + T * TS;
  float* cs_j = cs_i + T;
  float* dt_j = cs_j + T;
  const int tiles = (p.c + T - 1) / T;
  const int it = blockIdx.x % tiles, z = blockIdx.x / tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = it * T;
  const T_* xg = static_cast<const T_*>(p.x) + b * p.x_sb + z * p.x_sz + h * p.x_sh;
  const T_* bg = static_cast<const T_*>(p.bm) + b * p.b_sb + z * p.b_sz;
  const T_* cg = static_cast<const T_*>(p.cm) + b * p.c_sb + z * p.c_sz;
  for (int idx = tid; idx < T * p.N; idx += THREADS) {
    const int i = idx / p.N, n = idx % p.N;
    ct[n * TS + i] = i0 + i < p.c ? to_f32(cg[(long long)(i0 + i) * p.c_si + n]) : 0.f;
  }
  if (tid < T) cs_i[tid] = i0 + tid < p.c ? cs_at(p, b, z, i0 + tid, h) : 0.f;
  const float* stz = p.st + st_base(p, b, h, z);
  for (int idx = tid; idx < p.N * P_MAX; idx += THREADS) {
    const int n = idx / P_MAX, pp = idx % P_MAX;
    bt[n * TS + pp] = pp < p.P ? stz[(long long)n * p.P + pp] : 0.f;
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
#pragma unroll 4
  for (int n = 0; n < p.N; ++n) {
    const float4 cv = *reinterpret_cast<const float4*>(ct + n * TS + ty * 4);
    const float4 sv = *reinterpret_cast<const float4*>(bt + n * TS + tx * 4);
    const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
    const float sq[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(ca[a], sq[q], acc[a][q]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float g = expf(cs_i[ty * 4 + a]);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] *= g;
  }
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * T;
    __syncthreads();
    for (int idx = tid; idx < T * p.N; idx += THREADS) {
      const int j = idx / p.N, n = idx % p.N;
      bt[n * TS + j] = j0 + j < p.c ? to_f32(bg[(long long)(j0 + j) * p.b_si + n]) : 0.f;
    }
    for (int idx = tid; idx < T * P_MAX; idx += THREADS) {
      const int j = idx / P_MAX, pp = idx % P_MAX;
      xs[idx] = (j0 + j < p.c && pp < p.P)
                    ? to_f32(xg[(long long)(j0 + j) * p.x_si + pp]) : 0.f;
    }
    if (tid < T) {
      const bool in = j0 + tid < p.c;
      cs_j[tid] = in ? cs_at(p, b, z, j0 + tid, h) : 0.f;
      dt_j[tid] = in ? dt_at(p, b, z, j0 + tid, h) : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[a][q] = 0.f;
#pragma unroll 4
    for (int n = 0; n < p.N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(ct + n * TS + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(bt + n * TS + tx * 4);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
      const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[a][q] = fmaf(ca[a], bq[q], s[a][q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx * 4 + q;
      float w4[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
        const bool keep = j0 + j <= i0 + i && i0 + i < p.c;
        w4[a] = keep ? s[a][q] * expf(cs_i[i] - cs_j[j]) * dt_j[j] : 0.f;
      }
      *reinterpret_cast<float4*>(wt + j * TS + ty * 4) =
          make_float4(w4[0], w4[1], w4[2], w4[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(wt + j * TS + ty * 4);
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * P_MAX + tx * 4);
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
      const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(wa[a], xq[q], acc[a][q]);
    }
  }
  T_* yg = static_cast<T_*>(p.y) + b * p.y_sb + z * p.y_sz + h * p.y_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= p.c) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tx * 4 + q;
      if (pp < p.P) from_f32(yg + (long long)i * p.y_si + pp, acc[a][q]);
    }
  }
}

// ------------------------------------------------------------ bf16, tensor cores

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MT = MMA_WARPS * 16;   // rows / keys per tile, 16 rows a warp

// two bf16 (one fragment register) times two floats, rounded back to bf16
__device__ __forceinline__ unsigned scale_bf16x2(unsigned v, float s_lo, float s_hi) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(x) * s_lo, __high2float(x) * s_hi);
}
// a, b as two bf16 pairs, hi + lo: a product with each, summed in f32, keeps
// about 16 bits of a and b where one bf16 keeps 8
__device__ __forceinline__ void split_bf16x2(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// Shared memory: rows of P or N bf16 padded by 8 elements (16 bytes).
int mma_state_smem(int P, int N) {
  return 2 * MT * (P + 8 + N + 8) * 2 + 4 * MT * 4;
}
// (The output kernel's entering state, 2N(P+8) elements from C on, fits in
// C + B 1 + x 1, 2·64(N+8) + 64(P+8), for every P <= 64, N <= 128.)
int mma_output_smem(int P, int N) {
  return (3 * MT * (N + 8) + 2 * MT * (P + 8)) * 2 + 5 * MT * 4;
}

// S_z[n][p] = Σ_j (seg_j x[j][p]) B[j][n] as (P x c)·(c x N); warp w owns
// p in [16w, 16w+16) and all N columns.  A = (seg·x)ᵀ from x's [key][p] rows
// by ldmatrix.trans, scaled by seg in registers; B from [key][n] rows by
// ldmatrix.trans.
__global__ void __launch_bounds__(MMA_THREADS) ssd_state_mma_kernel(const Params p) {
  using BF = __nv_bfloat16;
  extern __shared__ uint4 smem16[];
  const int LDP = p.P + 8, LDN = p.N + 8;
  BF* sx = reinterpret_cast<BF*>(smem16);                     // [2][MT][LDP]
  BF* sb = sx + 2 * MT * LDP;                                 // [2][MT][LDN]
  float* scs = reinterpret_cast<float*>(sb + 2 * MT * LDN);   // [2][MT]
  float* sdt = scs + 2 * MT;                                  // [2][MT]
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const BF* xg = static_cast<const BF*>(p.x) + b * p.x_sb + z * p.x_sz + h * p.x_sh;
  const BF* bg = static_cast<const BF*>(p.bm) + b * p.b_sb + z * p.b_sz;
  const float* csg = p.cs + b * p.cs_sb + z * p.cs_sz + h * p.cs_sh;
  const float* dtg = p.dt + b * p.dt_sb + z * p.dt_sz + h * p.dt_sh;
  const float l2cs_last = csg[(long long)(p.c - 1) * p.cs_si] * LOG2E;
  const int ntiles = (p.c + MT - 1) / MT;
  const int cpx = p.P / 8, cpn = p.N / 8;   // 16-byte chunks per row

  // keys past c are zero (dt 0 makes their seg 0; x and B 0, never garbage)
  auto load = [&](int tile, int buf) {
    const int j0 = tile * MT;
    BF* dx = sx + buf * MT * LDP;
    BF* db = sb + buf * MT * LDN;
    for (int q = tid; q < MT * cpx; q += MMA_THREADS) {
      const int j = q / cpx, d = (q % cpx) * 8;
      const bool ok = j0 + j < p.c;
      cp_async16(dx + j * LDP + d, xg + (ok ? j0 + j : 0) * p.x_si + d, ok);
    }
    for (int q = tid; q < MT * cpn; q += MMA_THREADS) {
      const int j = q / cpn, d = (q % cpn) * 8;
      const bool ok = j0 + j < p.c;
      cp_async16(db + j * LDN + d, bg + (ok ? j0 + j : 0) * p.b_si + d, ok);
    }
    if (tid < MT) {
      const bool ok = j0 + tid < p.c;
      const long long j = ok ? j0 + tid : 0;
      cp_async4(scs + buf * MT + tid, csg + j * p.cs_si, ok);
      cp_async4(sdt + buf * MT + tid, dtg + j * p.dt_si, ok);
    }
  };
  load(0, 0);
  cp_async_commit();

  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 16 < p.P;     // warp-uniform
  const int nt = p.N / 8;                  // 8-wide n-tiles of S
  float acc[N_MAX / 8][4];
#pragma unroll
  for (int n = 0; n < N_MAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // ldmatrix row addresses.  A (xᵀ, transposed): key (lane & 7) + (lane / 16)·8,
  // p 16·warp + (lane / 8 & 1)·8.  B (transposed): key (lane & 7) + (lane / 8 & 1)·8,
  // n (lane / 16)·8.
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * LDP + warp * 16 + ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDN + (lane >> 4) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {   // the next tile loads while this one computes
      load(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const unsigned xa = smem_addr(sx + buf * MT * LDP + a_off);
      const unsigned bb = smem_addr(sb + buf * MT * LDN + b_off);
      const float* cs_t = scs + buf * MT;
      const float* dt_t = sdt + buf * MT;
      auto seg = [&](int k) { return exp2_approx(l2cs_last - cs_t[k] * LOG2E) * dt_t[k]; };
#pragma unroll
      for (int kk = 0; kk < MT / 16; ++kk) {
        // a0, a1 hold keys 16kk + 2t, +1; a2, a3 keys 16kk + 8 + 2t, +1
        const int k0 = kk * 16 + 2 * t;
        const float s0 = seg(k0), s1 = seg(k0 + 1), s2 = seg(k0 + 8), s3 = seg(k0 + 9);
        unsigned a[4];
        ldmatrix_x4_trans(a, xa + kk * 16 * LDP * 2);
        a[0] = scale_bf16x2(a[0], s0, s1);
        a[1] = scale_bf16x2(a[1], s0, s1);
        a[2] = scale_bf16x2(a[2], s2, s3);
        a[3] = scale_bf16x2(a[3], s2, s3);
#pragma unroll
        for (int n = 0; n < N_MAX / 8; n += 2) {
          if (n < nt) {
            unsigned bf[4];
            ldmatrix_x4_trans(bf, bb + (kk * 16 * LDN + n * 8) * 2);
            mma_bf16(acc[n], a, bf[0], bf[1]);
            mma_bf16(acc[n + 1], a, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();   // this buffer is consumed: the next iteration refills it
  }

  if (active) {   // rows p0, p0 + 8; columns n, n + 1 of each n-tile
    float* out = p.st + st_base(p, b, h, z);
    const int p0 = warp * 16 + g;
#pragma unroll
    for (int n = 0; n < N_MAX / 8; ++n) {
      if (n < nt) {
        const int col = n * 8 + 2 * t;
        out[(long long)col * p.P + p0] = acc[n][0];
        out[(long long)(col + 1) * p.P + p0] = acc[n][1];
        out[(long long)col * p.P + p0 + 8] = acc[n][2];
        out[(long long)(col + 1) * p.P + p0 + 8] = acc[n][3];
      }
    }
  }
}

// One block per (b, z, 64-row tile, h); warp w owns rows [16w, 16w+16) of the
// tile and all P columns of y.
//
// Shared memory: [B 0][x 0][C][B 1][x 1] (the key tiles of ring buffers 0
// and 1 around C), then the cs and dt arrays.  C is read into registers once;
// then C, B 1 and x 1 together hold the entering state (hi and lo) for the
// inter-chunk term, before the key loop first loads buffer 1.  So the state
// needs no space of its own: 71 KB at P = 64, N = 128, three blocks an SM.
// Rows of P or N bf16 are padded by 8 elements.
__global__ void __launch_bounds__(MMA_THREADS) ssd_output_mma_kernel(const Params p) {
  using BF = __nv_bfloat16;
  extern __shared__ uint4 smem16[];
  const int LDP = p.P + 8, LDN = p.N + 8;
  const int RING = 2 * MT * LDN + MT * LDP;  // from buffer 0 to buffer 1
  BF* sb = reinterpret_cast<BF*>(smem16);    // [MT][LDN] B key tile of buffer 0
  BF* sx = sb + MT * LDN;                    // [MT][LDP] x_h key tile of buffer 0
  BF* sc = sx + MT * LDP;                    // [MT][LDN] C rows of the tile
  BF* ss = sc;                               // [2][N][LDP] entering state, hi, lo
  float* scs_i = reinterpret_cast<float*>(sx + RING + MT * LDP);   // [MT] cs of the rows
  float* scs = scs_i + MT;                   // [2][MT] cs of the keys
  float* sdt = scs + 2 * MT;                 // [2][MT] dt of the keys

  const int tiles = (p.c + MT - 1) / MT;
  int idx = blockIdx.x;                      // h fastest, row tile slowest
  const int h = idx % p.H;
  idx /= p.H;
  const int z = idx % p.nc;
  idx /= p.nc;
  const int b = idx % p.B;
  const int it = tiles - 1 - idx / p.B;      // late (long) row tiles first
  const int i0 = it * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const BF* xg = static_cast<const BF*>(p.x) + b * p.x_sb + z * p.x_sz + h * p.x_sh;
  const BF* bg = static_cast<const BF*>(p.bm) + b * p.b_sb + z * p.b_sz;
  const BF* cg = static_cast<const BF*>(p.cm) + b * p.c_sb + z * p.c_sz;
  const float* csg = p.cs + b * p.cs_sb + z * p.cs_sz + h * p.cs_sh;
  const float* dtg = p.dt + b * p.dt_sb + z * p.dt_sz + h * p.dt_sh;
  const int cpx = p.P / 8, cpn = p.N / 8;    // 16-byte chunks per row

  // rows and keys past c are zero, never garbage (0·NaN would reach y)
  for (int q = tid; q < MT * cpn; q += MMA_THREADS) {
    const int r = q / cpn, d = (q % cpn) * 8;
    const bool ok = i0 + r < p.c;
    cp_async16(sc + r * LDN + d, cg + (ok ? i0 + r : 0) * p.c_si + d, ok);
  }
  if (tid < MT) {
    const bool ok = i0 + tid < p.c;
    cp_async4(scs_i + tid, csg + (ok ? i0 + tid : 0) * p.cs_si, ok);
  }
  auto load = [&](int tile, int buf) {
    const int j0 = tile * MT;
    BF* db = sb + buf * RING;
    BF* dx = sx + buf * RING;
    for (int q = tid; q < MT * cpn; q += MMA_THREADS) {
      const int j = q / cpn, d = (q % cpn) * 8;
      const bool ok = j0 + j < p.c;
      cp_async16(db + j * LDN + d, bg + (ok ? j0 + j : 0) * p.b_si + d, ok);
    }
    for (int q = tid; q < MT * cpx; q += MMA_THREADS) {
      const int j = q / cpx, d = (q % cpx) * 8;
      const bool ok = j0 + j < p.c;
      cp_async16(dx + j * LDP + d, xg + (ok ? j0 + j : 0) * p.x_si + d, ok);
    }
    if (tid < MT) {
      const bool ok = j0 + tid < p.c;
      const long long j = ok ? j0 + tid : 0;
      cp_async4(scs + buf * MT + tid, csg + j * p.cs_si, ok);
      cp_async4(sdt + buf * MT + tid, dtg + j * p.dt_si, ok);
    }
  };
  load(0, 0);
  cp_async_wait_all();   // C, cs of the rows and the first key tile
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;   // this thread's two rows of the tile
  const int nk = p.N / 16;                     // k-steps over N
  const int np = p.P / 8;                      // 8-wide n-tiles of y
  // ldmatrix row addresses.  C (A): row lane % 16, n (lane / 16)·8.  B (as
  // K in K2): key (lane & 7) + (lane / 16)·8, n (lane / 8 & 1)·8.  x and the
  // state (transposed, as V in K2): k (lane & 7) + (lane / 8 & 1)·8, p (lane / 16)·8.
  const unsigned c_addr = smem_addr(sc + (warp * 16 + (lane & 15)) * LDN + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LDN + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDP + (lane >> 4) * 8;
  unsigned ca[N_MAX / 16][4];                  // this warp's C rows, A fragments
#pragma unroll
  for (int kd = 0; kd < N_MAX / 16; ++kd)
    if (kd < nk) ldmatrix_x4(ca[kd], c_addr + kd * 32);
  const float l2cs0 = scs_i[r0] * LOG2E, l2cs1 = scs_i[r1] * LOG2E;   // log2 units
  float o[P_MAX / 8][4];
#pragma unroll
  for (int d = 0; d < P_MAX / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  if (z > 0) {   // y = e^{cs_i} · C·(state hi + state lo), on the f32 rows
    __syncthreads();   // C is in registers: its space takes the state
    const float* stz = p.st + st_base(p, b, h, z);
    const int c4 = p.P / 4;
    for (int q = tid; q < p.N * c4; q += MMA_THREADS) {
      const int n = q / c4, pp = (q % c4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(stz + (long long)n * p.P + pp);
      uint2 hi, lo;
      split_bf16x2(v.x, v.y, hi.x, lo.x);
      split_bf16x2(v.z, v.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(ss + n * LDP + pp) = hi;
      *reinterpret_cast<uint2*>(ss + (p.N + n) * LDP + pp) = lo;
    }
    __syncthreads();
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const unsigned sa = smem_addr(ss + part * p.N * LDP + v_off);
#pragma unroll
      for (int kd = 0; kd < N_MAX / 16; ++kd) {
#pragma unroll
        for (int d = 0; d < P_MAX / 8; d += 2) {
          if (kd < nk && d < np) {
            unsigned vf[4];
            ldmatrix_x4_trans(vf, sa + (kd * 16 * LDP + d * 8) * 2);
            mma_bf16(o[d], ca[kd], vf[0], vf[1]);
            mma_bf16(o[d + 1], ca[kd], vf[2], vf[3]);
          }
        }
      }
    }
    const float e0 = exp2_approx(l2cs0), e1 = exp2_approx(l2cs1);
#pragma unroll
    for (int d = 0; d < P_MAX / 8; ++d) {
      o[d][0] *= e0; o[d][1] *= e0;
      o[d][2] *= e1; o[d][3] *= e1;
    }
  }
  __syncthreads();   // C and the state are consumed: ring 1 may load

  for (int jt = 0; jt <= it; ++jt) {
    const int buf = jt & 1;
    if (jt < it) {   // the next key tile loads while this one computes
      load(jt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // G = C·Bᵀ for this warp's 16 rows; on the diagonal tile only the keys up
    // to the warp's last row
    const int j0 = jt * MT;
    const bool diag = jt == it;
    const int kend = diag ? warp * 16 + 16 : MT;
    float s[MT / 8][4];
#pragma unroll
    for (int n = 0; n < MT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const unsigned kb = smem_addr(sb + buf * RING + k_off);
#pragma unroll
    for (int kd = 0; kd < N_MAX / 16; ++kd) {
#pragma unroll
      for (int n = 0; n < MT / 8; n += 2) {
        if (kd < nk && n * 8 < kend) {
          unsigned kf[4];
          ldmatrix_x4(kf, kb + (n * 8 * LDN + kd * 16) * 2);
          mma_bf16(s[n], ca[kd], kf[0], kf[1]);
          mma_bf16(s[n + 1], ca[kd], kf[2], kf[3]);
        }
      }
    }

    // W = G ⊙ e^{cs_i - cs_j} dt_j as hi + lo bf16, the A operands of W·x:
    // k-step kk takes n-tiles 2kk, 2kk+1.  The mask (j <= i, i < c) only on the
    // diagonal tile and the ragged last row tile; e^x only where it holds.
    const bool edge = diag || i0 + MT > p.c;
    const float* cs_t = scs + buf * MT;
    const float* dt_t = sdt + buf * MT;
    unsigned pa[MT / 16][4], pl[MT / 16][4];
#pragma unroll
    for (int n = 0; n < MT / 8; ++n) {
      const int k = n * 8 + 2 * t;
      const float c0 = cs_t[k] * LOG2E, c1 = cs_t[k + 1] * LOG2E;
      const float d0 = dt_t[k], d1 = dt_t[k + 1];
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const bool ok = !edge || (j0 + k + (e & 1) <= i0 + row && i0 + row < p.c);
        w[e] = ok ? s[n][e] * exp2_approx((e < 2 ? l2cs0 : l2cs1) - ((e & 1) ? c1 : c0))
                        * ((e & 1) ? d1 : d0)
                  : 0.f;
      }
      split_bf16x2(w[0], w[1], pa[n / 2][(n & 1) * 2], pl[n / 2][(n & 1) * 2]);   // row g
      split_bf16x2(w[2], w[3], pa[n / 2][(n & 1) * 2 + 1], pl[n / 2][(n & 1) * 2 + 1]);   // g+8
    }

    const unsigned vb = smem_addr(sx + buf * RING + v_off);
#pragma unroll
    for (int kk = 0; kk < MT / 16; ++kk) {
#pragma unroll
      for (int d = 0; d < P_MAX / 8; d += 2) {
        if (kk * 16 < kend && d < np) {
          unsigned vf[4];
          ldmatrix_x4_trans(vf, vb + (kk * 16 * LDP + d * 8) * 2);
          mma_bf16(o[d], pa[kk], vf[0], vf[1]);
          mma_bf16(o[d + 1], pa[kk], vf[2], vf[3]);
          mma_bf16(o[d], pl[kk], vf[0], vf[1]);
          mma_bf16(o[d + 1], pl[kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // this buffer is consumed: the next iteration refills it
  }

  BF* yg = static_cast<BF*>(p.y) + b * p.y_sb + z * p.y_sz + h * p.y_sh;
  const int ia = i0 + r0, ib = i0 + r1;
#pragma unroll
  for (int d = 0; d < P_MAX / 8; ++d) {
    if (d < np) {
      const int col = d * 8 + 2 * t;
      if (ia < p.c)
        *reinterpret_cast<unsigned*>(yg + (long long)ia * p.y_si + col) = pack_bf16(o[d][0], o[d][1]);
      if (ib < p.c)
        *reinterpret_cast<unsigned*>(yg + (long long)ib * p.y_si + col) = pack_bf16(o[d][2], o[d][3]);
    }
  }
}

cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  const int st_smem = mma_state_smem(p.P, p.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, st_smem);
  if (err != cudaSuccess) return err;
  ssd_state_mma_kernel<<<dim3(p.nc, p.H, p.B), MMA_THREADS, st_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int np = p.N * p.P;
  ssd_carry_kernel<<<dim3((np + THREADS - 1) / THREADS, p.H, p.B), THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int out_smem = mma_output_smem(p.P, p.N);
  err = cudaFuncSetAttribute(
      ssd_output_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.c + MT - 1) / MT;
  ssd_output_mma_kernel<<<p.B * p.nc * tiles * p.H, MMA_THREADS, out_smem, stream>>>(p);
  return cudaGetLastError();
}

// f32: the three CUDA-core kernels
template <typename T_>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  ssd_state_kernel<T_><<<dim3(p.nc, p.H, p.B), THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int np = p.N * p.P;
  ssd_carry_kernel<<<dim3((np + THREADS - 1) / THREADS, p.H, p.B), THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = ssd_output_kernel<T_>;
  const int smem = (int)(sizeof(float) * out_smem_floats(p.N));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.c + T - 1) / T;
  kern<<<dim3(p.nc * tiles, p.H, p.B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  dt and cs are f32;
// st is f32 scratch of B*H*nc*N*P.  Returns 0, a cudaError_t, or -1 for a
// dtype or a P / N the kernels were not built for (bf16: multiples of 16).
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* cs, const void* bm, const void* cm,
    void* y, void* h_last, void* st, int dtype,
    int B, int nc, int c, int H, int P, int N,
    long long x_sb, long long x_sz, long long x_si, long long x_sh,
    long long dt_sb, long long dt_sz, long long dt_si, long long dt_sh,
    long long cs_sb, long long cs_sz, long long cs_si, long long cs_sh,
    long long b_sb, long long b_sz, long long b_si,
    long long c_sb, long long c_sz, long long c_si,
    long long y_sb, long long y_sz, long long y_si, long long y_sh,
    void* stream) {
  if (P < 1 || P > P_MAX || N < 1 || N > N_MAX) return -1;
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt); p.cs = static_cast<const float*>(cs);
  p.bm = bm; p.cm = cm; p.y = y;
  p.h_last = static_cast<float*>(h_last); p.st = static_cast<float*>(st);
  p.B = B; p.nc = nc; p.c = c; p.H = H; p.P = P; p.N = N;
  p.x_sb = x_sb; p.x_sz = x_sz; p.x_si = x_si; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_sz = dt_sz; p.dt_si = dt_si; p.dt_sh = dt_sh;
  p.cs_sb = cs_sb; p.cs_sz = cs_sz; p.cs_si = cs_si; p.cs_sh = cs_sh;
  p.b_sb = b_sb; p.b_sz = b_sz; p.b_si = b_si;
  p.c_sb = c_sb; p.c_sz = c_sz; p.c_si = c_si;
  p.y_sb = y_sb; p.y_sz = y_sz; p.y_si = y_si; p.y_sh = y_sh;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, st_);
  if (dtype == 1 && P % 16 == 0 && N % 16 == 0) return (int)launch_mma(p, st_);
  return -1;
}

extern "C" const char* repro_ssd_scan_error(int code) {
  if (code == -1)
    return "unsupported dtype, head dim (P > 64) or state (N > 128), or in bf16 "
           "a P or N that is no multiple of 16";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
