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
//   1. ssd_state_kernel, one block per (b, h, z): the chunk's own contribution
//      S_z = (x ⊙ e^{cs_last - cs} dt)ᵀ B, into f32 scratch laid out (N, P);
//   2. ssd_carry_kernel, one thread per (b, h, n, p): the serial pass over the
//      nc chunks, replacing each S_z in place by the state ENTERING chunk z and
//      writing the final state;
//   3. ssd_output_kernel, one block per (b, h, z, 64-row tile of the chunk):
//      y = e^{cs_i} C_i · state_z + Σ_{j <= i} (C_i · B_j) e^{cs_i - cs_j} dt_j x_j,
//      the j loop over 64-key tiles up to the diagonal tile only.
//
// Bound on an H100: at the path's shapes, bytes and operations are close (see
// PERF.md).  This first version runs all products as f32 FMAs on the CUDA
// cores from shared memory, 4 x 4 outputs per thread.  A 256-step chunk does
// not fit a block's 227 KB (x 64 KB + B 128 KB + C 128 KB + the 256 x 256
// score tile in f32), so rows and keys are tiled by 64: C (64 x N) and one
// B/x key tile are resident, the 64 x 64 weight tile is rebuilt per key tile.
// (Staging each tile's loads in registers with the next tile's in flight
// was measured and was slower: it spills at 128 registers.  PERF.md.)
// e^{cs_i - cs_j} is evaluated only where j <= i: above the diagonal the
// exponent is positive and could overflow, and inf * 0 would poison y.
// All inputs are read through their strides: x (B,nc,c,H,P), dt/cs
// (B,nc,c,H) and B/C (B,nc,c,N) are views of the model's tensors, no copies.
// P <= 64 and N <= 128 (every mamba2 config of the repo: P 64, N 128).
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
// dtype or a P / N the kernel was not built for.
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
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, st_);
  return -1;
}

extern "C" const char* repro_ssd_scan_error(int code) {
  if (code == -1) return "unsupported dtype, head dim (P > 64) or state (N > 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
