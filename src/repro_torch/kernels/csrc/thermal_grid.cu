// K6, the thermal grid for sm_90a, plain C interface.
//
// Replaces no TPU kernel: the reference computes `binned_power_trace` and
// `peak_temperature` of src/repro/dse/thermal_jax.py with jnp under vmap,
// outside any Pallas kernel, and the port's eager twin
// (`peak_temperature_grid_plain` in dse/thermal_torch.py) issued ~725 small
// launches per chunk of ~200 lanes.  This kernel computes the same function
// for every lane of a (..., D, S) grid in one launch:
//   1. bin: each lane's schedule (J*T cells of start, finish, PE and the
//      scheduled flag) is cut into `bins` equal bins of its makespan; a PE's
//      busy time in a bin is the sum of its cells' overlaps
//      min(min(f, e_k + dt) - max(s, e_k), dt), clamped at 0, e_k = k*dt;
//   2. power: util = clamp(busy / dt, 0, 1), a PE draws
//      active*util + idle*(1 - util), and the PEs fold onto the 3 nodes;
//   3. step: from the steady state of the period-mean power, bins*repeats
//      exact RC steps x' = A x + B u (A and B built from the host's float64
//      spectral pair, `core.thermal._rc_spectral`, as float32 constants,
//      summed in `exact_step_matrices`' order), the hottest node seen kept.
//
// Bound on an H100: instructions.  A lane's schedule is read once (13 bytes
// a cell: ~104 KB a lane of 1,000 jobs x 8 tasks), but every cell is tested
// against every bin (8,000 x 32 overlaps a lane), so the work is ~15 warp
// instructions a cell a warp.  Design:
//   * A block of WARPS warps a lane.  Warp w takes the lane's 32-cell tiles
//     w, w + WARPS, ... (coalesced loads, the next tile's loaded before the
//     current one is walked); each cell of a tile is broadcast by shuffles
//     and thread k of the warp tests it against bin k of the pass (passes of
//     32 bins cover any `bins`).  A cell that no thread overlaps, and an
//     unscheduled cell, adds nothing: only an exactly zero term is skipped.
//   * Sums run in one fixed order and use no atomics: within a warp by cell
//     index, then the warps' partial sums in warp order, then the PEs of a
//     node in PE order.  A lane's bits depend on that lane's inputs alone
//     (padding the job axis adds only unscheduled cells), so a lane alone,
//     inside any grid and in any shard gives the same bits.
//   * The RC phase is one warp: thread r owns row r of A and B, the state is
//     exchanged by shuffles each step.  Float32 throughout, `expf` (not
//     `__expf`), products and sums rounded op by op (`__fmul_rn`,
//     `__fadd_rn`) where the plain version rounds them so.
//
// A PE index outside 0..P-1 on any cell, or a node index outside 0..2,
// traps: a launch error at the host's next synchronisation, as the plain
// version's one-hot fails a device-side assert on CUDA tensors (it raises on
// CPU tensors).  A trap, not `assert`: the assert's call kept a stack frame
// in local memory.  K1 writes neither.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_P = 32;
constexpr int NODES = 3;
constexpr int MAX_SHARED = 232448;

// the entry points' argument errors (negative, so no cudaError_t), named by
// repro_thermal_grid_error
enum ArgError { BAD_GRID = -1, BAD_PES = -2, BAD_STEPS = -3, BAD_SHARED = -4, BAD_CONSTS = -5 };

// the RC network's float32 constants, in the order the wrapper packs them
struct Consts {
  float lam[4];           // eigenvalues of the RC state matrix
  float proj[4][4][4];    // rank-1 projectors P_j, row-major
  float r_to_board[NODES];
  float c_node[NODES];
  float t_ambient, r_board_amb, c_board;
};
constexpr int NUM_CONSTS = sizeof(Consts) / sizeof(float);

struct Params {
  const float* start;            // (L, JT)
  const float* finish;
  const int* onpe;
  const unsigned char* scheduled;
  const float* makespan;         // (L,)
  const int* node_of_pe;         // (D, P)
  const float* p_active;
  const float* p_idle;
  float* peak;                   // (L,)
  int D, S, JT, P, bins, repeats;
  Consts c;
};

// dynamic shared memory, in floats: the warps' partial busy sums (WARPS, P,
// 32), then each bin's node power and drive (bins, 2 * NODES), then the
// design's PE tables (3 * P)
inline long long shared_floats(int P, int bins) {
  return (long long)WARPS * P * 32 + 2LL * NODES * bins + 3LL * P;
}

// a[i] for a runtime i in 0..3 by selects: a kernel parameter indexed at run
// time would be copied to local memory
__device__ __forceinline__ float pick(const float* a, int n, int i) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (j < n && i == j) v = a[j];
  return v;
}

// cell c of a lane's schedule: start, finish and PE where it is scheduled,
// PE -1 where it is not (or past the lane's JT cells); every cell's PE must
// lie in 0..P-1
__device__ __forceinline__ void load_cell(const float* st, const float* fi, const int* pe,
                                          const unsigned char* sc, int c, int JT, int P,
                                          float& s, float& f, int& q) {
  s = 0.f; f = 0.f; q = -1;
  if (c >= JT) return;
  const int on = pe[c];
  if (on < 0 || on >= P) __trap();
  if (sc[c]) { s = st[c]; f = fi[c]; q = on; }
}

__global__ void __launch_bounds__(THREADS) thermal_grid_kernel(const Params p) {
  extern __shared__ float smem[];
  const int P = p.P, bins = p.bins;
  float* part = smem;                                   // [w][pe][k]
  float* power = part + WARPS * P * 32;                 // [k][node]
  float* drive = power + NODES * bins;                  // [k][node]: power / c_node
  int* node = reinterpret_cast<int*>(drive + NODES * bins);
  float* p_act = reinterpret_cast<float*>(node + P);
  float* p_idle = p_act + P;

  const long long l = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int d = (int)((l / p.S) % p.D);
  if (tid < P) {
    node[tid] = p.node_of_pe[d * P + tid];
    if (node[tid] < 0 || node[tid] >= NODES) __trap();
    p_act[tid] = p.p_active[d * P + tid];
    p_idle[tid] = p.p_idle[d * P + tid];
  }
  const float m = p.makespan[l];
  const float dt = __fdiv_rn(m < 1e-6f ? 1e-6f : m, (float)bins);   // us

  const long long base = l * (long long)p.JT;
  const float* st = p.start + base;
  const float* fi = p.finish + base;
  const int* pe = p.onpe + base;
  const unsigned char* sc = p.scheduled + base;
  float* mine = part + w * P * 32;

  for (int k0 = 0; k0 < bins; k0 += 32) {
    const int k = k0 + lane;
    const bool active = k < bins;
    const float e0 = __fmul_rn((float)k, dt);
    const float e1 = __fadd_rn(e0, dt);
    for (int q = 0; q < P; ++q) mine[q * 32 + lane] = 0.f;
    __syncwarp();
    // register double buffer: tile c's cell `lane`
    float s_n, f_n;
    int pe_n;
    load_cell(st, fi, pe, sc, w * 32 + lane, p.JT, P, s_n, f_n, pe_n);
    for (int t0 = w * 32; t0 < p.JT; t0 += WARPS * 32) {
      const float s = s_n, f = f_n;
      const int q = pe_n;
      load_cell(st, fi, pe, sc, t0 + WARPS * 32 + lane, p.JT, P, s_n, f_n, pe_n);
      unsigned todo = __ballot_sync(FULL_MASK, q >= 0);
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const float si = __shfl_sync(FULL_MASK, s, i);
        const float fi_ = __shfl_sync(FULL_MASK, f, i);
        const int qi = __shfl_sync(FULL_MASK, q, i);
        const float ov = __fsub_rn(fminf(fi_, e1), fmaxf(si, e0));
        if (active && ov > 0.f) {
          float* b = mine + qi * 32 + lane;
          *b = __fadd_rn(*b, fminf(ov, dt));
        }
      }
    }
    __syncthreads();
    // fold: thread (node n, bin k) sums its node's PEs in PE order
    if (tid < NODES * 32) {
      const int n = tid >> 5, kk = k0 + lane;
      if (kk < bins) {
        float acc = 0.f;
        for (int q = 0; q < P; ++q) {
          if (node[q] != n) continue;
          float b = part[q * 32 + lane];
          for (int v = 1; v < WARPS; ++v) b = __fadd_rn(b, part[(v * P + q) * 32 + lane]);
          float u = __fdiv_rn(b, dt);
          u = fminf(fmaxf(u, 0.f), 1.f);
          acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(p_act[q], u),
                                         __fmul_rn(p_idle[q], __fsub_rn(1.f, u))));
        }
        power[kk * NODES + n] = acc;
        drive[kk * NODES + n] = __fdiv_rn(acc, pick(p.c.c_node, NODES, n));
      }
    }
    __syncthreads();
  }
  if (w != 0) return;

  // steady state of the period-mean power (every thread of warp 0 alike)
  float mean[NODES];
#pragma unroll
  for (int n = 0; n < NODES; ++n) {
    float acc = 0.f;
    for (int k = 0; k < bins; ++k) acc = __fadd_rn(acc, power[k * NODES + n]);
    mean[n] = __fdiv_rn(acc, (float)bins);
  }
  const float tb = __fadd_rn(p.c.t_ambient,
                             __fmul_rn(p.c.r_board_amb, __fadd_rn(__fadd_rn(mean[0], mean[1]),
                                                                  mean[2])));
  const int r = lane & 3;
  float t = r < NODES ? __fadd_rn(tb, __fmul_rn(pick(p.c.r_to_board, NODES, r),
                                                 pick(mean, NODES, r)))
                      : tb;
  float peak = r < NODES ? t : -__int_as_float(0x7f800000);

  // this lane's row of A = sum_j e^{lam_j dt} P_j and B = sum_j (e^{lam_j dt} - 1)/lam_j P_j
  const float dt_s = __fmul_rn(dt, 1e-6f);
  float a_row[4], b_row[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lam = p.c.lam[j];
    const float e = expf(__fmul_rn(lam, dt_s));
    const float g = __fdiv_rn(__fsub_rn(e, 1.f), lam);
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const float pj_r[4] = {p.c.proj[j][0][col], p.c.proj[j][1][col], p.c.proj[j][2][col],
                             p.c.proj[j][3][col]};
      const float pj = pick(pj_r, 4, r);
      const float a_t = __fmul_rn(e, pj), b_t = __fmul_rn(g, pj);
      a_row[col] = j == 0 ? a_t : __fadd_rn(a_row[col], a_t);
      b_row[col] = j == 0 ? b_t : __fadd_rn(b_row[col], b_t);
    }
  }
  const float amb = __fdiv_rn(p.c.t_ambient, __fmul_rn(p.c.r_board_amb, p.c.c_board));
  const int steps = bins * p.repeats;
  for (int i = 0, k = 0; i < steps; ++i, k = k + 1 == bins ? 0 : k + 1) {
    const float x[4] = {__shfl_sync(FULL_MASK, t, 0), __shfl_sync(FULL_MASK, t, 1),
                        __shfl_sync(FULL_MASK, t, 2), __shfl_sync(FULL_MASK, t, 3)};
    const float u[4] = {drive[k * NODES], drive[k * NODES + 1], drive[k * NODES + 2], amb};
    float ax = __fmul_rn(a_row[0], x[0]), bu = __fmul_rn(b_row[0], u[0]);
#pragma unroll
    for (int col = 1; col < 4; ++col) {
      ax = __fadd_rn(ax, __fmul_rn(a_row[col], x[col]));
      bu = __fadd_rn(bu, __fmul_rn(b_row[col], u[col]));
    }
    t = __fadd_rn(ax, bu);
    if (r < NODES) peak = fmaxf(peak, t);
  }
  peak = fmaxf(peak, __shfl_xor_sync(FULL_MASK, peak, 1));
  peak = fmaxf(peak, __shfl_xor_sync(FULL_MASK, peak, 2));
  if (lane == 0) p.peak[l] = peak;
}

}  // namespace

// the one check of (P, bins, repeats) for both entry points: 0 or an ArgError
static int check_args(int P, int bins, int repeats) {
  if (P < 1 || P > MAX_P) return BAD_PES;
  if (bins < 1 || repeats < 0) return BAD_STEPS;
  if (4 * shared_floats(P, bins) > MAX_SHARED) return BAD_SHARED;
  return 0;
}

// Schedules of L lanes (start, finish f32, onpe i32, scheduled bool bytes;
// each (L, J*T) contiguous), makespan (L,) f32, each design's node_of_pe
// (D, P) i32 and active / idle power (D, P) f32 (lane l reads design
// (l / S) % D), the RC constants (`consts`, `n_consts` floats in `Consts`'
// order, host memory) -> peak (L,) f32.  One launch of L blocks.  Returns 0,
// an ArgError (nothing launched) or a cudaError_t.
extern "C" int repro_thermal_grid(const void* start, const void* finish, const void* onpe,
                                  const void* scheduled, const void* makespan,
                                  const void* node_of_pe, const void* p_active,
                                  const void* p_idle, const float* consts, int n_consts,
                                  void* peak, int L, int D, int S, int JT, int P, int bins,
                                  int repeats, void* stream) {
  if (L < 1 || D < 1 || S < 1 || JT < 0 || L % S != 0 || (L / S) % D != 0) return BAD_GRID;
  if (n_consts != NUM_CONSTS) return BAD_CONSTS;
  const int bad = check_args(P, bins, repeats);
  if (bad) return bad;
  const int bytes = (int)(4 * shared_floats(P, bins));
  Params p;
  p.start = static_cast<const float*>(start);
  p.finish = static_cast<const float*>(finish);
  p.onpe = static_cast<const int*>(onpe);
  p.scheduled = static_cast<const unsigned char*>(scheduled);
  p.makespan = static_cast<const float*>(makespan);
  p.node_of_pe = static_cast<const int*>(node_of_pe);
  p.p_active = static_cast<const float*>(p_active);
  p.p_idle = static_cast<const float*>(p_idle);
  p.peak = static_cast<float*>(peak);
  p.D = D; p.S = S; p.JT = JT; p.P = P; p.bins = bins; p.repeats = repeats;
  float* dst = reinterpret_cast<float*>(&p.c);
  for (int i = 0; i < NUM_CONSTS; ++i) dst[i] = consts[i];
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        thermal_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  thermal_grid_kernel<<<(unsigned)L, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The kernel's geometry at (P, bins): threads a block, dynamic shared bytes,
// resident blocks an SM, registers a thread, local bytes a thread.  Returns
// 0, an ArgError or a cudaError_t.
extern "C" int repro_thermal_grid_info(int P, int bins, int* out) {
  const int bad = check_args(P, bins, 0);
  if (bad) return bad;
  const int bytes = (int)(4 * shared_floats(P, bins));
  cudaError_t rc = cudaSuccess;
  if (bytes > 48 * 1024)
    rc = cudaFuncSetAttribute(thermal_grid_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int per_sm = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, thermal_grid_kernel, THREADS,
                                                       bytes);
  cudaFuncAttributes attr{};
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, thermal_grid_kernel);
  out[0] = THREADS; out[1] = bytes; out[2] = per_sm;
  out[3] = attr.numRegs; out[4] = (int)attr.localSizeBytes;
  return (int)rc;
}

extern "C" const char* repro_thermal_grid_error(int code) {
  switch (code) {
    case BAD_GRID: return "the lanes are not a (..., D, S) grid of one lane or more";
    case BAD_PES: return "the kernel takes 1..32 PEs";
    case BAD_STEPS: return "the kernel takes bins >= 1 and repeats >= 0";
    case BAD_SHARED: return "the bins' and PEs' sums need more shared memory than a block has";
    case BAD_CONSTS: return "the RC constants are not the kernel's count";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
