// K7, the epilogue for sm_90a, plain C interface.
//
// Replaces no TPU kernel: the reference derives latency, energy and per-PE
// busy time from the scan's schedule with XLA arithmetic after the scan
// (src/repro/core/simkernel_jax.py:533-571), outside any Pallas kernel, and
// the port's eager twin (`epilogue_plain` in kernels/epilogue.py) issued
// ~300 small launches a grid scan: an int64 copy of the PE indices, P masked
// passes over the (L, J*T) cells, and a zero-padded halving tree of 13-19
// launches for every sum.  This kernel computes the same outputs for every
// lane of a scan in one launch, from one read of K1's schedule:
//   * job_finish (L, J): each job's latest finish over its valid tasks, and
//     makespan (L,) their maximum;
//   * avg_job_latency (L,): the sum over jobs of job_finish - arrival, times
//     1/J (PyTorch divides a CUDA tensor by a scalar so: the eager version's
//     bits on the card; on the CPU it divides, up to one ulp away);
//   * busy_per_pe (L, P): each PE's sum of finish - start over the valid
//     cells it ran;
//   * energy (L,): (sum over cells of busy * the PE's active power, at the
//     task's latched OPP under DTPM, + sum over PEs of idle power *
//     max(makespan - busy, 0)) * 1e-6.
// A cell that is not valid adds a selected +0 (as `torch.where` does), never
// a product with a mask: K1 leaves such cells unwritten, and NaN * 0 is NaN.
//
// Every sum has the bits of `tree_sum` (kernels/epoch_scan.py): n values
// zero-padded to W = 2^m and halved m times, each step adding the top half
// onto the bottom half.  After k halvings position i holds the total of the
// values i (mod W / 2^k), combined in that fixed order, so:
//   * thread t of a warp owns the values t (mod 32), i.e. column t of
//     R = W / 32 rows of 32 consecutive values (loads coalesced; W < 32: one
//     row of W columns);
//   * a column's tree folds the top row bit first, which is the adjacent
//     pair tree over the rows taken in bit-reversed order.  A thread takes
//     the rows in that order in groups of 4 (their tree in registers) and
//     combines the groups through a binary-counter stack of partials,
//     [level][slot][thread] (no bank conflicts): the low levels in shared
//     memory, the levels touched once in 64 groups or less in global scratch;
//   * the warp folds the 32 column totals as the last 5 halvings, t += t + h
//     by shuffles for h = 16 .. 1 (only min(32, W) columns).
// A lane (a simulation) is one block of three warps.  Its sums over the J*T
// cells are P + 1 slots: PE p's busy time in slot p, the active energy in the
// last; a cell adds its busy time to its PE's slot and a selected +0 to every
// other, as the eager `where(onpe == pe, busy, 0)` passes did.  Two cell
// warps split the rows by their lowest bit (the last row halving, which
// joins the two warps' column totals in shared memory); the third warp sums
// over the J jobs (job_finish, makespan, the latency) meanwhile.  The idle
// energy, a tree over the P PEs, is one thread's.  A lane's bits thus depend
// on its own inputs and shapes only: alone, in a sweep, in a chunk or a
// shard alike, and equal to the eager version's, which stays the kernel's
// exact oracle.  No atomics.
//
// Bound on an H100: bytes.  The schedule is read once (start, finish, PE,
// and the latched OPP under DTPM: 12-16 B a cell) plus finish once more by
// the job warp (4 B), the lanes' arrival and app index (8 B a job), and each
// lane's design row of the tables into shared memory.  At 1,024 lanes x
// 320,000 cells that is ~6.6 GB, ~2 ms at 3.35 TB/s.  The design is for
// bytes in flight: a stack level takes 2 KB a cell warp at 15 PEs, so six
// shared levels keep a lane to ~26 KB and 8 lanes (24 warps) on an SM, and a
// cell warp issues a group's loads before it sums the group before.
//
// Indices are checked where the eager version's indexing would fail: an app
// index outside 0..A-1 of a job, or on a valid cell a PE outside 0..P-1 or
// an OPP outside 0..K-1, traps (a launch error at the host's next
// synchronisation).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int LOG_GROUP = 2;        // a thread folds GROUP rows in registers
constexpr int GROUP = 1 << LOG_GROUP;
constexpr int ROW_WARPS = 2;        // cell warps a lane, each a residue of the rows
constexpr int SHARED_LEVELS = 6;    // stack levels in shared memory; the rest in `spill`
constexpr int MAX_SLOTS = 80;       // the widest instantiation: 79 PEs + e_active
constexpr int MAX_SHARED = 232448;  // bytes of dynamic shared memory a block may take

// the entry points' argument errors (negative, so no cudaError_t), named by
// repro_epilogue_error
enum ArgError { BAD_GRID = -1, BAD_PES = -2, BAD_SHAPE = -3, BAD_SHARED = -4 };

struct Params {
  const float* start;            // (L, JT)
  const float* finish;
  const int* onpe;
  const int* onopp;              // DTPM only
  const float* arrival;          // (L, J)
  const int* app;
  const unsigned char* valid;    // (D, A, T)
  const float* p_active;         // (D, P), or (D, P, K) under DTPM
  const float* p_idle;           // (D, P)
  float* spill;                  // (L, ROW_WARPS, spill levels, SLOTS, 32) scratch
  float* job_finish;             // (L, J)
  float* makespan;               // (L,)
  float* latency;
  float* energy;
  float* busy;                   // (L, P)
  int S, J, T, A, P, K;
  unsigned magic;                // ceil(2^32 / T): c / T by one high multiply
  int width_c;                   // columns of the cells (32, or W when W < 32)
  int row_warps, rho_r;          // cell warps used, log2 of the rows each takes
  int rho_j, width_j;            // the job warp's: log2 of its rows, its columns
  int width_p;                   // P padded to a power of two
  int shared_levels, spill_levels;  // a cell warp's stack levels in each
};

// a tree_sum's geometry over n >= 1 values: W = 2^m >= n; 32 columns of
// R = 2^rho = W / 32 rows (one row of W columns when W < 32)
struct Geometry {
  int rho, width;
};

inline Geometry geometry(long long n) {
  int m = 0;
  while ((1LL << m) < n) ++m;
  return m >= 5 ? Geometry{m - 5, 32} : Geometry{0, 1 << m};
}

// stack levels of a column of 2^rho rows taken GROUP rows at a time
__host__ __device__ inline int levels(int rho) { return rho > LOG_GROUP ? rho - LOG_GROUP : 0; }

__host__ __device__ constexpr int log2_of(int n) { return n > 1 ? 1 + log2_of(n / 2) : 0; }

// bits 0..rho-1 of k reversed
__device__ __forceinline__ unsigned rev(unsigned k, int rho) {
  return rho ? __brev(k) >> (32 - rho) : 0u;
}

// c / T for c < 2^32: the high multiply is floor(c / T) or one above it
__device__ __forceinline__ unsigned job_of(unsigned c, unsigned T, unsigned magic) {
  if (T == 1) return c;                         // magic would be 2^32
  const unsigned q = __umulhi(c, magic);
  return q * T > c ? q - 1 : q;
}

// torch.amax's maximum: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// the adjacent-pair tree over GR leaves taken in bit-reversed row order
template <int GR>
__device__ __forceinline__ float group_tree(const float (&x)[GROUP]) {
  float v[GR];
#pragma unroll
  for (int i = 0; i < GR; ++i) v[i] = x[i];
#pragma unroll
  for (int w = GR; w > 1; w >>= 1) {
#pragma unroll
    for (int i = 0; i < w / 2; ++i) v[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
  }
  return v[0];
}

// A column's binary-counter stack: level j of N slots at
// level(j)[slot * 32 + column], the first `shared` levels in shared memory,
// the rest in global memory (touched once every 2^j groups)
struct Stack {
  float* sh;
  float* gl;
  int shared, levels;
  __device__ __forceinline__ float* level(int j, int N) const {
    return j < shared ? sh + j * N * 32 : gl + (j - shared) * N * 32;
  }
};

// Group q's N-slot value into the stack: merged with the completed groups
// to its left while q's low bits are ones, then stored.  After the last of
// 2^levels groups `carry` holds the column's total.
template <int N>
__device__ __forceinline__ void push(const Stack& st, int col, unsigned q, float (&carry)[N]) {
  int j = 0;
  for (; j < st.levels && ((q >> j) & 1u); ++j) {
    const float* s = st.level(j, N) + col;
#pragma unroll
    for (int i = 0; i < N; ++i) carry[i] = __fadd_rn(s[i * 32], carry[i]);
  }
  if (j < st.levels) {
    float* s = st.level(j, N) + col;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i * 32] = carry[i];
  }
}

// the warp's last halvings over `width` column totals; thread 0 holds the sum
template <int N>
__device__ __forceinline__ void fold_columns(float (&v)[N], int width) {
  for (int h = width >> 1; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __fadd_rn(v[i], __shfl_down_sync(FULL_MASK, v[i], h));
  }
}

// The job warp over GR-row groups: job_finish written, each job's latency
// folded into carry[0], the thread's makespan into `span`.  A group's finish
// loads do not wait for its app indices (the valid flags select afterwards),
// so a job's tasks are in flight together.
template <int GR>
__device__ __forceinline__ void job_groups(const Params& p, long long lane_job,
                                           const unsigned char* valid, const Stack& st,
                                           int col, float& span, float (&carry)[1]) {
  const int rho = p.rho_j, T = p.T;
  const unsigned groups = (1u << rho) / GR;
  const int* app = p.app + lane_job;
  const float* arrival = p.arrival + lane_job;
  const float* finish = p.finish + lane_job * T;
  for (unsigned q = 0; q < groups; ++q) {
    unsigned j[GROUP];
    int a[GROUP];
    float m[GROUP], lat[GROUP];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      j[i] = rev(q * GR + i, rho) * p.width_j + col;
      a[i] = j[i] < (unsigned)p.J ? __ldg(app + j[i]) : 0;
      m[i] = -__int_as_float(0x7f800000);
    }
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      float f[GROUP];
#pragma unroll
      for (int i = 0; i < GR; ++i)
        f[i] = j[i] < (unsigned)p.J ? __ldg(finish + j[i] * T + t) : 0.f;
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        const int ai = (unsigned)a[i] < (unsigned)p.A ? a[i] : 0;   // trapped below
        m[i] = nan_max(m[i], valid[ai * T + t] ? f[i] : 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      lat[i] = 0.f;
      if (j[i] < (unsigned)p.J) {
        if (a[i] < 0 || a[i] >= p.A) __trap();
        p.job_finish[lane_job + j[i]] = m[i];
        span = nan_max(span, m[i]);
        lat[i] = __fsub_rn(m[i], __ldg(arrival + j[i]));
      }
    }
    carry[0] = group_tree<GR>(lat);
    push<1>(st, col, q, carry);
  }
}

// one group's cells, as loaded
struct Cells {
  int app[GROUP], on[GROUP], opp[GROUP];
  float s[GROUP], f[GROUP];
};

// row i of cell warp w's group q: its cell in column `col`
template <int GR>
__device__ __forceinline__ unsigned cell_of(const Params& p, unsigned q, int i, int w, int col) {
  return (rev(q * GR + i, p.rho_r) * p.row_warps + w) * p.width_c + col;
}

// group q's loads, issued together
template <bool DTPM, int GR>
__device__ __forceinline__ void load_cells(const Params& p, long long lane_cell,
                                           long long lane_job, unsigned q, int w, int col,
                                           Cells& x) {
  const unsigned JT = (unsigned)p.J * (unsigned)p.T;
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    const unsigned c = cell_of<GR>(p, q, i, w, col);
    x.s[i] = x.f[i] = 0.f;
    x.on[i] = x.opp[i] = x.app[i] = 0;
    if (c < JT) {
      x.app[i] = __ldg(p.app + lane_job + job_of(c, p.T, p.magic));
      x.s[i] = __ldg(p.start + lane_cell + c);
      x.f[i] = __ldg(p.finish + lane_cell + c);
      x.on[i] = __ldg(p.onpe + lane_cell + c);
      if (DTPM) x.opp[i] = __ldg(p.onopp + lane_cell + c);
    }
  }
}

// group q of cell warp w, its cells loaded: slot pe < SLOTS - 1 takes PE
// pe's busy time, slot SLOTS - 1 the active energy, into the stack
template <bool DTPM, int SLOTS, int GR>
__device__ __forceinline__ void fold_cells(const Params& p, const Cells& x, unsigned q, int w,
                                           const unsigned char* valid, const float* p_act,
                                           const Stack& st, int col, float (&carry)[SLOTS]) {
  const unsigned JT = (unsigned)p.J * (unsigned)p.T;
  float busy[GROUP], ea[GROUP];
  int pe[GROUP];
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    busy[i] = 0.f;
    ea[i] = 0.f;
    pe[i] = -1;
    const unsigned c = cell_of<GR>(p, q, i, w, col);
    if (c < JT) {
      const int a = x.app[i], on = x.on[i];
      if (a < 0 || a >= p.A) __trap();
      if (valid[a * p.T + (c - job_of(c, p.T, p.magic) * p.T)]) {
        if (on < 0 || on >= p.P) __trap();
        float pw;
        if (DTPM) {
          if (x.opp[i] < 0 || x.opp[i] >= p.K) __trap();
          pw = p_act[on * p.K + x.opp[i]];
        } else {
          pw = p_act[on];
        }
        busy[i] = __fsub_rn(x.f[i], x.s[i]);
        ea[i] = __fmul_rn(busy[i], pw);
        pe[i] = on;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SLOTS - 1; ++k) {
    float v[GROUP];
#pragma unroll
    for (int i = 0; i < GR; ++i) v[i] = pe[i] == k ? busy[i] : 0.f;
    carry[k] = group_tree<GR>(v);
  }
  carry[SLOTS - 1] = group_tree<GR>(ea);
  push<SLOTS>(st, col, q, carry);
}

// cell warp w over GR-row groups, each group's loads issued before the
// group before it is summed
template <bool DTPM, int SLOTS, int GR>
__device__ __forceinline__ void cell_groups(const Params& p, long long lane_cell,
                                            long long lane_job, int w,
                                            const unsigned char* valid, const float* p_act,
                                            const Stack& st, int col, float (&carry)[SLOTS]) {
  const unsigned groups = (1u << p.rho_r) / GR;
  Cells cur, next;
  load_cells<DTPM, GR>(p, lane_cell, lane_job, 0, w, col, cur);
  for (unsigned q = 0; q < groups; ++q) {
    if (q + 1 < groups) load_cells<DTPM, GR>(p, lane_cell, lane_job, q + 1, w, col, next);
    fold_cells<DTPM, SLOTS, GR>(p, cur, q, w, valid, p_act, st, col, carry);
    cur = next;
  }
}

// the passes at the widest group a column's 2^rho rows fill
template <int GR>
__device__ __forceinline__ void jobs(const Params& p, long long lane_job,
                                     const unsigned char* valid, const Stack& st, int col,
                                     float& span, float (&carry)[1]) {
  if constexpr (GR == 1)
    job_groups<1>(p, lane_job, valid, st, col, span, carry);
  else if (p.rho_j >= log2_of(GR))
    job_groups<GR>(p, lane_job, valid, st, col, span, carry);
  else
    jobs<GR / 2>(p, lane_job, valid, st, col, span, carry);
}

template <bool DTPM, int SLOTS, int GR>
__device__ __forceinline__ void cells(const Params& p, long long lane_cell, long long lane_job,
                                      int w, const unsigned char* valid, const float* p_act,
                                      const Stack& st, int col, float (&carry)[SLOTS]) {
  if constexpr (GR == 1)
    cell_groups<DTPM, SLOTS, 1>(p, lane_cell, lane_job, w, valid, p_act, st, col, carry);
  else if (p.rho_r >= log2_of(GR))
    cell_groups<DTPM, SLOTS, GR>(p, lane_cell, lane_job, w, valid, p_act, st, col, carry);
  else
    cells<DTPM, SLOTS, GR / 2>(p, lane_cell, lane_job, w, valid, p_act, st, col, carry);
}

// floats of a cell warp's region of shared memory: its stack's shared levels,
// at least one level (it holds the warp's column totals at the end)
__host__ __device__ inline int region_floats(int shared_levels, int slots) {
  return (shared_levels > 1 ? shared_levels : 1) * slots * 32;
}

// One block a lane: ROW_WARPS cell warps (warp w takes the rows w (mod
// row_warps)), then the job warp.  Dynamic shared memory, in floats: the cell
// warps' regions, the job warp's stack, the idle tree, the job warp's
// makespan and latency sum, the design's active and idle power; then its
// valid flags as bytes.
template <bool DTPM, int SLOTS>
__global__ void __launch_bounds__((ROW_WARPS + 1) * 32, SLOTS <= 16 ? 8 : 4)
    epilogue_kernel(const Params p) {
  extern __shared__ float smem[];
  const int P = p.P, T = p.T;
  const int region = region_floats(p.shared_levels, SLOTS);
  float* job_stack = smem + ROW_WARPS * region;
  float* idle = job_stack + levels(p.rho_j) * 32;
  float* jobs_out = idle + p.width_p;
  float* p_act = jobs_out + 2;
  const int n_act = DTPM ? P * p.K : P;
  float* p_idle = p_act + n_act;
  unsigned char* valid = reinterpret_cast<unsigned char*>(p_idle + P);

  const long long l = blockIdx.x;
  const long long d = l / p.S;
  const int warp = threadIdx.x >> 5, col = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n_act; i += blockDim.x) p_act[i] = p.p_active[d * n_act + i];
  for (int i = threadIdx.x; i < P; i += blockDim.x) p_idle[i] = p.p_idle[d * P + i];
  for (int i = threadIdx.x; i < p.A * T; i += blockDim.x) valid[i] = p.valid[d * p.A * T + i];
  __syncthreads();

  const long long lane_job = l * p.J;
  if (warp == ROW_WARPS) {
    float span = -__int_as_float(0x7f800000);
    float lat[1];
    const Stack st{job_stack, nullptr, levels(p.rho_j), levels(p.rho_j)};
    jobs<GROUP>(p, lane_job, valid, st, col, span, lat);
    fold_columns<1>(lat, p.width_j);
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) span = nan_max(span, __shfl_xor_sync(FULL_MASK, span, h));
    if (col == 0) {
      jobs_out[0] = span;
      jobs_out[1] = lat[0];
    }
  } else if (warp < p.row_warps) {
    float* mine = smem + warp * region;
    const Stack st{mine,
                   p.spill + (l * ROW_WARPS + warp) * (long long)p.spill_levels * SLOTS * 32,
                   p.shared_levels, p.shared_levels + p.spill_levels};
    float acc[SLOTS];
    cells<DTPM, SLOTS, GROUP>(p, lane_job * T, lane_job, warp, valid, p_act, st, col, acc);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) mine[k * 32 + col] = acc[k];
  }
  __syncthreads();
  if (warp != 0) return;

  // the cell warps' column totals folded (the last row halvings), then the
  // columns (the last 5 halvings)
  float acc[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    float v[ROW_WARPS];
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w)
      v[w] = w < p.row_warps ? smem[w * region + k * 32 + col] : 0.f;
#pragma unroll
    for (int h = ROW_WARPS / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int i = 0; i < h; ++i)
        if (2 * h <= p.row_warps) v[i] = __fadd_rn(v[i], v[i + h]);
    }
    acc[k] = v[0];
  }
  fold_columns<SLOTS>(acc, p.width_c);
  if (col != 0) return;

  // idle energy: a tree over the P PEs, zero-padded to width_p
  const float span = jobs_out[0];
#pragma unroll
  for (int k = 0; k < SLOTS - 1; ++k) {
    if (k < P) {
      p.busy[l * P + k] = acc[k];
      float gap = __fsub_rn(span, acc[k]);
      gap = gap < 0.f ? 0.f : gap;
      idle[k] = __fmul_rn(p_idle[k], gap);
    }
  }
  for (int k = P; k < p.width_p; ++k) idle[k] = 0.f;
  for (int h = p.width_p >> 1; h >= 1; h >>= 1)
    for (int k = 0; k < h; ++k) idle[k] = __fadd_rn(idle[k], idle[k + h]);
  p.makespan[l] = span;
  p.latency[l] = __fmul_rn(jobs_out[1], __fdiv_rn(1.f, (float)p.J));
  p.energy[l] = __fmul_rn(__fadd_rn(acc[SLOTS - 1], idle[0]), 1e-6f);
}

// the slot count of the instantiation that takes P PEs (0: none does)
inline int slots_for(int P) {
  return P < 16 ? 16 : P < 32 ? 32 : P < MAX_SLOTS ? MAX_SLOTS : 0;
}

template <bool DTPM, int SLOTS>
void* kernel_of() {
  return reinterpret_cast<void*>(epilogue_kernel<DTPM, SLOTS>);
}

void* kernel_for(bool dtpm, int slots) {
  switch (slots) {
    case 16: return dtpm ? kernel_of<true, 16>() : kernel_of<false, 16>();
    case 32: return dtpm ? kernel_of<true, 32>() : kernel_of<false, 32>();
    default: return dtpm ? kernel_of<true, MAX_SLOTS>() : kernel_of<false, MAX_SLOTS>();
  }
}

// the one check of the shapes for both entry points: 0 or an ArgError;
// fills `p`'s geometry, `bytes` (dynamic shared memory) and `spill` (scratch
// floats a lane)
int plan(int J, int T, int A, int P, int K, bool dtpm, Params& p, int& bytes,
         long long& spill) {
  if (P < 1 || !slots_for(P)) return BAD_PES;
  if (J < 1 || T < 1 || A < 1 || (dtpm && K < 1)) return BAD_SHAPE;
  const long long JT = (long long)J * T;
  if (JT > (1LL << 31) - 1) return BAD_SHAPE;
  const int slots = slots_for(P);
  const Geometry gc = geometry(JT), gj = geometry(J), gp = geometry(P);
  p.J = J; p.T = T; p.A = A; p.P = P; p.K = dtpm ? K : 1;
  p.magic = (unsigned)((0xffffffffULL + T) / T);
  p.width_c = gc.width;
  p.row_warps = gc.rho >= log2_of(ROW_WARPS) ? ROW_WARPS : 1 << gc.rho;
  p.rho_r = gc.rho - log2_of(p.row_warps);
  p.rho_j = gj.rho; p.width_j = gj.width;
  p.width_p = gp.width << gp.rho;
  const int lv = levels(p.rho_r);
  p.shared_levels = lv < SHARED_LEVELS ? lv : SHARED_LEVELS;
  p.spill_levels = lv - p.shared_levels;
  spill = (long long)ROW_WARPS * p.spill_levels * slots * 32;
  const long long floats = ROW_WARPS * (long long)region_floats(p.shared_levels, slots) +
                           levels(gj.rho) * 32LL + p.width_p + 2 +
                           (dtpm ? (long long)P * K : P) + P;
  const long long total = 4 * floats + (long long)A * T;
  if (total > MAX_SHARED) return BAD_SHARED;
  bytes = (int)total;
  return 0;
}

}  // namespace

// Scratch floats a lane needs at these shapes (the stacks' levels past
// shared memory), or an ArgError.
extern "C" long long repro_epilogue_spill(int dtpm, int J, int T, int A, int P, int K) {
  Params p;
  int bytes = 0;
  long long spill = 0;
  const int bad = plan(J, T, A, P, K, dtpm != 0, p, bytes, spill);
  return bad ? bad : spill;
}

// K1's schedule of L lanes (start, finish f32, onpe i32, and under DTPM
// onopp i32 -- null for a static scan; each (L, J*T) contiguous), the lanes'
// arrival (L, J) f32 and app index (L, J) i32, each design's valid tasks
// (D, A, T) bool bytes, active power (D, P) f32 -- (D, P, K) under DTPM --
// and idle power (D, P) f32 (lane l reads design l / (L / D)), and
// L * repro_epilogue_spill(...) floats of scratch -> job_finish (L, J),
// makespan, latency, energy (L,) and busy (L, P), all f32.  One launch of L
// blocks.  Returns 0, an ArgError (nothing launched) or a cudaError_t.
extern "C" int repro_epilogue(const void* start, const void* finish, const void* onpe,
                              const void* onopp, const void* arrival, const void* app,
                              const void* valid, const void* p_active, const void* p_idle,
                              void* spill, void* job_finish, void* makespan, void* latency,
                              void* energy, void* busy, int L, int D, int J, int T, int A,
                              int P, int K, void* stream) {
  if (L < 1 || D < 1 || L % D != 0) return BAD_GRID;
  const bool dtpm = onopp != nullptr;
  Params p;
  int bytes = 0;
  long long spill_floats = 0;
  const int bad = plan(J, T, A, P, K, dtpm, p, bytes, spill_floats);
  if (bad) return bad;
  p.start = static_cast<const float*>(start);
  p.finish = static_cast<const float*>(finish);
  p.onpe = static_cast<const int*>(onpe);
  p.onopp = static_cast<const int*>(onopp);
  p.arrival = static_cast<const float*>(arrival);
  p.app = static_cast<const int*>(app);
  p.valid = static_cast<const unsigned char*>(valid);
  p.p_active = static_cast<const float*>(p_active);
  p.p_idle = static_cast<const float*>(p_idle);
  p.spill = static_cast<float*>(spill);
  p.job_finish = static_cast<float*>(job_finish);
  p.makespan = static_cast<float*>(makespan);
  p.latency = static_cast<float*>(latency);
  p.energy = static_cast<float*>(energy);
  p.busy = static_cast<float*>(busy);
  p.S = L / D;
  const void* fn = kernel_for(dtpm, slots_for(P));
  if (bytes > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  void* args[] = {&p};
  const cudaError_t rc = cudaLaunchKernel(fn, dim3((unsigned)L), dim3((ROW_WARPS + 1) * 32),
                                          args, (size_t)bytes, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// The geometry of a launch at these shapes: threads a block, dynamic shared
// bytes, resident blocks an SM, registers a thread, local bytes a thread,
// slots.  Returns 0, an ArgError or a cudaError_t.
extern "C" int repro_epilogue_info(int dtpm, int J, int T, int A, int P, int K, int* out) {
  Params p;
  int bytes = 0;
  long long spill = 0;
  const int bad = plan(J, T, A, P, K, dtpm != 0, p, bytes, spill);
  if (bad) return bad;
  const void* fn = kernel_for(dtpm != 0, slots_for(P));
  const int threads = (ROW_WARPS + 1) * 32;
  cudaError_t rc = cudaSuccess;
  if (bytes > 48 * 1024)
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int per_sm = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, bytes);
  cudaFuncAttributes attr{};
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, fn);
  out[0] = threads; out[1] = bytes; out[2] = per_sm;
  out[3] = attr.numRegs; out[4] = (int)attr.localSizeBytes; out[5] = slots_for(P);
  return (int)rc;
}

extern "C" const char* repro_epilogue_error(int code) {
  switch (code) {
    case BAD_GRID: return "the lanes do not split evenly over the designs";
    case BAD_PES: return "the kernel takes 1..79 PEs";
    case BAD_SHAPE: return "the kernel takes J >= 1 jobs, T >= 1 tasks, A >= 1 apps, K >= 1 OPPs "
                           "and J * T < 2^31 cells a lane";
    case BAD_SHARED: return "the sums' stacks and the design's tables need more shared memory "
                            "than a block has";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
