// K1, the DS3 epoch scan for sm_90a: the kernel, shared by epoch_scan.cu (the
// fault-free programs) and epoch_scan_faults.cu (the fail-stop ones), each
// with a plain C interface.
//
// Replaces `_epoch_scan` of src/repro/core/simkernel_jax.py (:321), a lax.scan
// that XLA compiles (it has no Pallas original), in its four forms, as the
// reference compiles one program for each: static governors under etf, met
// and table (epoch_scan_kernel<false, false, ...>), closed-loop DTPM, the
// ondemand governor and its thermal throttle (<true, false, ...>), and each
// of them with fail-stop faults under etf and met (<false, true, false>,
// <true, true, false>).  The last argument, WINDOWED: the fault-free
// programs keep the live window (<..., true>), but for the static one at J
// <= RING, which takes every job at the start (<false, false, false>); see
// "The live window".
// Contract: for the tables of one design and L lanes of (arrival, app_idx[,
// policy][, fail times]), the same scheduled, start, finish and onpe (and
// under DTPM onopp, opp_idx, peak_temp_c; with faults the steps and commits
// of each lane) as the plain scan of kernels/epoch_scan.py, bit for bit.
//
// Bound on an H100: neither bytes nor operations.  The scan is a chain of J*T
// dependent steps a lane (each commit moves the next step's ready times and
// PE queues); a lane's whole state is a few (J, T) arrays, so the card's
// memory rate and peak are far away, and what a step costs is its latency.
// So a step does only what the commit changed, in one warp, with no block
// barrier.
//
// Design:
//   * Grid: one block of one warp per lane, lane = blockIdx.x; lanes are laid
//     out (D, S) and lane l reads design l / S.  The kernel has no block
//     barrier: __syncwarp and shuffles only.
//   * Shared memory: the design's small tables (exec_us (A,T,P), ebytes
//     (A,T,T), comm_mult (P,P), table_pe and each task's predecessors as a
//     T-bit mask (A,T), each app's valid tasks as a mask and its untouched
//     job's first eligible tasks), loaded by the warp;
//     then the lane's slice: pe_free[P] and the job state of W slots, per
//     slot a job's `done` mask (T <= 32: one 32-bit word) and its key, per
//     group of 32 slots the least key.  The (J, T) schedule (start, finish,
//     onpe) lives in global memory, which is the output; a job's arrival and
//     app are read from global memory for the one job a step touches.
//   * The pick from per-job keys: key[j] is the least 64-bit (order bits of
//     ready << 32 | j*T + t) over job j's eligible tasks (NONE if it has
//     none): a task is eligible when it is not done and its pred mask lies
//     inside the job's done mask, and its ready time is max(arrival, over
//     preds of finish) (no preds: arrival, as the reference's -BIG fill
//     gives).  A ready time depends only on its own job, so a commit in job j
//     changes key[j] alone: a lane per task recomputes it, then the lanes of
//     its group of 32 slots gmin.  The least key is the reference's rmin,
//     then its first flat index at rmin, as a min over per-job minima is the
//     min; nothing eligible, or rmin >= BIG/2, ends the scan (any_left).
//   * The live window (the fault-free programs): the jobs lo..hi, lo the
//     first job with an uncommitted task.  Every job before lo is done (key
//     NONE); jobs take their first commit in order (a root's key is its
//     arrival, arrivals are sorted, the low 32 bits order j first on equal
//     arrivals), so a job u untouched in the window has a key no greater
//     than any job after hi: the least key of lo..hi is the least of all J
//     as long as the window holds an untouched job.  So only the window holds
//     state, in a ring of W slots (job j in slot j % W, W = min(the power of
//     two >= J, RING)), and the window takes jobs 32 at a time (a chunk is
//     one group of slots: a lane a job, one coalesced read of the arrivals
//     and apps, the untouched keys from each app's first eligible tasks, the
//     group's minimum by one warp reduction, lo moved past the jobs done by
//     ballot), once every job in it has a commit.  A step's pick reads the
//     ring's groups, at most 32 (one a lane), whatever J: a group outside the
//     window is NONE.  The live jobs are the backlog: a few at a light load,
//     thousands on an overloaded lane.  A lane whose window outgrows the
//     ring starts again with its job state in global memory (the `spill`
//     buffer, J slots a lane, job j in slot j; the pick then reads the
//     window's groups), where the window may grow to J; its outputs are those
//     of one run.  A static lane whose ring has a slot for every job (J <=
//     RING) takes all J at the start instead, each in its own slot, and its
//     step loop never admits (EVERY, its own instantiation: the ring's
//     per-step bookkeeping would do no work there).  The DTPM program keeps
//     the window at any J: on an H100 its EVERY instantiation ran grid (c)
//     4% slower than the window's (which matched the scan before the
//     window), the static one the other way round (PERF.md §6).  Taking a chunk checks that its arrivals ascend and
//     traps where one falls (the window's pick is exact only then).  `live`
//     (a lane) is the most jobs it held: J where it took them all, else the
//     most its window held when a chunk came in (over W where it spilled).
//     The fail-stop programs keep every job live (lo = 0, hi = J - 1, W = J
//     in shared memory): a rollback may reopen any job.
//   * Each step, in the reference's order, by the warp:
//     3.   the pick from gmin;
//     4.   a lane per PE: data_ready = max(rmin, over preds of finish +
//          comm), then start_c and fin_c;
//     5.   the policy's PE: etf the first argmin of fin_c, met of exec, table
//          table_pe, by a warp reduction over (value, PE) that keeps the
//          lower PE on ties;
//     6.   lane 0 commits s0 and f0 to the task and the PE's queue; then the
//          job's key and its group's minimum; after the first commit of
//          the window's last untouched job, the next chunk.
//   * Stopping early: the scan ends at the first step with nothing left.  In
//     the fault-free programs every later step of the reference's J*T is a
//     no-op, so this is exact.  With faults too: a fault fires only while a
//     task is left (any_left is in its condition), so once nothing is left
//     nothing re-opens; and the faulted program also stops after the
//     launch's step cap, the reference's J*T*(1+n)+n for the most finite fail
//     times n of a lane, which never binds (each firing rolls back at most
//     J*T commits and skips at most one step).
// Fail-stop faults (the `FAULTS` argument; simkernel_jax.py:372-376,
// :402-435, :446-447, :460-466, :499-506):
//   * Per lane a fail time per PE; the carry adds the dead PEs, each task's
//     re-enqueue floor (in global memory beside finish: 32 KB a lane at the
//     full grid) and per job a T-bit "has a floor" mask, so a task's ready
//     time is max(arrival, pred finishes, its floor or 0).
//   * After the pick the warp tests the fail times against rmin.  If one
//     crosses (at most once per distinct fail time a lane), the warp rolls
//     back, a lane per job (the closure over descendants stays inside a job),
//     and recomputes the key of each job it touched; the queues drain at the
//     surviving finishes (a max over them, integer atomicMax on their bits,
//     exact), every group's minimum is recomputed, and the step skips the
//     pick if a pred of it was rolled back or else places it at the
//     pre-rollback rmin.
//   * The policy's argmin takes a dead PE as inf (an unsupported one is the
//     finite BIG); when every candidate is inf it takes PE 0, as argmin does.
//   * DTPM's carry repaired at a rollback: the makespan is recomputed from the
//     surviving schedule (a rolled-back task may have held the largest
//     finish) and each PE's commit list is relinked over its surviving cells.
//     A re-committed root may start in a window that already closed; closed
//     windows are not revisited, as in the reference.
// DTPM (the `DTPM` argument; simkernel_jax.py:271-316, :377-391, :471-480,
// :525-526, :535-543):
//   * The tables add the OPP-indexed latency exec_opp (A,T,P,K) in place of
//     exec_us (A,T,P), the per-level active power (P,K), the domain ladders
//     (C,K) and level counts, the domain and node maps and idle power; the
//     lane's slice adds the carry: OPP index per domain, the next window's
//     end, the 4 RC temperatures, their peak, the makespan so far, and per PE
//     the head and tail of its commit list.  Per lane the policy: window, up
//     threshold, thermal cap, the exact RC matrices A and B (from the host,
//     the plain version's f32 values; lanes 0-3 hold a row of each in
//     registers) and the two fixed-point exponents of the window sums.
//   * Before the commit of each step the warp runs the windows that closed by
//     the pick's ready time (while next_w <= rmin); after the last step, the
//     drain (while next_w - window < makespan).
//   * The window sums from per-PE commit lists: a PE's tasks start at or after
//     its previous finish (st = max(data_ready, pe_free[pe])), so its commits,
//     in commit order, are disjoint and sorted by start and by finish.  A
//     commit appends its cell (next_cell, (L, J, T) int32 in global memory,
//     links a PE's cells).  In a window [w0, w1) a lane per PE moves its head
//     past the cells that finish by w0 (no later window sees them: w0 only
//     grows) and walks on to the first cell that starts at or after w1.  Each
//     overlap `ov` and its energy `ov * p` go into the lane's own bins as
//     64-bit integers, round(x * 2^s): integer sums are the same bits in
//     every order and equal the plain version's (kernels/epoch_scan.py,
//     `quanta`).  A lane per PE then turns its bins into window power; the
//     node power is a fixed shuffle tree over the 32 lanes; a lane per domain
//     takes utilisation and the ondemand step; lanes 0-3 a row each of the RC
//     step; the throttle last.
//   * The pick's latency is exec_opp at its PEs' domain OPPs; the commit latches
//     the OPP (onopp) and moves the makespan.
//   * DTPM needs P, C, K <= 32 (a lane each); the wrapper checks.
// Numerics: f32 as the reference, op by op.  nvcc contracts a*b+c into one
// fma by default and the build's flags do not turn that off, so the three
// contractible spots are written with __fmul_rn / __fadd_rn, in the
// reference's order (simkernel_jax.py:487-491): base = startup + ebytes*inv_bw
// (multiply, then add), comm = mult*base, finish + comm.  fin = start + exec is
// one add.  The window step's spots are written the same way: ov * p before
// its quantisation, e_act / window + idle_power * idle_frac, window *
// domain_cpu, fmax * util / up, the node tree's adds and every product and sum
// of A @ temps + B @ u (left to right, then the two added); the ondemand
// slack is the f32 1e-9f, as the reference's weakly typed 1e-9 rounds.  The
// window step's f32 divisions go through div_rn (the quotient refined in
// f64, rounded once to f32: the IEEE f32 quotient), whose SASS, unlike nvcc's
// f32 division, holds no FFMA: so "no FFMA" still proves that nothing was
// contracted (its DFMAs are its own f64 refinement).
// BIG = 1e30 is finite on purpose (:43): an unsupported PE carries 1e30 of
// latency and loses etf and met as in the reference.
#pragma once

#include "common.cuh"

using namespace repro;

namespace {

constexpr int MAX_TASKS = 32;
constexpr float BIG = 1e30f;
constexpr int ETF = 0, MET = 1, TABLE = 2;
constexpr unsigned long long NONE = ~0ull;
constexpr int RING = 1024;      // the most job slots of a fault-free lane's ring

constexpr int MAX_DTPM = 32;    // P, C and K under DTPM: a lane each
constexpr int NODES = 3;        // thermal nodes with power (the 4th is the board)

struct Params {
  const float* exec_us;      // (D, A, T, P)
  const int* pred_bits;      // (D, A, T): bit t' set where t' precedes t
  const float* ebytes;       // (D, A, T, T): bytes t' -> t
  const int* valid_bits;     // (D, A): bit t set where task t exists
  const float* comm_mult;    // (D, P, P)
  const float* comm_startup; // (D,)
  const float* comm_inv_bw;  // (D,)
  const int* table_pe;       // (D, A, T)
  const float* arrival;      // (D*S, J), ascending in each lane (fault-free: else a trap)
  const int* app_idx;        // (D*S, J)
  unsigned char* scheduled;  // (D*S, J, T) bool
  float* start;              // (D*S, J, T)
  float* finish;             // (D*S, J, T), read back by later steps
  int* onpe;                 // (D*S, J, T), read back by later steps
  int* live;                 // (D*S,): the most jobs a lane held
  unsigned long long* spill; // (D*S, spill_words(J)) scratch, or null where J <= the ring
  int D, S, J, A, T, P, policy;
};

// DTPM's tables (leading design axis D), per-lane policies and outputs
struct DtpmParams {
  const float* exec_opp;     // (D, A, T, P, K)
  const float* pwr_opp;      // (D, P, K) active power at each level
  const float* opp_freq;     // (D, C, K) ascending, top-padded
  const int* num_opp;        // (D, C)
  const int* domain_node;    // (D, C) thermal node of each domain
  const float* domain_cpu;   // (D, C) CPU PEs per domain
  const int* pe_domain;      // (D, P)
  const float* pe_is_cpu;    // (D, P) 1 or 0
  const int* node_of_pe;     // (D, P)
  const float* power_idle;   // (D, P)
  const float* window;       // (D*S,) sample window, us
  const float* up;           // (D*S,) up threshold
  const float* cap;          // (D*S,) thermal cap, C (inf: none)
  const float* rc;           // (D*S, 2, 4, 4): A, then B
  const int* quanta;         // (D*S, 2): fixed-point exponents, busy and energy
  const float* rc_consts;    // (5,): C_NODE[3], ambient drive, ambient
  int* onopp;                // (D*S, J, T)
  int* opp_idx;              // (D*S, C)
  float* peak;               // (D*S,)
  int* next_cell;            // (D*S, J, T) scratch: the next cell on the same PE
  int C, K;
};

// the fail-stop program's per-lane plans, scratch and counts
struct FaultParams {
  const float* faults;       // (D*S, P) fail times (inf: never)
  float* floor;              // (D*S, J, T) scratch: a rolled-back root's fail time
  int* counts;               // (D*S, 2): steps taken, tasks committed
  int cap;                   // steps a lane may take (the reference's scan length)
};

// Job slots of a lane in shared memory: the fault-free programs' ring, the
// power of two >= J (at least 32, at most RING); every job with faults
__host__ __device__ inline int job_slots(int J, bool faults) {
  if (faults) return J;
  int w = 32;
  while (w < J && w < RING) w <<= 1;
  return w;
}
// 64-bit words of a lane's spilled job state: J keys, their group minima,
// then J done masks (two a word)
__host__ __device__ inline long long spill_words(int J) {
  return (long long)J + (J + 31) / 32 + (J + 1) / 2;
}
// 32-bit words of a design's tables (K = 0: the static kernel),
// and of one lane's slice (64-bit words first), each rounded up to an even
// count so that every slice starts 8-byte aligned
__host__ __device__ inline long long table_words(int A, int T, int P, int C, int K) {
  long long w = (long long)A * T * P * (K > 0 ? K : 1) + (long long)A * T * T +
                (long long)P * P + 2LL * A * T + 2LL * A;
  if (K > 0) w += (long long)P * K + (long long)C * K + 3LL * C + 4LL * P;
  return (w + 1) & ~1LL;
}
__host__ __device__ inline long long lane_words(int J, int P, int C, int K, bool faults) {
  const long long W = job_slots(J, faults), G = (W + 31) / 32;
  long long w = 2 * G + 2 * W + P + W;   // gmin, key, pe_free, done
  if (K > 0) w += 2LL * P + 2LL * P + C + 7;   // bins; head, tail, OPPs, carry
  if (faults) w += 4LL * P + J;                // fail times, PE masks, queues, floors
  return (w + 1) & ~1LL;
}
// shared words of one block: the tables, then the lane's slice
__host__ __device__ inline long long shared_words(int J, int A, int T, int P, int C, int K,
                                                  bool faults) {
  return table_words(A, T, P, C, K) + lane_words(J, P, C, K, faults);
}

// order-preserving bits of a float (not NaN), -0 taken as +0
__device__ __forceinline__ unsigned order_bits(float x) {
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_order_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(FULL_MASK, v, o);
    v = other < v ? other : v;
  }
  return v;
}

// a window sum (fixed point, exponent s) back to f32: one rounding
__device__ __forceinline__ float fixed_to_f32(unsigned long long v, double back) {
  return __double2float_rn(__dmul_rn(__ll2double_rn((long long)v), back));
}
// a / b for finite a >= 0 and normal b > 0, rounded to f32 as IEEE f32
// division rounds it.  The exact quotient of two 24-bit floats lies at least
// ~2^-49 (relative) from any f32 rounding midpoint, so a quotient good to
// ~2^-52 rounds to the right f32: a reciprocal from MUFU (~2^-22) and two
// Newton steps in f64, the product, and one correction by its exact FMA
// residual.  nvcc's f32 division refines with FFMA and its f64 division
// calls a slow-path subroutine (registers saved across it spill); this holds
// neither, so "no FFMA" in the SASS still proves nothing was contracted
__device__ __forceinline__ float div_rn(float a, float b) {
  const double ad = (double)a, bd = (double)b;
  double r = (double)__fdividef(1.f, b);
  r = __fma_rn(r, __fma_rn(-bd, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-bd, r, 1.0), r);
  const double q = __dmul_rn(ad, r);
  return __double2float_rn(__fma_rn(r, __fma_rn(-bd, q, ad), q));
}
// 2^s as an f32 and 2^-s as an f64, exactly (|s| <= 126: the wrapper checks)
__device__ __forceinline__ float pow2f(int s) { return __int_as_float((127 + s) << 23); }
__device__ __forceinline__ double pow2d(int s) {
  return __longlong_as_double((long long)(1023 + s) << 52);
}

// Where a lane keeps its job state (scan_lane's JOBS): EVERY job in its own
// slot of shared memory, all taken at the start (the fail-stop programs, and
// the fault-free ones where the ring has a slot for each of the J jobs);
// the live WINDOW in the ring; the window SPILLED to global memory (p.spill),
// job j in slot j
constexpr int EVERY = 0, WINDOW = 1, SPILLED = 2;

// The scan of one lane (one warp), after its design's tables are in shared
// memory.  Returns false, having written nothing final, when a WINDOW lane's
// window outgrows its ring (the caller then runs it again SPILLED)
template <bool DTPM, bool FAULTS, int JOBS>
__device__ __forceinline__ bool scan_lane(const Params& p, const DtpmParams& dp,
                                          const FaultParams& fp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = p.A, T = p.T, P = p.P, J = p.J;
  const int C = DTPM ? dp.C : 0, K = DTPM ? dp.K : 1;
  const int lane_id = threadIdx.x;
  const long long lane = blockIdx.x;

  // the tables
  float* exec_s = reinterpret_cast<float*>(smem);
  float* ebytes_s = exec_s + A * T * P * K;
  float* mult_s = ebytes_s + A * T * T;
  int* pred_s = reinterpret_cast<int*>(mult_s + P * P);
  int* tpe_s = pred_s + A * T;
  int* valid_s = tpe_s + A * T;
  int* root_s = valid_s + A;                               // A: see admit
  // DTPM only, after the static tables
  float* pwr_s = reinterpret_cast<float*>(root_s + A);     // (P, K)
  float* freq_s = pwr_s + P * K;                           // (C, K)
  int* nopp_s = reinterpret_cast<int*>(freq_s + C * K);    // C
  int* dnode_s = nopp_s + C;                               // C
  float* dcpu_s = reinterpret_cast<float*>(dnode_s + C);   // C
  int* pdom_s = reinterpret_cast<int*>(dcpu_s + C);        // P
  float* iscpu_s = reinterpret_cast<float*>(pdom_s + P);   // P
  int* node_s = reinterpret_cast<int*>(iscpu_s + P);       // P
  float* pidle_s = reinterpret_cast<float*>(node_s + P);   // P
  const int d = (int)(lane / p.S);

  // the lane's slice: 64-bit words first.  The job state: W slots of
  // (key, done), a least key per group of 32 slots; slot(j) = j % W in the
  // ring (WINDOW), j otherwise
  const int WS = job_slots(J, FAULTS);            // the shared slots
  const int W = JOBS == SPILLED ? J : WS;
  const unsigned slot_mask = JOBS == WINDOW ? (unsigned)(W - 1) : 0xffffffffu;
  unsigned long long* gmin_s = reinterpret_cast<unsigned long long*>(
      smem + 4 * table_words(A, T, P, C, DTPM ? K : 0));
  unsigned long long* key_s = gmin_s + (WS + 31) / 32;
  unsigned long long* bins = key_s + WS;       // DTPM: P busy sums
  float* pe_free = reinterpret_cast<float*>(bins + (DTPM ? P : 0));
  unsigned* done_s = reinterpret_cast<unsigned*>(pe_free + P);
  unsigned long long* key = key_s;
  unsigned long long* gmin = gmin_s;
  unsigned* done = done_s;
  if constexpr (JOBS == SPILLED) {
    key = p.spill + lane * spill_words(J);
    gmin = key + J;
    done = reinterpret_cast<unsigned*>(gmin + (J + 31) / 32);
  }
  // DTPM: each PE's commit list, the lane's OPP per domain, and the carry:
  // next window end, peak, makespan, temps[4]
  int* head = reinterpret_cast<int*>(done_s + WS);
  int* tail = head + P;
  int* oppidx_s = tail + P;
  float* st_f = reinterpret_cast<float*>(oppidx_s + C);
  // FAULTS only, after either layout: the lane's fail times, the dead PEs,
  // the PEs firing now, the recomputed queues (float bits), per job a T-bit
  // "has a floor" mask
  float* ftime_s = DTPM ? st_f + 7 : reinterpret_cast<float*>(done_s + WS);
  int* fired_s = reinterpret_cast<int*>(ftime_s + P);
  int* fire_s = fired_s + P;
  int* newfree = fire_s + P;
  unsigned* hasfloor = reinterpret_cast<unsigned*>(newfree + P);

  const unsigned all = T == 32 ? 0xffffffffu : ((1u << T) - 1u);
  const long long row0 = lane * J;             // this lane's first job
  const float* arr_g = p.arrival + row0;
  const int* app_g = p.app_idx + row0;
  float* start_g = p.start + row0 * T;
  float* fin_g = p.finish + row0 * T;
  int* onpe_g = p.onpe + row0 * T;
  int* onopp_g = DTPM ? dp.onopp + row0 * T : nullptr;
  int* next_g = DTPM ? dp.next_cell + row0 * T : nullptr;
  float* floor_g = FAULTS ? fp.floor + row0 * T : nullptr;
  auto slot = [&](const int j) { return (int)((unsigned)j & slot_mask); };

  for (int i = lane_id; i < P; i += 32) pe_free[i] = 0.f;
  // DTPM: lanes 0-3 hold a row each of the lane's RC matrices A and B
  float rc_a[4] = {0.f, 0.f, 0.f, 0.f}, rc_b[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (DTPM) {
    for (int i = lane_id; i < C; i += 32) oppidx_s[i] = 0;   // ondemand starts at fmin
    for (int i = lane_id; i < P; i += 32) head[i] = tail[i] = -1;
    if (lane_id < 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rc_a[k] = dp.rc[lane * 32 + lane_id * 4 + k];
        rc_b[k] = dp.rc[lane * 32 + 16 + lane_id * 4 + k];
      }
    }
    if (lane_id == 0) {
      const float amb = dp.rc_consts[4];
      st_f[0] = dp.window[lane];              // next_w
      st_f[1] = amb;                          // peak
      st_f[2] = 0.f;                          // makespan
      for (int i = 0; i < 4; ++i) st_f[3 + i] = amb;
    }
  }
  if constexpr (FAULTS) {
    for (int i = lane_id; i < P; i += 32) {
      ftime_s[i] = fp.faults[lane * P + i];
      fired_s[i] = 0;
    }
    for (int j = lane_id; j < J; j += 32) {
      hasfloor[j] = 0u;
      done[j] = ~(unsigned)valid_s[app_g[j]] & all;   // a task that does not exist is done
    }
  } else {
    // no job admitted yet: every slot and group NONE
    for (int s = lane_id; s < W; s += 32) key[s] = NONE;
    for (int g = lane_id; g < (W + 31) / 32; g += 32) gmin[g] = NONE;
  }
  for (int c = lane_id; c < J * T; c += 32) {
    start_g[c] = 0.f;
    fin_g[c] = 0.f;
    onpe_g[c] = 0;
    if constexpr (DTPM) onopp_g[c] = 0;
  }
  const float startup = p.comm_startup[d], inv_bw = p.comm_inv_bw[d];
  __syncwarp();

  // job j's key, by one thread: the least (ready, flat index) of its
  // eligible tasks (the rollback's and the first keys)
  auto serial_key = [&](const int j) {
    unsigned long long best = NONE;
    const unsigned dn = done[slot(j)];
    if (dn == all) return best;
    const int* pr = pred_s + app_g[j] * T;
    const float arr = arr_g[j];
    const float* fin_row = fin_g + (long long)j * T;
    unsigned open = ~dn & all;
    while (open) {
      const int t = __ffs(open) - 1;
      open &= open - 1;
      unsigned m = (unsigned)pr[t];
      if (m & ~dn) continue;                 // a predecessor is not committed yet
      float ready = arr;
      while (m) {
        const int q = __ffs(m) - 1;
        m &= m - 1;
        ready = fmaxf(ready, fin_row[q]);
      }
      // a rolled-back root waits out its fail time (floor 0 elsewhere)
      if constexpr (FAULTS)
        ready = fmaxf(ready, ((hasfloor[j] >> t) & 1u) ? floor_g[(long long)j * T + t] : 0.f);
      const unsigned long long k =
          ((unsigned long long)order_bits(ready) << 32) | (unsigned)(j * T + t);
      best = k < best ? k : best;
    }
    return best;
  };
  // job j's key, by the warp: a lane per task, its preds' finishes by shuffle
  auto warp_key = [&](const int j) {
    const unsigned dn = done[slot(j)];
    const int t = lane_id;
    const bool in = t < T;
    const long long c = (long long)j * T + t;
    const unsigned pm = in ? (unsigned)pred_s[app_g[j] * T + t] : 0u;
    const float f = in ? fin_g[c] : 0.f;
    float ready = arr_g[j];
    for (int q = 0; q < T; ++q) {
      const float v = __shfl_sync(FULL_MASK, f, q);
      if ((pm >> q) & 1u) ready = fmaxf(ready, v);
    }
    const bool elig = in && !((dn >> t) & 1u) && !(pm & ~dn);
    if constexpr (FAULTS) {
      if (elig) ready = fmaxf(ready, ((hasfloor[j] >> t) & 1u) ? floor_g[c] : 0.f);
    }
    return warp_min(elig ? ((unsigned long long)order_bits(ready) << 32) | (unsigned)c
                         : NONE);
  };
  // every group's least key, a lane per group
  auto refresh_groups = [&]() {
    for (int g = lane_id; g < (W + 31) / 32; g += 32) {
      unsigned long long m = NONE;
      for (int s = g * 32; s < min(W, g * 32 + 32); ++s) m = key[s] < m ? key[s] : m;
      gmin[g] = m;
    }
  };

  // the jobs taken lo..hi (EVERY: every job), u the first job with a task
  // and no commit (it and every job after it untouched), and the most jobs
  // the lane held
  int lo = 0, hi = FAULTS ? J - 1 : -1, u = J, most = FAULTS ? J : 0;
  unsigned pending = 0u;     // the tasked, untouched jobs of hi's chunk, from u
  // Takes the next chunk of 32 jobs (a chunk is one group of slots), a lane
  // a job, each with its untouched key (done: the tasks that do not exist;
  // ready: the arrival, or max(arrival, 0) where a pred does not exist, at
  // the app's first such task), and returns its tasked jobs.  The window's
  // pick is exact only if arrivals ascend: a decrease traps
  auto take = [&]() {
    const int top = min(hi + 32, J - 1);
    const int j = hi + 1 + lane_id;
    unsigned long long k = NONE;
    unsigned v = 0u;
    float x = 0.f;
    if (j <= top) {
      const int a = app_g[j];
      x = arr_g[j];
      v = (unsigned)valid_s[a] & all;
      const int r = root_s[a], ta = (r & 0xff) - 1, tf = (r >> 8) - 1;
      if (tf >= 0) k = ((unsigned long long)order_bits(x) << 32) | (unsigned)(j * T + tf);
      if (ta >= 0 && ta != tf) {
        const unsigned long long kt =
            ((unsigned long long)order_bits(fmaxf(x, 0.f)) << 32) | (unsigned)(j * T + ta);
        k = kt < k ? kt : k;
      }
      done[slot(j)] = ~v & all;
      key[slot(j)] = k;
    }
    float prev = __shfl_up_sync(FULL_MASK, x, 1);
    if (lane_id == 0) prev = hi >= 0 ? arr_g[hi] : x;
    if (j <= top && x < prev) __trap();
    const unsigned long long m = warp_min(k);
    if (lane_id == 0) gmin[slot(hi + 1) / 32] = m;   // the chunk's group, whole
    hi = top;
    return __ballot_sync(FULL_MASK, v != 0u);
  };
  // WINDOW, SPILLED: moves lo past the jobs done (by ballot, 32 at a time),
  // then takes chunks until one has a task.  False, taking nothing, where
  // the window would outgrow the ring.  Jobs take their first commit in
  // order (a root's key is its arrival), so u is always the lowest job of
  // `pending`
  auto admit = [&]() {
    while (lo <= hi) {
      const int jl = lo + lane_id;
      const unsigned fin_ = __ballot_sync(FULL_MASK, jl <= hi && done[slot(jl)] == all);
      if (fin_ != FULL_MASK) {
        lo += __ffs(~fin_) - 1;
        break;
      }
      lo += 32;
    }
    while (hi + 1 < J) {
      if (JOBS == WINDOW && min(hi + 32, J - 1) - lo + 1 > W) return false;
      pending = take();
      if (pending) break;                     // a job with no task is done already
    }
    u = pending ? (hi & ~31) + __ffs(pending) - 1 : J;
    __syncwarp();
    most = max(most, hi - lo + 1);
    return true;
  };

  if constexpr (FAULTS) {
    for (int j = lane_id; j < J; j += 32) key[j] = serial_key(j);
    __syncwarp();
    refresh_groups();
    __syncwarp();
  } else if constexpr (JOBS == EVERY) {
    while (hi + 1 < J) take();                // every job, once: the loop never admits
    __syncwarp();
    most = J;
  } else {
    admit();                                  // job 0: the ring holds at least 32
  }

  // DTPM: one sampling window [next_w - window, next_w), by the warp (the
  // reference's _window_step, simkernel_jax.py:271-316)
  float window = 0.f, up = 0.f, cap = 0.f, scale_b = 0.f, scale_e = 0.f;
  double back_b = 0.0, back_e = 0.0;
  if constexpr (DTPM) {
    window = dp.window[lane];
    up = dp.up[lane];
    cap = dp.cap[lane];
    const int sb = dp.quanta[lane * 2], se = dp.quanta[lane * 2 + 1];
    scale_b = pow2f(sb);
    scale_e = pow2f(se);
    back_b = pow2d(-sb);
    back_e = pow2d(-se);
  }
  auto window_step = [&]() {
    const float w1 = st_f[0];
    const float w0 = __fsub_rn(w1, window);
    // a lane per PE: its commits that overlap the window, exact fixed-point
    // sums in the lane's own bins
    unsigned long long busy_q = 0, en_q = 0;
    if (lane_id < P) {
      const int pe = lane_id;
      int c = head[pe];
      while (c >= 0 && !(fin_g[c] > w0)) c = next_g[c];   // no later window sees these
      head[pe] = c;
      if (c < 0) tail[pe] = -1;
      for (; c >= 0; c = next_g[c]) {
        const float s = start_g[c];
        if (s >= w1) break;                   // this and every later cell start past w1
        const float ov = fminf(fmaxf(__fsub_rn(fminf(fin_g[c], w1), fmaxf(s, w0)), 0.f),
                               window);
        if (ov > 0.f) {
          const float e = __fmul_rn(ov, pwr_s[pe * K + onopp_g[c]]);
          busy_q += (unsigned long long)__float2ll_rn(__fmul_rn(ov, scale_b));
          en_q += (unsigned long long)__float2ll_rn(__fmul_rn(e, scale_e));
        }
      }
      bins[pe] = busy_q;
    }
    __syncwarp();
    // a lane per PE: its window power, active at the latched OPPs + idle
    float p_pe = 0.f;
    if (lane_id < P) {
      const float busy = fixed_to_f32(busy_q, back_b);
      const float e_act = fixed_to_f32(en_q, back_e);
      const float idle = __fsub_rn(1.f, fminf(fmaxf(div_rn(busy, window), 0.f), 1.f));
      p_pe = __fadd_rn(div_rn(e_act, window), __fmul_rn(pidle_s[lane_id], idle));
    }
    // per node: a fixed tree over the 32 lanes (the plain version's order)
    float u[4];
#pragma unroll
    for (int n = 0; n < NODES; ++n) {
      float x = (lane_id < P && node_s[lane_id] == n) ? p_pe : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(FULL_MASK, x, o));
      u[n] = div_rn(__shfl_sync(FULL_MASK, x, 0), dp.rc_consts[n]);
    }
    u[3] = dp.rc_consts[3];
    // a lane per domain: utilisation -> the ondemand proposal
    int proposed = 0;
    if (lane_id < C) {
      unsigned long long busy_dom_q = 0;
      for (int pe = 0; pe < P; ++pe)
        if (pdom_s[pe] == lane_id && iscpu_s[pe] != 0.f) busy_dom_q += bins[pe];
      const float busy_dom = fixed_to_f32(busy_dom_q, back_b);
      const float util =
          div_rn(busy_dom, fmaxf(__fmul_rn(window, dcpu_s[lane_id]), 1e-9f));
      const int top = nopp_s[lane_id] - 1;
      const float* fr = freq_s + lane_id * K;
      const float target = div_rn(__fmul_rn(fr[top], fmaxf(util, 0.f)), up);
      const float slack = __fsub_rn(target, 1e-9f);
      int down = 0;                           // no level covers: argmax of all-false
      for (int k = 0; k < K; ++k)
        if (fr[k] >= slack) { down = k; break; }
      proposed = util > up ? top : down;
    }
    // lanes 0-3: a row each of A @ temps + B @ u, left to right
    float r = 0.f;
    if (lane_id < 4) {
      float a = __fmul_rn(rc_a[0], st_f[3]);
      float b = __fmul_rn(rc_b[0], u[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        a = __fadd_rn(a, __fmul_rn(rc_a[k], st_f[3 + k]));
        b = __fadd_rn(b, __fmul_rn(rc_b[k], u[k]));
      }
      r = __fadd_rn(a, b);
    }
    float temps[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) temps[i] = __shfl_sync(FULL_MASK, r, i);
    // a domain's node temperature, from the lane holding that row (a runtime
    // index into temps[] would put the array on the stack)
    const float t_dom = __shfl_sync(FULL_MASK, r, lane_id < C ? dnode_s[lane_id] : 0);
    __syncwarp();                             // every lane has read the carry
    if (lane_id == 0) {
      st_f[0] = __fadd_rn(w1, window);
      st_f[1] = fmaxf(st_f[1], fmaxf(fmaxf(temps[0], temps[1]), temps[2]));
#pragma unroll
      for (int i = 0; i < 4; ++i) st_f[3 + i] = temps[i];
    }
    // the throttle: a domain hotter than the cap drops to its lowest OPP
    if (lane_id < C) oppidx_s[lane_id] = t_dom > cap ? 0 : proposed;
    __syncwarp();
  };

  // 3b-6. for the pick (j, t) at rmin: the windows that closed by this epoch
  // (DTPM), the policy's PE, the commit, then the job's key and its group's
  // least key
  auto place = [&](const int j, const int t, const float rmin) {
    const int at = app_g[j] * T + t;
    const unsigned pm = (unsigned)pred_s[at];
    const float* eb = ebytes_s + at * T;
    const float* ex_row = exec_s + at * P * K;
    // 3b. DTPM: the windows that closed by this epoch (lazy advance)
    if constexpr (DTPM) {
      while (st_f[0] <= rmin) window_step();
    }
    const float* fin_row = fin_g + (long long)j * T;
    const int* pe_row = onpe_g + (long long)j * T;
    const int tpe = tpe_s[at];
    // 4-5. a lane per PE; keep the first minimum of the policy's value
    const float inf = __int_as_float(0x7f800000);
    float best_v = inf, best_s = 0.f, best_f = 0.f;
    int best_pe = 0x7fffffff;
    for (int pe = lane_id; pe < P; pe += 32) {
      float dr = rmin;
      unsigned m = pm;
      while (m) {
        const int q = __ffs(m) - 1;
        m &= m - 1;
        // no contraction: multiply, then add, as the reference rounds
        const float base = __fadd_rn(startup, __fmul_rn(eb[q], inv_bw));
        const float comm = __fmul_rn(mult_s[pe_row[q] * P + pe], base);
        dr = fmaxf(dr, __fadd_rn(fin_row[q], comm));
      }
      const float ex = DTPM ? ex_row[pe * K + oppidx_s[pdom_s[pe]]] : ex_row[pe];
      const float st = fmaxf(dr, pe_free[pe]);
      const float fn = st + ex;      // one add: nothing to contract
      if constexpr (FAULTS) {
        // etf or met (the table policy takes no faults); a dead PE is inf in
        // the argmin; every PE inf: argmin's PE 0, so a lane keeps its first
        // PE until a smaller value comes
        const float v = fired_s[pe] ? inf : p.policy == ETF ? fn : ex;
        if (v < best_v || best_pe == 0x7fffffff) {
          best_v = v; best_pe = pe; best_s = st; best_f = fn;
        }
      } else {
        const float v = p.policy == ETF ? fn : p.policy == MET ? ex
                                               : (pe == tpe ? 0.f : inf);
        if (v < best_v) { best_v = v; best_pe = pe; best_s = st; best_f = fn; }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL_MASK, best_v, o);
      const int op = __shfl_xor_sync(FULL_MASK, best_pe, o);
      const float os = __shfl_xor_sync(FULL_MASK, best_s, o);
      const float of = __shfl_xor_sync(FULL_MASK, best_f, o);
      if (ov < best_v || (ov == best_v && op < best_pe)) {
        best_v = ov; best_pe = op; best_s = os; best_f = of;
      }
    }
    // 6. commit
    if (lane_id == 0) {
      const int c = j * T + t;
      start_g[c] = best_s;
      fin_g[c] = best_f;
      onpe_g[c] = best_pe;
      pe_free[best_pe] = best_f;
      done[slot(j)] |= 1u << t;
      if constexpr (DTPM) {                   // latch the OPP; append to the PE's list
        onopp_g[c] = oppidx_s[pdom_s[best_pe]];
        st_f[2] = fmaxf(st_f[2], best_f);
        next_g[c] = -1;
        if (tail[best_pe] >= 0) next_g[tail[best_pe]] = c;
        else head[best_pe] = c;
        tail[best_pe] = c;
      }
    }
    __syncwarp();
    // the job's new key, then its group's least key (the lane at its slot's
    // place in the group holds the new key)
    const unsigned long long kj = warp_key(j);
    const int sj = slot(j), g = sj / 32, sl = g * 32 + lane_id;
    unsigned long long m = sl == sj ? kj : sl < W ? key[sl] : NONE;
    m = warp_min(m);
    if (lane_id == 0) {
      key[sj] = kj;
      gmin[g] = m;
    }
    __syncwarp();
  };

  // the rollback of the PEs in fire_s, by the warp (the reference's
  // apply_faults, simkernel_jax.py:402-435).  A job's preds lie in the job, so
  // a lane takes its jobs whole: the committed tasks on a firing PE that
  // finish after its fail time, closed over their committed descendants; their
  // cells reset, a root's floor set to its PE's fail time (read before the
  // reset), the floor dropped where a pred was lost, and the job's key
  // recomputed.  Every surviving commit goes into the queues' recomputed
  // maxima (finishes are >= 0, so a float's bits order as an int's) and the
  // surviving makespan.  If a task was lost, the queues drain at those
  // maxima, DTPM's makespan is the surviving one and each PE's list is
  // relinked over its surviving cells, and every group's least key is
  // recomputed.  The fail-stop programs keep every job in its own slot
  auto roll_back = [&]() {
    bool lost = false;
    float mk = 0.f;
    for (int j = lane_id; j < J; j += 32) {
      const int a = app_g[j];
      const unsigned vb = (unsigned)valid_s[a];
      const int* pr = pred_s + a * T;
      const long long base = (long long)j * T;
      unsigned committed = done[j] & vb;
      unsigned inv = 0u;
      for (unsigned m = committed; m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        const int pe = onpe_g[base + t];
        if (fire_s[pe] && fin_g[base + t] > ftime_s[pe]) inv |= 1u << t;
      }
      if (inv) {
        for (bool grew = true; grew;) {       // the fixpoint of the T rounds
          grew = false;
          for (unsigned m = committed & ~inv; m; m &= m - 1) {
            const int t = __ffs(m) - 1;
            if ((unsigned)pr[t] & inv) { inv |= 1u << t; grew = true; }
          }
        }
        unsigned any_pred = 0u;
        for (int t = 0; t < T; ++t)
          if ((unsigned)pr[t] & inv) any_pred |= 1u << t;
        const unsigned roots = inv & ~any_pred;
        for (unsigned m = inv; m; m &= m - 1) {
          const int t = __ffs(m) - 1;
          const long long c = base + t;
          if ((roots >> t) & 1u) floor_g[c] = ftime_s[onpe_g[c]];
          fin_g[c] = 0.f;
          start_g[c] = 0.f;
          onpe_g[c] = 0;
          if constexpr (DTPM) onopp_g[c] = 0;
        }
        hasfloor[j] = (hasfloor[j] & ~any_pred) | roots;
        committed &= ~inv;
        done[j] &= ~inv;
        lost = true;
        key[j] = serial_key(j);
      }
      for (unsigned m = committed; m; m &= m - 1) {
        const long long c = base + __ffs(m) - 1;
        atomicMax(&newfree[onpe_g[c]], __float_as_int(fin_g[c]));
        mk = fmaxf(mk, fin_g[c]);
      }
    }
    lost = __any_sync(FULL_MASK, lost);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mk = fmaxf(mk, __shfl_xor_sync(FULL_MASK, mk, o));
    __syncwarp();
    for (int pe = lane_id; pe < P; pe += 32) {
      if (lost) pe_free[pe] = __int_as_float(newfree[pe]);
      if (fire_s[pe]) fired_s[pe] = 1;
    }
    if (lost) {
      if constexpr (DTPM) {
        if (lane_id == 0) st_f[2] = mk;
        if (lane_id < P) {                    // a lane per PE: drop the lost cells
          const int pe = lane_id;
          int prev = -1;
          for (int c = head[pe]; c >= 0;) {
            const int n = next_g[c];
            if ((done[c / T] >> (c % T)) & 1u) {
              if (prev >= 0) next_g[prev] = c;
              else head[pe] = c;
              prev = c;
            }
            c = n;
          }
          if (prev >= 0) next_g[prev] = -1;
          else head[pe] = -1;
          tail[pe] = prev;
        }
      }
      refresh_groups();
    }
    __syncwarp();
  };

  // the steps; a WINDOW or SPILLED lane leaves the inner loop only to admit
  // the next chunk, so that the loop's body stays one short stretch of code
  // (the admission inlined in it cost every step ~5% on an H100); an EVERY
  // lane never admits
  int nsteps = 0, ncommits = 0;
  for (bool left = true; left;) {
    while (true) {
      // 3. the least (ready, flat index) of the lane: over every group of
      // the ring (at most 32; a group outside the window is NONE), over the
      // window's groups where spilled
      unsigned long long best = NONE;
      for (int g = (JOBS == SPILLED ? lo / 32 : 0) + lane_id;
           g <= (JOBS == SPILLED ? hi / 32 : (W - 1) / 32); g += 32)
        best = gmin[g] < best ? gmin[g] : best;
      best = warp_min(best);
      const float rmin = from_order_bits((unsigned)(best >> 32));
      if (best == NONE || !(rmin < BIG * 0.5f)) {   // nothing left: the rest are no-ops
        left = false;
        break;
      }
      const int flat = (int)(best & 0xffffffffu);
      const int j = flat / T;
      bool go = true;
      if constexpr (FAULTS) {
        if (nsteps >= fp.cap) {
          left = false;
          break;
        }
        ++nsteps;
        // 3a. the fail times this epoch crosses fire before anything else,
        // together; a pick whose pred was rolled back is stale: skip the step
        bool f = false;
        for (int pe = lane_id; pe < P; pe += 32) f |= !fired_s[pe] && ftime_s[pe] <= rmin;
        if (__any_sync(FULL_MASK, f)) {
          for (int pe = lane_id; pe < P; pe += 32) {
            fire_s[pe] = !fired_s[pe] && ftime_s[pe] <= rmin;
            newfree[pe] = 0;
          }
          __syncwarp();
          roll_back();
          go = !((unsigned)pred_s[app_g[j] * T + flat % T] & ~done[j]);
        }
      }
      if (go) {
        place(j, flat - j * T, rmin);
        ++ncommits;
        // job u's first commit: u moves to the next tasked job; the next
        // chunk comes in once the window holds no untouched job
        if constexpr (JOBS != EVERY) {
          if (j == u) {
            pending &= pending - 1;
            if (!pending) break;
            u = (hi & ~31) + __ffs(pending) - 1;
          }
        }
      }
    }
    if constexpr (JOBS != EVERY) {
      if (left && !admit()) return false;
    }
  }
  if constexpr (FAULTS) {
    if (lane_id == 0) {
      fp.counts[lane * 2] = nsteps;
      fp.counts[lane * 2 + 1] = ncommits;
    }
  }
  if constexpr (DTPM) {
    // drain the windows between the last decision epoch and the makespan
    while (__fsub_rn(st_f[0], window) < st_f[2]) window_step();
    if (lane_id < C) dp.opp_idx[lane * C + lane_id] = oppidx_s[lane_id];
    if (lane_id == 0) dp.peak[lane] = st_f[1];
  }
  if (lane_id == 0) p.live[lane] = most;
  // before lo every job is done; after hi no job was touched
  for (int c = lane_id; c < J * T; c += 32) {
    const int j = c / T;
    const unsigned dn = j < lo ? all : j <= hi ? done[slot(j)]
                                               : ~(unsigned)valid_s[app_g[j]] & all;
    p.scheduled[row0 * T + c] = (unsigned char)((dn >> (c - j * T)) & 1u);
  }
  return true;
}

// The scan of one lane (one warp).  K1_LAUNCH_BOUNDS(DTPM) comes from the
// unit that includes this header: epoch_scan.cu builds the fault-free
// instantiations, epoch_scan_faults.cu the fail-stop ones.  WINDOWED
// (fault-free only): the live window, else every job at the start
template <bool DTPM, bool FAULTS, bool WINDOWED>
__global__ void K1_LAUNCH_BOUNDS(DTPM) epoch_scan_kernel(Params p, DtpmParams dp,
                                                         FaultParams fp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = p.A, T = p.T, P = p.P;
  const int C = DTPM ? dp.C : 0, K = DTPM ? dp.K : 1;
  const int lane_id = threadIdx.x;
  const int d = (int)((long long)blockIdx.x / p.S);

  // copy the tables of the lane's design, by the warp (scan_lane's layout)
  float* exec_s = reinterpret_cast<float*>(smem);
  float* ebytes_s = exec_s + A * T * P * K;
  float* mult_s = ebytes_s + A * T * T;
  int* pred_s = reinterpret_cast<int*>(mult_s + P * P);
  int* tpe_s = pred_s + A * T;
  int* valid_s = tpe_s + A * T;
  int* root_s = valid_s + A;
  if constexpr (DTPM) {
    float* pwr_s = reinterpret_cast<float*>(root_s + A);
    float* freq_s = pwr_s + P * K;
    int* nopp_s = reinterpret_cast<int*>(freq_s + C * K);
    int* dnode_s = nopp_s + C;
    float* dcpu_s = reinterpret_cast<float*>(dnode_s + C);
    int* pdom_s = reinterpret_cast<int*>(dcpu_s + C);
    float* iscpu_s = reinterpret_cast<float*>(pdom_s + P);
    int* node_s = reinterpret_cast<int*>(iscpu_s + P);
    float* pidle_s = reinterpret_cast<float*>(node_s + P);
    for (int i = lane_id; i < A * T * P * K; i += 32)
      exec_s[i] = dp.exec_opp[(long long)d * A * T * P * K + i];
    for (int i = lane_id; i < P * K; i += 32) pwr_s[i] = dp.pwr_opp[(long long)d * P * K + i];
    for (int i = lane_id; i < C * K; i += 32) freq_s[i] = dp.opp_freq[(long long)d * C * K + i];
    for (int i = lane_id; i < C; i += 32) {
      nopp_s[i] = dp.num_opp[(long long)d * C + i];
      dnode_s[i] = dp.domain_node[(long long)d * C + i];
      dcpu_s[i] = dp.domain_cpu[(long long)d * C + i];
    }
    for (int i = lane_id; i < P; i += 32) {
      pdom_s[i] = dp.pe_domain[(long long)d * P + i];
      iscpu_s[i] = dp.pe_is_cpu[(long long)d * P + i];
      node_s[i] = dp.node_of_pe[(long long)d * P + i];
      pidle_s[i] = dp.power_idle[(long long)d * P + i];
    }
  } else {
    for (int i = lane_id; i < A * T * P; i += 32)
      exec_s[i] = p.exec_us[(long long)d * A * T * P + i];
  }
  for (int i = lane_id; i < A * T * T; i += 32)
    ebytes_s[i] = p.ebytes[(long long)d * A * T * T + i];
  for (int i = lane_id; i < P * P; i += 32) mult_s[i] = p.comm_mult[(long long)d * P * P + i];
  for (int i = lane_id; i < A * T; i += 32) {
    pred_s[i] = p.pred_bits[(long long)d * A * T + i];
    tpe_s[i] = p.table_pe[(long long)d * A * T + i];
  }
  for (int i = lane_id; i < A; i += 32) valid_s[i] = p.valid_bits[(long long)d * A + i];
  __syncwarp();
  // per app, for a job no task of which is committed: its first eligible
  // task (a valid task with no valid pred) and its first eligible task with
  // no pred at all, each + 1 (0: none), in bits 0-7 and 8-15
  const unsigned all = T == 32 ? 0xffffffffu : ((1u << T) - 1u);
  for (int a = lane_id; a < A; a += 32) {
    const unsigned v = (unsigned)valid_s[a] & all;
    int ta = 0, tf = 0;
    for (unsigned m = v; m; m &= m - 1) {
      const int t = __ffs(m) - 1;
      const unsigned pm = (unsigned)pred_s[a * T + t];
      if (pm & v) continue;
      if (!ta) ta = t + 1;
      if (!pm && !tf) tf = t + 1;
    }
    root_s[a] = ta | (tf << 8);
  }
  __syncwarp();

  if constexpr (FAULTS || !WINDOWED) {
    scan_lane<DTPM, FAULTS, EVERY>(p, dp, fp);
  } else if (!scan_lane<DTPM, false, WINDOW>(p, dp, fp)) {
    // the window outgrew the ring: the lane again, its job state in global
    // memory (the wrapper passes the buffer wherever J exceeds the ring)
    __syncwarp();
    scan_lane<DTPM, false, SPILLED>(p, dp, fp);
  }
}

Params make_params(const void* exec_us, const void* pred_bits, const void* ebytes,
                   const void* valid_bits, const void* comm_mult, const void* comm_startup,
                   const void* comm_inv_bw, const void* table_pe, const void* arrival,
                   const void* app_idx, void* scheduled, void* start, void* finish, void* onpe,
                   void* live, void* spill, int D, int S, int J, int A, int T, int P,
                   int policy) {
  Params p;
  p.exec_us = static_cast<const float*>(exec_us);
  p.pred_bits = static_cast<const int*>(pred_bits);
  p.ebytes = static_cast<const float*>(ebytes);
  p.valid_bits = static_cast<const int*>(valid_bits);
  p.comm_mult = static_cast<const float*>(comm_mult);
  p.comm_startup = static_cast<const float*>(comm_startup);
  p.comm_inv_bw = static_cast<const float*>(comm_inv_bw);
  p.table_pe = static_cast<const int*>(table_pe);
  p.arrival = static_cast<const float*>(arrival);
  p.app_idx = static_cast<const int*>(app_idx);
  p.scheduled = static_cast<unsigned char*>(scheduled);
  p.start = static_cast<float*>(start);
  p.finish = static_cast<float*>(finish);
  p.onpe = static_cast<int*>(onpe);
  p.live = static_cast<int*>(live);
  p.spill = static_cast<unsigned long long*>(spill);
  p.D = D; p.S = S; p.J = J; p.A = A; p.T = T; p.P = P; p.policy = policy;
  return p;
}

bool bad_sizes(int D, int S, int J, int A, int T, int P, int policy) {
  return D < 1 || S < 1 || J < 1 || A < 1 || P < 1 || T < 1 || T > MAX_TASKS ||
         policy < ETF || policy > TABLE || (long long)J * T >= (1LL << 31) ||
         (long long)D * S >= (1LL << 31);
}

bool bad_dtpm(int P, int C, int K) {
  return P > MAX_DTPM || C < 1 || C > MAX_DTPM || K < 1 || K > MAX_DTPM;
}

// the table policy pins each task to its PE: it cannot route around a dead one
bool bad_faults(int policy, int cap) { return policy == TABLE || cap < 0; }

DtpmParams make_dtpm_params(const void* exec_opp, const void* pwr_opp, const void* opp_freq,
                            const void* num_opp, const void* domain_node,
                            const void* domain_cpu, const void* pe_domain,
                            const void* pe_is_cpu, const void* node_of_pe,
                            const void* power_idle, const void* window, const void* up,
                            const void* cap, const void* rc, const void* quanta,
                            const void* rc_consts, void* onopp, void* opp_idx, void* peak,
                            void* next_cell, int C, int K) {
  DtpmParams dp;
  dp.exec_opp = static_cast<const float*>(exec_opp);
  dp.pwr_opp = static_cast<const float*>(pwr_opp);
  dp.opp_freq = static_cast<const float*>(opp_freq);
  dp.num_opp = static_cast<const int*>(num_opp);
  dp.domain_node = static_cast<const int*>(domain_node);
  dp.domain_cpu = static_cast<const float*>(domain_cpu);
  dp.pe_domain = static_cast<const int*>(pe_domain);
  dp.pe_is_cpu = static_cast<const float*>(pe_is_cpu);
  dp.node_of_pe = static_cast<const int*>(node_of_pe);
  dp.power_idle = static_cast<const float*>(power_idle);
  dp.window = static_cast<const float*>(window);
  dp.up = static_cast<const float*>(up);
  dp.cap = static_cast<const float*>(cap);
  dp.rc = static_cast<const float*>(rc);
  dp.quanta = static_cast<const int*>(quanta);
  dp.rc_consts = static_cast<const float*>(rc_consts);
  dp.onopp = static_cast<int*>(onopp);
  dp.opp_idx = static_cast<int*>(opp_idx);
  dp.peak = static_cast<float*>(peak);
  dp.next_cell = static_cast<int*>(next_cell);
  dp.C = C; dp.K = K;
  return dp;
}

FaultParams make_fault_params(const void* faults, void* floor, void* counts, int cap) {
  FaultParams fp;
  fp.faults = static_cast<const float*>(faults);
  fp.floor = static_cast<float*>(floor);
  fp.counts = static_cast<int*>(counts);
  fp.cap = cap;
  return fp;
}


template <bool DTPM, bool FAULTS, bool WINDOWED>
int launch_as(const Params& p, const DtpmParams& dp, const FaultParams& fp, void* stream) {
  const long long bytes = 4 * shared_words(p.J, p.A, p.T, p.P, DTPM ? dp.C : 0,
                                           DTPM ? dp.K : 0, FAULTS);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(epoch_scan_kernel<DTPM, FAULTS, WINDOWED>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = (long long)p.D * p.S;   // a block (a warp) a lane
  epoch_scan_kernel<DTPM, FAULTS, WINDOWED><<<(unsigned)blocks, 32, (size_t)bytes,
                                              static_cast<cudaStream_t>(stream)>>>(p, dp, fp);
  return (int)cudaGetLastError();
}

// one launch: the fail-stop programs and a static one at J <= RING take
// every job at the start, the others keep the window
template <bool DTPM, bool FAULTS>
int launch(const Params& p, const DtpmParams& dp, const FaultParams& fp, void* stream) {
  if constexpr (FAULTS)
    return launch_as<DTPM, true, false>(p, dp, fp, stream);
  else if constexpr (DTPM)
    return launch_as<true, false, true>(p, dp, fp, stream);
  else
    return p.J > RING ? launch_as<false, false, true>(p, dp, fp, stream)
                      : launch_as<false, false, false>(p, dp, fp, stream);
}

// Threads a block, lanes a block, resident lanes an SM, dynamic shared bytes,
// registers a thread and local (stack and spill) bytes a thread of one launch
// at (J, A, T, P[, C, K]) (of the instantiation `launch` picks): out[0..5].
template <bool FAULTS>
int kernel_info(int J, int A, int T, int P, int C, int K, int dtpm, int* out) {
  const long long bytes = 4 * (dtpm ? shared_words(J, A, T, P, C, K, FAULTS)
                                    : shared_words(J, A, T, P, 0, 0, FAULTS));
  const void* kernel;
  if constexpr (FAULTS)
    kernel = dtpm ? (const void*)epoch_scan_kernel<true, true, false>
                  : (const void*)epoch_scan_kernel<false, true, false>;
  else
    kernel = dtpm ? (const void*)epoch_scan_kernel<true, false, true>
                  : J > RING ? (const void*)epoch_scan_kernel<false, false, true>
                             : (const void*)epoch_scan_kernel<false, false, false>;
  int per_sm = 0;
  cudaError_t rc = cudaSuccess;
  if (bytes > 48 * 1024)
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, (size_t)bytes);
  cudaFuncAttributes attr{};
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, kernel);
  out[0] = 32; out[1] = 1; out[2] = per_sm; out[3] = (int)bytes;
  out[4] = attr.numRegs; out[5] = (int)attr.localSizeBytes;
  return (int)rc;
}

}  // namespace
