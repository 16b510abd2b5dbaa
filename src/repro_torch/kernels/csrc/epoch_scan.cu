// K1, the DS3 epoch scan for sm_90a, plain C interface.
//
// Replaces `_epoch_scan` of src/repro/core/simkernel_jax.py (:321), a lax.scan
// that XLA compiles (it has no Pallas original), in its static-governor,
// fault-free form under the etf, met and table schedulers.  Contract: for the
// static tables of one design and L lanes of (arrival, app_idx), the same
// scheduled, start, finish and onpe as that scan, bit for bit.
//
// Bound on an H100: neither bytes nor operations.  The scan is a chain of J*T
// dependent steps a lane (each commit moves the next step's ready times and
// PE queues); a lane's whole state is a few (J, T) arrays, so the card's
// memory rate and peak are far away, and what a step costs is its latency:
// a walk over the lane's open jobs, a block reduction and one commit.
//
// Design (a first form that is right; speed is for later):
//   * Grid: one block of THREADS threads per lane, lanes laid out (D, S): the
//     tables carry a leading design axis of D, and lane l reads design l / S.
//   * Shared memory for the whole scan: the design's small tables (exec_us
//     (A,T,P), ebytes (A,T,T), comm_mult (P,P), table_pe and each task's
//     predecessors as a T-bit mask (A,T), each app's valid tasks as a mask),
//     pe_free[P], and per job its arrival, app and `done` mask (T <= 32: one
//     32-bit word a job; the wrapper and the C entry refuse a larger T).  The
//     (J, T) schedule (start, finish, onpe) lives in global memory, which is
//     the output; the L2 holds it, and __syncthreads makes one thread's writes
//     visible to the block.
//   * Each step, in the reference's order:
//     1-2. a thread walks its jobs (j = tid, tid + THREADS, ...), skipping a
//          job whose tasks are all done; a task is eligible when it is not
//          done and its pred mask lies inside the job's done mask; its ready
//          time is max(arrival, max over preds of finish) (no preds: arrival,
//          as the reference's -BIG fill gives);
//     3.   a block reduction takes the least (ready, j*T + t) as one 64-bit
//          key (ready's order-preserving bits above the flat index): the
//          reference's rmin, then the first flat index at rmin; nothing
//          eligible, or rmin >= BIG/2, ends the scan (any_left);
//     4.   warp 0, a lane per PE: data_ready = max(rmin, over preds of
//          finish + comm), then start_c and fin_c;
//     5.   the policy's PE: etf the first argmin of fin_c, met of exec, table
//          table_pe, by a warp reduction over (value, PE) that keeps the
//          lower PE on ties;
//     6.   lane 0 commits s0 and f0 to the task and the PE's queue.
//   * Stopping early: the scan ends at the first step with nothing left.  In
//     the static, fault-free program every later step of the reference's J*T
//     is a no-op, so this is exact.  It does not hold for fail-stop faults,
//     whose rollbacks re-open tasks and whose skipped epochs commit nothing:
//     that program needs its own bound (ROADMAP.md queue 1, item 4).
// Numerics: f32 as the reference, op by op.  nvcc contracts a*b+c into one
// fma by default and the build's flags do not turn that off, so the three
// contractible spots are written with __fmul_rn / __fadd_rn, in the
// reference's order (simkernel_jax.py:487-491): base = startup + ebytes*inv_bw
// (multiply, then add), comm = mult*base, finish + comm.  fin = start + exec is
// one add.  BIG = 1e30 is finite on purpose (:43): an unsupported PE carries
// 1e30 of latency and loses etf and met as in the reference.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TASKS = 32;
constexpr float BIG = 1e30f;
constexpr int ETF = 0, MET = 1, TABLE = 2;
constexpr unsigned long long NONE = ~0ull;

struct Params {
  const float* exec_us;      // (D, A, T, P)
  const int* pred_bits;      // (D, A, T): bit t' set where t' precedes t
  const float* ebytes;       // (D, A, T, T): bytes t' -> t
  const int* valid_bits;     // (D, A): bit t set where task t exists
  const float* comm_mult;    // (D, P, P)
  const float* comm_startup; // (D,)
  const float* comm_inv_bw;  // (D,)
  const int* table_pe;       // (D, A, T)
  const float* arrival;      // (D*S, J)
  const int* app_idx;        // (D*S, J)
  unsigned char* scheduled;  // (D*S, J, T) bool
  float* start;              // (D*S, J, T)
  float* finish;             // (D*S, J, T), read back by later steps
  int* onpe;                 // (D*S, J, T), read back by later steps
  int D, S, J, A, T, P, policy;
};

// shared words of one block, in the order the kernel lays them out
__host__ __device__ inline long long shared_words(int J, int A, int T, int P) {
  return 2LL * WARPS + (long long)A * T * P + (long long)A * T * T + (long long)P * P +
         2LL * A * T + A + P + 3LL * J;
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

__global__ void __launch_bounds__(THREADS) epoch_scan_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int stop;
  const int A = p.A, T = p.T, P = p.P, J = p.J;
  const int tid = threadIdx.x, warp = tid / 32, lane_id = tid % 32;
  const long long lane = blockIdx.x;
  const int d = (int)(lane / p.S);

  unsigned long long* red = reinterpret_cast<unsigned long long*>(smem);  // WARPS
  float* exec_s = reinterpret_cast<float*>(red + WARPS);
  float* ebytes_s = exec_s + A * T * P;
  float* mult_s = ebytes_s + A * T * T;
  int* pred_s = reinterpret_cast<int*>(mult_s + P * P);
  int* tpe_s = pred_s + A * T;
  int* valid_s = tpe_s + A * T;
  float* pe_free = reinterpret_cast<float*>(valid_s + A);
  float* arr_s = pe_free + P;
  int* app_s = reinterpret_cast<int*>(arr_s + J);
  unsigned* done = reinterpret_cast<unsigned*>(app_s + J);

  // the design's tables, once
  for (int i = tid; i < A * T * P; i += THREADS) exec_s[i] = p.exec_us[(long long)d * A * T * P + i];
  for (int i = tid; i < A * T * T; i += THREADS) ebytes_s[i] = p.ebytes[(long long)d * A * T * T + i];
  for (int i = tid; i < P * P; i += THREADS) mult_s[i] = p.comm_mult[(long long)d * P * P + i];
  for (int i = tid; i < A * T; i += THREADS) {
    pred_s[i] = p.pred_bits[(long long)d * A * T + i];
    tpe_s[i] = p.table_pe[(long long)d * A * T + i];
  }
  for (int i = tid; i < A; i += THREADS) valid_s[i] = p.valid_bits[(long long)d * A + i];
  for (int i = tid; i < P; i += THREADS) pe_free[i] = 0.f;
  if (tid == 0) stop = 0;
  __syncthreads();

  const unsigned all = T == 32 ? 0xffffffffu : ((1u << T) - 1u);
  const long long row0 = lane * J;             // this lane's first job
  float* fin_g = p.finish + row0 * T;
  int* onpe_g = p.onpe + row0 * T;
  for (int j = tid; j < J; j += THREADS) {
    arr_s[j] = p.arrival[row0 + j];
    const int a = p.app_idx[row0 + j];
    app_s[j] = a;
    done[j] = ~(unsigned)valid_s[a] & all;     // a task that does not exist is done
  }
  for (int c = tid; c < J * T; c += THREADS) {
    p.start[row0 * T + c] = 0.f;
    fin_g[c] = 0.f;
    onpe_g[c] = 0;
  }
  const float startup = p.comm_startup[d], inv_bw = p.comm_inv_bw[d];
  __syncthreads();

  while (true) {
    // 1-2. eligible tasks of this thread's jobs and their ready times
    unsigned long long best = NONE;
    for (int j = tid; j < J; j += THREADS) {
      const unsigned dn = done[j];
      if (dn == all) continue;
      const int* pr = pred_s + app_s[j] * T;
      const float arr = arr_s[j];
      const float* fin_row = fin_g + (long long)j * T;
      unsigned open = ~dn & all;
      while (open) {
        const int t = __ffs(open) - 1;
        open &= open - 1;
        unsigned m = (unsigned)pr[t];
        if (m & ~dn) continue;               // a predecessor is not committed yet
        float ready = arr;
        while (m) {
          const int q = __ffs(m) - 1;
          m &= m - 1;
          ready = fmaxf(ready, fin_row[q]);
        }
        const unsigned long long key =
            ((unsigned long long)order_bits(ready) << 32) | (unsigned)(j * T + t);
        best = key < best ? key : best;
      }
    }
    // 3. the least (ready, flat index) of the block
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(FULL_MASK, best, o);
      best = other < best ? other : best;
    }
    if (lane_id == 0) red[warp] = best;
    __syncthreads();

    if (warp == 0) {
      best = lane_id < WARPS ? red[lane_id] : NONE;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(FULL_MASK, best, o);
        best = other < best ? other : best;
      }
      const float rmin = from_order_bits((unsigned)(best >> 32));
      if (best == NONE || !(rmin < BIG * 0.5f)) {
        if (lane_id == 0) stop = 1;          // nothing left: the rest are no-ops
      } else {
        const int flat = (int)(best & 0xffffffffu);
        const int j = flat / T, t = flat % T;
        const int at = app_s[j] * T + t;
        const unsigned pm = (unsigned)pred_s[at];
        const float* eb = ebytes_s + at * T;
        const float* ex_row = exec_s + at * P;
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
          const float ex = ex_row[pe];
          const float st = fmaxf(dr, pe_free[pe]);
          const float fn = st + ex;      // one add: nothing to contract
          const float v = p.policy == ETF ? fn : p.policy == MET ? ex
                                                 : (pe == tpe ? 0.f : inf);
          if (v < best_v) { best_v = v; best_pe = pe; best_s = st; best_f = fn; }
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
          const long long c = (long long)j * T + t;
          p.start[row0 * T + c] = best_s;
          fin_g[c] = best_f;
          onpe_g[c] = best_pe;
          pe_free[best_pe] = best_f;
          done[j] |= 1u << t;
        }
      }
    }
    __syncthreads();
    if (stop) break;
  }

  for (int c = tid; c < J * T; c += THREADS)
    p.scheduled[row0 * T + c] = (unsigned char)((done[c / T] >> (c % T)) & 1u);
}

}  // namespace

// Tables of D designs (exec_us (D,A,T,P) f32, pred_bits (D,A,T) i32, ebytes
// (D,A,T,T) f32, valid_bits (D,A) i32, comm_mult (D,P,P) f32, comm_startup and
// comm_inv_bw (D,) f32, table_pe (D,A,T) i32, each valid task's entry in 0..P-1 for the table
// policy), lanes (D*S, J) of arrival f32 and app_idx
// i32 in 0..A-1; outputs (D*S, J, T): scheduled (bool bytes), start, finish
// f32, onpe i32, all contiguous.  policy: 0 etf, 1 met, 2 table.  One launch
// of D*S blocks.  Returns 0 or a cudaError_t.
extern "C" int repro_epoch_scan(const void* exec_us, const void* pred_bits, const void* ebytes,
                                const void* valid_bits, const void* comm_mult,
                                const void* comm_startup, const void* comm_inv_bw,
                                const void* table_pe, const void* arrival, const void* app_idx,
                                void* scheduled, void* start, void* finish, void* onpe,
                                int D, int S, int J, int A, int T, int P, int policy,
                                void* stream) {
  if (D < 1 || S < 1 || J < 1 || A < 1 || P < 1 || T < 1 || T > MAX_TASKS ||
      policy < ETF || policy > TABLE || (long long)J * T >= (1LL << 31) ||
      (long long)D * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
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
  p.D = D; p.S = S; p.J = J; p.A = A; p.T = T; p.P = P; p.policy = policy;
  const long long bytes = 4 * shared_words(J, A, T, P);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        epoch_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  epoch_scan_kernel<<<(unsigned)((long long)D * S), THREADS, (size_t)bytes,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Threads per block, resident blocks per SM and dynamic shared bytes of one
// launch at (J, A, T, P).  Returns 0 or a cudaError_t.
extern "C" int repro_epoch_scan_info(int J, int A, int T, int P, int* out) {
  const long long bytes = 4 * shared_words(J, A, T, P);
  int per_sm = 0;
  cudaError_t rc = cudaSuccess;
  if (bytes > 48 * 1024)
    rc = cudaFuncSetAttribute(epoch_scan_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epoch_scan_kernel, THREADS,
                                                       (size_t)bytes);
  out[0] = THREADS; out[1] = per_sm; out[2] = (int)bytes;
  return (int)rc;
}

extern "C" const char* repro_epoch_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
