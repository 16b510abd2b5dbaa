// K1, the DS3 epoch scan for sm_90a: the fault-free programs, static
// governors (epoch_scan_kernel<false, false>) and closed-loop DTPM
// (<true, false>), with a plain C interface.  The kernel and its design
// notes are in epoch_scan.cuh; the fail-stop programs are built apart, in
// epoch_scan_faults.cu.  The bound is the block of one warp (a lane);
// ptxas may then take up to 255 registers a thread, and even that leaves 8
// warps (lanes) an SM, so shared memory, not registers, sets the lanes an SM.
#define K1_LAUNCH_BOUNDS(DTPM) __launch_bounds__(32)
#include "epoch_scan.cuh"

// Tables of D designs (exec_us (D,A,T,P) f32, pred_bits (D,A,T) i32, ebytes
// (D,A,T,T) f32, valid_bits (D,A) i32, comm_mult (D,P,P) f32, comm_startup and
// comm_inv_bw (D,) f32, table_pe (D,A,T) i32, each valid task's entry in 0..P-1 for the table
// policy), lanes (D*S, J) of arrival f32 (ascending in each lane: the kernel
// traps where one falls) and app_idx i32 in 0..A-1; outputs (D*S, J, T):
// scheduled (bool bytes), start, finish f32, onpe i32, all contiguous; live
// (D*S,) i32, the most jobs a lane held (J where J is at most the ring's
// slots); spill (D*S, spill_words(J)) 64-bit scratch (no initial value
// needed), or null where J is at most the ring's slots.  policy: 0 etf, 1
// met, 2 table.  One launch of D*S blocks of one warp, a lane each.  Returns
// 0 or a cudaError_t.
extern "C" int repro_epoch_scan(const void* exec_us, const void* pred_bits, const void* ebytes,
                                const void* valid_bits, const void* comm_mult,
                                const void* comm_startup, const void* comm_inv_bw,
                                const void* table_pe, const void* arrival, const void* app_idx,
                                void* scheduled, void* start, void* finish, void* onpe,
                                void* live, void* spill, int D, int S, int J, int A, int T,
                                int P, int policy, void* stream) {
  if (bad_sizes(D, S, J, A, T, P, policy)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(exec_us, pred_bits, ebytes, valid_bits, comm_mult, comm_startup,
                               comm_inv_bw, table_pe, arrival, app_idx, scheduled, start, finish,
                               onpe, live, spill, D, S, J, A, T, P, policy);
  return launch<false, false>(p, DtpmParams{}, FaultParams{}, stream);
}

// The DTPM program: the static arguments (exec_us is not read; live and
// spill included), then the design's OPP tables (exec_opp (D,A,T,P,K),
// power_active_opp (D,P,K), opp_freq (D,C,K) f32, num_opp (D,C) i32 >= 1,
// domain_node (D,C) i32 in 0..2, domain_cpu (D,C) f32, pe_domain (D,P) i32
// in 0..C-1, pe_is_cpu (D,P) f32, node_of_pe (D,P) i32 in 0..2, power_idle
// (D,P) f32), per lane the policy (window, up, cap (D*S,) f32, window > 0
// and up > 0; rc (D*S,2,4,4) f32, the exact RC step's A and B; quanta
// (D*S,2) i32, the window sums' fixed-point exponents), rc_consts (5,) f32
// (C_NODE, ambient drive, ambient), and the outputs onopp (D*S,J,T) i32,
// opp_idx (D*S,C) i32, peak (D*S,) f32, and the scratch next_cell (D*S,J,T)
// i32 (no initial value needed).  P, C, K <= 32.  Returns 0 or a
// cudaError_t.
extern "C" int repro_epoch_scan_dtpm(
    const void* exec_us, const void* pred_bits, const void* ebytes, const void* valid_bits,
    const void* comm_mult, const void* comm_startup, const void* comm_inv_bw,
    const void* table_pe, const void* arrival, const void* app_idx, void* scheduled,
    void* start, void* finish, void* onpe, void* live, void* spill, const void* exec_opp,
    const void* pwr_opp, const void* opp_freq, const void* num_opp, const void* domain_node,
    const void* domain_cpu, const void* pe_domain, const void* pe_is_cpu,
    const void* node_of_pe, const void* power_idle, const void* window, const void* up,
    const void* cap, const void* rc, const void* quanta, const void* rc_consts, void* onopp,
    void* opp_idx, void* peak, void* next_cell, int D, int S, int J, int A, int T, int P,
    int policy, int C, int K, void* stream) {
  if (bad_sizes(D, S, J, A, T, P, policy) || bad_dtpm(P, C, K))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(exec_us, pred_bits, ebytes, valid_bits, comm_mult, comm_startup,
                               comm_inv_bw, table_pe, arrival, app_idx, scheduled, start, finish,
                               onpe, live, spill, D, S, J, A, T, P, policy);
  const DtpmParams dp = make_dtpm_params(exec_opp, pwr_opp, opp_freq, num_opp, domain_node,
                                         domain_cpu, pe_domain, pe_is_cpu, node_of_pe,
                                         power_idle, window, up, cap, rc, quanta, rc_consts,
                                         onopp, opp_idx, peak, next_cell, C, K);
  return launch<true, false>(p, dp, FaultParams{}, stream);
}

// Threads a block, lanes a block, resident lanes an SM, dynamic shared bytes,
// registers a thread and local (stack and spill) bytes a thread of one launch
// at (J, A, T, P), of the DTPM kernel (with C, K) when dtpm != 0: out[0..5].
// Returns 0 or a cudaError_t.
extern "C" int repro_epoch_scan_info(int J, int A, int T, int P, int C, int K, int dtpm,
                                     int* out) {
  return kernel_info<false>(J, A, T, P, C, K, dtpm, out);
}

extern "C" const char* repro_epoch_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
