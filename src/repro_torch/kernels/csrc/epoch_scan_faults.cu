// K1, the DS3 epoch scan for sm_90a: the fail-stop programs, static
// governors (epoch_scan_kernel<false, true>) and closed-loop DTPM
// (<true, true>), under etf and met, with a plain C interface.  The kernel
// and its design notes are in epoch_scan.cuh.  The bound is the block of
// one warp (a lane), as in epoch_scan.cu: at up to 255 registers a thread an
// SM still holds 8 warps (lanes), so shared memory, not registers, sets the
// lanes an SM.
#define K1_LAUNCH_BOUNDS(DTPM) __launch_bounds__(32)
#include "epoch_scan.cuh"

// The static program with fail-stop faults: the static arguments (live
// reads J: every job stays live; spill is not read), then per lane the fail
// times faults (D*S,P) f32 (inf: never), the scratch floor
// (D*S,J,T) f32 (no initial value needed), the output counts (D*S,2) i32
// (steps taken, tasks committed) and the step cap of every lane.  etf or
// met only.  Returns 0 or a cudaError_t.
extern "C" int repro_epoch_scan_faults(const void* exec_us, const void* pred_bits,
                                       const void* ebytes, const void* valid_bits,
                                       const void* comm_mult, const void* comm_startup,
                                       const void* comm_inv_bw, const void* table_pe,
                                       const void* arrival, const void* app_idx, void* scheduled,
                                       void* start, void* finish, void* onpe,
                                       void* live, void* spill, const void* faults,
                                       void* floor, void* counts, int cap,
                                       int D, int S, int J, int A, int T, int P, int policy,
                                       void* stream) {
  if (bad_sizes(D, S, J, A, T, P, policy) || bad_faults(policy, cap))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(exec_us, pred_bits, ebytes, valid_bits, comm_mult, comm_startup,
                               comm_inv_bw, table_pe, arrival, app_idx, scheduled, start, finish,
                               onpe, live, spill, D, S, J, A, T, P, policy);
  return launch<false, true>(p, DtpmParams{}, make_fault_params(faults, floor, counts, cap),
                             stream);
}

// The DTPM program with fail-stop faults: the DTPM arguments (next_cell
// included), then the fault arguments of repro_epoch_scan_faults.  etf or met only.  Returns 0 or a
// cudaError_t.
extern "C" int repro_epoch_scan_dtpm_faults(
    const void* exec_us, const void* pred_bits, const void* ebytes, const void* valid_bits,
    const void* comm_mult, const void* comm_startup, const void* comm_inv_bw,
    const void* table_pe, const void* arrival, const void* app_idx, void* scheduled,
    void* start, void* finish, void* onpe, void* live, void* spill, const void* exec_opp,
    const void* pwr_opp, const void* opp_freq, const void* num_opp, const void* domain_node,
    const void* domain_cpu, const void* pe_domain, const void* pe_is_cpu,
    const void* node_of_pe, const void* power_idle, const void* window, const void* up,
    const void* cap, const void* rc, const void* quanta, const void* rc_consts, void* onopp,
    void* opp_idx, void* peak, void* next_cell, const void* faults, void* floor, void* counts,
    int step_cap, int D, int S, int J, int A, int T, int P, int policy, int C, int K,
    void* stream) {
  if (bad_sizes(D, S, J, A, T, P, policy) || bad_dtpm(P, C, K) ||
      bad_faults(policy, step_cap))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(exec_us, pred_bits, ebytes, valid_bits, comm_mult, comm_startup,
                               comm_inv_bw, table_pe, arrival, app_idx, scheduled, start, finish,
                               onpe, live, spill, D, S, J, A, T, P, policy);
  const DtpmParams dp = make_dtpm_params(exec_opp, pwr_opp, opp_freq, num_opp, domain_node,
                                         domain_cpu, pe_domain, pe_is_cpu, node_of_pe,
                                         power_idle, window, up, cap, rc, quanta, rc_consts,
                                         onopp, opp_idx, peak, next_cell, C, K);
  return launch<true, true>(p, dp, make_fault_params(faults, floor, counts, step_cap), stream);
}

// As repro_epoch_scan_info, for the fail-stop kernels.
extern "C" int repro_epoch_scan_faults_info(int J, int A, int T, int P, int C, int K,
                                            int dtpm, int* out) {
  return kernel_info<true>(J, A, T, P, C, K, dtpm, out);
}

extern "C" const char* repro_epoch_scan_faults_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
