"""Random schedules for the thermal grid, shared by its CPU tests
(tests/test_torch_thermal_grid.py), its card tests
(tests/test_torch_thermal_card.py) and chip_smoke.py's K6 phase.

Imports torch only, so that it runs on the card's machine as well.
"""
import torch


def schedules(gen, lead, J, T, pes, makespan_us=400.0, task_us=60.0,
              valid_p=0.8, busy_share=1.0):
    """Random (lead..., J, T) schedules on ``gen``'s device and (D, P) power
    tables, ``lead`` ending in (D, S).  Design d runs on its first
    ``pes[d]`` PEs (the rest are padding: no power, node 0).  A task starts
    uniformly in the first ``busy_share`` of ``makespan_us`` and runs
    1 + U(0, ``task_us``) us; a share ``valid_p`` of the cells is scheduled.
    Below a ``busy_share`` of 1 each lane's last cell is a 1 us task that
    ends at ``makespan_us``, so the period closes with an idle stretch.
    Returns (sim_out, node_of_pe, power_active, power_idle)."""
    dev = gen.device
    D, P = len(pes), max(pes)
    shape = tuple(lead) + (J, T)

    def u(*s):
        return torch.rand(s, generator=gen, device=dev)
    start = u(*shape) * (busy_share * makespan_us)
    finish = start + 1.0 + u(*shape) * task_us
    own = torch.tensor(pes, device=dev)[:, None, None, None]      # (D,1,1,1)
    onpe = (u(*shape) * own).to(torch.int32).clamp_max(own - 1)
    valid = u(*shape) < valid_p
    if busy_share < 1.0:
        start[..., -1, -1] = makespan_us - 1.0
        finish[..., -1, -1] = makespan_us
        valid[..., -1, -1] = True
    makespan = torch.where(valid, finish, 0.0).amax(dim=(-1, -2))
    out = dict(start=start, finish=finish, onpe=onpe, scheduled=valid,
               makespan_us=makespan)
    used = torch.arange(P, device=dev)[None, :] < own[:, :, 0, 0]  # (D, P)
    nodes = torch.where(used, (u(D, P) * 3).to(torch.int32), 0)
    p_act = torch.where(used, 0.1 + 2.9 * u(D, P), 0.0)
    p_idle = torch.where(used, 0.01 + 0.19 * u(D, P), 0.0)
    return out, nodes, p_act, p_idle


def node_power(out, tables, bins):
    """The plain version's (lanes..., bins, 3) node power trace of every
    lane, and the (lanes..., 3) power of each node with its PEs all idle
    and all busy."""
    from repro_torch.dse import thermal_torch as tthermal
    nodes, p_act, p_idle = tables
    lead = tuple(out["makespan_us"].shape)
    D, S = lead[-2:]
    d = torch.arange(D, device=nodes.device)[:, None].expand(lead)
    trace, _ = tthermal.binned_power_trace(
        out["start"], out["finish"], out["onpe"], out["scheduled"], nodes[d],
        p_act[d], p_idle[d], out["makespan_us"], bins=bins)
    onehot = torch.nn.functional.one_hot(nodes[d].long(), 3).float()
    return (trace, (p_idle[d][..., None] * onehot).sum(-2),
            (p_act[d][..., None] * onehot).sum(-2))


# Cases where the bins matter, each (the CPU tests' size, the card's: DS3's
# 1,000 jobs x 8 tasks) on designs of BIN_PES PEs: bins that the PEs fill in
# part (tasks of 1-61 us: every bin's node power lies strictly between its
# PEs' idle and busy power), and a period busy for its first half and idle
# for the rest, as long as the nodes' time constants (0.2-0.3 s), so that
# the ripple lifts the peak far above the warm start
BIN_PES = [15, 12, 7]
BIN_CASES = {
    "partial-utilisation": (
        dict(J=60, T=8, makespan_us=2_000.0, task_us=60.0),
        dict(J=1000, T=8, makespan_us=50_000.0, task_us=60.0)),
    "bursty-period": (
        dict(J=40, T=6, makespan_us=250_000.0, task_us=20_000.0,
             busy_share=0.5),
        dict(J=1000, T=8, makespan_us=250_000.0, task_us=600.0,
             busy_share=0.5)),
}


def assert_bins_matter(out, tables, bins, peak, case, rtol):
    """The case exercises what it is for: bins that the PEs fill in part
    ("partial-utilisation"), or a ``peak`` that the RC steps lift above the
    warm start by far more than ``rtol`` ("bursty-period")."""
    from repro_torch.dse import thermal_torch as tthermal
    trace, idle, busy = node_power(out, tables, bins)
    if case == "partial-utilisation":
        used = (busy > idle)[..., None, :].expand(trace.shape)
        gap = 0.05 * (busy - idle)[..., None, :]
        inner = (trace > idle[..., None, :] + gap) & \
            (trace < busy[..., None, :] - gap)
        assert float(inner[used].float().mean()) > 0.8, case
    else:
        steady = tthermal.steady_state(trace.mean(-2))[..., :3].amax(-1)
        assert bool(((peak - steady) > 100 * rtol * peak).all()), case
