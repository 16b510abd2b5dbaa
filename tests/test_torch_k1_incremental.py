"""K1's incremental bookkeeping, modelled on the CPU against the plain scan.

K1 (``csrc/epoch_scan.cuh``) keeps, per lane, one key per job (the least
``(order bits of ready) << 32 | j*T + t`` over the job's eligible tasks) and
the least key of each group of 32 slots, and recomputes only the key of the
job a commit or a rollback touched.  The fault-free programs hold only the
live window, the first job with a task left to the first job with none
placed, in a ring of W slots (job j in slot j % W), admit the next job
with its untouched key when the last one takes its first commit, and run
a lane again with every job in its own slot (the spill) when its window
outgrows the ring; the fail-stop ones keep every job live.  (Where the ring
has a slot for every job, J <= 1,024, K1's static program takes them all
at the start; the model runs the ring at every J, so that its small cases
reach the window's bookkeeping.)  Under DTPM it sums a window from per-PE commit lists whose
heads move past the cells that finished before the window.  CUDA cannot run
here, so ``model_scan`` below runs that bookkeeping lane by lane in numpy
f32 scalars, op by op as the kernel rounds, with the plain version's
``_Windows`` for the rest of the window step, and must equal
``epoch_scan_plain`` bit for bit on every output; the most jobs its window
held must equal ``live_jobs`` (tests/k1_window.py), worked out from the
plain outputs alone.  At every window its integer bins must equal
the plain version's fixed-point sums, and each PE's list from its head must
hold exactly that PE's committed cells that finish after the window's
start, in start order; after every step each live job's key and each
group's least key must be current and every other slot empty.  Broken
copies of the model must fail: with no head advance (every cell it keeps
lies before the window, so only the list check sees it), with the head
advanced past the cells that finish by the window's end instead of its
start (they still overlap it: the bins differ), with no key recompute after
a rollback (a stale key, and, with the checks of the model's own state off,
a different output), with no job admitted after the first, with a ring
that takes more jobs than its slots instead of spilling, and with the
window's first job never moved on (every output right, its held count
wrong).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import simkernel_torch as skt
from repro_torch.core.applications import _chain
from repro_torch.core.dvfs import policy_lanes
from repro_torch.core.jobgen import poisson_trace
from repro_torch.core.resources import make_soc_table2
from repro_torch.dse import DesignPoint
from repro_torch.kernels import epoch_scan as k1
from repro_torch.scenario import Scenario, tables_for

from k1_window import live_jobs

torch.set_num_threads(1)

f32 = np.float32
NONE = (1 << 64) - 1
HALF_BIG = f32(k1.BIG * 0.5)
APPS = ("wifi_tx", "wifi_rx", "single_carrier", "range_detection",
        "pulse_doppler")
THROTTLE = (("thermal_cap_c", 27.0), ("thermal_dt_s", 0.05))


def order_bits(x) -> int:
    u = int(np.array(x, np.float32).view(np.uint32))
    if u == 0x80000000:
        u = 0
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def from_order_bits(k: int):
    u = (k & 0x7FFFFFFF) if k & 0x80000000 else ~k & 0xFFFFFFFF
    return np.array(u, np.uint32).view(np.float32)[()]


def bits(m: int):
    t = 0
    while m:
        if m & 1:
            yield t
        m >>= 1
        t += 1


class Overflow(Exception):
    """The live window outgrew the ring: the lane runs again spilled."""


class Lane:
    """One lane of K1: its tables, the job state in slots (a ring of W, or
    every job in its own), the live window and under DTPM each PE's commit
    list."""

    def __init__(self, tables, policy, arrival, app_idx, design, gov=None,
                 faults=None, ring=None, spilled=False, advance_heads="w0",
                 rekey=True, admit=True, spill=True, advance_lo=True,
                 check_invariants=True):
        def tab(name, dtype=None):
            x = k1.per_design(tables, name)[design].numpy()
            return x if dtype is None else x.astype(dtype)
        self.policy, self.advance_heads, self.rekey = policy, advance_heads, rekey
        self.admit_more, self.spill, self.advance_lo = admit, spill, advance_lo
        self.check_invariants = check_invariants
        self.arr = arrival.numpy().astype(np.float32)
        self.app = app_idx.numpy().astype(np.int64)
        J, self.J = len(self.arr), len(self.arr)
        A, T, P = tables.exec_us.shape[-3:]
        self.T, self.P = T, P
        pred = tab("pred")                                  # (A, T, T)
        self.pred = [[sum(1 << q for q in range(T) if pred[a, t, q])
                      for t in range(T)] for a in range(A)]
        valid = tab("valid")
        self.valid = [sum(1 << t for t in range(T) if valid[a, t])
                      for a in range(A)]
        self.ebytes, self.mult = tab("ebytes", np.float32), tab("comm_mult", np.float32)
        self.startup = f32(tab("comm_startup"))
        self.inv_bw = f32(tab("comm_inv_bw"))
        self.table_pe = tab("table_pe")
        self.all = (1 << T) - 1
        self.start = np.zeros((J, T), np.float32)
        self.fin = np.zeros((J, T), np.float32)
        self.onpe = np.zeros((J, T), np.int64)
        self.onopp = np.zeros((J, T), np.int64)
        self.pe_free = np.zeros(P, np.float32)
        self.dtpm, self.faulted = gov is not None, faults is not None
        # the slots: job j in slot j % W of the ring; in slot j with faults
        # (every job live) or spilled
        self.direct, self.spilled = self.faulted or spilled, spilled
        self.W = J if self.direct else (ring or k1.job_slots(J))
        self.key = [NONE] * self.W
        self.done = [self.all] * self.W
        self.gmin = [NONE] * (-(-self.W // 32))
        if self.dtpm:
            self.exec = tab("exec_opp", np.float32)          # (A, T, P, K)
            self.win = k1._Windows(tables, gov, torch.tensor([design]),
                                   torch.device("cpu"))
            self.window = f32(gov.window[0])
            self.K = self.win.K
            self.head, self.tail = [-1] * P, [-1] * P
            self.nxt = np.full(J * T, -7, np.int64)
            self.makespan = f32(0.0)
        else:
            self.exec = tab("exec_us", np.float32)          # (A, T, P)
        if self.faulted:
            self.ftime = faults.numpy().astype(np.float32)
            self.fired = np.zeros(P, bool)
            self.hasfloor = [0] * J
            self.floor = np.zeros((J, T), np.float32)
            self.lo, self.hi, self.most = 0, J - 1, J
            for j in range(J):
                self.done[j] = ~self.valid[self.app[j]] & self.all
            self.key = [self.job_key(j) for j in range(J)]
            self.gmin = [self.group_min(g) for g in range(len(self.gmin))]
        else:
            self.lo, self.hi, self.most = 0, -1, 0
            self.admit()

    def slot(self, j: int) -> int:
        return j if self.direct else j % self.W

    def dn(self, j: int) -> int:
        """Job j's done mask: all before the window, untouched after it."""
        if j < self.lo:
            return self.all
        if j > self.hi:
            return ~self.valid[self.app[j]] & self.all
        return self.done[self.slot(j)]

    # -- the live window
    def admit(self):
        """lo past the jobs done, then the next chunks of 32 jobs in (a chunk
        is one group of slots) until one has a task, each job with its
        untouched key (the kernel's closed form: the arrival, or max(arrival,
        0) where a pred does not exist, at the app's first such task); u the
        chunk's first tasked job."""
        while self.advance_lo and self.lo <= self.hi and self.dn(self.lo) == self.all:
            self.lo += 1
        self.pending = []
        while self.hi + 1 < self.J:
            top = min(self.hi + 32, self.J - 1)
            if not self.direct and top - self.lo + 1 > self.W and self.spill:
                raise Overflow
            for j in range(self.hi + 1, top + 1):
                a, x = self.app[j], self.arr[j]
                v, k = self.valid[a], NONE
                # the app's first eligible task (a valid task with no valid
                # pred: ready max(x, 0)) and first one with no pred at all
                # (ready x), as the kernel tabulates them an app
                elig = [t for t in bits(v) if not self.pred[a][t] & v]
                ta = elig[0] if elig else -1
                tf = next((t for t in elig if not self.pred[a][t]), -1)
                if tf >= 0:
                    k = (order_bits(x) << 32) | (j * self.T + tf)
                if ta >= 0 and ta != tf:
                    k = min(k, (order_bits(max(x, f32(0.0))) << 32) | (j * self.T + ta))
                self.done[self.slot(j)], self.key[self.slot(j)] = ~v & self.all, k
                if v:
                    self.pending.append(j)
            g = self.slot(self.hi + 1) // 32
            self.hi = top
            self.gmin[g] = self.group_min(g)
            if self.pending:
                break
        self.u = self.pending[0] if self.pending else self.J
        self.most = max(self.most, self.hi - self.lo + 1)

    # -- the pick
    def job_key(self, j: int) -> int:
        dn, best = self.dn(j), NONE
        pr = self.pred[self.app[j]]
        for t in bits(~dn & self.all):
            if pr[t] & ~dn:
                continue                           # a pred is not committed yet
            ready = self.arr[j]
            for q in bits(pr[t]):
                ready = max(ready, self.fin[j, q])
            if self.faulted:
                ready = max(ready, self.floor[j, t]
                            if (self.hasfloor[j] >> t) & 1 else f32(0.0))
            best = min(best, (order_bits(ready) << 32) | (j * self.T + t))
        return best

    def group_min(self, g: int) -> int:
        return min(self.key[g * 32:(g + 1) * 32])

    def check_keys(self):
        live = {self.slot(j): j for j in range(self.lo, self.hi + 1)}
        assert len(live) == max(self.hi - self.lo + 1, 0), \
            "stale key: two live jobs share a slot"
        assert self.key == [self.job_key(live[s]) if s in live else NONE
                            for s in range(self.W)], "stale key"
        assert self.gmin == [self.group_min(g) for g in range(len(self.gmin))]

    def pick(self) -> int:
        """The least group minimum: of every group of the ring (a group
        outside the window is empty), of the window's groups when spilled."""
        groups = range(self.lo // 32, self.hi // 32 + 1) if self.spilled \
            else range(len(self.gmin))
        return min((self.gmin[g] for g in groups), default=NONE)

    # -- DTPM: the window from the per-PE lists
    def cells(self):
        """The lane's cells as the plain ``_Windows.step`` takes them."""
        sched = np.array([[(self.dn(j) >> t) & 1 for t in range(self.T)]
                          for j in range(self.J)], bool)
        valid = np.array([[(self.valid[a] >> t) & 1 for t in range(self.T)]
                          for a in self.app], bool)
        return tuple(torch.from_numpy(np.ascontiguousarray(x).reshape(1, -1))
                     for x in (sched & valid, self.start, self.fin, self.onpe,
                               self.onopp))

    def committed(self, c: int) -> bool:
        j, t = divmod(c, self.T)
        return bool((self.dn(j) >> t) & 1 and (self.valid[self.app[j]] >> t) & 1)

    def walk(self, pe: int):
        c, out = self.head[pe], []
        while c >= 0:
            out.append(c)
            c = self.nxt[c]
        return out

    def window_step(self):
        win = self.win
        w1 = f32(win.next_w[0])
        w0 = f32(w1 - self.window)
        scale_b, scale_e = (f32(x) for x in win.scales[0, :, 0])
        power = win.power_opp[0].numpy()
        busy, energy = np.zeros(self.P, np.int64), np.zeros(self.P, np.int64)
        # the head moves past the cells that finish by w0 (a mutation: by w1)
        bound = {"w0": w0, "w1": w1}.get(self.advance_heads)
        for pe in range(self.P):
            c = self.head[pe]
            if bound is not None:
                while c >= 0 and not self.fin.flat[c] > bound:
                    c = self.nxt[c]                 # no later window sees these
                self.head[pe] = c
                if c < 0:
                    self.tail[pe] = -1
            live = self.walk(pe)
            if self.check_invariants:
                # the list from the head: this PE's committed cells that
                # finish after w0, in start order
                want = [c for c in range(self.J * self.T) if self.committed(c)
                        and self.onpe.flat[c] == pe and self.fin.flat[c] > w0]
                assert sorted(live) == want, f"PE {pe}: list {live}, live cells {want}"
                s = self.start.flat[live]
                assert np.all(s[1:] >= self.fin.flat[live][:-1]), "list out of order"
            for c in live:
                s = self.start.flat[c]
                if s >= w1:
                    break                          # every later cell starts later
                ov = min(max(f32(min(self.fin.flat[c], w1) - max(s, w0)), f32(0.0)),
                         self.window)
                if ov > 0:
                    e = f32(ov * power[pe * self.K + self.onopp.flat[c]])
                    busy[pe] += int(np.rint(f32(ov * scale_b)))
                    energy[pe] += int(np.rint(f32(e * scale_e)))
        # the plain version's integer bins of the same window
        committed, start, fin, onpe, onopp = cells = self.cells()
        window = win.window[:, None]
        w1t = win.next_w[:, None]
        ov = torch.minimum(torch.clamp(torch.minimum(fin, w1t)
                                       - torch.maximum(start, w1t - window),
                                       min=0.0), window)
        ov = torch.where(committed, ov, 0.0)
        p_cell = win.power_opp.gather(1, onpe * self.K + onopp)
        acc = k1.fixed_sums(torch.stack([ov, ov * p_cell], dim=1), win.scales,
                            onpe[:, None, :], self.P)
        assert acc[0, 0].tolist() == busy.tolist(), "busy bins differ"
        assert acc[0, 1].tolist() == energy.tolist(), "energy bins differ"
        win.step(torch.tensor([True]), *cells)

    # -- a step: place the pick, commit, rekey its job
    def place(self, j: int, t: int, rmin):
        if self.dtpm:
            while self.win.next_w[0] <= torch.tensor(rmin):
                self.window_step()
            opp_pe = self.win.opp_pe[0].tolist()
        a = self.app[j]
        pm, eb = self.pred[a][t], self.ebytes[a, t]
        inf = f32(np.inf)
        best = None
        for pe in range(self.P):
            dr = rmin
            for q in bits(pm):
                base = f32(self.startup + f32(eb[q] * self.inv_bw))
                comm = f32(self.mult[self.onpe[j, q], pe] * base)
                dr = max(dr, f32(self.fin[j, q] + comm))
            ex = self.exec[a, t, pe, opp_pe[pe]] if self.dtpm else self.exec[a, t, pe]
            st = max(dr, self.pe_free[pe])
            fn = f32(st + ex)
            if self.policy == "table":
                v = f32(0.0) if pe == self.table_pe[a, t] else inf
            else:
                v = fn if self.policy == "etf" else ex
            if self.faulted and self.fired[pe]:
                v = inf
            if best is None or v < best[0]:
                best = (v, pe, st, fn)
        _, pe, s0, f0 = best
        self.start[j, t], self.fin[j, t], self.onpe[j, t] = s0, f0, pe
        self.pe_free[pe] = f0
        self.done[self.slot(j)] |= 1 << t
        if self.dtpm:
            c = j * self.T + t
            self.onopp[j, t] = opp_pe[pe]
            self.makespan = max(self.makespan, f0)
            self.nxt[c] = -1
            if self.tail[pe] >= 0:
                self.nxt[self.tail[pe]] = c
            else:
                self.head[pe] = c
            self.tail[pe] = c
        self.key[self.slot(j)] = self.job_key(j)
        self.gmin[self.slot(j) // 32] = self.group_min(self.slot(j) // 32)
        if not self.faulted and j == self.u:
            # job u's first commit: the next tasked job, or the next chunk
            self.pending.pop(0)
            self.u = self.pending[0] if self.pending else self.J
            if not self.pending and self.admit_more:
                self.admit()
        if self.check_invariants:
            self.check_keys()

    def roll_back(self, fire):
        """The kernel's rollback, a job at a time."""
        T, lost = self.T, False
        newfree = np.zeros(self.P, np.float32)
        mk = f32(0.0)
        for j in range(self.J):
            pr = self.pred[self.app[j]]
            committed = self.done[j] & self.valid[self.app[j]]
            inv = 0
            for t in bits(committed):
                pe = self.onpe[j, t]
                if fire[pe] and self.fin[j, t] > self.ftime[pe]:
                    inv |= 1 << t
            if inv:
                grew = True
                while grew:
                    grew = False
                    for t in bits(committed & ~inv):
                        if pr[t] & inv:
                            inv |= 1 << t
                            grew = True
                any_pred = sum(1 << t for t in range(T) if pr[t] & inv)
                roots = inv & ~any_pred
                for t in bits(inv):
                    if (roots >> t) & 1:
                        self.floor[j, t] = self.ftime[self.onpe[j, t]]
                    self.fin[j, t] = self.start[j, t] = 0.0
                    self.onpe[j, t] = self.onopp[j, t] = 0
                self.hasfloor[j] = (self.hasfloor[j] & ~any_pred) | roots
                committed &= ~inv
                self.done[j] &= ~inv
                lost = True
                if self.rekey:
                    self.key[j] = self.job_key(j)
            for t in bits(committed):
                pe = self.onpe[j, t]
                newfree[pe] = max(newfree[pe], self.fin[j, t])
                mk = max(mk, self.fin[j, t])
        if lost:
            self.pe_free[:] = newfree
        self.fired |= fire
        if lost:
            if self.dtpm:
                self.makespan = mk
                for pe in range(self.P):
                    keep = [c for c in self.walk(pe) if self.committed(c)]
                    for a, b in zip(keep, keep[1:]):
                        self.nxt[a] = b
                    if keep:
                        self.nxt[keep[-1]] = -1
                    self.head[pe] = keep[0] if keep else -1
                    self.tail[pe] = keep[-1] if keep else -1
            self.gmin = [self.group_min(g) for g in range(len(self.gmin))]
            if self.check_invariants:
                self.check_keys()

    def run(self, cap=None):
        steps = commits = 0
        while True:
            best = self.pick()
            rmin = from_order_bits(best >> 32)
            if best == NONE or not rmin < HALF_BIG:
                break
            j, t = divmod(best & 0xFFFFFFFF, self.T)
            go = True
            if self.faulted:
                if steps >= cap:
                    break
                steps += 1
                fire = ~self.fired & (self.ftime <= rmin)
                if fire.any():
                    self.roll_back(fire)
                    go = not self.pred[self.app[j]][t] & ~self.done[j]
            if go:
                self.place(j, t, rmin)
                commits += 1
        if self.dtpm:
            while f32(self.win.next_w[0] - self.win.window[0]) < self.makespan:
                self.window_step()
        sched = np.array([[(self.dn(j) >> t) & 1 for t in range(self.T)]
                          for j in range(self.J)], bool)
        out = [torch.from_numpy(sched), torch.from_numpy(self.start),
               torch.from_numpy(self.fin),
               torch.from_numpy(self.onpe.astype(np.int32))]
        if self.dtpm:
            out += [torch.from_numpy(self.onopp.astype(np.int32)),
                    self.win.opp_idx[0].to(torch.int32), self.win.peak[0]]
        if self.faulted:
            out.append(torch.tensor([steps, commits], dtype=torch.int32))
        return out, self.most


def model_scan(tables, policy, arrival, app_idx, gov=None, faults=None,
               **mutation):
    """The kernel's bookkeeping, lane by lane: the outputs stacked as
    ``epoch_scan_plain`` returns them, and the most jobs each lane held live
    (L,)."""
    L, J = arrival.shape
    design = k1.lane_designs(tables, L).tolist()
    cap = None
    if faults is not None:
        from repro_torch.scenario.faults import fault_scan_steps
        cap = fault_scan_steps(J, tables.t_max,
                               int(torch.isfinite(faults).sum(1).max()))
    lanes = []
    for l in range(L):
        args = (tables, policy, arrival[l], app_idx[l], design[l],
                None if gov is None else gov.take(torch.tensor([l])),
                None if faults is None else faults[l])
        try:
            lanes.append(Lane(*args, **mutation).run(cap))
        except Overflow:
            # the window outgrew the ring: the lane again, spilled
            lanes.append(Lane(*args, spilled=True, **mutation).run(cap))
    outs, most = zip(*lanes)
    return [torch.stack(x) for x in zip(*outs)], torch.tensor(most, dtype=torch.int32)


def lanes_of(apps, rates, jobs):
    traces = [poisson_trace(r, jobs, apps, seed=k) for k, r in enumerate(rates)]
    return (torch.from_numpy(np.stack([t.arrival_us for t in traces])),
            torch.from_numpy(np.stack([t.app_index for t in traces])))


def case(name):
    """(tables, policy, arrival, app_idx, gov, faults) of a named case."""
    program, policy = name.split("-")
    apps = APPS if program == "static" else ("wifi_tx", "wifi_rx")
    # 45 and 37 jobs: not multiples of 32, so the last group is ragged
    rates = (20.0, 60.0) if program == "static" else (70.0,)
    arrival, app_idx = lanes_of(apps, rates, 45 if program == "static" else 37)
    if program == "tiny":
        # one two-task app, 1,100 jobs: 35 groups, more than a warp's 32
        app = _chain("tiny", ["scrambler_encoder", "crc"])
        tables = skt.build_tables(make_soc_table2(), [app], device="cpu")
        arrival = torch.from_numpy(
            poisson_trace(60.0, 1100, ["tiny"], seed=0).arrival_us)[None]
        return tables, policy, arrival, torch.zeros_like(arrival, dtype=torch.long), \
            None, None
    design = DesignPoint(num_vit=1)
    if program.startswith("overload"):
        # two PEs at 80 jobs/ms: the backlog grows through the trace
        design = DesignPoint(num_big=1, num_little=1, num_scr=0, num_fft=0)
        arrival, app_idx = lanes_of(APPS, (80.0,), 70)
    gov, params = {"ondemand": ("ondemand", ()), "throttle": ("throttle", THROTTLE),
                   "dtpmfaults": ("ondemand", ()), "overloaddtpm": ("ondemand", ())
                   }.get(program, ("performance", ()))
    scn = Scenario(design=design, apps=apps if design.num_vit else APPS,
                   scheduler=policy, governor=gov, governor_params=params)
    tables = tables_for(scn, device="cpu")
    pol = policy_lanes(scn.make_policy(), len(arrival)) if gov != "performance" else None
    plans = None
    if "faults" in program:
        # four PEs lost, each while it runs a task (so tasks roll back)
        plans = torch.full((len(arrival), tables.num_pes), float("inf"))
        for pe, t_us in ((0, 36.0), (1, 200.0), (10, 140.0), (14, 130.0)):
            plans[:, pe] = t_us
    return tables, policy, arrival, app_idx, pol, plans


CASES = ["static-etf", "static-met", "static-table", "ondemand-met",
         "throttle-met", "faults-etf", "faults-met", "dtpmfaults-met",
         "tiny-etf", "overload-etf", "overloaddtpm-met"]
# a ring of 32 slots on the overloaded lanes, so that their windows spill
RINGS = {"overload-etf": 32, "overloaddtpm-met": 32}


def check_held(name, tables, arrival, app_idx, want, most, plans):
    """The most jobs the model held live is what ``live_jobs`` reads off the
    plain outputs; the overloaded lanes outgrew their ring."""
    held = live_jobs(tables, arrival, app_idx, want[0], want[2],
                        plans is not None)
    assert torch.equal(most, held), f"held {most.tolist()}, want {held.tolist()}"
    if name in RINGS:
        assert int(most.min()) > RINGS[name]


@pytest.mark.parametrize("name", CASES)
def test_incremental_model_equals_plain_scan(name):
    tables, policy, arrival, app_idx, gov, plans = case(name)
    want = k1.epoch_scan_plain(tables, policy, arrival, app_idx, gov, plans)
    got, most = model_scan(tables, policy, arrival, app_idx, gov, plans,
                           ring=RINGS.get(name))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), (name, k)
    check_held(name, tables, arrival, app_idx, want, most, plans)
    if plans is not None:         # the faults did roll back committed tasks
        assert int(want[-1][:, 1].sum()) > int(tables.valid[app_idx].sum())


@pytest.mark.parametrize("name,mutation,fails_on", [
    ("dtpmfaults-met", {"advance_heads": None}, "list"),
    ("dtpmfaults-met", {"advance_heads": "w1", "check_invariants": False},
     "bins differ|output"),
    ("faults-met", {"rekey": False}, "stale key"),
    ("faults-met", {"rekey": False, "check_invariants": False}, "output"),
    ("static-met", {"admit": False}, "output"),
    ("overload-etf", {"ring": 32, "spill": False}, "stale key"),
    ("overload-etf", {"ring": 32, "spill": False, "check_invariants": False},
     "output"),
    ("overload-etf", {"ring": 32, "advance_lo": False}, "held")])
def test_broken_bookkeeping_fails(name, mutation, fails_on):
    tables, policy, arrival, app_idx, gov, plans = case(name)
    want = k1.epoch_scan_plain(tables, policy, arrival, app_idx, gov, plans)
    with pytest.raises(AssertionError, match=fails_on):
        got, most = model_scan(tables, policy, arrival, app_idx, gov, plans,
                               **mutation)
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and torch.equal(g, w), f"output {k} differs"
        check_held(name, tables, arrival, app_idx, want, most, plans)
