"""k1_ns_per_task: device time of the epoch-scan kernel (K1, every
instantiation of ``epoch_scan_kernel``) over the tasks of the traced calls
(``run.calls[].tasks``, counted from the benchmark's own traces), in ns:
K1's cost for each task it places (profiler trace)."""


def read(run):
    t = run.trace
    k1 = [] if t is None else t.k1_seconds()
    tasks = sum(c.tasks for c in run.calls)
    if not k1 or tasks <= 0:
        return None
    return 1e9 * sum(k1) / tasks
