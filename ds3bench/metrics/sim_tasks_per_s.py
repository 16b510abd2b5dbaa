"""sim_tasks_per_s: every task of every lane of every call in the window,
counted from the job traces the benchmark made, over the whole window
(host clock, from the first call's start to the last call's answers)."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.tasks for c in run.calls) / run.window_s
