"""SC001 fixtures — stable loop-step carries (all good)."""
import torch


def floor_step(i, acc):
    return i // 2, acc + 1                     # floor division keeps int


def run_floor(x):
    i, acc = 8, x
    while i > 1:
        i, acc = floor_step(i, acc)
    return acc


def float_step(t, e):
    return t / 2.0, e                          # float init: division is fine


def run_float(n):
    t, e = torch.zeros(()), torch.zeros(())
    for _ in range(n):
        t, e = float_step(t, e)
    return t


def sym(idx, a, b):
    if idx > 3:
        return a.float(), b
    return a.float(), b                        # a cast on every path: stable


def run_sym(a, b):
    for idx in range(10):
        a, b = sym(idx, a, b)
    return a


class Stack:
    def layer(self, x, cache):
        return x + 1, cache                    # a method as the step

    def run(self, x, cache, n):
        for _ in range(n):
            x, cache = self.layer(x, cache)
        return x


def opaque(state):
    return dict(state)                         # opaque: never guessed at


def run_opaque(state, n):
    for _ in range(n):
        state = opaque(state)
    return state


def run_closure(x, n):
    def inner(h, k):
        return h * k, k                        # a nested def as the step
    k = 2
    for _ in range(n):
        x, k = inner(x, k)
    return x
