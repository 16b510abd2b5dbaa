"""SC001 fixtures — unstable loop-step carries (all bad)."""
import torch


def grow(a, b, x):
    return a, b, x                             # SC001 arity 2 -> 3


def run_grow(xs):
    a, b = torch.zeros(()), torch.zeros(())
    for x in xs:
        a, b = grow(a, b, x)
    return a, b


def swap(a, b):
    return b, a                                # SC001 reordered carry


def run_swap(n):
    a, b = torch.zeros(()), torch.ones(())
    for _ in range(n):
        a, b = swap(a, b)
    return a


def halve(i, acc):
    return i / 2, acc + 1                      # SC001 true division, int carry


def run_halve(x):
    i, acc = 8, x
    while i > 1:
        i, acc = halve(i, acc)
    return acc


def smooth(count, x):
    return count.mean(), x                     # SC001 .mean() of an int carry


def run_smooth(xs):
    count = torch.zeros(4, dtype=torch.int32)
    for x in xs:
        count, x = smooth(count, x)
    return count


def cast(v, y):
    return v.to(torch.int32), y                # SC001 cast against a float init


def run_cast(y):
    v = torch.zeros((), dtype=torch.float32)
    while y > 0:
        v, y = cast(v, y)
    return v


def branchy(idx, a, b):
    if idx > 3:
        return a.float(), b                    # SC001 cast on 1 of 2 paths
    return a, b


def run_branchy(a, b):
    for idx in range(10):
        a, b = branchy(idx, a, b)
    return a, b
