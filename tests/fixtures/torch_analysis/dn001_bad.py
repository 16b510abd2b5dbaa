"""DN001 fixtures — in-place writes to values that may alias (all bad)."""
import torch


def update(m, g):
    m2 = m.float()
    m2.mul_(0.9)                               # DN001 .mul_ of .float()
    m2.add_(g)                                 # the same binding: reported once
    return m2


def scale(x, dtype):
    y = x.to(dtype)
    torch.mul(y, 2.0, out=y)                   # DN001 out=
    return y


def fill(x):
    d = x.detach()
    d[0] = 0.0                                 # DN001 subscript assignment
    return d


def bump(buf):
    t = torch.as_tensor(buf)
    t += 1                                     # DN001 augmented assignment
    return t


def retype(x):
    z = x.type(torch.float32)
    z.copy_(x * 2)                             # DN001 .copy_
    return z
