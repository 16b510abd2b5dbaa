"""DN001 fixtures — in-place writes that cannot alias (all good)."""
import torch


def master(p):
    w = p.detach().to(torch.float32, copy=True)   # a copy, always
    w.mul_(0.5)
    return w


def cloned(x):
    y = x.float().clone()
    y.add_(1.0)
    return y


def rebound(x):
    y = x.float()
    y = y * 2                                  # a rebind: a new tensor
    y.add_(1.0)
    return y


def through_view(cache, new, slot):
    cache.view(-1)[slot] = 0.0                 # through a view, on purpose
    cache[:, slot] = new.to(cache.dtype)       # a parameter, not an alias
    return cache


def fresh(shape):
    out = torch.empty(shape)
    torch.zeros(shape, out=out)
    out.add_(1.0)
    return out
