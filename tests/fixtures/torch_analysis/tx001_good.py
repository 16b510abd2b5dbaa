"""TX001 fixtures — host-side idioms that stay clean."""
import numpy as np
import torch


def decode_step(x, window: int, scale: float = 1.0, causal=True):
    n = int(x.shape[0] * 2)                    # shape is metadata
    if x.dim() > 2 and x.numel() > 0:          # metadata again
        x = x.flatten(0, 1)
    if window > 4 and causal:                  # host parameters
        x = x[-window:]
    w = float(scale)                           # a host float
    return x * w, n


def on_host(xs):
    if not isinstance(xs, torch.Tensor):
        xs = np.ascontiguousarray(xs)          # narrowed: not a tensor here
    return torch.as_tensor(xs)


def host_driver(x):
    out, _ = decode_step(x, 4)
    return out.tolist()                        # not in the hot set
