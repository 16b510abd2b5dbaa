"""TX002 fixtures — host numpy on tensors in the hot set (bad + waiver)."""
import numpy as np
import torch


def step(x):
    return np.mean(x)                          # TX002 np on a tensor


def waived(x):
    y = torch.relu(x)
    return np.asarray(y)  # lint: waive TX002 -- fixture: demonstrates waiver
