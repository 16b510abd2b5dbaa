"""TX001 fixtures — host syncs in the hot set (all bad)."""
import torch


class Engine:
    def step(self, logits):
        nxt = torch.argmax(logits, dim=-1)
        self.peak(logits)
        return nxt.tolist()                    # TX001 .tolist()

    def peak(self, temps):
        return float(temps.max())              # TX001 float()


def make_step(model):
    def decode(x):
        h = model(x)
        if torch.isnan(h).any():               # TX001 if on a tensor
            raise ValueError("nan")
        return drain(h.cpu())                  # TX001 .cpu()
    return decode


def drain(x):
    while x.sum() > 0:                         # TX001 while on a reduction
        x = x - 1
    torch.cuda.synchronize()                   # TX001 synchronize
    return x
