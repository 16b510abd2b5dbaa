"""KL001 fixture — a tool that calls a kernel module's private launcher."""
import kl001_good as kernel


def time_it(x, out):
    return kernel._launch(x, out)              # KL001 no guard on this path
