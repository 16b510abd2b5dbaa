"""WV001 fixture — a waiver with no justification (strict-mode finding)."""
import numpy as np


def step(x):
    return np.mean(x)  # lint: waive TX002
