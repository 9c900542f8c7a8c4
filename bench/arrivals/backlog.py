"""A backlog: ``count`` requests, every one due at once (t = 0), so the
queue is longer than a window finishes and every slot stays full."""
import numpy as np


def count(spec, seconds):
    return int(spec["count"])


def due(spec, n, rng, strata):
    return np.zeros(n)
