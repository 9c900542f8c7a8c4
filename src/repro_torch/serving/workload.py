"""Traffic helpers of the port: its own copy of what it needs from the
reference's ``repro.serving.workload``."""
from __future__ import annotations

import numpy as np


def zipf_popularity(n_adapters: int, s: float = 1.2) -> np.ndarray:
    """Adapter popularity p_i proportional to 1 / i**s, i = 1..n_adapters."""
    w = 1.0 / np.arange(1, n_adapters + 1) ** s
    return w / w.sum()
