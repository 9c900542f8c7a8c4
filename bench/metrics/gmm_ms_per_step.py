"""gmm_ms_per_step: device ms of the base expert GEMM kernels
(csrc/gmm.cu: names with "gmm_") over the traced stretch, divided by the
stretch's decode steps (prefill chunks' GEMMs included)."""
from bench import devtrace


def read(run):
    tr = run.devtrace
    if tr is None or not tr["n_steps"]:
        return None
    us = devtrace.kernel_us(tr, ("gmm_",))
    return us / 1e3 / tr["n_steps"] if us > 0 else None
