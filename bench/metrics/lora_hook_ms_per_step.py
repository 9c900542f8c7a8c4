"""lora_hook_ms_per_step: device ms of the LoRA Server's hook kernels
(csrc/bgmv_expert.cu: names with "bgmv_expert") over the traced stretch,
divided by the stretch's decode steps."""
from bench import devtrace


def read(run):
    tr = run.devtrace
    if tr is None or not tr["n_steps"]:
        return None
    us = devtrace.kernel_us(tr, ("bgmv_expert",))
    return us / 1e3 / tr["n_steps"] if us > 0 else None
