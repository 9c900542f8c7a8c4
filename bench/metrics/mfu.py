"""mfu: the model flops of the window's work (``bench/flops.py``, counted
from the configuration and the traffic) over the chips' bf16 peak times
the window's seconds, in %.

The work: each prompt whose prefill ran in a window round (all but its
last token), and each output token stamped in the window, at its
position, under its adapter's true rank."""
from bench import flops


def read(run):
    if not run.rounds:
        return None
    m = run.sizes
    admitted = {rid for r in run.rounds for rid in r["admitted"]}
    total = 0.0
    for rid, r in run.reqs.items():
        plen = len(r["prompt"])
        if rid in admitted and plen > 1:
            total += flops.prefill_flops(m, plen - 1)
        rank = run.ranks[r["adapter"]]
        for j, t in enumerate(r["stamps"]):
            if run.t_open <= t <= run.t_close:
                total += flops.decode_flops(m, plen - 1 + j, rank)
    return 100.0 * total / (flops.PEAK_FLOPS * run.chips * run.window_s())
