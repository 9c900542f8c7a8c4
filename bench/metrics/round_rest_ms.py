"""round_rest_ms: per decoding round, the host time of step() less the
program's decode.step wall time (admission, prefill, bookkeeping), summed
over the window and divided by its rounds. Needs the program's tracer
(traced runs)."""
from bench.metrics._stats import decoded_rounds


def read(run):
    rounds = decoded_rounds(run)
    if not rounds:
        return None
    return sum(1e3 * (r["t1"] - r["t0"]) - r["decode_ms"]
               for r in rounds) / len(rounds)
