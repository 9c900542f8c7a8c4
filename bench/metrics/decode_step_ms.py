"""decode_step_ms: the program's decode.step wall ms (a host clock around
Engine.step(), which ends in the tokens' read-back), averaged over the
window's decoding rounds. Needs the program's tracer (traced runs)."""
from bench.metrics._stats import decoded_rounds


def read(run):
    rounds = decoded_rounds(run)
    if not rounds:
        return None
    return sum(r["decode_ms"] for r in rounds) / len(rounds)
