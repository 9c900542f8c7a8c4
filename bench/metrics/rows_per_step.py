"""rows_per_step: rows decoded per round (tokens each step() returned),
over the window's rounds."""


def read(run):
    rounds = [r for r in run.rounds if r["tokens"]]
    if not rounds:
        return None
    return sum(r["tokens"] for r in rounds) / len(rounds)
