"""output_tokens_per_s: output tokens of the rounds that end inside the
window, over the window's seconds (its first round's start to its last
round's end; host clock)."""


def read(run):
    if not run.rounds:
        return None
    return sum(r["tokens"] for r in run.rounds) / run.window_s()
