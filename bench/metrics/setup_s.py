"""setup_s: process start to the window's first round (host clock)."""


def read(run):
    return run.setup_s
