"""Shared arithmetic of the readers."""


def decoded_rounds(run):
    """The window's rounds that ran a decode step, with its wall time."""
    return [r for r in run.rounds if r["decode_ms"] is not None]
