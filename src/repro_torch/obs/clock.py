"""The port's wall-clock accessor: every wall-clock read in ``repro_torch``
goes through ``wall_time`` so that timing has one seam."""
import time


def wall_time() -> float:
    """Monotonic wall-clock seconds (``time.perf_counter``). Use the
    difference of two calls as a duration; the epoch is arbitrary."""
    return time.perf_counter()
