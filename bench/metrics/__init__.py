"""The metric readers, one module a metric (or a family whose names share
the part before the first dot): ``read(run)`` takes the metric from the
run's records (``harness.Run``) and returns its value, or None where the
run holds nothing to read it from, and the metric is then left out."""
