"""The arrival processes, one module a process, found by the name a
traffic file gives under ``arrivals``. Each has ``count(spec, seconds)``,
the number of requests a run of ``seconds`` needs, and ``due(spec, n,
rng, strata)``, their due times in seconds from the window's opening,
ascending. A request due at or before 0 is submitted during set-up."""
