"""Logical-axis sharding rules and the serving plane's expert parallelism."""
