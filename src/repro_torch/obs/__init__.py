"""Observability seam of the port (the wall clock)."""
