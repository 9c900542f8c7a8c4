"""The port's serving plane (the paged slot engine)."""
