"""Region IR of the port."""
