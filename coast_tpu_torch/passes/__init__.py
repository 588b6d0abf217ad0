"""Protection passes of the port: the replication engine and strategies."""
