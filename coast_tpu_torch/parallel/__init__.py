"""Campaign scale-out: the sharded runner and the process-group worker."""
