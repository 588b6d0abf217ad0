"""Tensor ops of the port: indexing, voters, the bit flip, the K1 kernel wrapper."""
