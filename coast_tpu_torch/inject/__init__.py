"""Fault injection of the port: memory map, schedule, classify, campaigns."""
