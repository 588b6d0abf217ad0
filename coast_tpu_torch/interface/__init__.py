"""Scope configuration of the port: the functions.config file and the
command-line scope lists."""
