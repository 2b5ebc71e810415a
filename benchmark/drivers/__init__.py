"""The general generators: one module a kind of work, named by a traffic
mix's ``driver`` key, each exporting its class as ``DRIVER``."""
