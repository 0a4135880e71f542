"""Core runtime of the port: the flag registry and device resolution."""
