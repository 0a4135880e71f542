"""Observability plane of the port: metrics registry and flight ring."""
