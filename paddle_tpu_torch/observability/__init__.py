"""Observability plane of the port: metrics registry, its HTTP
exposition and the flight ring."""
