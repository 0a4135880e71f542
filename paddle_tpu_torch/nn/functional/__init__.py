"""Functional ops of the port (attention so far)."""
from .attention import sdpa_reference  # noqa: F401
