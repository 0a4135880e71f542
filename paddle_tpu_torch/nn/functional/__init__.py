"""Functional ops of the port (attention so far)."""
from .attention import (flash_attention,  # noqa: F401
                        scaled_dot_product_attention, sdpa_reference)
