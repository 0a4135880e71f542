"""Models of the port (Llama so far)."""
