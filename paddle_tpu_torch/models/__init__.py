"""Models of the port (Llama and BERT)."""
