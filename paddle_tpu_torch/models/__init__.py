"""Models of the port (Llama, BERT, ERNIE-MoE and the GPT attention it
uses)."""
