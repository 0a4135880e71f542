"""Incubating modules of the port: the MoE layer and its dispatch."""
