"""Paged decode attention: CUDA kernel, plain version and dispatch."""
