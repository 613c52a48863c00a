"""Fused resonator sweep: CUDA kernel, plain version and dispatch."""
