"""Int8 codebook similarity: CUDA kernel, plain version and dispatch."""
