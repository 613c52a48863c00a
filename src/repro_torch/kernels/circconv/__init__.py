"""Row-wise circular convolution: CUDA kernels, plain versions and dispatch."""
