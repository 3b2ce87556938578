"""Device code: segmented reductions, the CUDA aggregation kernels."""
