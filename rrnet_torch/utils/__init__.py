"""Device policy, the CUDA kernel build and the flax weight converter."""
