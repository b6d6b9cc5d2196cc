"""Device policy, the CUDA kernel build, the flax weight converter, the
reference-checkpoint converters, drawing, logging and checkpoints."""
