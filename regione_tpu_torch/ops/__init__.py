"""Hand-written Hopper kernels (csrc/) with their wrappers and plain versions."""
