"""Hand-written Pallas kernels (GPU, through Triton)."""
