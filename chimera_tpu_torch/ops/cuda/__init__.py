"""Hand-written CUDA kernels for Hopper: ``build`` compiles and loads
``chimera_tpu_torch/csrc/*.cu``; each kernel module holds its wrapper (with
a launch counter) and the plain PyTorch version of the same function."""
