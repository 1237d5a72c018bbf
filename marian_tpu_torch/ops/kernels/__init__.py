"""Hand-written CUDA kernels of the port and their plain PyTorch
versions; see each module and csrc/."""
