"""The device plane: plain PyTorch versions of every kernel (CPU tensors)
and the wrappers that launch the CUDA kernels (CUDA tensors)."""
