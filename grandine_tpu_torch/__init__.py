"""grandine_tpu_torch: the PyTorch/CUDA port of grandine_tpu's BLS verify
path for an NVIDIA H100 (sm_90a). `gpu/` mirrors grandine_tpu/tpu/,
`csrc/` holds the CUDA kernels, `crypto/` is the port's own copy of the
host anchor, `kzg/` the EIP-4844 blob plane. Imports torch and numpy,
never jax or grandine_tpu."""
