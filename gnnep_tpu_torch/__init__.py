"""gnnep_tpu_torch: the PyTorch and CUDA port of gnnep_tpu for NVIDIA Hopper.

Imports torch and numpy, never jax and nothing of `gnnep_tpu`: the host code
it needs is its own copy. Its entry points run on the GPU unless the caller
passes `device="cpu"`.
"""
