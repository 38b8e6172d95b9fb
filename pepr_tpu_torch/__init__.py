"""pepr_tpu_torch — PyTorch and CUDA port of pepr_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  It
imports torch, numpy and scipy, never jax or pepr_tpu: the JAX-free
modules it needs (alphabet, WAG data, Gamma rates, trees, simulator)
are its own copies.  The pruning likelihood's forward pass and its
gradient run as hand-written CUDA kernels (csrc/pruning.cu) built with
nvcc at first use.  Entry points run on the card unless the caller
passes device="cpu".
"""

__version__ = "0.1.0"
