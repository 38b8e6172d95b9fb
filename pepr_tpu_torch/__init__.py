"""pepr_tpu_torch — PyTorch and CUDA port of pepr_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  It
imports torch, numpy and scipy, never jax or pepr_tpu: the JAX-free
modules it needs (alphabet, BLOSUM62/blastn/WAG data, Gamma rates,
FASTA and blast8 I/O, trees, simulator) are its own copies.  Stage 1
(homology search, MCL, SW outgroup selection) runs its Smith-Waterman
through a hand-written CUDA kernel (csrc/sw.cu); stage 2's pruning
likelihood and its gradient run as hand-written CUDA kernels
(csrc/pruning.cu).  The kernels are built with nvcc at first use
(ops/_cuda.py), and the host's FASTA scanner, k-mer counter and
union-find (native/fastio.cpp, the JAX package's C++) with g++.  The
tools (tools/: tree comparison with per-site
log-likelihoods, the AU test, support decoration, set extraction,
MinHash distances, the tree-builder comparison) run as
`python -m pepr_tpu_torch.tools.<name>`.  Entry points run on the card
unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
from pepr_tpu_torch.data.wag import WAG_RATES, WAG_FREQS, wag_rate_matrix

__all__ = ["WAG_RATES", "WAG_FREQS", "wag_rate_matrix"]
