"""AutoMoE in PyTorch + CUDA: the serving path and the detection training
path of the JAX package `automoe_tpu`, ported module by module (same
subpackage and module names), with its Pallas kernels as hand-written
Hopper kernels: the int8 stem (csrc/stem.cu) and the auction matcher with
its exact JV escalation (csrc/auction.cu).

Importing the package needs neither a GPU nor nvcc: the CUDA sources are
compiled at first launch (ops/_ext.py). Entry points run on `cuda` unless
the caller passes device="cpu"."""
