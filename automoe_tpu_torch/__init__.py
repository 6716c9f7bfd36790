"""AutoMoE in PyTorch + CUDA: the serving path of the JAX package
`automoe_tpu`, ported module by module (same subpackage and module
names), with the int8 stem as hand-written Hopper kernels (csrc/stem.cu).

Importing the package needs neither a GPU nor nvcc: the CUDA sources are
built at first launch (ops/stem.py). Entry points run on `cuda` unless
the caller passes device="cpu"."""
