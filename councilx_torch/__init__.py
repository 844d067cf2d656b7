"""councilx_torch — the Council-GAN system of ``councilx`` ported to PyTorch
and CUDA for an NVIDIA H100.

Same module layout and names as ``councilx``; imports ``torch`` and never
JAX or ``councilx``. The generator's hand-written kernels (the 3x3
resblock conv, the IN/AdaIN norm) are built from ``councilx_torch/csrc`` at
first use on a CUDA tensor; on CPU tensors their plain PyTorch versions run.
"""
