"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref``) and the drivers of the ``cuda`` backend.

Nothing is compiled or loaded at import time: ``build.load_library`` runs
``nvcc`` at the first launch on a CUDA tensor.
"""
