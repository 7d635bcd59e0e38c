"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their build (see ``build.py``)."""
