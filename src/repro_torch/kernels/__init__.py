"""Hand-written CUDA kernels (``csrc/``), their wrappers, plain PyTorch
versions (``ref.py``) and the dispatch layer (``ops.py``)."""
