"""repro_torch: the PyTorch/CUDA port of the X-PEFT serving path.

The JAX package ``repro`` is the reference this package is held against
(tests/test_torch_*.py). Nothing here imports jax or ``repro``: modules
mirror ``repro``'s layout, keep its parameter layouts, and run on the card
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
