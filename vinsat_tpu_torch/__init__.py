"""vinsat_tpu_torch: the PyTorch / CUDA port of vinsat_tpu.

Keeps the JAX package's module layout and function names so each
counterpart can be found (``vinsat_tpu/estimation/ba.py`` ->
``vinsat_tpu_torch/estimation/ba.py``).  Imports torch and numpy, never jax.
Kernels written by hand for Hopper live in ``vinsat_tpu_torch/kernels``;
each keeps a plain PyTorch twin that runs for CPU tensors.
"""

__version__ = "0.1.0"
