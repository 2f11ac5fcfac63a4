"""scenenet_tpu_torch: the PyTorch/CUDA port of scenenet_tpu for NVIDIA Hopper.

Imports torch and numpy, never jax and never scenenet_tpu. Kernels written
by hand in CUDA C++ live in ``csrc/`` and are built at first use
(``ops/_build.py``).
"""
