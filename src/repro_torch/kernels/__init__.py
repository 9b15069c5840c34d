"""Hand-written Hopper kernels for the compute hot spots.

Each kernel ships as a subpackage: ``csrc/*.cu`` (CUDA C++ for ``sm_90a``
with a plain C entry point), ``ops.py`` (the wrapper with shape policy, the
plain PyTorch version beside it, and a launch counter).  A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version, which
is what the tests here hold against the JAX package.  ``_build`` compiles
the sources with ``nvcc`` into ``build/kernels/`` on first use.
"""
