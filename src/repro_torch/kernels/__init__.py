"""Hand-written CUDA kernels of the port (csrc/), their build
(build.py) and their Python wrappers."""
