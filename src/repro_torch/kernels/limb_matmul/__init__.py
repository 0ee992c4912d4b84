"""Limb-plane field matmul and Freivalds fold kernels, their oracle
and the public field ops."""
