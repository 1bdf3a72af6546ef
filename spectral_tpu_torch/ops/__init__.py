"""Compute kernels: spectral transforms, low-order stencils, tensor-product
solvers and the hand-written CUDA kernels (``cuda_cheb``)."""
