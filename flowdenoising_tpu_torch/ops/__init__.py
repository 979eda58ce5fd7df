"""Tensor operations: resize, blur, warp, Farneback flow, and the CUDA
kernels under ``ops.cuda``."""
