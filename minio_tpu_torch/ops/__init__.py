"""Device compute: GF(2^8) erasure coding, the mxsum256 and mxhash256
bitrot digests, and the bitrot registry (bitrot.py).

Each hot function has a hand-written CUDA kernel (csrc/, built on first use
by ops/kernels.py) and a plain PyTorch version beside it in the same module.
A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""
