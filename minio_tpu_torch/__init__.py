"""minio_tpu_torch — the PyTorch/CUDA port of minio_tpu.

It serves the erasure data path of one drive set behind an S3 front door,
with the GF(2) Reed-Solomon contraction and the mxsum256 and mxhash256
bitrot digests as hand-written CUDA kernels for Hopper (csrc/), and the
host bitrot hashes (sip256, HighwayHash-256, XXH64) in a C++ library
(csrc/host_hash.cc, native/). Module paths mirror the JAX
package `minio_tpu`, which stays the reference; this package imports
nothing from it and never imports jax.

Entry points take `device=` and default to "cuda"; without CUDA they raise
unless the caller asks for "cpu", where the plain PyTorch versions of the
kernels run.
"""
