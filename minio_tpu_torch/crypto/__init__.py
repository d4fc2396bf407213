"""Data at rest (counterpart of minio_tpu/crypto/): the AEAD provider
gate (aead.py), the DARE stream framing of SSE-C / SSE-S3 / SSE-KMS
(sse.py), the local and KES key managers (kms.py, kes.py), the sealed
config envelope (configcrypt.py) and S2 / zlib object compression
(compress.py). Every format is the JAX package's, byte for byte, so each
package reads what the other stored."""
