"""Host bitrot hashes (counterpart of minio_tpu/native/, the part of it the
bitrot registry uses): `lib` builds and binds the C++ library
csrc/host_hash.cc (sip256, HighwayHash-256, XXH64); `plain` holds their
pure-Python plain versions, for tests."""
