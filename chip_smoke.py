#!/usr/bin/env python3
"""Chip smoke test of minio_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It needs CUDA, nvcc and no network, and
exits non-zero (printing no result) without a CUDA device or without the
package beside it. Phases, each raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the build of the hand-written kernels from minio_tpu_torch/csrc/;
2. kernels, each held byte-equal to its plain PyTorch version on the same
   inputs (tolerance: exact, all integer work) and timed with CUDA events
   (median of 20 runs after warm-up, L2 flushed and the launches queued
   behind a short device spin before each run, so host launch overhead
   stays out of the device time) beside its bound, its plain version and,
   for K2, torch._int_mm (the library call that computes its main
   contraction). Shapes: at EC 8+4 with 1 MiB blocks (B=16, k=8,
   S=131072), K1 gf2_matmul for encode, a 4-missing reconstruct,
   per-block weights with 3 failure patterns and a ragged S=87382, and K2
   mxsum_digest over [B*12, S] with lengths 0, 1, 513 and S among the rows
   (PUT), [B*8, S] (GET verify) and [B*4, S] (heal); the batched data
   plane's lanes, K1 encode [32, 8, 65536]->4, K1 reconstruct
   [32, 8, 16384]->4 with a decode matrix per row over 4 survivor
   patterns, K2 [128, 65536] and [128, 512] with ragged lengths; the hot
   tier's serve, K2 over the [256, 131072] window of a resident 32 MiB
   object; at EC 12+4 with 1 MiB blocks (the 16-drive sets of phase 6:
   87,382-byte chunks, K1's ragged byte path), K1 encode [16,12,87382]->4
   and a 4-missing reconstruct, K2 [256, 87382] (PUT digests) and
   [256, 87382] with 192 rows of data and 64 of length 0 (GET verify, as
   the GET path stages it); a one-drive heal's, K1 reconstruct
   [16,8,131072]->1 and K2 over the rebuilt chunks [16, 131072]; and,
   checked but not timed, fused.reconstruct_with_digests and
   reconstruct_only (K1 then K2, 4 missing) against the same compositions
   of the plain versions. Then what the plane's width gates cost: one
   lane call against the 32 per-object calls it replaces, at 16 and 64 KiB
   chunks. Then K3 mxhash256 at the bitrot phase's shapes, [192, 131072]
   (PUT), [128, 131072] (GET verify), [64, 131072] and [16, 131072]
   (heal) and [256, 87382] (EC 12+4 PUT), rows of lengths 0, 1, 503,
   504, 512, 700 and 4096 among full ones in every launch, beside its
   plain version (no library call computes the chain);
   mxhash.encode_with_bitrot (K1 then K3) checked against the plain
   composition; and the mxsum256 and mxhash256 keys this machine's numpy
   derives held against their pinned SHA-256;
3. S3: the port's server on 12 tmp drives (device="cuda"), driven over
   http.client with the port's SigV4 signer: PUT 256 MiB, 9 MiB + 12,345 B
   and 1 KiB objects; GET back byte-equal with ETag == md5; a ranged GET;
   4 drives' shard files copied then deleted and a degraded GET; a deep
   heal that must rebuild files byte-equal to the copies; one byte of a
   fifth drive's shard flipped, a GET that reads around it and a deep heal
   that rewrites it; then a GET with 4 OTHER drives removed;
4. the batched data plane at its defaults, through a fresh server: 64
   client threads PUT PLANE_OBJECTS objects of 1 KiB-512 KiB (log-uniform),
   GET them back byte-equal, lose 2 drives' shard files, GET those of
   16-128 KiB (up to 256) concurrently and heal one; launches < requests
   on PUT, a
   reconstruct lane launched for the degraded GETs and for the heal. The
   same traffic again with the plane off (MTPU_BATCHED_DATAPLANE=0), in
   turns on, off, off, on, and each stage's objects/s side by side;
5. the hot tier (MTPU_HOTTIER=1, 2 GiB budget): PUT ~2.5 GiB of 4-32 MiB
   objects, heat them until admission and eviction have run, then hot
   GETs byte-equal and ETag-identical to the drive path with one K2
   launch each, ranged hits, an overwrite served new, and a flipped
   resident byte falling back to the drive path;
6. multipart over erasure sets and pools (BASELINE.json configs 5 and 4):
   64 tmp drives as 4 pools of 16, each pool ErasureSets(set_drive_count=
   16) at EC 12+4, 1 MiB blocks, behind the port's S3 server over HTTP with
   SigV4. One object of MP_PARTS parts of 16 MiB (5 GiB; minio-go's part
   size for it) with 4 part uploads in flight (minio-go's default), its
   bytes made from --seed part by part and never held whole; a streamed GET
   compared by SHA-256, a Range GET across a part boundary, HEAD with the
   "-N" ETag, ListParts and Abort of a second upload; then 4 of the 16
   drives of the object's set wiped, a degraded GET, a deep heal whose
   rebuilt shard files must equal the originals, and a GET again. The
   object halves (down to 1 GiB) when the tmp filesystem cannot hold it.
   Its pools keep serving the object until phase 9 has listed it;
7. versioning, server-side copies, tags and conditional requests
   (versioning_phase): on 12 drives in /dev/shm at EC 8+4, a 256 MiB object PUT
   as the null version and, with the bucket's versioning enabled, 3
   times more; every version read by its id; the noncurrent one read with
   4 drives lost, deep-healed and read with 4 other drives lost; a delete
   marker and its removal; CopyObject of the noncurrent version (COPY and
   REPLACE); tags on a version; If-Match and If-None-Match; 64 clients
   PUT 64 keys x 4 versions of 1-512 KiB, ListObjectVersions walks them
   in pages of 1000 and one DeleteObjects removes 250 by VersionId; then
   on phase 6's pools, UploadPartCopy of the object's first 64 parts,
   part by part, into a versioned bucket;
8. heal (heal_phase): on 12 drives in /dev/shm at EC 8+4, the server at
   build_server's defaults (MRF on) and the auto-healer started as main()
   starts it, with a 1 s interval. 8 objects of 256 MiB, 512 warp-mix
   objects PUT by 64 clients, a multipart object of 16 parts of 16 MiB,
   64 versioned keys x 3 versions with 16 delete markers; 64 PUTs while
   2 drives refuse every call, drained by the MRF queue once they are
   back; a GET over a flipped byte and the deep heal it queued;
   heal_bucket and a dangling object purged; then live replacement: drive
   5 wiped under the running server and rebuilt by the auto-healer, its
   format.json, latest journal entries and shard files equal to a copy
   taken before, and every latest object read with 4 other drives
   removed. The phases before this one build their servers with
   enable_mrf=False and no auto-healer, so their degraded reads queue no
   background heal and their launch counts stay comparable with the
   earlier runs recorded in PERF.md;
9. listing and the bucket calls (listing_phase): 12 drives on /dev/shm
   at EC 8+4 behind the S3 server, a bucket of LIST_OBJECTS synthetic
   objects (halved to 50,000 to fit the 1,000 s budget, and below only to
   keep the script under 1,100 s) plus 1,000 real
   ones PUT through the server; ListObjectsV2 over the whole bucket in
   pages of 1,000 (every name once, in order; the real objects' ETag and
   Size), a delimiter listing, a v1 marker resume, ListBuckets, GETs of
   every 50th real object, one DeleteObjects of the 1,000, DeleteBucket
   refused on the full bucket and done on an emptied one, then one
   ListObjectsV2 on phase 6's 4 pools naming the 5 GiB object once;
10. bitrot (bitrot_phase, run before phase 9): every algorithm of the
   JAX registry on config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB
   blocks), each through the port's S3Server over
   ErasureSets(..., bitrot_algorithm=): one 256 MiB object under mxhash256
   and under sip256, one of 16 MiB under highwayhash256, sha256, xxh64 and
   blake2b256; PUT, GET (bytes and ETag), GET with 4 of 12 drives' shard
   files removed, a deep heal of the 4 (files equal their copies,
   verify_shard_file over each), sampled chunk digests against the plain
   versions; K3 launched once per batch (the mxhash256 PUT: as often as
   K1); the host hashes' MB/s on one thread and on 12.

The launch count of each kernel is reset just before each of phases 3-10
(each run of phase 4) and read after it; the JSON line carries phase 4's
counts from its first run, the plane at its default. It prints a JSON line with every kernel's numbers at
every shape, then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import http.client
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.parse

ACCESS, SECRET = "smokeadmin", "smokesecret123"
MXSUM_KERNELS = ("gf2_matmul", "mxsum_digest")   # the paths of the mxsum256 phases
K, M, B, S = 8, 4, 16, 131072   # EC 8+4, 1 MiB blocks: S = 1 MiB / 8
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor rate
PLANE_OBJECTS = 512             # plane phase: small objects PUT by 64 clients, per run
PLANE_RUNS = (True, False, False, True)   # the plane on / off, in turns
HOT_WORKING_SET = 5 << 29       # hot-tier phase: 2.5 GiB of 4-32 MiB objects
MP_PARTS, MP_PART_SIZE = 320, 16 << 20    # multipart phase: 5 GiB in 16 MiB parts
MP_INFLIGHT = 4                 # part uploads in flight
K12, M12, S12 = 12, 4, 87382    # EC 12+4, 1 MiB blocks: S = ceil(1 MiB / 12)
VER_SIZE, VER_VERSIONS = 256 << 20, 4   # versioning phase: 4 versions of 256 MiB
VER_KEYS = 64                   # ... and 64 small keys of 4 versions, 1-512 KiB
VER_DELETE = 250                # ... of which one DeleteObjects removes 250
VER_COPY_PARTS = 64             # ... and UploadPartCopy of phase 6's first 64 parts
HEAL_BIG, HEAL_BIG_SIZE = 8, 256 << 20   # heal phase: 8 objects of 256 MiB,
HEAL_SMALL = 512                # ... 512 warp-mix objects,
HEAL_MP_PARTS = 16              # ... a multipart object of 16 parts of 16 MiB,
HEAL_VER_KEYS = 64              # ... 64 versioned keys x 3 versions,
HEAL_MRF_PUTS = 64              # ... and 64 PUTs with 2 drives refusing
BITROT_BIG, BITROT_SMALL = 256 << 20, 16 << 20   # bitrot phase: one object each
BITROT_ALGOS = (("mxhash256", BITROT_BIG), ("sip256", BITROT_BIG),
                ("highwayhash256", BITROT_SMALL), ("sha256", BITROT_SMALL),
                ("xxh64", BITROT_SMALL), ("blake2b256", BITROT_SMALL))
LIST_OBJECTS = 200_000          # listing phase: synthetic objects, 200 prefixes of 1000
LIST_MIN_OBJECTS = 50_000       # ... never cut below this to meet SMOKE_BUDGET_S
LIST_REAL = 1000                # ... and real objects of 1-512 KiB PUT through S3
LIST_PAGE = 1000                # ListObjectsV2 max-keys
# The listing phase's cost on the card's machine (NVIDIA H100 80GB HBM3,
# 12 drives on /dev/shm), bounded from above by this script's runs there
# at 12,500, 25,000 and 50,000 objects (115, 156 and 282 s; PERF.md 5):
# seconds per synthetic object (build, walk, removal), the rest of the
# phase, and tmpfs bytes per synthetic object (12 journal files and their
# directories, with room to spare).
LIST_S_PER_OBJECT = 0.004
LIST_FIXED_S = 90.0
LIST_BYTES_PER_OBJECT = 12 * 8192
SMOKE_BUDGET_S = 1000.0         # what the whole script should stay under
SMOKE_LIMIT_S = 1100.0          # what it must stay under: 1200 s less a margin
S3_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, flush, runs: int = 20, warm: int = 3) -> float:
    """Median device time of fn() over `runs` runs, in ms. Before each run
    the L2 cache is flushed (the caller's data is not in L2): `flush` is a
    tensor larger than L2, zeroed (which leaves L2 full of dirty lines).
    Then the card spins for ~1 ms, so the host has queued both events and
    fn's launches before the card reaches them: the time between the
    events is the card's work, not the Python launch overhead."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for moving `nbytes` through HBM and doing `ops` int8
    operations, and which of the two sets it ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gf2_bound_ms(b: int, kin: int, tout: int, s: int,
                  per_block_weights: bool = False) -> tuple[float, str]:
    """K1's bound: x in, out written, the weight read once (per block when
    per-block), against the bit contraction the TPU kernel runs."""
    w = kin * 8 * tout * 8 * (b if per_block_weights else 1)
    return _bound_ms(b * kin * s + b * tout * s + w,
                     2.0 * b * s * (kin * 8) * (tout * 8))


def _mxsum_bound_ms(n: int, s: int) -> tuple[float, str]:
    """K2's bound: data and key in, lengths and length key in, digests
    out, against 16 int8 operations per data byte."""
    return _bound_ms(n * s + 8 * s + 4 * n + 32 + 32 * n, 2.0 * n * s * 8)


def _record(kernel: str, label: str, path: str, ms: float, plain: float,
            bound: tuple[float, str], library: float | None) -> dict:
    """One entry of the result line: a kernel at one shape. `path` names
    the phase whose launch count the entry carries (s3, plane or hot)."""
    src = {"gf2_matmul": ("minio_tpu_torch/csrc/gf2_matmul.cu",
                          "minio_tpu/ops/rs_pallas.py:48"),
           "mxsum_digest": ("minio_tpu_torch/csrc/mxsum_digest.cu",
                            "minio_tpu/ops/mxsum.py:153"),
           "mxhash256": ("minio_tpu_torch/csrc/mxhash256.cu",
                         "minio_tpu/ops/mxhash.py:104")}[kernel]
    return {"name": f"{kernel} {label}", "route": "cuda", "source": src[0],
            "replaces": src[1], "launches": 0, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library, "kernel": kernel, "path": path}


def _time_k1(records, label, path, args, bound, flush):
    from minio_tpu_torch.ops import rs

    ms = _median_ms(lambda: rs.gf2_matmul(*args), flush)
    plain = _median_ms(lambda: rs.gf2_matmul_plain(*args), flush)
    print(f"  K1 {label}: {ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}), "
          f"{100 * bound[0] / ms:.1f}% of the bound; plain {plain:.6f} ms")
    records.append(_record("gf2_matmul", label, path, ms, plain, bound, None))


def _time_k2(records, label, path, chunks, lens, flush, bound_rows=None):
    """K2 at [N, S] beside its plain version and torch._int_mm, the library
    call that computes its main contraction [N, S] @ [S, 8]. The bound
    counts `bound_rows` rows of data (default N): rows of length 0 carry
    none."""
    import torch

    from minio_tpu_torch.ops import mxsum

    n, s = chunks.shape
    key = mxsum.device_key(s, chunks.device).t().contiguous()     # [S, 8]
    ci8 = chunks.view(torch.int8)
    if s % 8:
        # torch._int_mm takes an inner size that is a multiple of 8: zero
        # columns of the data against zero rows of the key add nothing.
        pad = 8 - s % 8
        ci8 = torch.nn.functional.pad(ci8, (0, pad))
        key = torch.nn.functional.pad(key, (0, 0, 0, pad))
    if n <= 16:
        # ... and more than 16 rows: zero rows added up to 24 (its time is
        # then that of a third more rows than K2's).
        ci8 = torch.nn.functional.pad(ci8, (0, 0, 0, 24 - n))
    ms = _median_ms(lambda: mxsum.digest(chunks, lens), flush)
    plain = _median_ms(lambda: mxsum.digest_plain(chunks, lens), flush)
    lib = _median_ms(lambda: torch._int_mm(ci8, key), flush)
    bound = _mxsum_bound_ms(bound_rows or n, s)
    print(f"  K2 {label} [{n}, {s}]: {ms:.6f} ms, bound {bound[0]:.6f} ms "
          f"({bound[1]}), {100 * bound[0] / ms:.1f}% of the bound; plain "
          f"{plain:.6f} ms; torch._int_mm {lib:.6f} ms")
    records.append(_record("mxsum_digest", f"{label} [{n},{s}]", path, ms, plain,
                           bound, lib))


def _mxhash_bound_ms(lens) -> tuple[float, str]:
    """K3's bound from this run's lengths: each row's bytes read once, the
    packed key, the lengths and the digests, against the bit contraction
    of every block the rows need, 2 * 4352 * 256 operations a block,
    counted at the int8 rate as K1's are."""
    from minio_tpu_torch.ops import mxhash

    lens = [int(x) for x in lens]
    blocks = sum(mxhash._pad_blocks(ln) for ln in lens)
    return _bound_ms(sum(lens) + mxhash.KEY_WORDS * 256 * 8 + 36 * len(lens),
                     2.0 * blocks * (mxhash.KEY_WORDS * 64) * mxhash.STATE_BITS)


def _time_k3(records, label, chunks, lens, flush):
    """K3 at [N, S] beside its plain version. No one PyTorch call computes
    the chain, so there is no library time. Its launches come from the
    bitrot phase."""
    from minio_tpu_torch.ops import mxhash

    n, s = chunks.shape
    ms = _median_ms(lambda: mxhash.mxhash256(chunks, lens), flush)
    plain = _median_ms(lambda: mxhash.mxhash256_plain(chunks, lens), flush)
    bound = _mxhash_bound_ms(lens.tolist())
    print(f"  K3 {label} [{n}, {s}]: {ms:.6f} ms, bound {bound[0]:.6f} ms "
          f"({bound[1]}), {100 * bound[0] / ms:.1f}% of the bound; plain "
          f"{plain:.6f} ms")
    records.append(_record("mxhash256", f"{label} [{n},{s}]", "bitrot", ms, plain,
                           bound, None))


def mxhash_shapes(rng, dev, flush, check, records) -> None:
    """K3 at the bitrot phase's shapes, rows of mixed lengths (0 among
    them) in every launch, against its plain version; encode_with_bitrot
    (K1 then K3) against the same composition of the plain versions; the
    digest keys of mxsum256 and mxhash256 derived by this machine's numpy
    against their pinned SHA-256."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import mxhash, mxsum, rs

    keys = (("mxhash256", mxhash._key_matrix(), mxhash.KEY_SHA256),
            ("mxsum256", mxsum._key_rows(mxsum._KEY_CHUNK), mxsum.KEY_SHA256),
            ("mxsum256 length", mxsum._len_key(), mxsum.LEN_KEY_SHA256))
    for name, key, want in keys:
        got = hashlib.sha256(np.ascontiguousarray(key).tobytes()).hexdigest()
        if got != want:
            raise AssertionError(f"{name} key: SHA-256 {got} != pinned {want}")
    print(f"  keys pinned (numpy {np.__version__}): "
          + ", ".join(f"{name} {want[:16]}" for name, _k, want in keys))
    mixed = (0, 1, 503, 504, 512, 700, 4096)
    shapes = (("PUT", B * (K + M), S), ("GET verify", B * K, S),
              ("heal", B * 4, S), ("heal 1 target", B, S),
              (f"PUT {K12}+{M12}", B * (K12 + M12), S12))
    cases = []
    for label, n, s in shapes:
        x = torch.from_numpy(rng.integers(0, 256, (n, s), dtype=np.uint8)).to(dev)
        lens_np = np.full(n, s, dtype=np.int32)
        lens_np[:len(mixed)] = mixed
        lens = torch.from_numpy(lens_np).to(dev)
        got = mxhash.mxhash256(x, lens)
        check("mxhash256", f"K3 {label} (lengths {', '.join(map(str, mixed))}, "
              f"{s} ...)", got, mxhash.mxhash256_plain(x, lens))
        host = mxhash.digest_host(x[2, :503].cpu().numpy().tobytes())
        if got[2].cpu().numpy().tobytes() != host:
            raise AssertionError(f"K3 {label}: disagrees with the CPU digest_host")
        cases.append((label, x, lens))
    x3 = torch.from_numpy(rng.integers(0, 256, (B, K, S), dtype=np.uint8)).to(dev)
    par, digs = mxhash.encode_with_bitrot(x3, K, M)
    w_enc = rs.device_encode_weights(K, M, dev)
    ppar = rs.gf2_matmul_plain(x3, w_enc, M)
    pdigs = mxhash.mxhash256_plain(torch.cat([x3, ppar], 1).reshape(B * (K + M), S),
                                   torch.full((B * (K + M),), S, dtype=torch.int32,
                                              device=dev)).reshape(B, K + M, 32)
    check("gf2_matmul", "mxhash.encode_with_bitrot (parity)", par, ppar)
    check("mxhash256", "mxhash.encode_with_bitrot (digests)", digs, pdigs)
    print("  timed at the bitrot phase's shapes (EC 8+4 and 12+4, 1 MiB blocks):")
    for label, x, lens in cases:
        _time_k3(records, label, x, lens, flush)


def kernel_phase(seed: int) -> list[dict]:
    """K1 and K2 on the card against their plain versions, at the S3
    path's shapes and at the lane shapes of the batched data plane and the
    hot tier; returns the entries of the result line (launches filled in
    by the phases that drive those paths)."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import fused, gf, mxsum, rs

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    errs = {"gf2_matmul": 0, "mxsum_digest": 0, "mxhash256": 0}

    def check(kernel, name, got, want):
        if got.shape != want.shape:
            raise AssertionError(
                f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        errs[kernel] = max(errs[kernel], err)
        if err:
            raise AssertionError(f"{name}: kernel disagrees with plain (max err {err})")
        print(f"  {name}: {tuple(got.shape)} byte-equal to plain")

    x_np = rng.integers(0, 256, (B, K, S), dtype=np.uint8)
    x = torch.from_numpy(x_np).to(dev)
    w_enc = rs.device_encode_weights(K, M, dev)
    parity = rs.gf2_matmul(x, w_enc, M)
    check("gf2_matmul", "K1 encode", parity, rs.gf2_matmul_plain(x, w_enc, M))
    if not np.array_equal(parity[0].cpu().numpy(), gf.encode_ref(x_np[0], M)):
        raise AssertionError("K1 encode disagrees with gf.encode_ref")
    shards = torch.cat([x, parity], dim=1)                     # [B, 12, S]

    surv, targets = (0, 2, 4, 5, 8, 9, 10, 11), (1, 3, 6, 7)
    xs = shards[:, list(surv)].contiguous()
    w_dec = rs.device_decode_weights(K, K + M, surv, targets, dev)
    rebuilt = rs.gf2_matmul(xs, w_dec, len(targets))
    check("gf2_matmul", "K1 reconstruct (4 missing)", rebuilt,
          rs.gf2_matmul_plain(xs, w_dec, 4))
    if not torch.equal(rebuilt, shards[:, list(targets)]):
        raise AssertionError("K1 reconstruct did not rebuild the lost shards")

    # A one-drive heal (the heal phase's shapes): K1 rebuilds 1 target from
    # the first 8 survivors, K2 digests the rebuilt chunks.
    surv1, tgt1 = (0, 1, 2, 3, 4, 6, 7, 8), (5,)
    xs1 = shards[:, list(surv1)].contiguous()
    w_dec1 = rs.device_decode_weights(K, K + M, surv1, tgt1, dev)
    rebuilt1 = rs.gf2_matmul(xs1, w_dec1, 1)
    check("gf2_matmul", "K1 reconstruct (1 missing)", rebuilt1,
          rs.gf2_matmul_plain(xs1, w_dec1, 1))
    if not torch.equal(rebuilt1, shards[:, list(tgt1)]):
        raise AssertionError("K1 reconstruct did not rebuild the lost shard")
    heal_chunks = rebuilt1.reshape(B, S)
    heal_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    check("mxsum_digest", "K2 digest of the rebuilt chunks",
          mxsum.digest(heal_chunks, heal_lens), mxsum.digest_plain(heal_chunks, heal_lens))

    # The static-pattern compositions on K1 then K2, at the S3 shape with
    # 4 missing, against the same compositions of the plain versions.
    got, gdig = fused.reconstruct_with_digests(shards, K, K + M, surv, targets)
    want, wdig = fused.reconstruct_with_digests_plain(shards, K, K + M, surv, targets)
    check("gf2_matmul", "fused.reconstruct_with_digests (rebuilt)", got, want)
    check("mxsum_digest", "fused.reconstruct_with_digests (digests)", gdig, wdig)
    check("gf2_matmul", "fused.reconstruct_only",
          fused.reconstruct_only(shards, K, K + M, surv, targets),
          fused.reconstruct_only_plain(shards, K, K + M, surv, targets))

    pats = [((0, 1, 2, 3, 4, 5, 6, 7), (8, 9, 10, 11)),
            ((2, 3, 4, 5, 6, 7, 8, 9), (0, 1)),
            ((0, 1, 2, 3, 8, 9, 10, 11), (4, 5, 6))]
    w_multi = np.zeros((B, K * 8, 32), dtype=np.int8)
    xm = torch.empty_like(x)
    for b in range(B):
        sv, tg = pats[b % 3]
        w_multi[b, :, :len(tg) * 8] = rs.decode_weights_np(K, K + M, sv, tg)
        xm[b] = shards[b, list(sv)]
    w_multi_d = torch.from_numpy(w_multi).to(dev)
    check("gf2_matmul", "K1 per-block weights (3 patterns)",
          rs.gf2_matmul_multi(xm, w_multi_d, 4),
          rs.gf2_matmul_plain(xm, w_multi_d, 4))

    xr = x[:, :, :87382].contiguous()
    check("gf2_matmul", "K1 ragged S=87382", rs.gf2_matmul(xr, w_enc, M),
          rs.gf2_matmul_plain(xr, w_enc, M))

    n_rows = B * (K + M)
    chunks = shards.reshape(n_rows, S).clone()
    lens = torch.full((n_rows,), S, dtype=torch.int32, device=dev)
    for row, ln in ((0, 0), (1, 1), (2, 513), (3, S)):
        chunks[row, ln:] = 0
        lens[row] = ln
    digs = mxsum.digest(chunks, lens)
    check("mxsum_digest", "K2 digest", digs, mxsum.digest_plain(chunks, lens))
    if digs[2].cpu().numpy().tobytes() != mxsum.digest_np(
            chunks[2, :513].cpu().numpy().tobytes()):
        raise AssertionError("K2 digest disagrees with the host digest")
    for rows in (B * K, B * 4):
        check("mxsum_digest", f"K2 digest [{rows}, S]",
              mxsum.digest(chunks[:rows], lens[:rows]),
              mxsum.digest_plain(chunks[:rows], lens[:rows]))
    # Whether torch._int_mm's int32 sums wrap as K2's uint32 ones do is
    # checked on this run's data, not assumed.
    key = mxsum.device_key(S, dev).t().contiguous()
    lterm = (mxsum._len_bytes(lens).to(torch.float64)
             @ mxsum.device_len_key(dev).to(torch.float64)).to(torch.int64)
    lib_out = torch._int_mm(chunks.view(torch.int8), key)
    print("  torch._int_mm with the length term and packing equals K2's "
          f"digests: {torch.equal(mxsum._pack_words(lib_out.to(torch.int64) + lterm), digs)}")

    records: list[dict] = []
    print("  timed at the S3 path's shapes (EC 8+4, 1 MiB blocks):")
    _time_k1(records, "encode [16,8,131072]->4", "s3", (x, w_enc, M),
             _gf2_bound_ms(B, K, M, S), flush)
    _time_k1(records, "reconstruct 4 missing [16,8,131072]->4", "s3",
             (xs, w_dec, 4), _gf2_bound_ms(B, K, 4, S), flush)
    _time_k1(records, "per-block weights, 3 patterns [16,8,131072]->4", "s3",
             (xm, w_multi_d, 4), _gf2_bound_ms(B, K, 4, S, per_block_weights=True),
             flush)
    _time_k1(records, "ragged [16,8,87382]->4", "s3", (xr, w_enc, M),
             _gf2_bound_ms(B, K, M, xr.shape[2]), flush)
    for label, rows in (("PUT", n_rows), ("GET verify", B * K), ("heal", B * 4)):
        _time_k2(records, label, "s3", chunks[:rows], lens[:rows], flush)
    print("  timed at a one-drive heal's shapes (EC 8+4, 1 MiB blocks):")
    _time_k1(records, "reconstruct 1 missing [16,8,131072]->1", "heal",
             (xs1, w_dec1, 1), _gf2_bound_ms(B, K, 1, S), flush)
    _time_k2(records, "heal 1 target", "heal", heal_chunks, heal_lens, flush)

    lane_shapes(rng, dev, flush, check, records)
    ec12_shapes(rng, dev, flush, check, records)
    mxhash_shapes(rng, dev, flush, check, records)
    for r in records:
        r["max_abs_err"] = errs[r["kernel"]]
    return records


def lane_shapes(rng, dev, flush, check, records) -> None:
    """K1 and K2 at the lane shapes of the batched data plane (the widest
    full encode lane, the widest reconstruct lane with a decode matrix per
    row, the widest and narrowest verify lanes) and at the hot tier's
    serve window; then what the plane's width gates cost: one lane launch
    against the per-object launches it replaces, at 16 and 64 KiB."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import fused, mxsum, rs

    print("  lane shapes (dataplane defaults: 32 encode/reconstruct rows, "
          "128 verify rows):")
    xe = torch.from_numpy(rng.integers(0, 256, (32, K, 65536), dtype=np.uint8)).to(dev)
    w_enc = rs.device_encode_weights(K, M, dev)
    check("gf2_matmul", "K1 encode lane", rs.gf2_matmul(xe, w_enc, M),
          rs.gf2_matmul_plain(xe, w_enc, M))

    # Reconstruct lane: 32 rows over 4 survivor patterns, each row its own
    # [64, 32] decode matrix with the padded target columns zero.
    data = torch.from_numpy(rng.integers(0, 256, (32, K, 16384), dtype=np.uint8)).to(dev)
    full = torch.cat([data, rs.gf2_matmul(data, w_enc, M)], dim=1)
    pats = [(0, 2, 4, 5, 8, 9, 10, 11), (2, 3, 4, 5, 6, 7, 8, 9),
            (0, 1, 2, 3, 8, 9, 10, 11), (1, 3, 5, 7, 8, 9, 10, 11)]
    w_rows = np.zeros((32, K * 8, 32), dtype=np.int8)
    xr = torch.empty_like(data)
    lost = []
    for r in range(32):
        sv = pats[r % 4]
        tg = tuple(i for i in range(K) if i not in sv)
        w_rows[r, :, :len(tg) * 8] = rs.decode_weights_np(K, K + M, sv, tg)
        xr[r] = full[r, list(sv)]
        lost.append(tg)
    w_rows_d = torch.from_numpy(w_rows).to(dev)
    rebuilt = rs.gf2_matmul_multi(xr, w_rows_d, 4)
    check("gf2_matmul", "K1 reconstruct lane (4 patterns)", rebuilt,
          rs.gf2_matmul_plain(xr, w_rows_d, 4))
    for r in range(32):
        if not torch.equal(rebuilt[r, :len(lost[r])], full[r, list(lost[r])]):
            raise AssertionError("K1 reconstruct lane did not rebuild row "
                                 f"{r}'s lost shards")

    def ragged(n, s):
        ln = rng.integers(0, s + 1, n).astype(np.int32)
        c = rng.integers(0, 256, (n, s), dtype=np.uint8)
        c[np.arange(s)[None, :] >= ln[:, None]] = 0
        return torch.from_numpy(c).to(dev), torch.from_numpy(ln).to(dev)

    cv, lv = ragged(128, 65536)
    check("mxsum_digest", "K2 verify lane (ragged)", mxsum.digest(cv, lv),
          mxsum.digest_plain(cv, lv))
    cn, ln = ragged(128, 512)
    check("mxsum_digest", "K2 narrowest lane (ragged)", mxsum.digest(cn, ln),
          mxsum.digest_plain(cn, ln))
    # Hot tier: a 32 MiB object resident as [32, 8, 131072], served whole:
    # K2 over the window's view [256, 131072], the last block ragged.
    resident = torch.from_numpy(rng.integers(0, 256, (32, K, S), dtype=np.uint8)).to(dev)
    rlens = torch.full((32,), S, dtype=torch.int32, device=dev)
    rlens[31] = 70001
    resident[31, :, 70001:] = 0
    win = resident[0:32].reshape(32 * K, S)
    wl = rlens.repeat_interleave(K)
    check("mxsum_digest", "K2 hot-tier window", mxsum.digest(win, wl),
          mxsum.digest_plain(win, wl))

    _time_k1(records, "encode lane [32,8,65536]->4", "plane", (xe, w_enc, M),
             _gf2_bound_ms(32, K, M, 65536), flush)
    _time_k1(records, "reconstruct lane, 4 patterns [32,8,16384]->4", "plane",
             (xr, w_rows_d, 4), _gf2_bound_ms(32, K, 4, 16384, per_block_weights=True),
             flush)
    _time_k2(records, "verify lane, ragged", "plane", cv, lv, flush)
    _time_k2(records, "narrowest lane, ragged", "plane", cn, ln, flush)
    _time_k2(records, "hot-tier window", "hot", win, wl, flush)

    print("  width gates (MTPU_DP_MAX_WIDTH=65536, MTPU_DP_MAX_RECON_WIDTH=16384): "
          "one lane call against the 32 per-object calls it replaces")
    for w in (16384, 65536):
        xw = xe[:, :, :w].contiguous()
        lw = torch.full((32,), w, dtype=torch.int32, device=dev)
        xrw = torch.from_numpy(rng.integers(0, 256, (32, K, w), dtype=np.uint8)).to(dev)
        singles = [(xw[i:i + 1], lw[i:i + 1]) for i in range(32)]
        rsingles = [(xrw[i:i + 1], rs.device_decode_weights(
            K, K + M, pats[i % 4], lost[i], dev), len(lost[i])) for i in range(32)]
        cases = {
            "encode+digests": (
                lambda: fused.encode_with_digests(xw, K, M, lw),
                lambda: [fused.encode_with_digests(a, K, M, b) for a, b in singles]),
            "reconstruct": (
                lambda: rs.gf2_matmul_multi(xrw, w_rows_d, 4),
                lambda: [rs.gf2_matmul(a, wt, t) for a, wt, t in rsingles]),
        }
        for name, (lane, per_object) in cases.items():
            lane_ms = _median_ms(lane, flush)
            obj_ms = _median_ms(per_object, flush)
            lane_host = _host_ms(lane)
            obj_host = _host_ms(per_object)
            print(f"    {name} at {w} B chunks: lane {lane_ms:.6f} ms device "
                  f"({lane_host:.6f} ms host, launch to sync); 32 per-object "
                  f"{obj_ms:.6f} ms device ({obj_host:.6f} ms host)")


def ec12_shapes(rng, dev, flush, check, records) -> None:
    """K1 and K2 at the multipart phase's shapes: EC 12+4 with 1 MiB blocks,
    one 16-block batch of a 16 MiB part. The 87,382-byte chunks are not a
    multiple of 16 bytes, so K1 takes its byte path on every block."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, mxsum, rs

    print(f"  EC {K12}+{M12} shapes (16-drive sets, 1 MiB blocks, S={S12}):")
    x_np = rng.integers(0, 256, (B, K12, S12), dtype=np.uint8)
    x = torch.from_numpy(x_np).to(dev)
    w_enc = rs.device_encode_weights(K12, M12, dev)
    parity = rs.gf2_matmul(x, w_enc, M12)
    check("gf2_matmul", "K1 encode 12+4", parity, rs.gf2_matmul_plain(x, w_enc, M12))
    if not np.array_equal(parity[0].cpu().numpy(), gf.encode_ref(x_np[0], M12)):
        raise AssertionError("K1 encode 12+4 disagrees with gf.encode_ref")
    shards = torch.cat([x, parity], dim=1)                     # [B, 16, S]
    surv = (0, 1, 3, 4, 5, 7, 8, 10, 12, 13, 14, 15)
    targets = (2, 6, 9, 11)
    xs = shards[:, list(surv)].contiguous()
    w_dec = rs.device_decode_weights(K12, K12 + M12, surv, targets, dev)
    rebuilt = rs.gf2_matmul(xs, w_dec, len(targets))
    check("gf2_matmul", "K1 reconstruct 12+4 (4 missing)", rebuilt,
          rs.gf2_matmul_plain(xs, w_dec, len(targets)))
    if not torch.equal(rebuilt, shards[:, list(targets)]):
        raise AssertionError("K1 reconstruct 12+4 did not rebuild the lost shards")
    put_rows = shards.reshape(B * (K12 + M12), S12).clone()   # [256, S]
    put_lens = torch.full((B * (K12 + M12),), S12, dtype=torch.int32, device=dev)
    for row, ln in ((0, 0), (1, 1), (2, 513)):
        put_rows[row, ln:] = 0
        put_lens[row] = ln
    check("mxsum_digest", "K2 PUT digests 12+4", mxsum.digest(put_rows, put_lens),
          mxsum.digest_plain(put_rows, put_lens))
    # The GET path stages its 16 x 12 = 192 chunks as fused.digest_chunks_host
    # does: rows padded to the next power of two, the last 64 of length 0.
    get_rows = torch.zeros((256, S12), dtype=torch.uint8, device=dev)
    get_rows[:B * K12] = xs.reshape(B * K12, S12)
    get_lens = torch.zeros((256,), dtype=torch.int32, device=dev)
    get_lens[:B * K12] = S12
    check("mxsum_digest", "K2 GET verify 12+4", mxsum.digest(get_rows, get_lens),
          mxsum.digest_plain(get_rows, get_lens))
    _time_k1(records, f"encode 12+4 [16,12,{S12}]->4", "multipart",
             (x, w_enc, M12), _gf2_bound_ms(B, K12, M12, S12), flush)
    _time_k1(records, f"reconstruct 4 missing 12+4 [16,12,{S12}]->4", "multipart",
             (xs, w_dec, len(targets)), _gf2_bound_ms(B, K12, 4, S12), flush)
    _time_k2(records, "PUT 12+4", "multipart", put_rows, put_lens, flush)
    _time_k2(records, "GET verify 12+4, 64 rows empty", "multipart", get_rows,
             get_lens, flush, bound_rows=B * K12)


def _host_ms(fn, runs: int = 20) -> float:
    """Median host time of fn() from its first launch to the card's
    synchronize, in ms (the launch overhead a caller pays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class _Client:
    """S3 over http.client, signed with the port's SigV4 code."""

    def __init__(self, url: str):
        from minio_tpu_torch.s3.sigv4 import Credentials

        self.host = urllib.parse.urlparse(url).netloc
        self.creds = Credentials(ACCESS, SECRET)
        self.conn = http.client.HTTPConnection(self.host, timeout=600)

    def send(self, method: str, path: str, body: bytes = b"",
             headers: dict | None = None, query: dict | None = None,
             check: bool = True):
        """Send one request; -> the response, its body not yet read. With
        `check`, an answer of 300 or above raises."""
        from minio_tpu_torch.s3.sigv4 import UNSIGNED_PAYLOAD, sign_request

        query = query or {}
        signed = sign_request(method, path, query, headers or {}, self.host,
                              self.creds, UNSIGNED_PAYLOAD)
        url = urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        self.conn.request(method, url, body=body, headers=signed)
        r = self.conn.getresponse()
        if check and r.status >= 300:
            raise AssertionError(f"{method} {path}: {r.status} {r.read()[:300]!r}")
        return r

    def request(self, method: str, path: str, body: bytes = b"",
                headers: dict | None = None, query: dict | None = None,
                check: bool = True):
        r = self.send(method, path, body, headers, query, check)
        return r, r.read()

    def close(self):
        self.conn.close()


S3_SIZES = {"big": 256 << 20, "mid": (9 << 20) + 12345, "tiny": 1 << 10}


def _fill_launches(records: list[dict], path: str, counts: dict) -> None:
    """Set the launch count of every entry of `path` from the counts of
    that path's run; a kernel of the path that never launched fails."""
    for r in records:
        if r["path"] == path:
            r["launches"] = counts[r["kernel"]]
            if r["launches"] <= 0:
                raise AssertionError(f"{r['kernel']} never launched on the "
                                     f"{path} path")


def s3_phase(seed: int, card: str, records: list[dict], device: str = "cuda") -> None:
    """Phase 3 (see the module's docstring). The server runs with
    enable_mrf=False: a background heal queued by the degraded GETs would
    race the phase's own deep heals and change its launch counts."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    rng = np.random.default_rng(seed + 1)
    objects = {key: rng.bytes(size) for key, size in S3_SIZES.items()}
    work = tempfile.mkdtemp(prefix="mtpu-torch-smoke-")
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    cl = _Client(srv.url)
    stages = {}
    try:
        obj = srv.obj.pools[0].sets[0]
        print(f"  server {srv.url}: EC {obj.n - obj.parity}+{obj.parity}, "
              f"block {obj.block_size} B, bitrot {obj.bitrot_algorithm}")

        def mark(stage):
            stages[stage] = kernels.launches()

        kernels.reset_launches()
        mark("start")
        cl.request("PUT", "/smoke")
        t0 = time.perf_counter()
        cl.request("PUT", "/smoke/big", objects["big"])
        put_s = time.perf_counter() - t0
        for key in ("mid", "tiny"):
            cl.request("PUT", f"/smoke/{key}", objects[key])
        mark("put")

        def get_ok(key, what):
            r, data = cl.request("GET", f"/smoke/{key}")
            if data != objects[key]:
                raise AssertionError(f"{what}: GET {key} bytes differ")
            if r.getheader("ETag") != f'"{hashlib.md5(objects[key]).hexdigest()}"':
                raise AssertionError(f"{what}: GET {key} ETag is not the md5")

        t0 = time.perf_counter()
        get_ok("big", "intact")
        get_s = time.perf_counter() - t0
        for key in ("mid", "tiny"):
            get_ok(key, "intact")
        r, data = cl.request("GET", "/smoke/big",
                             headers={"Range": "bytes=1000000-3999999"})
        if r.status != 206 or data != objects["big"][1000000:4000000]:
            raise AssertionError("ranged GET")
        mark("get")

        def part_file(i):
            hits = glob.glob(os.path.join(paths[i], "smoke", "big", "*", "part.1"))
            return hits[0] if hits else None

        originals = {i: open(part_file(i), "rb").read() for i in range(12)}
        lost = [0, 1, 2, 3]
        for i in lost:
            shutil.rmtree(os.path.dirname(part_file(i)))
        t0 = time.perf_counter()
        get_ok("big", "degraded (4 drives lost)")
        deg_s = time.perf_counter() - t0
        mark("degraded_get")

        t0 = time.perf_counter()
        res = obj.heal_object("smoke", "big", scan_deep=True)
        heal_s = time.perf_counter() - t0
        if res.healed_count != 4 or any(open(part_file(i), "rb").read() != originals[i]
                                        for i in lost):
            raise AssertionError(f"heal: {res.healed_count} healed or files differ")
        mark("heal")

        f = part_file(4)
        raw = bytearray(originals[4])
        raw[32 + 4096] ^= 0xA5
        with open(f, "wb") as fh:
            fh.write(raw)
        get_ok("big", "one shard byte flipped")
        if obj.heal_object("smoke", "big", scan_deep=True).healed_count != 1 \
                or open(part_file(4), "rb").read() != originals[4]:
            raise AssertionError("deep heal did not rewrite the flipped shard")
        mark("bitrot_heal")

        for i in (8, 9, 10, 11):
            shutil.rmtree(os.path.dirname(part_file(i)))
        get_ok("big", "4 other drives lost after heal")
        mark("end")
    finally:
        cl.close()
        srv.close()
        shutil.rmtree(work, ignore_errors=True)

    def delta(a, b, name):
        return stages[b][name] - stages[a][name]

    order = ["start", "put", "get", "degraded_get", "heal", "bitrot_heal", "end"]
    for a, b in zip(order, order[1:]):
        print(f"  launches {b}: " + ", ".join(
            f"{n} {delta(a, b, n)}" for n in kernels.KERNELS))
    for stage, need in (("put", "encode"), ("degraded_get", "decode"), ("heal", "heal")):
        prev = order[order.index(stage) - 1]
        if delta(prev, stage, "gf2_matmul") <= 0:
            raise AssertionError(f"K1 did not launch for {need}")
    _fill_launches(records, "s3", {n: delta("start", "end", n)
                                   for n in kernels.KERNELS})
    gib = len(objects["big"]) / (1 << 30)
    print(f"  S3 {len(objects['big']) >> 20} MiB on {card}: "
          f"PUT {gib / put_s:.6f} GiB/s ({put_s:.6f} s), "
          f"GET {gib / get_s:.6f} GiB/s ({get_s:.6f} s), degraded GET "
          f"{gib / deg_s:.6f} GiB/s ({deg_s:.6f} s), deep heal of 4 shards "
          f"{heal_s:.6f} s")


class _Pool:
    """`n` client threads, each with its own S3 connection."""

    def __init__(self, url: str, n: int):
        from concurrent.futures import ThreadPoolExecutor
        import threading

        self._url = url
        self._local = threading.local()
        self._clients: list[_Client] = []
        self._mu = threading.Lock()
        self._ex = ThreadPoolExecutor(max_workers=n, thread_name_prefix="smoke-client")

    def client(self) -> _Client:
        cl = getattr(self._local, "cl", None)
        if cl is None:
            cl = self._local.cl = _Client(self._url)
            with self._mu:
                self._clients.append(cl)
        return cl

    def run(self, fn, items) -> list:
        """fn(client, item) for every item; re-raises the first failure."""
        futs = [self._ex.submit(lambda it=it: fn(self.client(), it)) for it in items]
        return [f.result() for f in futs]

    def close(self) -> None:
        self._ex.shutdown(wait=True)
        for cl in self._clients:
            cl.close()


def _md5_etag(data: bytes) -> str:
    return f'"{hashlib.md5(data).hexdigest()}"'


def plane_phase(seed: int, card: str, records: list[dict] | None,
                n_objects: int, plane_on: bool = True, n_clients: int = 64,
                n_degraded: int = 256, device: str = "cuda") -> dict:
    """Small-object traffic through the S3 server on 12 tmp drives at EC
    8+4, with the batched data plane at its default (on) or opted out
    (MTPU_BATCHED_DATAPLANE=0, the per-object codec path): `n_clients`
    client threads PUT `n_objects` objects of sizes drawn log-uniformly
    from 1 KiB to 512 KiB (the small-object mix of MinIO's warp tool,
    --obj.size/--concurrent), GET them all back byte-equal, then with the
    shard files of 2 drives lost GET `n_degraded` objects of 16-128 KiB
    concurrently (reconstruct lanes when on) and heal one of them (the
    digest-fused reconstruct lane when on). Launch counts go into
    `records` unless it is None. Returns each stage's objects/s. The
    server runs with enable_mrf=False, so the degraded GETs queue no
    background heal."""
    import numpy as np

    from minio_tpu_torch import dataplane
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    if plane_on:
        os.environ.pop("MTPU_BATCHED_DATAPLANE", None)   # the default: on
    else:
        os.environ["MTPU_BATCHED_DATAPLANE"] = "0"
    rng = np.random.default_rng(seed + 2)
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                               n_objects)).astype(np.int64)
    objects = {f"o{i:05d}": rng.bytes(int(n)) for i, n in enumerate(sizes)}
    total = int(sizes.sum())
    work = tempfile.mkdtemp(prefix="mtpu-torch-plane-")
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    pool = _Pool(srv.url, n_clients)
    plane = dataplane.get_plane(srv.obj.device) if plane_on else None
    stages, marks = {}, {}

    def mark(stage):
        stages[stage] = (kernels.launches(), plane.stats() if plane else None)
        marks[stage] = time.perf_counter()

    try:
        print(f"  plane {'on' if plane_on else 'off'}: {n_objects} objects, "
              f"{total} B ({total / (1 << 20):.1f} MiB), "
              f"{int((sizes <= 16 << 10).sum())} inline (<= 16 KiB), "
              f"{n_clients} client threads")
        _Client(srv.url).request("PUT", "/plane")
        kernels.reset_launches()
        mark("start")
        pool.run(lambda cl, kv: cl.request("PUT", f"/plane/{kv[0]}", kv[1]),
                 objects.items())
        mark("put")

        def get_ok(cl, key):
            r, data = cl.request("GET", f"/plane/{key}")
            if data != objects[key] or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"plane GET {key}: bytes or ETag differ")

        pool.run(get_ok, objects)
        mark("get")

        def part(i, key):
            hits = glob.glob(os.path.join(paths[i], "plane", key, "*", "part.1"))
            return hits[0] if hits else None

        lost = (2, 7)
        degraded = [k for k, v in objects.items() if 16 << 10 < len(v) <= 128 << 10]
        degraded = degraded[:n_degraded]
        heal_key = degraded[0]
        originals = {i: open(part(i, heal_key), "rb").read() for i in lost}
        for i in lost:
            for f in glob.glob(os.path.join(paths[i], "plane", "*", "*", "part.1")):
                shutil.rmtree(os.path.dirname(f))
        mark("lose")
        pool.run(get_ok, degraded)
        mark("degraded_get")
        res = srv.obj.heal_object("plane", heal_key)
        if res.healed_count != 2 or any(open(part(i, heal_key), "rb").read()
                                        != originals[i] for i in lost):
            raise AssertionError(f"plane heal: {res.healed_count} healed or files differ")
        mark("heal")
    finally:
        pool.close()
        srv.close()
        os.environ.pop("MTPU_BATCHED_DATAPLANE", None)
        shutil.rmtree(work, ignore_errors=True)

    for a, b in (("start", "put"), ("put", "get"), ("lose", "degraded_get"),
                 ("degraded_get", "heal")):
        ka, pa = stages[a]
        kb, pb = stages[b]
        k1 = kb["gf2_matmul"] - ka["gf2_matmul"]
        line = "kernel launches " + ", ".join(
            f"{n} {kb[n] - ka[n]}" for n in kernels.KERNELS)
        if b in ("degraded_get", "heal") and k1 <= 0:
            raise AssertionError(f"plane {'on' if plane_on else 'off'} {b}: "
                                 "K1 never launched")
        if plane_on:
            d = {f: pb[f] - pa[f] for f in ("launches", "requests", "rows",
                                            "capacity", "rejected")}
            recon = (pb["op_launches"]["reconstruct"]
                     - pa["op_launches"]["reconstruct"])
            line = (f"plane launches {d['launches']} ({recon} reconstruct), "
                    f"requests {d['requests']}, rows {d['rows']}, capacity "
                    f"{d['capacity']}, rejected {d['rejected']}; " + line)
            if b == "put" and not d["launches"] < d["requests"]:
                raise AssertionError("plane PUT: no coalescing (launches >= requests)")
            if b in ("degraded_get", "heal") and recon <= 0:
                raise AssertionError(f"plane {b}: no reconstruct lane launched")
        print(f"  {b}: {line}")
    if records is not None:
        _fill_launches(records, "plane", {
            n: stages["heal"][0][n] - stages["start"][0][n] for n in kernels.KERNELS})
    put_s = marks["put"] - marks["start"]
    get_s = marks["get"] - marks["put"]
    deg_s = marks["degraded_get"] - marks["lose"]
    deg_bytes = sum(len(objects[k]) for k in degraded)
    gib = total / (1 << 30)
    print(f"  plane {'on' if plane_on else 'off'} on {card}: PUT "
          f"{n_objects / put_s:.3f} objects/s, {gib / put_s:.6f} GiB/s "
          f"({put_s:.6f} s); GET {n_objects / get_s:.3f} objects/s, "
          f"{gib / get_s:.6f} GiB/s ({get_s:.6f} s); degraded GET of "
          f"{len(degraded)}: {len(degraded) / deg_s:.3f} objects/s, "
          f"{deg_bytes / (1 << 30) / deg_s:.6f} GiB/s ({deg_s:.6f} s)")
    return {"put": n_objects / put_s, "get": n_objects / get_s,
            "degraded_get": len(degraded) / deg_s}


def hot_tier_phase(seed: int, card: str, records: list[dict], working_set: int,
                   budget: int = 2 << 30, device: str = "cuda") -> None:
    """The HBM hot tier (MTPU_HOTTIER=1, admit cooldown 0, a `budget`-byte
    budget cut from an 80 GB card to fit the run's time) through the S3
    server on 12 tmp drives: PUT about `working_set` bytes of 4-32 MiB
    objects, heat them until admission lands and eviction has run, then
    hold every hot GET byte-equal and ETag-identical to the drive-path GET
    with K2 launched once per hit, ranged hits byte-equal, an overwrite
    served new, and a flipped resident byte falling back to the drive
    path. The server runs with enable_mrf=False, as phase 3's does."""
    import numpy as np
    import torch

    from minio_tpu_torch import hottier
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    env = {"MTPU_HOTTIER": "1", "MTPU_HOTTIER_ADMIT_COOLDOWN_S": "0",
           "MTPU_HOTTIER_BYTES": str(budget),
           "MTPU_HOTTIER_MAX_OBJECT": str(32 << 20)}
    os.environ.update(env)
    hottier.reset_global()
    rng = np.random.default_rng(seed + 3)
    objects: dict[str, bytes] = {}
    total = 0
    while total < working_set:
        n = int(rng.integers(4 << 20, (32 << 20) + 1))
        objects[f"h{len(objects):04d}"] = rng.bytes(n)
        total += n
    work = tempfile.mkdtemp(prefix="mtpu-torch-hot-")
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    pool = _Pool(srv.url, 8)
    cl = _Client(srv.url)
    try:
        tier = hottier.get_tier(srv.obj.device)
        print(f"  {len(objects)} objects, {total} B ({total / (1 << 30):.3f} GiB); "
              f"budget {budget} B; " + ", ".join(f"{k}={v}" for k, v in env.items()))
        cl.request("PUT", "/hot")
        kernels.reset_launches()
        start = kernels.launches()
        pool.run(lambda c, kv: c.request("PUT", f"/hot/{kv[0]}", kv[1]),
                 objects.items())

        def get_ok(c, key):
            r, data = c.request("GET", f"/hot/{key}")
            if data != objects[key] or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"hot phase GET {key}: bytes or ETag differ")

        t0 = time.perf_counter()
        for _ in range(2):                    # the second GET admits
            pool.run(get_ok, objects)
        if not tier.drain(600):
            raise AssertionError(f"hot tier admission never settled: {tier.stats()}")
        heat_s = time.perf_counter() - t0
        st = tier.stats()
        cold = [k for k in objects if not tier.resident("hot", k)]
        print(f"  after 2 GETs each ({heat_s:.3f} s): {st}")
        if st["resident_objects"] == 0 or not cold:
            raise AssertionError("hot tier: want some objects resident and some not")
        for _ in range(4):                    # 3 cold keys get hotter
            pool.run(get_ok, cold[:3])
        if not tier.drain(600):
            raise AssertionError(f"hot tier admission never settled: {tier.stats()}")
        st = tier.stats()
        print(f"  after 4 more GETs of 3 non-resident objects: {st}")
        if st["evictions"] < 1 or not any(tier.resident("hot", k) for k in cold[:3]):
            raise AssertionError("hot tier: the hotter keys did not evict colder ones")
        if st["resident_bytes"] > budget:
            raise AssertionError("hot tier: over its budget")

        resident = [k for k in objects if tier.resident("hot", k)]
        drive_s = hot_s = 0.0
        hits0 = tier.stats()["hits"]
        k2 = 0
        for key in resident:
            os.environ["MTPU_HOTTIER"] = "0"
            t0 = time.perf_counter()
            r, drive = cl.request("GET", f"/hot/{key}")
            drive_s += time.perf_counter() - t0
            drive_etag = r.getheader("ETag")
            os.environ["MTPU_HOTTIER"] = "1"
            before = kernels.launches()["mxsum_digest"]
            t0 = time.perf_counter()
            r, hot = cl.request("GET", f"/hot/{key}")
            hot_s += time.perf_counter() - t0
            k2 += kernels.launches()["mxsum_digest"] - before
            if not (hot == drive == objects[key]) or r.getheader("ETag") != drive_etag:
                raise AssertionError(f"hot GET {key}: not equal to the drive-path GET")
        hits = tier.stats()["hits"] - hits0
        if hits != len(resident) or k2 != hits:
            raise AssertionError(f"hot GETs: {hits} hits and {k2} K2 launches for "
                                 f"{len(resident)} resident objects")
        nbytes = sum(len(objects[k]) for k in resident)
        print(f"  hot GETs of {len(resident)} resident objects ({nbytes} B) on "
              f"{card}: {hits} hits, {k2} K2 launches; hot {hot_s:.6f} s "
              f"({nbytes / (1 << 30) / hot_s:.6f} GiB/s), drive path "
              f"{drive_s:.6f} s ({nbytes / (1 << 30) / drive_s:.6f} GiB/s)")

        hits0 = tier.stats()["hits"]
        for _ in range(16):
            key = resident[int(rng.integers(len(resident)))]
            size = len(objects[key])
            off = int(rng.integers(size))
            end = int(rng.integers(off, size))
            r, data = cl.request("GET", f"/hot/{key}",
                                 headers={"Range": f"bytes={off}-{end}"})
            if r.status != 206 or data != objects[key][off:end + 1]:
                raise AssertionError(f"hot ranged GET {key} {off}-{end}")
        if tier.stats()["hits"] - hits0 != 16:
            raise AssertionError("hot ranged GETs did not all hit")

        key = resident[0]
        new = rng.bytes(len(objects[key]))
        cl.request("PUT", f"/hot/{key}", new)
        objects[key] = new
        get_ok(cl, key)
        print(f"  overwrite of resident {key}: the next GET served the new bytes")

        key = resident[1]
        with tier._mu:
            entry = tier._entries[("hot", key)]
        entry.data[0, 0, 0] ^= 0xFF
        if entry.data.is_cuda:
            torch.cuda.synchronize()
        st0 = tier.stats()
        get_ok(cl, key)
        st1 = tier.stats()
        if st1["hits"] != st0["hits"] or st1["evictions"] <= st0["evictions"]:
            raise AssertionError("flipped resident byte: the GET did not fall back")
        print(f"  flipped byte in resident {key}: the GET fell back to the "
              f"drive path, byte-equal; {st1}")
        end = kernels.launches()
        _fill_launches(records, "hot", {n: end[n] - start[n] for n in kernels.KERNELS})
        print("  launches hot-tier phase: " + ", ".join(
            f"{n} {end[n] - start[n]}" for n in kernels.KERNELS))
    finally:
        pool.close()
        cl.close()
        srv.close()
        hottier.reset_global()
        for k in env:
            os.environ.pop(k, None)
        shutil.rmtree(work, ignore_errors=True)


def _mp_part(seed: int, i: int) -> bytes:
    """Part i of the multipart phase's object, made from the seed."""
    import numpy as np

    return np.random.default_rng([seed, 6, i]).bytes(MP_PART_SIZE)


def _mp_parts_for(free_bytes: int) -> int:
    """MP_PARTS, halved (down to 64 parts, 1 GiB) until the drives' copy of
    the object (16/12 of it, plus room for a second upload and heal's tmp
    files) fits in `free_bytes`."""
    parts = MP_PARTS
    while parts > 64 and parts * MP_PART_SIZE * 16 / 12 * 1.25 > free_bytes:
        parts //= 2
    return parts


def _upload_id(doc: bytes) -> str:
    import xml.etree.ElementTree as ET

    return ET.fromstring(doc).find(
        "{http://s3.amazonaws.com/doc/2006-03-01/}UploadId").text


def _complete_doc(etags: list[str]) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>").encode()


class _Kept:
    """A phase's deployment kept serving for later phases: its S3 URL,
    what it holds (the object's part md5s and SHA-256), and close() to
    stop it and remove its drives."""

    def __init__(self, url: str, bucket: str, key: str, size: int, md5s: list,
                 sha256: str, close):
        self.url, self.bucket, self.key, self.size = url, bucket, key, size
        self.md5s, self.sha256 = md5s, sha256
        self.close = close


def multipart_phase(seed: int, card: str, records: list[dict] | None,
                    n_parts: int | None = None, device: str = "cuda",
                    keep: bool = False) -> _Kept | None:
    """BASELINE.json config 5 (erasure-server-pool PutObject, 4x16-drive
    pools, multipart) and config 4 (HealObject of a 16-drive set with 4
    drives offline) through the port's S3 server; see phase 6 above. With
    `keep`, the pools keep serving the object after the phase, for the
    listing phase, until the caller closes the returned _Kept."""
    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.local import LocalDrive

    work = tempfile.mkdtemp(prefix="mtpu-torch-mp-")
    free = shutil.disk_usage(work).free
    parts = n_parts or _mp_parts_for(free)
    size = parts * MP_PART_SIZE
    gib = size / (1 << 30)
    print(f"  tmp filesystem: {free} B free; object {parts} parts x "
          f"{MP_PART_SIZE} B = {size} B ({gib:.3f} GiB), {MP_INFLIGHT} part "
          f"uploads in flight" + ("" if parts == MP_PARTS else
                                  f" (cut from {MP_PARTS} parts to fit)"))
    pool_paths = [[os.path.join(work, f"pool{p}", f"d{i:02d}") for i in range(16)]
                  for p in range(4)]
    layer = ErasureServerPools([
        ErasureSets([LocalDrive(d) for d in paths], set_drive_count=16,
                    device=device) for paths in pool_paths])
    srv = S3Server(layer, sigv4.Credentials(ACCESS, SECRET)).start()
    pool = _Pool(srv.url, MP_INFLIGHT)
    cl = _Client(srv.url)
    stages, marks = {}, {}

    def mark(stage):
        stages[stage] = kernels.launches()
        marks[stage] = time.perf_counter()

    def get_sha(path, headers=None) -> tuple[str, int]:
        r = cl.send("GET", path, headers=headers)
        sha, n = hashlib.sha256(), 0
        while chunk := r.read(4 << 20):
            sha.update(chunk)
            n += len(chunk)
        return sha.hexdigest(), n

    try:
        es0 = layer.pools[0].sets[0]
        print(f"  4 pools x {layer.pools[0].set_count} set of 16 drives, EC "
              f"{es0.n - es0.parity}+{es0.parity}, block {es0.block_size} B, "
              f"bitrot {es0.bitrot_algorithm}")
        want_sha, md5s = hashlib.sha256(), []
        for i in range(parts):
            part = _mp_part(seed, i)
            want_sha.update(part)
            md5s.append(hashlib.md5(part).hexdigest())
        want_sha = want_sha.hexdigest()
        want_etag = hashlib.md5(b"".join(bytes.fromhex(e) for e in md5s)).hexdigest()
        key = "/mpu/object-5g"
        cl.request("PUT", "/mpu")
        frees = [layer._pool_free(p) for p in layer.pools]
        kernels.reset_launches()
        mark("start")
        _r, doc = cl.request("POST", key, query={"uploads": ""})
        uid = _upload_id(doc)

        def put_part(c, i):
            r, _ = c.request("PUT", key, _mp_part(seed, i),
                             query={"partNumber": str(i + 1), "uploadId": uid})
            if r.getheader("ETag") != f'"{md5s[i]}"':
                raise AssertionError(f"part {i + 1}: ETag {r.getheader('ETag')}")

        pool.run(put_part, range(parts))
        _r, doc = cl.request("POST", key, _complete_doc(md5s), query={"uploadId": uid})
        if f"{want_etag}-{parts}".encode() not in doc:
            raise AssertionError(f"complete: {doc[:300]!r}")
        mark("put")
        owner = layer.pool_of("mpu", "object-5g")
        es = layer.pools[owner].get_hashed_set("object-5g")
        print(f"  the object went to pool {owner} (free bytes per pool before "
              f"the upload: {frees})")

        got_sha, n = get_sha(key)
        if (got_sha, n) != (want_sha, size):
            raise AssertionError(f"GET: {n} B, sha256 {got_sha} != {want_sha}")
        mark("get")
        lo = MP_PART_SIZE - 1000
        _r, data = cl.request("GET", key, headers={"Range": f"bytes={lo}-{lo + 1999}"})
        if data != _mp_part(seed, 0)[-1000:] + _mp_part(seed, 1)[:1000]:
            raise AssertionError("Range GET across the part 1/2 boundary")
        r, _ = cl.request("HEAD", key)
        if r.getheader("ETag") != f'"{want_etag}-{parts}"' or \
                int(r.getheader("Content-Length")) != size:
            raise AssertionError(f"HEAD: {r.getheader('ETag')}")

        key2 = "/mpu/second"
        _r, doc = cl.request("POST", key2, query={"uploads": ""})
        uid2 = _upload_id(doc)
        small = [_mp_part(seed + 1, 0)[:5 << 20], b"tail" * 1000]
        for i, body in enumerate(small):
            cl.request("PUT", key2, body, query={"partNumber": str(i + 1),
                                                 "uploadId": uid2})
        _r, doc = cl.request("GET", key2, query={"uploadId": uid2})
        for i, body in enumerate(small):
            if hashlib.md5(body).hexdigest().encode() not in doc:
                raise AssertionError(f"ListParts: part {i + 1} missing: {doc[:300]!r}")
        r, _ = cl.request("DELETE", key2, query={"uploadId": uid2})
        left = [d for paths in pool_paths for d in paths
                if glob.glob(os.path.join(d, ".mtpu.sys", "multipart", "*", uid2))]
        if r.status != 204 or left:
            raise AssertionError(f"Abort: {r.status}, session left on {left}")
        print(f"  GET, Range GET, HEAD (ETag {want_etag}-{parts}), ListParts and "
              "Abort of a second upload: ok")

        # BASELINE.json config 4: 4 of the set's 16 drives lose the object,
        # the 4 that hold data shards 1-4, so a read must rebuild.
        dist = es.latest_fileinfo("mpu", "object-5g").erasure.distribution
        lost = [d.root for d, shard in zip(es.drives, dist) if shard <= 4]
        originals = {}
        for d in lost:
            for f in glob.glob(os.path.join(d, "mpu", "object-5g", "*", "part.*")):
                with open(f, "rb") as fh:
                    originals[f] = hashlib.sha256(fh.read()).hexdigest()
        if len(originals) != 4 * parts:
            raise AssertionError(f"{len(originals)} shard files on the lost drives")
        for d in lost:
            shutil.rmtree(os.path.join(d, "mpu", "object-5g"))
        mark("lose")
        got_sha, n = get_sha(key)
        if (got_sha, n) != (want_sha, size):
            raise AssertionError("degraded GET: bytes differ")
        mark("degraded_get")
        res = layer.heal_object("mpu", "object-5g", scan_deep=True)
        mark("heal")
        rebuilt = {}
        for f in originals:
            with open(f, "rb") as fh:
                rebuilt[f] = hashlib.sha256(fh.read()).hexdigest()
        if res.healed_count != 4 or rebuilt != originals:
            raise AssertionError(f"heal: {res.healed_count} healed, "
                                 f"{sum(rebuilt[f] != originals[f] for f in originals)}"
                                 " files differ")
        got_sha, n = get_sha(key)
        if (got_sha, n) != (want_sha, size):
            raise AssertionError("GET after heal: bytes differ")
        mark("end")
    except BaseException:
        keep = False
        raise
    finally:
        pool.close()
        cl.close()

        def close():
            srv.close()
            shutil.rmtree(work, ignore_errors=True)

        if not keep:
            close()

    order = ["start", "put", "get", "lose", "degraded_get", "heal", "end"]
    for a, b in zip(order, order[1:]):
        if b != "lose":
            print(f"  launches {b}: " + ", ".join(
                f"{n} {stages[b][n] - stages[a][n]}" for n in kernels.KERNELS))
    for a, b, names in (("start", "put", MXSUM_KERNELS),
                        ("lose", "degraded_get", ("gf2_matmul", "mxsum_digest")),
                        ("degraded_get", "heal", ("gf2_matmul", "mxsum_digest"))):
        for name in names:
            if stages[b][name] - stages[a][name] <= 0:
                raise AssertionError(f"{name} did not launch for {b}")
    if records is not None:
        _fill_launches(records, "multipart", {
            n: stages["end"][n] - stages["start"][n] for n in kernels.KERNELS})
    put_s = marks["put"] - marks["start"]
    get_s = marks["get"] - marks["put"]
    deg_s = marks["degraded_get"] - marks["lose"]
    heal_s = marks["heal"] - marks["degraded_get"]
    print(f"  multipart {gib:.3f} GiB on {card}: PUT {gib / put_s:.6f} GiB/s "
          f"({put_s:.6f} s, Create to Complete), GET {gib / get_s:.6f} GiB/s "
          f"({get_s:.6f} s), degraded GET (4 of 16 lost) {gib / deg_s:.6f} GiB/s "
          f"({deg_s:.6f} s), deep heal of 4 drives {heal_s:.6f} s; pool {owner}")
    return (_Kept(srv.url, "mpu", "object-5g", size, md5s, want_sha, close)
            if keep else None)


_VERSIONING_ON = (b"<VersioningConfiguration><Status>Enabled</Status>"
                  b"</VersioningConfiguration>")


def _versions_page(doc: bytes):
    """A ListObjectVersions answer -> ([(key, version id, is latest, is a
    delete marker, etag, size)], truncated, next key marker, next
    version-id marker)."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(doc)
    out = []
    for e in root:
        tag = e.tag[len(S3_NS):]
        if tag in ("Version", "DeleteMarker"):
            out.append((e.findtext(S3_NS + "Key"), e.findtext(S3_NS + "VersionId"),
                        e.findtext(S3_NS + "IsLatest") == "true", tag == "DeleteMarker",
                        (e.findtext(S3_NS + "ETag") or "").strip('"'),
                        int(e.findtext(S3_NS + "Size") or 0)))
    return (out, root.findtext(S3_NS + "IsTruncated") == "true",
            root.findtext(S3_NS + "NextKeyMarker") or "",
            root.findtext(S3_NS + "NextVersionIdMarker") or "")


def _copy_etag(doc: bytes) -> str:
    import xml.etree.ElementTree as ET

    return ET.fromstring(doc).findtext(S3_NS + "ETag").strip('"')


class _Stages:
    """Kernel launch counts and the host clock at each named point of a
    phase; report() prints each stage's seconds, rate and launches."""

    def __init__(self):
        from minio_tpu_torch.ops import kernels

        self._kernels = kernels
        self.at: list[tuple[str, dict, float]] = []

    def mark(self, name: str) -> None:
        self.at.append((name, self._kernels.launches(), time.perf_counter()))

    def delta(self, name: str) -> tuple[float, dict]:
        i = [n for n, _l, _t in self.at].index(name)
        (_a, la, ta), (_b, lb, tb) = self.at[i - 1], self.at[i]
        return tb - ta, {k: lb[k] - la[k] for k in lb}

    def need(self, name: str, kernels=("gf2_matmul", "mxsum_digest")) -> None:
        _s, d = self.delta(name)
        for k in kernels:
            if d[k] <= 0:
                raise AssertionError(f"{k} did not launch for {name}")


def versioning_phase(seed: int, card: str, mp: _Kept | None, device: str = "cuda",
                     big_size: int = VER_SIZE, small_keys: int = VER_KEYS,
                     clients: int = 64) -> None:
    """S3 versioning, server-side copies, tags and conditional requests
    (phase 7) through the port's S3 server over HTTP with SigV4. On config
    1's deployment (12 drives on /dev/shm, EC 8+4, 1 MiB blocks): one object of
    `big_size` bytes PUT as the null version, then, with the bucket's
    versioning enabled, overwritten 3 times; each of the 4 versions read
    back by its id ("null" included); the first versioned one, now
    noncurrent, read with its shards lost on the 4 drives that hold data
    shards 1-4, deep-healed (the rebuilt files equal to the originals) and
    read with data shards 5-8 moved away; a DELETE without an id answers
    with a delete marker, a GET then 404 with x-amz-delete-marker, and the
    marker deleted by its id brings the newest version back; CopyObject of
    the noncurrent version with the metadata directives COPY and REPLACE;
    tags on a version; If-Match and If-None-Match on GET and HEAD. Then
    small versioned objects: `clients` clients PUT `small_keys` keys, 4
    versions each, of 1-512 KiB (log-uniform), the bucket walked with
    ListObjectVersions in pages of 1000 (every version once, one latest
    per key), and VER_DELETE versions removed by one DeleteObjects naming
    their VersionIds. Last, on phase 6's pools (`mp`), UploadPartCopy of
    the multipart object's first VER_COPY_PARTS parts into a versioned
    bucket, in its own 16 MiB parts, 4 in flight: every part's ETag the
    source part's md5, the Complete answered with a version id, each part
    of the copy read back with the source part's md5. The server runs
    with enable_mrf=False: the degraded GET queues no background heal to
    race the phase's deep heal."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    rng = np.random.default_rng(seed + 8)
    bodies = [rng.bytes(big_size) for _ in range(VER_VERSIONS)]  # null, then 3
    md5 = [hashlib.md5(b).hexdigest() for b in bodies]
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                               small_keys * VER_VERSIONS)).astype(np.int64)
    small = [(f"s{i // VER_VERSIONS:04d}", rng.bytes(int(n))) for i, n in enumerate(sizes)]
    # Drives on /dev/shm, as the listing phase's: the phase's rates then
    # do not hang on the write-back of the gigabytes that the earlier
    # phases left on the tmp filesystem.
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-ver-", dir=shm)
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    cl = _Client(srv.url)
    pool = _Pool(srv.url, clients)
    st = _Stages()
    big = "/ver/big"
    gib = big_size / (1 << 30)
    try:
        es = srv.obj.pools[0].sets[0]
        print(f"  server {srv.url}: EC {es.n - es.parity}+{es.parity}, block "
              f"{es.block_size} B, bitrot {es.bitrot_algorithm}; {VER_VERSIONS} versions "
              f"of {big_size} B, {small_keys} x {VER_VERSIONS} small versions, "
              f"{clients} client threads")
        cl.request("PUT", "/ver")
        kernels.reset_launches()
        st.mark("start")
        r, _ = cl.request("PUT", big, bodies[0], headers={"x-amz-meta-gen": "0"})
        if r.getheader("x-amz-version-id"):
            raise AssertionError("a PUT before versioning got a version id")
        cl.request("PUT", "/ver", _VERSIONING_ON, query={"versioning": ""})
        vids = ["null"]
        for i in range(1, VER_VERSIONS):
            r, _ = cl.request("PUT", big, bodies[i], headers={
                "x-amz-meta-gen": str(i), "Content-Type": f"application/x-v{i}"})
            if not r.getheader("x-amz-version-id") or r.getheader("ETag") != f'"{md5[i]}"':
                raise AssertionError(f"versioned PUT {i}: {r.getheader('x-amz-version-id')}")
            vids.append(r.getheader("x-amz-version-id"))
        st.mark("put")

        def get_version(i, what, headers=None):
            r, data = cl.request("GET", big, query={"versionId": vids[i]}, headers=headers)
            if data != bodies[i] or r.getheader("ETag") != f'"{md5[i]}"':
                raise AssertionError(f"{what}: GET of version {i} differs")
            if r.getheader("x-amz-version-id") != (vids[i] if i else None):
                raise AssertionError(f"{what}: x-amz-version-id {r.getheader('x-amz-version-id')}")

        for i in range(VER_VERSIONS):
            get_version(i, "intact")
        st.mark("get")

        # The first versioned one is noncurrent: lose its shards on the 4
        # drives of data shards 1-4, read it, deep-heal it.
        fi = es.latest_fileinfo("ver", "big", vids[1])
        by_shard = {shard: d for d, shard in zip(es.drives, fi.erasure.distribution)}

        def v1_dir(shard):
            return os.path.join(by_shard[shard].root, "ver", "big", fi.data_dir)

        originals = {s_: open(os.path.join(v1_dir(s_), "part.1"), "rb").read()
                     for s_ in (1, 2, 3, 4)}
        for s_ in originals:
            shutil.rmtree(v1_dir(s_))
        st.mark("lose")
        get_version(1, "degraded (4 of 12 drives lost)")
        st.mark("degraded_get")
        res = srv.obj.heal_object("ver", "big", vids[1], scan_deep=True)
        if res.healed_count != 4 or res.version_id != vids[1] or any(
                open(os.path.join(v1_dir(s_), "part.1"), "rb").read() != data
                for s_, data in originals.items()):
            raise AssertionError(f"heal of the noncurrent version: {res.healed_count} "
                                 "healed or files differ")
        st.mark("heal")
        aside = [(v1_dir(s_), os.path.join(work, f"aside-{s_}")) for s_ in (5, 6, 7, 8)]
        for src, dst in aside:
            os.replace(src, dst)
        get_version(1, "healed, 4 other drives lost")
        for src, dst in aside:
            os.replace(dst, src)
        st.mark("get_after_heal")

        r, _ = cl.request("DELETE", big)
        dm = r.getheader("x-amz-version-id")
        if r.status != 204 or r.getheader("x-amz-delete-marker") != "true" or not dm:
            raise AssertionError(f"DELETE without an id: {r.status}, no delete marker")
        r, doc = cl.request("GET", big, check=False)
        if (r.status != 404 or b"<Code>NoSuchKey</Code>" not in doc
                or r.getheader("x-amz-delete-marker") != "true"
                or r.getheader("x-amz-version-id") != dm):
            raise AssertionError(f"GET after the delete marker: {r.status}")
        r, _ = cl.request("DELETE", big, query={"versionId": dm})
        r, data = cl.request("GET", big, headers={"Range": "bytes=0-1048575"})
        if data != bodies[-1][:1 << 20] or r.getheader("x-amz-version-id") != vids[-1]:
            raise AssertionError("the newest version does not answer after its marker went")
        st.mark("markers")

        source = f"/ver/big?versionId={vids[1]}"
        _r, doc = cl.request("PUT", "/ver/copy-v1", headers={"x-amz-copy-source": source})
        _r, doc2 = cl.request("PUT", "/ver/copy-v1-replace", headers={
            "x-amz-copy-source": source, "x-amz-metadata-directive": "REPLACE",
            "x-amz-meta-new": "yes", "Content-Type": "text/plain"})
        st.mark("copy")
        if _copy_etag(doc) != md5[1] or _copy_etag(doc2) != md5[1]:
            raise AssertionError("CopyObject: ETag is not the source's md5")
        for key, want in (("copy-v1", {"x-amz-meta-gen": "1", "x-amz-meta-new": None,
                                       "Content-Type": "application/x-v1"}),
                          ("copy-v1-replace", {"x-amz-meta-gen": None, "x-amz-meta-new": "yes",
                                               "Content-Type": "text/plain"})):
            r, data = cl.request("GET", f"/ver/{key}")
            got = {h: r.getheader(h) for h in want}
            if data != bodies[1] or got != want or r.getheader("x-amz-version-id") is None:
                raise AssertionError(f"CopyObject {key}: bytes or metadata differ: {got}")
        st.mark("copy_get")

        tags = (b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
                b"<Tag><Key>gen</Key><Value>2</Value></Tag></TagSet></Tagging>")
        v2 = {"versionId": vids[2]}
        cl.request("PUT", big, tags, query={"tagging": "", **v2})
        _r, doc = cl.request("GET", big, query={"tagging": "", **v2})
        r, _ = cl.request("HEAD", big, query=v2)
        if b"<Key>env</Key><Value>prod</Value>" not in doc or \
                r.getheader("x-amz-tagging-count") != "2":
            raise AssertionError("tags on a version")
        r, _ = cl.request("DELETE", big, query={"tagging": "", **v2})
        _r, doc = cl.request("GET", big, query={"tagging": "", **v2})
        if r.status != 204 or b"<Tag>" in doc:
            raise AssertionError("DeleteObjectTagging")
        etag, other = f'"{md5[-1]}"', '"00000000000000000000000000000000"'
        for method, headers, want in (
                ("GET", {"If-Match": etag, "Range": "bytes=0-1023"}, 206),
                ("GET", {"If-Match": other}, 412),
                ("GET", {"If-None-Match": etag}, 304),
                ("GET", {"If-None-Match": other, "Range": "bytes=0-1023"}, 206),
                ("HEAD", {"If-None-Match": etag}, 304),
                ("HEAD", {"If-Match": other}, 412),
                ("HEAD", {"If-Match": etag}, 200)):
            r, data = cl.request(method, big, headers=headers, check=False)
            if r.status != want or (want == 206 and data != bodies[-1][:1024]):
                raise AssertionError(f"{method} {headers}: {r.status}, {want} expected")
        st.mark("tags")
        print(f"  {VER_VERSIONS} versions byte-equal by id (null included); the "
              "noncurrent one degraded, healed and read again; delete marker 404 and "
              "its removal; CopyObject COPY and REPLACE byte-equal with their metadata; "
              "tags on a version; If-Match/If-None-Match 206/412/304/200: ok")

        # Small versioned objects: the plane phase's mix, 4 versions a key.
        cl.request("PUT", "/vsmall")
        cl.request("PUT", "/vsmall", _VERSIONING_ON, query={"versioning": ""})
        st.mark("small_start")

        def put_small(c, item):
            key, data = item
            r, _ = c.request("PUT", f"/vsmall/{key}", data)
            vid = r.getheader("x-amz-version-id")
            if not vid or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"small versioned PUT {key}")
            return (key, vid), (hashlib.md5(data).hexdigest(), len(data))

        expected = dict(pool.run(put_small, small))
        st.mark("small_put")

        def walk_versions():
            seen, latest, km, vm, pages = {}, set(), "", "", 0
            while True:
                q = {"versions": "", "max-keys": "1000"}
                if km:
                    q.update({"key-marker": km, "version-id-marker": vm})
                page, truncated, km, vm = _versions_page(cl.request("GET", "/vsmall",
                                                                    query=q)[1])
                pages += 1
                for key, vid, is_latest, is_marker, etag, size in page:
                    if (key, vid) in seen or is_marker:
                        raise AssertionError(f"ListObjectVersions: {key} {vid} repeated")
                    seen[(key, vid)] = (etag, size)
                    if is_latest:
                        if key in latest:
                            raise AssertionError(f"two latest versions of {key}")
                        latest.add(key)
                if not truncated:
                    return seen, latest, pages

        seen, latest, pages = walk_versions()
        st.mark("small_list")
        if seen != expected or latest != {k for k, _v in expected}:
            raise AssertionError(f"ListObjectVersions: {len(seen)} versions, "
                                 f"{len(expected)} PUT")
        doomed = sorted(expected)[:VER_DELETE]
        doc = cl.request("POST", "/vsmall", ("<Delete>" + "".join(
            f"<Object><Key>{k}</Key><VersionId>{v}</VersionId></Object>"
            for k, v in doomed) + "</Delete>").encode(), query={"delete": ""})[1]
        st.mark("small_delete")
        if doc.count(b"<Deleted>") != len(doomed) or b"<Error>" in doc or any(
                f"<VersionId>{v}</VersionId>".encode() not in doc for _k, v in doomed):
            raise AssertionError(f"DeleteObjects of versions: {doc[:300]!r}")
        left, _latest, _p = walk_versions()
        if left != {kv: expected[kv] for kv in sorted(expected)[len(doomed):]}:
            raise AssertionError(f"{len(left)} versions left after DeleteObjects")
        print(f"  {len(small)} small versioned PUTs; ListObjectVersions: every version "
              f"once in {pages} pages, one latest per key; DeleteObjects of "
              f"{len(doomed)} VersionIds in one POST, {len(left)} versions left: ok")
    finally:
        pool.close()
        cl.close()
        srv.close()
        shutil.rmtree(work, ignore_errors=True)

    if mp is not None:
        # UploadPartCopy on phase 6's pools, into a versioned bucket.
        c = _Client(mp.url)
        ppool = _Pool(mp.url, MP_INFLIGHT)
        try:
            c.request("PUT", "/mpver")
            c.request("PUT", "/mpver", _VERSIONING_ON, query={"versioning": ""})
            st.mark("part_copy_start")
            _r, doc = c.request("POST", "/mpver/copy", query={"uploads": ""})
            uid = _upload_id(doc)

            def copy_part(cc, i):
                _r, doc = cc.request("PUT", "/mpver/copy", query={
                    "partNumber": str(i + 1), "uploadId": uid}, headers={
                    "x-amz-copy-source": f"/{mp.bucket}/{mp.key}",
                    "x-amz-copy-source-range":
                        f"bytes={i * MP_PART_SIZE}-{(i + 1) * MP_PART_SIZE - 1}"})
                if _copy_etag(doc) != mp.md5s[i]:
                    raise AssertionError(f"UploadPartCopy {i + 1}: ETag {_copy_etag(doc)}")

            md5s = mp.md5s[:VER_COPY_PARTS]
            ppool.run(copy_part, range(len(md5s)))
            want_etag = hashlib.md5(b"".join(bytes.fromhex(e) for e in md5s)).hexdigest()
            r, doc = c.request("POST", "/mpver/copy", _complete_doc(md5s),
                               query={"uploadId": uid})
            st.mark("part_copy")
            if not r.getheader("x-amz-version-id") or \
                    f"{want_etag}-{len(md5s)}".encode() not in doc:
                raise AssertionError(f"Complete of the part copy: {doc[:300]!r}")
            # The copy read back part by part against the md5 of each
            # source part, taken when phase 6 PUT it.
            r = c.send("GET", "/mpver/copy")
            for i, want in enumerate(md5s):
                got = r.read(MP_PART_SIZE)
                if len(got) != MP_PART_SIZE or hashlib.md5(got).hexdigest() != want:
                    raise AssertionError(f"the part copy's part {i + 1} differs "
                                         "from the source's")
            if r.read(1):
                raise AssertionError("the part copy is longer than its parts")
            st.mark("part_copy_get")
            print(f"  UploadPartCopy of {mp.key}'s first {len(md5s)} parts of "
                  f"{MP_PART_SIZE} B, {MP_INFLIGHT} in flight, into a versioned bucket: "
                  f"every part ETag the source part's md5, version id "
                  f"{r.getheader('x-amz-version-id')}, every part's md5 read back: ok")
        finally:
            ppool.close()
            c.close()

    # Each stage: (amount, unit, what the amount counts).
    report = [("put", VER_VERSIONS * gib, "GiB", f"{VER_VERSIONS} PUTs"),
              ("get", VER_VERSIONS * gib, "GiB", f"{VER_VERSIONS} GETs by id"),
              ("degraded_get", gib, "GiB", "4 of 12 drives lost"),
              ("heal", 4, "shards", "deep heal of the noncurrent version"),
              ("get_after_heal", gib, "GiB", "4 other drives lost"),
              ("markers", 4, "requests", "DELETE, GET 404, DELETE of the marker, GET"),
              ("copy", 2 * gib, "GiB", "CopyObject COPY and REPLACE"),
              ("copy_get", 2 * gib, "GiB", "GETs of the copies"),
              ("tags", 12, "requests", "tags on a version and conditional requests"),
              ("small_put", len(small), "objects", "small versioned PUTs"),
              ("small_list", len(small), "versions", "ListObjectVersions walk"),
              ("small_delete", min(VER_DELETE, len(small)), "versions",
               "one DeleteObjects")]
    if mp is not None:
        n_copy = min(VER_COPY_PARTS, len(mp.md5s))
        mp_gib = n_copy * MP_PART_SIZE / (1 << 30)
        report += [("part_copy", mp_gib, "GiB",
                    f"UploadPartCopy of {n_copy} parts, Create to Complete"),
                   ("part_copy_get", mp_gib, "GiB", "GET of the copy")]
    for name, amount, unit, what in report:
        secs, d = st.delta(name)
        print(f"  versioning {name} on {card}: {secs:.6f} s, {amount / secs:.6f} "
              f"{unit}/s ({amount:g} {unit}, {what}); launches "
              + ", ".join(f"{k} {d[k]}" for k in kernels.KERNELS))
    for name in ("put", "degraded_get", "heal", "copy", "small_put") + (
            ("part_copy",) if mp is not None else ()):
        st.need(name)
    st.need("get", ("mxsum_digest",))
    st.need("get_after_heal")
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in kernels.KERNELS}
    print("  launches versioning phase: " + ", ".join(f"{k} {total[k]}"
                                                      for k in kernels.KERNELS))


class _Down:
    """A drive that refuses every call, as one pulled from its slot does
    (is_online false, every other method raising FaultyDisk)."""

    def __init__(self, drive):
        self.inner = drive

    def endpoint(self) -> str:
        return self.inner.endpoint()

    def is_online(self) -> bool:
        return False

    def __getattr__(self, name):
        from minio_tpu_torch.utils import errors as se

        def refuse(*_a, **_kw):
            raise se.FaultyDisk(f"{self.inner.endpoint()}: {name} refused")

        return refuse


def _wipe_keep_root(root: str) -> None:
    """Remove everything under a drive's root and keep the root (a blank
    drive mounted in its place). Retried: the server's healers write."""
    for _ in range(200):
        try:
            for name in os.listdir(root):
                full = os.path.join(root, name)
                if os.path.isdir(full):
                    shutil.rmtree(full)
                else:
                    os.remove(full)
            return
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"could not wipe {root}")


def _heal_bigs_for(free_bytes: int, n_big: int, big_size: int, rest: int) -> int:
    """n_big, halved (down to 1) until the drives' copy of the phase's data
    (12/8 of it) plus one drive's copy (1/8) fits in `free_bytes` with a
    quarter to spare."""
    while n_big > 1 and (n_big * big_size + rest) * 13 / 8 * 1.25 > free_bytes:
        n_big //= 2
    return n_big


def heal_phase(seed: int, card: str, records: list[dict] | None, device: str = "cuda",
               n_big: int = HEAL_BIG, big_size: int = HEAL_BIG_SIZE,
               n_small: int = HEAL_SMALL, mp_parts: int = HEAL_MP_PARTS,
               ver_keys: int = HEAL_VER_KEYS, mrf_puts: int = HEAL_MRF_PUTS,
               clients: int = 64, interval: float = 1.0) -> None:
    """Heal on config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB blocks)
    behind the port's server at build_server's defaults (each set's MRF
    healer on) with the auto-healer started as main() starts it (one
    AutoHealer per pool, `interval` s). Bucket A: `n_big` objects of
    `big_size`, `n_small` warp-mix objects (1-512 KiB, log-uniform) PUT by
    `clients` clients, one multipart object of `mp_parts` parts of 16 MiB;
    bucket B, versioned: `ver_keys` keys x 3 warp-mix versions, delete
    markers on a quarter of them. Then: `mrf_puts` warp-mix PUTs while 2
    drives refuse every call, all answered 200, and, once the drives are
    back, the MRF queue drained with every object ok on all 12 drives; a
    GET over a flipped byte of a big object, and the deep heal it queued
    rewriting the shard file equal to its copy; bucket C lost on 2 drives
    and healed by heal_bucket; an object whose journal is gone from 5
    drives purged as dangling, its GET then 404. Last, live replacement:
    drive 5's tree copied, then wiped with its root kept; the auto-healer
    claims the slot (format.json equal to the copy's) and rebuilds the
    drive, timed from the wipe until its healing tracker is gone; the shard
    files of every latest version equal the copy's, and so do their
    journal entries (inline ones but for the shard index, which the heal
    writes as pos + 1, as the JAX heal does); and every latest object GETs
    byte-equal, with its ETag, while 4 other drives are removed. Launch
    counts go into `records` unless it is None."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server
    from minio_tpu_torch.storage.local import LocalDrive

    rng = np.random.default_rng(seed + 9)

    def warp(n):
        return [int(x) for x in np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10), n))]

    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-heal-", dir=shm)
    small_sizes = warp(n_small)
    ver_sizes = warp(ver_keys * 3)
    mrf_sizes = warp(mrf_puts)
    rest = (sum(small_sizes) + sum(ver_sizes) + sum(mrf_sizes)
            + mp_parts * MP_PART_SIZE + (2 << 20))
    free = shutil.disk_usage(work).free
    cut = _heal_bigs_for(free, n_big, big_size, rest)
    data_bytes = cut * big_size + rest
    print(f"  drives' filesystem: {free} B free; {cut} objects of {big_size} B"
          + ("" if cut == n_big else f" (cut from {n_big} to fit)")
          + f", {n_small} warp-mix objects, {mp_parts} parts of {MP_PART_SIZE} B, "
          f"{ver_keys} x 3 versioned, {mrf_puts} MRF PUTs: {data_bytes} B of object data")
    bigs = {f"big-{i}": rng.bytes(big_size) for i in range(cut)}
    smalls = {f"s{i:04d}": rng.bytes(n) for i, n in enumerate(small_sizes)}
    parts = [rng.bytes(MP_PART_SIZE) for _ in range(mp_parts)]
    versions = [(f"v{i // 3:03d}", rng.bytes(n)) for i, n in enumerate(ver_sizes)]
    mrf_objs = {f"m{i:03d}": rng.bytes(n) for i, n in enumerate(mrf_sizes)}
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device).start()
    srv.start_auto_heal(interval=interval)
    es = srv.obj.pools[0].sets[0]
    cl = _Client(srv.url)
    pool = _Pool(srv.url, clients)
    st = _Stages()
    try:
        if es.mrf is None or len(srv.auto_healer) != 1:
            raise AssertionError("build_server's defaults: MRF and the auto-healer on")
        print(f"  server {srv.url}: EC {es.n - es.parity}+{es.parity}, block "
              f"{es.block_size} B, bitrot {es.bitrot_algorithm}, MRF on, auto-heal "
              f"every {interval} s, {clients} client threads")
        for b in ("/heal-a", "/heal-b", "/heal-c"):
            cl.request("PUT", b)
        cl.request("PUT", "/heal-b", _VERSIONING_ON, query={"versioning": ""})
        kernels.reset_launches()
        st.mark("start")

        def put(c, item, bucket="heal-a"):
            key, data = item
            r, _ = c.request("PUT", f"/{bucket}/{key}", data)
            if r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"PUT {bucket}/{key}: ETag")
            return r.getheader("x-amz-version-id")

        for item in bigs.items():
            put(cl, item)
        st.mark("put_big")
        pool.run(put, smalls.items())
        st.mark("put_small")
        _r, doc = cl.request("POST", "/heal-a/mp", query={"uploads": ""})
        uid = _upload_id(doc)
        md5s = [hashlib.md5(p).hexdigest() for p in parts]
        pool.run(lambda c, i: c.request("PUT", "/heal-a/mp", parts[i], query={
            "partNumber": str(i + 1), "uploadId": uid}), range(mp_parts))
        cl.request("POST", "/heal-a/mp", _complete_doc(md5s), query={"uploadId": uid})
        mp_body = b"".join(parts)
        mp_etag = '"' + hashlib.md5(b"".join(bytes.fromhex(e) for e in md5s)
                                    ).hexdigest() + f'-{mp_parts}"'
        st.mark("put_multipart")

        def put_versions(c, key):
            return [put(c, kv, "heal-b") for kv in versions if kv[0] == key]

        keys_b = sorted({k for k, _ in versions})
        vids = dict(zip(keys_b, pool.run(put_versions, keys_b)))
        marked = keys_b[::4]
        for key in marked:
            r, _ = cl.request("DELETE", f"/heal-b/{key}")
            if r.getheader("x-amz-delete-marker") != "true":
                raise AssertionError(f"DELETE heal-b/{key}: no delete marker")
        st.mark("put_versioned")
        latest_b = {k: [d for kk, d in versions if kk == k][-1]
                    for k in keys_b if k not in marked}
        print(f"  PUT {cut} x {big_size} B, {n_small} warp-mix, {mp_parts} parts, "
              f"{len(versions)} versions of {len(keys_b)} keys and {len(marked)} "
              "delete markers: ok")

        # MRF on PUT: 2 drives refuse every call while the PUTs run.
        real = {i: es.drives[i] for i in (3, 8)}
        for i, d in real.items():
            es.drives[i] = _Down(d)
        try:
            pool.run(put, mrf_objs.items())
        finally:
            for i, d in real.items():
                es.drives[i] = d
        st.mark("mrf_put")
        t0 = time.perf_counter()
        if not es.mrf.wait_idle(300):
            raise AssertionError("the MRF queue did not drain in 300 s")
        drain_s = time.perf_counter() - t0
        st.mark("mrf_drain")
        for key in mrf_objs:
            res = es.heal_object("heal-a", key, dry_run=True)
            if [s_.state for s_ in res.before] != ["ok"] * 12:
                raise AssertionError(f"after the MRF drain, {key}: "
                                     f"{[s_.state for s_ in res.before]}")
        print(f"  MRF on PUT: {mrf_puts} PUTs answered 200 with 2 of 12 drives "
              f"refusing; queue drained {drain_s:.6f} s after the drives came back "
              f"on {card}; every object ok on all 12 drives")

        # MRF on GET: a flipped byte in the shard a GET reads first.
        fi = es.latest_fileinfo("heal-a", "big-0")
        victim = es.drives[fi.erasure.distribution.index(1)]
        shard = glob.glob(os.path.join(victim.root, "heal-a", "big-0", "*", "part.1"))[0]
        original = open(shard, "rb").read()
        raw = bytearray(original)
        raw[32 + 4096] ^= 0x5A
        with open(shard, "wb") as fh:
            fh.write(raw)
        st.mark("flip")
        r, data = cl.request("GET", "/heal-a/big-0")
        if data != bigs["big-0"] or r.getheader("ETag") != _md5_etag(data):
            raise AssertionError("GET over a flipped byte: bytes or ETag differ")
        st.mark("mrf_get")
        if not es.mrf.wait_idle(300) or open(shard, "rb").read() != original:
            raise AssertionError("the deep heal queued by the GET did not rewrite "
                                 "the shard file")
        st.mark("mrf_deep_heal")
        print("  MRF on GET: byte-equal GET over a flipped byte; the deep heal it "
              "queued rewrote the shard file equal to its copy: ok")

        # heal_bucket and a dangling object.
        cl.request("PUT", "/heal-c/keep", b"k" * 1000)
        dangling = rng.bytes(1 << 20)
        cl.request("PUT", "/heal-c/dangling", dangling)
        for i in (0, 1, 2, 3, 4):
            shutil.rmtree(os.path.join(paths[i], "heal-c", "dangling"))
        for i in (6, 7):
            shutil.rmtree(os.path.join(paths[i], "heal-c"))
        st.mark("damage_c")
        res = srv.obj.heal_bucket("heal-c")
        if ([s_.state for s_ in res.before].count("missing") != 2
                or any(s_.state != "ok" for s_ in res.after)
                or not all(os.path.isdir(os.path.join(p, "heal-c")) for p in paths)):
            raise AssertionError(f"heal_bucket: {[s_.state for s_ in res.after]}")
        res = srv.obj.heal_object("heal-c", "dangling")
        if not res.purged:
            raise AssertionError("the dangling object was not purged")
        r, doc = cl.request("GET", "/heal-c/dangling", check=False)
        if r.status != 404 or b"<Code>NoSuchKey</Code>" not in doc:
            raise AssertionError(f"GET of the purged object: {r.status}")
        st.mark("heal_bucket")
        print("  heal_bucket recreated heal-c on 2 drives; an object without its "
              "journal on 5 drives purged as dangling, GET 404 NoSuchKey: ok")

        # Live replacement of drive 5.
        if not es.mrf.wait_idle(300):
            raise AssertionError("the MRF queue did not drain before the replacement")
        drive = es.drives[5]
        copy = os.path.join(work, "copy-d05")
        shutil.copytree(drive.root, copy)
        healer = srv.auto_healer[0]
        st.mark("copy")
        t0 = time.perf_counter()
        _wipe_keep_root(drive.root)
        tracker = os.path.join(drive.root, ".mtpu.sys", "healing.json")
        fmt = os.path.join(drive.root, ".mtpu.sys", "format.json")
        deadline = t0 + 600
        while not (os.path.exists(fmt) and not os.path.exists(tracker)
                   and healer.last_walk is not None):
            if time.perf_counter() > deadline:
                raise AssertionError("the wiped drive was not rebuilt in 600 s")
            time.sleep(0.02)
        replace_s = time.perf_counter() - t0
        st.mark("replace")
        walk = healer.last_walk
        if open(fmt, "rb").read() != open(
                os.path.join(copy, ".mtpu.sys", "format.json"), "rb").read():
            raise AssertionError("the rebuilt drive's format.json differs from its copy")
        old, new = LocalDrive(copy), LocalDrive(drive.root)
        rebuilt = n_latest = inline_idx = 0
        for bucket in ("heal-a", "heal-b", "heal-c"):
            for key in sorted(os.listdir(os.path.join(copy, bucket))):
                want = old.read_version(bucket, key)
                got = new.read_version(bucket, key)
                # What the journal holds beside the entry: the walk heals
                # latest versions only, so a versioned key's journal on the
                # new drive holds one version where the copy's holds all.
                got.num_versions = want.num_versions
                got.successor_mod_time = want.successor_mod_time
                if want.inline_data and got.erasure.index != want.erasure.index:
                    got.erasure.index = want.erasure.index
                    inline_idx += 1
                if got != want:
                    raise AssertionError(f"{bucket}/{key}: the latest version's journal "
                                         "entry differs from the copy's")
                for part in want.parts if want.data_dir else ():
                    rel = os.path.join(bucket, key, want.data_dir, f"part.{part.number}")
                    body = open(os.path.join(drive.root, rel), "rb").read()
                    if body != open(os.path.join(copy, rel), "rb").read():
                        raise AssertionError(f"{rel}: rebuilt shard differs from the copy")
                    rebuilt += len(body)
                n_latest += 1
        st.mark("compare")
        print(f"  live replacement: format.json, the journal entries of {n_latest} "
              f"latest versions ({inline_idx} inline ones with the heal's shard "
              f"index) and {rebuilt} B of shard files equal to the copy's: ok")

        # Every latest object, with 4 other drives removed.
        removed = {i: es.drives[i] for i in (0, 1, 2, 3)}
        for i, d in removed.items():
            es.drives[i] = _Down(d)
        try:
            def get_ok(c, item):
                path, want, etag = item
                r, data = c.request("GET", path)
                if data != want or r.getheader("ETag") != (etag or _md5_etag(want)):
                    raise AssertionError(f"GET {path} with 4 drives removed: differs")

            items = ([(f"/heal-a/{k}", v, None) for k, v in bigs.items()]
                     + [("/heal-a/mp", mp_body, mp_etag)])
            for item in items:
                get_ok(cl, item)
            pool.run(get_ok, [(f"/heal-a/{k}", v, None) for k, v in smalls.items()]
                     + [(f"/heal-a/{k}", v, None) for k, v in mrf_objs.items()]
                     + [(f"/heal-b/{k}", v, None) for k, v in latest_b.items()]
                     + [("/heal-c/keep", b"k" * 1000, None)])
            for key in marked:
                r, _ = cl.request("GET", f"/heal-b/{key}", check=False)
                if r.status != 404:
                    raise AssertionError(f"GET heal-b/{key} behind its marker: {r.status}")
        finally:
            for i, d in removed.items():
                es.drives[i] = d
        st.mark("get_degraded")
        n_get = len(bigs) + 1 + len(smalls) + len(mrf_objs) + len(latest_b) + 1
        gib_s = rebuilt / (1 << 30) / replace_s
        _s, d = st.delta("replace")
        print(f"  live replacement on {card}: {replace_s:.6f} s from the wipe until "
              f"the tracker was gone; {rebuilt} B of shards rebuilt, "
              f"{gib_s:.6f} GiB/s; tracker healed {walk.healed}, failed "
              f"{walk.failed}, {walk.healed / replace_s:.6f} objects/s; launches "
              + ", ".join(f"{k} {d[k]}" for k in kernels.KERNELS))
        print(f"  {n_get} latest objects GET byte-equal with their ETags and "
              f"{len(marked)} markers 404, 4 other drives removed: ok")
        if walk.failed:
            raise AssertionError(f"the walk failed {walk.failed} objects")
    finally:
        pool.close()
        cl.close()
        backlog = es.mrf.backlog()
        srv.close()
        shutil.rmtree(work, ignore_errors=True)
    print(f"  server closed with {backlog} MRF entries left (heals queued by the "
          "GETs with 4 drives removed, backing off; dropped at close)")
    gib = cut * big_size / (1 << 30)
    report = [("put_big", gib, "GiB", f"{cut} PUTs of {big_size} B"),
              ("put_small", n_small, "objects", "warp-mix PUTs"),
              ("put_multipart", mp_parts * MP_PART_SIZE / (1 << 30), "GiB",
               "multipart, Create to Complete"),
              ("put_versioned", len(versions) + len(marked), "requests",
               "versioned PUTs and delete markers"),
              ("mrf_put", mrf_puts, "objects", "PUTs with 2 drives refusing"),
              ("mrf_drain", mrf_puts, "objects", "MRF drain after the drives came back"),
              ("mrf_get", big_size / (1 << 30), "GiB", "GET over a flipped byte"),
              ("mrf_deep_heal", 1, "objects", "the deep heal the GET queued"),
              ("heal_bucket", 2, "calls", "heal_bucket and the dangling purge"),
              ("replace", n_latest, "objects", "live replacement of drive 5"),
              ("get_degraded", n_get, "objects", "GETs with 4 other drives removed")]
    for name, amount, unit, what in report:
        secs, d = st.delta(name)
        print(f"  heal {name} on {card}: {secs:.6f} s, {amount / secs:.6f} {unit}/s "
              f"({amount:g} {unit}, {what}); launches "
              + ", ".join(f"{k} {d[k]}" for k in kernels.KERNELS))
    for name in ("put_big", "put_small", "mrf_put", "mrf_deep_heal", "replace",
                 "get_degraded"):
        st.need(name)
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in kernels.KERNELS}
    print("  launches heal phase: " + ", ".join(f"{k} {total[k]}" for k in kernels.KERNELS))
    if records is not None:
        _fill_launches(records, "heal", total)


def _cpu_model() -> str:
    """The host CPU as lscpu (else /proc/cpuinfo) names it: its model name,
    or, where a virtual machine reports none, vendor, family, model and
    stepping."""
    try:
        text = subprocess.run(["lscpu"], capture_output=True, text=True,
                              timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        text = ""
    try:
        text += open("/proc/cpuinfo").read()
    except OSError:
        pass
    fields: dict[str, str] = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip().lower(), value.strip())
    name = fields.get("model name", "")
    if name and name.lower() not in ("unknown", "-"):
        return name
    return (f"{fields.get('vendor id') or fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')} "
            f"stepping {fields.get('stepping', '?')} (no model name)")


def _host_hash_rates(seed: int, threads: int = 12, reps: int = 64) -> dict:
    """MB/s of each host algorithm over 128 KiB chunks (a PUT's chunk at
    EC 8+4, 1 MiB blocks): one thread, and `threads` threads at once, as
    the writer threads of a 12-drive PUT hash (ctypes and hashlib release
    the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from minio_tpu_torch.ops import bitrot

    chunk = np.random.default_rng(seed).bytes(S)
    rates = {}
    with ThreadPoolExecutor(max_workers=threads) as ex:
        for name in ("sip256", "highwayhash256", "xxh64", "sha256", "blake2b256"):
            algo = bitrot.get_algorithm(name)
            algo.digest(chunk)
            t0 = time.perf_counter()
            for _ in range(reps):
                algo.digest(chunk)
            one = reps * S / (time.perf_counter() - t0) / 1e6
            t0 = time.perf_counter()
            list(ex.map(lambda _i: [algo.digest(chunk) for _ in range(reps)],
                        range(threads)))
            many = threads * reps * S / (time.perf_counter() - t0) / 1e6
            rates[name] = (one, many)
    return rates


def _plain_digest(algo: str, chunk: bytes, device: str) -> bytes:
    """A chunk's digest by the algorithm's plain version (the port's
    pure-Python host hashes, hashlib, or the plain PyTorch device digests
    on `device`)."""
    import numpy as np
    import torch

    from minio_tpu_torch.native import plain
    from minio_tpu_torch.ops import bitrot, mxhash, mxsum

    if algo in bitrot.DEVICE_ALGORITHMS:
        x = torch.from_numpy(np.frombuffer(chunk, dtype=np.uint8).copy())[None].to(device)
        lens = torch.tensor([len(chunk)], dtype=torch.int32, device=device)
        fn = mxhash.mxhash256_plain if algo == "mxhash256" else mxsum.digest_plain
        return fn(x, lens)[0].cpu().numpy().tobytes()
    return {"sip256": lambda c: plain.sip256_py(bitrot.BITROT_KEY, c),
            "highwayhash256": lambda c: plain.highwayhash256_py(bitrot.HH_BITROT_KEY, c),
            "xxh64": lambda c: plain.xxh64_py(c, bitrot.XXH64_SEED).to_bytes(8, "big"),
            "sha256": lambda c: hashlib.sha256(c).digest(),
            "blake2b256": lambda c: hashlib.blake2b(c, digest_size=32,
                                                    key=bitrot.BITROT_KEY).digest(),
            }[algo](chunk)


def bitrot_phase(seed: int, card: str, records: list[dict] | None,
                 device: str = "cuda", algos=BITROT_ALGOS) -> None:
    """Every bitrot algorithm of the JAX registry on config 1's set (12
    drives on /dev/shm, EC 8+4, 1 MiB blocks), each behind the port's S3
    server over ErasureSets(..., bitrot_algorithm=) in a bucket of its own:
    one object of the algorithm's size PUT, GET (bytes and ETag), GET with
    4 of 12 drives' shard files removed, deep-healed (the 4 rebuilt files
    equal their copies, verify_shard_file over each), and two sampled chunk
    digests of a data and a parity shard held against the algorithm's plain
    version. Under mxhash256 every digest comes from K3, one launch per
    batch: the PUT launches K3 as often as K1. Also the host hashes' MB/s.
    Launch counts go into `records` unless it is None."""
    import numpy as np

    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.ops import bitrot, kernels
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.local import LocalDrive

    rng = np.random.default_rng(seed + 10)
    rates = _host_hash_rates(seed)
    cpu = _cpu_model()
    for name, (one, many) in rates.items():
        print(f"  host {name} over {S} B chunks on {cpu} ({os.cpu_count()} "
              f"cores; card {card}): {one:.3f} MB/s one thread, {many:.3f} MB/s "
              "12 threads at once")
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-bitrot-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    st = _Stages()
    lost = (0, 1, 2, 3)
    try:
        kernels.reset_launches()
        st.mark("start")
        for algo, size in algos:
            data = rng.bytes(size)
            sets = ErasureSets([LocalDrive(p) for p in paths], set_drive_count=12,
                               parity=4, device=device, bitrot_algorithm=algo)
            srv = S3Server(ErasureServerPools([sets]),
                           sigv4.Credentials(ACCESS, SECRET)).start()
            es = sets.sets[0]
            cl = _Client(srv.url)
            bucket = f"bitrot-{algo}"
            try:
                cl.request("PUT", f"/{bucket}")
                st.mark(f"{algo}:bucket")
                r, _ = cl.request("PUT", f"/{bucket}/obj", data)
                if r.getheader("ETag") != _md5_etag(data):
                    raise AssertionError(f"{algo}: PUT ETag")
                st.mark(f"{algo}:put")

                def get_ok(what):
                    r, got = cl.request("GET", f"/{bucket}/obj")
                    if got != data or r.getheader("ETag") != _md5_etag(data):
                        raise AssertionError(f"{algo}: {what} GET: bytes or ETag differ")

                get_ok("intact")
                st.mark(f"{algo}:get")
                fi = es.latest_fileinfo(bucket, "obj")
                if [c.algorithm for c in fi.erasure.checksums] != [algo]:
                    raise AssertionError(f"{algo}: journal names "
                                         f"{fi.erasure.checksums}")
                pos = fi.erasure.distribution
                files = {i: glob.glob(os.path.join(paths[i], bucket, "obj", "*",
                                                   "part.1"))[0] for i in range(12)}
                originals = {i: open(f, "rb").read() for i, f in files.items()}
                for i in lost:
                    shutil.rmtree(os.path.dirname(files[i]))
                get_ok("degraded (4 drives lost)")
                st.mark(f"{algo}:degraded_get")
                res = es.heal_object(bucket, "obj", scan_deep=True)
                if res.healed_count != len(lost) or any(
                        open(files[i], "rb").read() != originals[i] for i in lost):
                    raise AssertionError(f"{algo}: heal {res.healed_count}, or files "
                                         "differ from their copies")
                st.mark(f"{algo}:heal")
                shard_data = fi.erasure.shard_file_size(size)
                for i in lost:
                    with open(files[i], "rb") as f:
                        bitrot.verify_shard_file(f, shard_data, fi.erasure.shard_size(),
                                                 algo, es.device)
                st.mark(f"{algo}:verify")
                dl = bitrot.digest_len(algo)
                n_chunks = -(-shard_data // fi.erasure.shard_size())
                for shard in (1, 12):   # a data shard and a parity shard
                    raw = originals[pos.index(shard)]
                    for ci in (0, n_chunks - 1):
                        with open(files[pos.index(shard)], "rb") as f:
                            want, chunk = bitrot.BitrotReader(
                                f, shard_data, fi.erasure.shard_size(),
                                algo).read_record(ci)
                        if want != _plain_digest(algo, chunk, device) or \
                                raw[ci * (dl + fi.erasure.shard_size()):][:dl] != want:
                            raise AssertionError(f"{algo}: shard {shard} chunk {ci}: "
                                                 "digest differs from the plain version")
            finally:
                cl.close()
                srv.close()
            line = []
            for stage in ("put", "get", "degraded_get", "heal"):
                sec, d = st.delta(f"{algo}:{stage}")
                line.append(f"{stage} {sec:.6f} s ({size / (1 << 30) / sec:.6f} GiB/s; "
                            f"K1/K2/K3 {d['gf2_matmul']}/{d['mxsum_digest']}/"
                            f"{d['mxhash256']})")
            print(f"  {algo}, {size} B on {card}: " + "; ".join(line)
                  + "; verify of the 4 healed files, sampled digests: ok")
            _s, put = st.delta(f"{algo}:put")
            if algo == "mxhash256" and not put["mxhash256"] == put["gf2_matmul"] > 0:
                raise AssertionError(f"mxhash256 PUT: K3 {put['mxhash256']} launches, "
                                     f"K1 {put['gf2_matmul']}")
            if algo not in bitrot.DEVICE_ALGORITHMS and (
                    put["mxhash256"] or put["mxsum_digest"] or not put["gf2_matmul"]):
                raise AssertionError(f"{algo} PUT: launches {put}")
        st.mark("end")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in st.at[0][1]}
    print(f"  launches in the phase: {total}")
    if records is not None:
        _fill_launches(records, "bitrot", total)


def _list_objects_for(free_bytes: int, elapsed_s: float) -> tuple[int, str]:
    """LIST_OBJECTS, halved (down to 1/16 of it) until its journals fit in
    `free_bytes` and the phase's estimated time fits what is left of
    SMOKE_BUDGET_S after `elapsed_s`, but for time not below
    LIST_MIN_OBJECTS unless the estimate passes SMOKE_LIMIT_S;
    -> (count, the reason for a cut)."""
    n, why = LIST_OBJECTS, ""
    while n > LIST_OBJECTS // 16:
        end_s = elapsed_s + LIST_FIXED_S + n * LIST_S_PER_OBJECT
        if n * LIST_BYTES_PER_OBJECT > free_bytes:
            why = f"{free_bytes} B free on the drives' filesystem"
        elif end_s > SMOKE_LIMIT_S or (end_s > SMOKE_BUDGET_S and n > LIST_MIN_OBJECTS):
            limit = SMOKE_BUDGET_S if n > LIST_MIN_OBJECTS else SMOKE_LIMIT_S
            why = (f"{elapsed_s:.0f} s spent, {LIST_S_PER_OBJECT * 1e3:.1f} ms per "
                   f"object, the script kept under {limit:.0f} s")
        else:
            break
        n //= 2
    return n, why


def _rss_bytes() -> int:
    """This process's resident set now (/proc/self/statm), in bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _list_page(doc: bytes):
    """A ListObjects answer -> ([(key, etag, size)], [prefixes],
    truncated, next marker or continuation token)."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(doc)
    keys = [(c.find(S3_NS + "Key").text, c.find(S3_NS + "ETag").text.strip('"'),
             int(c.find(S3_NS + "Size").text)) for c in root.iter(S3_NS + "Contents")]
    prefixes = [c.find(S3_NS + "Prefix").text for c in root.iter(S3_NS + "CommonPrefixes")]
    nxt = root.find(S3_NS + "NextContinuationToken")
    if nxt is None:
        nxt = root.find(S3_NS + "NextMarker")
    return (keys, prefixes, root.find(S3_NS + "IsTruncated").text == "true",
            "" if nxt is None else nxt.text)


def _delete_doc(keys) -> bytes:
    return ("<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>" for k in keys)
            + "</Delete>").encode()


def listing_phase(seed: int, card: str, mp: _Kept | None, elapsed_s: float,
                  n_objects: int | None = None, device: str = "cuda",
                  clients: int = 64) -> None:
    """Listing and the bucket calls (phase 9) on config 1's deployment: one
    12-drive set at EC 8+4, 1 MiB blocks, mxsum256, behind the port's S3
    server over HTTP with SigV4, its drives on /dev/shm. A bucket of
    LIST_OBJECTS synthetic objects (the JAX package's listing-scale
    layout, 200 prefixes of 1000; halved by _list_objects_for to fit) and
    LIST_REAL real ones PUT through the server; the whole bucket walked
    with ListObjectsV2 pages of LIST_PAGE: every name once, in order, the
    real objects' ETag and Size as PUT; a delimiter listing in pages, a v1
    listing resumed from a marker in the middle, ListBuckets; every 50th
    real object read back; the real objects deleted in one DeleteObjects,
    their prefix then empty; DeleteBucket on the big bucket answers
    BucketNotEmpty; a small bucket emptied and deleted, then absent from
    ListBuckets; and on phase 6's pools (`mp`), one ListObjectsV2 naming
    the 5 GiB object once across the 4 pools. The server runs with
    enable_mrf=False, as every phase's but the heal phase's does."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server
    from minio_tpu_torch.utils.synthbucket import (make_synthetic_bucket,
                                                   synthetic_key)

    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-list-", dir=shm)
    free = shutil.disk_usage(work).free
    if n_objects is None:
        n_syn, why = _list_objects_for(free, elapsed_s)
    else:
        n_syn, why = n_objects, "asked for"
    print(f"  drives on {shm or tempfile.gettempdir()} ({free} B free); {n_syn} "
          f"synthetic objects + {LIST_REAL} real" +
          (f" (cut from {LIST_OBJECTS}: {why})" if n_syn != LIST_OBJECTS else ""))
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    layer = srv.obj
    pool = _Pool(srv.url, clients)
    cl = _Client(srv.url)
    rng = np.random.default_rng(seed + 7)
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                               LIST_REAL)).astype(np.int64)
    real = {f"real/{i:04d}": rng.bytes(int(n)) for i, n in enumerate(sizes)}
    stats = {}
    try:
        es = layer.pools[0].sets[0]
        print(f"  server {srv.url}: EC {es.n - es.parity}+{es.parity}, block "
              f"{es.block_size} B, bitrot {es.bitrot_algorithm}")
        kernels.reset_launches()
        cl.request("PUT", "/big")
        t0 = time.perf_counter()
        make_synthetic_bucket(es.drives, "big", n_syn)
        stats["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool.run(lambda c, kv: c.request("PUT", f"/big/{kv[0]}", kv[1]), real.items())
        stats["put_s"] = time.perf_counter() - t0
        after_put = kernels.launches()

        # The whole bucket through ListObjectsV2, checked page by page
        # against the expected names (the client holds one page).
        expected = iter([synthetic_key(i) for i in range(n_syn)] + sorted(real))
        mc = layer.metacache
        hits0, misses0 = mc.hits, mc.misses
        rss0 = rss_peak = _rss_bytes()
        page_ms, token, listed, seen_real = [], "", 0, {}
        t_walk = time.perf_counter()
        while True:
            q = {"list-type": "2", "max-keys": str(LIST_PAGE)}
            if token:
                q["continuation-token"] = token
            t0 = time.perf_counter()
            _r, doc = cl.request("GET", "/big", query=q)
            page_ms.append((time.perf_counter() - t0) * 1e3)
            rss_peak = max(rss_peak, _rss_bytes())
            keys, _p, truncated, token = _list_page(doc)
            for key, etag, size in keys:
                want = next(expected, None)
                if key != want:
                    raise AssertionError(f"listing: {key!r} where {want!r} belongs")
                if key in real:
                    seen_real[key] = (etag, size)
            listed += len(keys)
            if not truncated:
                break
            if len(keys) != LIST_PAGE:
                raise AssertionError(f"a truncated page of {len(keys)} keys")
        stats["walk_s"] = time.perf_counter() - t_walk
        stats["rss_mb"] = (rss_peak - rss0) / (1 << 20)
        stats["hits"], stats["misses"] = mc.hits - hits0, mc.misses - misses0
        if next(expected, None) is not None or listed != n_syn + LIST_REAL:
            raise AssertionError(f"listing: {listed} names, {n_syn + LIST_REAL} expected")
        bad = [k for k, v in real.items()
               if seen_real[k] != (hashlib.md5(v).hexdigest(), len(v))]
        if bad:
            raise AssertionError(f"listing: ETag or Size of {bad[:3]} differ from the PUT")
        print(f"  ListObjectsV2: {listed} names in {len(page_ms)} pages, once each, "
              "in order; the real objects' ETag and Size as PUT")

        # CommonPrefixes in pages of 50, then v1 from a marker mid-bucket.
        prefixes, marker = [], ""
        while True:
            q = {"list-type": "2", "delimiter": "/", "max-keys": "50"}
            if marker:
                q["continuation-token"] = marker
            keys, pfx, truncated, marker = _list_page(cl.request("GET", "/big", query=q)[1])
            if keys:
                raise AssertionError(f"delimiter listing: keys {keys[:3]} at the top level")
            prefixes += pfx
            if not truncated:
                break
        want = [f"p{p:03d}/" for p in range(-(-n_syn // 1000))] + ["real/"]
        if prefixes != want:
            raise AssertionError(f"delimiter listing: {len(prefixes)} prefixes, "
                                 f"{len(want)} expected")
        mid = n_syn // 2
        keys, _p, truncated, nxt = _list_page(cl.request(
            "GET", "/big", query={"marker": synthetic_key(mid), "max-keys": "1000"})[1])
        want = [synthetic_key(i) for i in range(mid + 1, mid + 1001)]
        if [k for k, _e, _s in keys] != want or not truncated or nxt != want[-1]:
            raise AssertionError("v1 listing from a marker")
        doc = cl.request("GET", "/")[1]
        if b"<Name>big</Name>" not in doc:
            raise AssertionError("ListBuckets: big missing")
        print(f"  delimiter listing: {len(prefixes)} CommonPrefixes in pages of 50; "
              f"v1 from marker {synthetic_key(mid)}: the next 1000; ListBuckets: ok")

        # Read back every 50th real object named in the listing.
        def get_ok(c, key):
            r, data = c.request("GET", f"/big/{key}")
            if data != real[key] or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"GET {key}: bytes or ETag differ")

        before_get = kernels.launches()
        pool.run(get_ok, sorted(seen_real)[::50])
        after_get = kernels.launches()

        # The real objects in one DeleteObjects (S3's 1000-key cap).
        t0 = time.perf_counter()
        doc = cl.request("POST", "/big", _delete_doc(sorted(real)),
                         query={"delete": ""})[1]
        stats["delete_s"] = time.perf_counter() - t0
        if doc.count(b"<Deleted>") != LIST_REAL or b"<Error>" in doc:
            raise AssertionError(f"DeleteObjects: {doc[:300]!r}")
        keys, pfx, truncated, _n = _list_page(cl.request(
            "GET", "/big", query={"list-type": "2", "prefix": "real/"})[1])
        if keys or pfx or truncated:
            raise AssertionError(f"real/ not empty after DeleteObjects: {keys[:3]}")
        r, doc = cl.request("DELETE", "/big", check=False)
        if r.status != 409 or b"<Code>BucketNotEmpty</Code>" not in doc:
            raise AssertionError(f"DeleteBucket on a full bucket: {r.status} {doc[:200]!r}")
        cl.request("PUT", "/small")
        for i in range(3):
            cl.request("PUT", f"/small/k{i}", real[f"real/{i:04d}"])
        cl.request("POST", "/small", _delete_doc([f"k{i}" for i in range(3)]),
                   query={"delete": ""})
        r, _doc = cl.request("DELETE", "/small")
        doc = cl.request("GET", "/")[1]
        if r.status != 204 or b"<Name>small</Name>" in doc or b"<Name>big</Name>" not in doc:
            raise AssertionError("the emptied bucket is not deleted, or ListBuckets lists it")
        print(f"  DeleteObjects of {LIST_REAL} keys in one POST; real/ then empty; "
              "DeleteBucket: BucketNotEmpty on big, 204 on the emptied one, which "
              "ListBuckets then omits")
        end = kernels.launches()
    finally:
        pool.close()
        cl.close()
        srv.close()
        t0 = time.perf_counter()
        rms = [subprocess.Popen(["rm", "-rf", p]) for p in paths]
        for p in rms:
            p.wait()
        shutil.rmtree(work, ignore_errors=True)
        stats["cleanup_s"] = time.perf_counter() - t0

    for stage, at in (("PUT", after_put), ("GET", after_get)):
        for name in MXSUM_KERNELS:
            if at[name] <= 0:
                raise AssertionError(f"{name} did not launch by the listing phase's {stage}s")
    if after_get["mxsum_digest"] <= before_get["mxsum_digest"]:
        raise AssertionError("K2 did not launch for the GETs' verify")

    if mp is not None:
        c = _Client(mp.url)
        try:
            keys, pfx, truncated, _n = _list_page(c.request(
                "GET", f"/{mp.bucket}", query={"list-type": "2"})[1])
        finally:
            c.close()
        if keys != [(mp.key, keys[0][1] if keys else "", mp.size)] or pfx or truncated:
            raise AssertionError(f"4-pool listing: {keys}")
        print(f"  4 pools x 16 drives: ListObjectsV2 names {mp.key} once "
              f"({mp.size} B, ETag {keys[0][1]})")

    cont = sorted(page_ms[1:]) or [0.0]
    p99 = cont[min(len(cont) - 1, int(round(0.99 * (len(cont) - 1))))]
    print(f"  launches listing phase: " + ", ".join(
        f"{n} {end[n]}" for n in kernels.KERNELS))
    print(f"  listing {n_syn} + {LIST_REAL} objects on {card}: build "
          f"{stats['build_s']:.6f} s, {LIST_REAL} PUTs {stats['put_s']:.6f} s; page 1 "
          f"(walk + synchronous render) {page_ms[0]:.3f} ms, continuation pages "
          f"median {statistics.median(cont):.3f} ms, p99 {p99:.3f} ms; "
          f"{listed / stats['walk_s']:.1f} objects/s listed over the full walk "
          f"({stats['walk_s']:.6f} s, {len(page_ms)} pages); metacache hits "
          f"{stats['hits']}, misses {stats['misses']}; RSS peak over the walk "
          f"+{stats['rss_mb']:.1f} MiB (sampled after each page); DeleteObjects {LIST_REAL / stats['delete_s']:.1f} keys/s "
          f"({stats['delete_s']:.6f} s); removal of the drives {stats['cleanup_s']:.3f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from minio_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: minio_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.3f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    print("kernel phase (EC 8+4, 1 MiB blocks):")
    records = kernel_phase(args.seed)
    print("S3 phase:")
    s3_phase(args.seed, card, records)
    print("plane phase (EC 8+4, 1 MiB blocks; the plane on, off, off, on):")
    rates = {True: [], False: []}
    for i, on in enumerate(PLANE_RUNS):
        rates[on].append(plane_phase(args.seed, card, records if i == 0 else None,
                                     PLANE_OBJECTS, plane_on=on))
    for stage in ("put", "get", "degraded_get"):
        on, off = ([r[stage] for r in rates[v]] for v in (True, False))
        print(f"  {stage} objects/s on {card}: plane on "
              f"{', '.join(f'{x:.3f}' for x in on)}; plane off "
              f"{', '.join(f'{x:.3f}' for x in off)}; on/off "
              f"{sum(on) / sum(off):.3f}")
    print("hot-tier phase (MTPU_HOTTIER=1):")
    hot_tier_phase(args.seed, card, records, HOT_WORKING_SET)
    print("multipart phase (4 pools x 16 drives, EC 12+4, 1 MiB blocks):")
    mp = multipart_phase(args.seed, card, records, keep=True)
    try:
        print("versioning phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; "
              "UploadPartCopy on the 4 pools, EC 12+4):")
        versioning_phase(args.seed, card, mp)
        print("heal phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; MRF and the "
              "auto-healer on):")
        heal_phase(args.seed, card, records)
        print("bitrot phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; every "
              "algorithm of the JAX registry):")
        bitrot_phase(args.seed, card, records)
        print("listing phase (EC 8+4, 1 MiB blocks; drives on /dev/shm):")
        listing_phase(args.seed, card, mp, time.perf_counter() - t_start)
    finally:
        mp.close()
    for r in records:
        del r["kernel"], r["path"]
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
