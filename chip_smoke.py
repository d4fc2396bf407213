#!/usr/bin/env python3
"""Chip smoke test of minio_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It needs CUDA, nvcc and no network, and
exits non-zero (printing no result) without a CUDA device or without the
package beside it. Phases, each raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the build of the hand-written kernels from minio_tpu_torch/csrc/;
2. kernels at EC 8+4 with 1 MiB blocks (B=16, k=8, S=131072): K1
   gf2_matmul for encode, a 4-missing reconstruct, per-block weights with
   3 failure patterns and a ragged S=87382; K2 mxsum_digest over the
   [B*12, S] shards with lengths 0, 1, 513 and S among the rows (PUT),
   and over their first B*8 (GET verify) and B*4 rows (heal). Each is
   held byte-equal to its plain PyTorch version on the same inputs
   (tolerance: exact, all integer work) and timed at every one of those
   shapes with CUDA events (median of 20 runs after warm-up, L2 flushed
   and the launches queued behind a short device spin before each run,
   so host launch overhead stays out of the device time), beside its
   bound and the share of it reached; K1 also beside its plain version,
   K2 beside torch._int_mm, the library call that computes its main
   contraction;
3. S3: the port's server on 12 tmp drives (device="cuda"), driven over
   http.client with the port's SigV4 signer: PUT 256 MiB, 9 MiB + 12,345 B
   and 1 KiB objects; GET back byte-equal with ETag == md5; a ranged GET;
   4 drives' shard files copied then deleted and a degraded GET; a deep
   heal that must rebuild files byte-equal to the copies; one byte of a
   fifth drive's shard flipped, a GET that reads around it and a deep heal
   that rewrites it; then a GET with 4 OTHER drives removed. The launch
   count of each kernel is reset just before this phase and read after it.

It prints a JSON line with every kernel's numbers, then, as the last line,
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
K, M, B, S = 8, 4, 16, 131072   # EC 8+4, 1 MiB blocks: S = 1 MiB / 8
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor rate


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


def kernel_phase(seed: int) -> dict:
    """K1 and K2 on the card against their plain versions; returns the
    kernel records of the result line (launches filled in later)."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, mxsum, rs

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    errs = {"gf2_matmul": 0, "mxsum_digest": 0}

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

    out = {}
    # Every main-path shape, timed; the first of each kernel is the one of
    # the result line.
    k1_shapes = [
        ("encode [16,8,S]->4", (x, w_enc, M), _gf2_bound_ms(B, K, M, S)),
        ("reconstruct 4 missing", (xs, w_dec, 4), _gf2_bound_ms(B, K, 4, S)),
        ("per-block weights, 3 patterns", (xm, w_multi_d, 4),
         _gf2_bound_ms(B, K, 4, S, per_block_weights=True)),
        ("ragged S=87382", (xr, w_enc, M), _gf2_bound_ms(B, K, M, xr.shape[2])),
    ]
    k1 = []
    for label, args, (bnd, by) in k1_shapes:
        ms = _median_ms(lambda: rs.gf2_matmul(*args), flush)
        plain = _median_ms(lambda: rs.gf2_matmul_plain(*args), flush)
        print(f"  K1 {label}: {ms:.6f} ms, bound {bnd:.6f} ms ({by}), "
              f"{100 * bnd / ms:.1f}% of the bound; plain {plain:.6f} ms")
        k1.append((label, ms, (bnd, by)))
        if len(k1) == 1:
            k1_plain = plain
    out["gf2_matmul"] = {
        "name": "gf2_matmul", "route": "cuda",
        "source": "minio_tpu_torch/csrc/gf2_matmul.cu",
        "replaces": "minio_tpu/ops/rs_pallas.py:48", "launches": 0,
        "max_abs_err": errs["gf2_matmul"], "ms": k1[0][1], "plain_ms": k1_plain,
        "bound_ms": k1[0][2][0], "bound_by": k1[0][2][1], "library_ms": None}

    # K2 at the PUT (all k+m shards), GET verify (k data shards) and heal
    # (4 rebuilt shards) row counts of a 16-block batch. Library yardstick:
    # torch._int_mm (int8 x int8 -> int32, cuBLASLt) computes the main
    # contraction [N, S] @ [S, 8] in one call, without the length term and
    # the byte packing. Timed here only; the port never calls it. Whether
    # its int32 sums wrap as K2's uint32 ones do is checked on this run's
    # data, not assumed.
    key = mxsum.device_key(S, dev).t().contiguous()                # [S, 8]
    lterm = (mxsum._len_bytes(lens).to(torch.float64)
             @ mxsum.device_len_key(dev).to(torch.float64)).to(torch.int64)
    lib_out = torch._int_mm(chunks.view(torch.int8), key)
    print("  torch._int_mm with the length term and packing equals K2's "
          f"digests: {torch.equal(mxsum._pack_words(lib_out.to(torch.int64) + lterm), digs)}")
    k2 = []
    for label, rows in (("PUT", n_rows), ("GET verify", B * K), ("heal", B * 4)):
        c, ln = chunks[:rows], lens[:rows]
        if rows != n_rows:
            check("mxsum_digest", f"K2 digest [{rows}, S]", mxsum.digest(c, ln),
                  mxsum.digest_plain(c, ln))
        ms = _median_ms(lambda: mxsum.digest(c, ln), flush)
        ci8 = c.view(torch.int8)
        lib = _median_ms(lambda: torch._int_mm(ci8, key), flush)
        bnd, by = _mxsum_bound_ms(rows, S)
        print(f"  K2 {label} [{rows}, {S}]: {ms:.6f} ms, bound {bnd:.6f} ms "
              f"({by}), {100 * bnd / ms:.1f}% of the bound; torch._int_mm "
              f"{lib:.6f} ms")
        k2.append((ms, lib, bnd, by))
    k2_plain = _median_ms(lambda: mxsum.digest_plain(chunks, lens), flush)
    out["mxsum_digest"] = {
        "name": "mxsum_digest", "route": "cuda",
        "source": "minio_tpu_torch/csrc/mxsum_digest.cu",
        "replaces": "minio_tpu/ops/mxsum.py:153", "launches": 0,
        "max_abs_err": errs["mxsum_digest"], "ms": k2[0][0], "plain_ms": k2_plain,
        "bound_ms": k2[0][2], "bound_by": k2[0][3], "library_ms": k2[0][1]}
    for r in out.values():
        print(f"  {r['name']}: {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return out


class _Client:
    """S3 over http.client, signed with the port's SigV4 code."""

    def __init__(self, url: str):
        from minio_tpu_torch.s3.sigv4 import Credentials

        self.host = urllib.parse.urlparse(url).netloc
        self.creds = Credentials(ACCESS, SECRET)
        self.conn = http.client.HTTPConnection(self.host, timeout=600)

    def request(self, method: str, path: str, body: bytes = b"",
                headers: dict | None = None):
        from minio_tpu_torch.s3.sigv4 import UNSIGNED_PAYLOAD, sign_request

        signed = sign_request(method, path, {}, headers or {}, self.host,
                              self.creds, UNSIGNED_PAYLOAD)
        self.conn.request(method, urllib.parse.quote(path), body=body,
                          headers=signed)
        r = self.conn.getresponse()
        data = r.read()
        if r.status >= 300:
            raise AssertionError(f"{method} {path}: {r.status} {data[:300]!r}")
        return r, data

    def close(self):
        self.conn.close()


S3_SIZES = {"big": 256 << 20, "mid": (9 << 20) + 12345, "tiny": 1 << 10}


def s3_phase(seed: int, card: str, records: dict, device: str = "cuda") -> None:
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    rng = np.random.default_rng(seed + 1)
    objects = {key: rng.bytes(size) for key, size in S3_SIZES.items()}
    work = tempfile.mkdtemp(prefix="mtpu-torch-smoke-")
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device).start()
    cl = _Client(srv.url)
    stages = {}
    try:
        obj = srv.obj
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
    for name in kernels.KERNELS:
        records[name]["launches"] = delta("start", "end", name)
        if records[name]["launches"] <= 0:
            raise AssertionError(f"{name} never launched on the S3 path")
    gib = len(objects["big"]) / (1 << 30)
    print(f"  S3 {len(objects['big']) >> 20} MiB on {card}: "
          f"PUT {gib / put_s:.6f} GiB/s ({put_s:.6f} s), "
          f"GET {gib / get_s:.6f} GiB/s ({get_s:.6f} s), degraded GET "
          f"{gib / deg_s:.6f} GiB/s ({deg_s:.6f} s), deep heal of 4 shards "
          f"{heal_s:.6f} s")


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
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
