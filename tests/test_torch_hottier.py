"""The port's HBM hot tier (minio_tpu_torch/hottier, plain PyTorch on the
CPU) against the JAX package's (minio_tpu/hottier, on the CPU), case by
case after tests/test_hottier.py. Each package runs its own tier over its
own 4-drive set (parity 1) with the same seeded payloads:

  1. byte equality: full and ranged hits, and 16 concurrent readers, equal
     the payload, the port's drive path and the JAX tier's hits, with the
     same ETags;
  2. coherence: an overwrite serves the new bytes, a DELETE answers 404,
     a heal under a resident object stays byte-equal;
  3. residence: inline objects are never admitted, the budget evicts the
     coldest first, a digest mismatch (a changed baseline or a flipped
     resident byte) falls back to the drive path, an upload that differs
     from the staged bytes is refused at admission, a miss noted without a
     reader admits through the process-wide one, and a bucket-wide
     invalidation drops every resident key of the bucket.

Tolerance: exact bytes."""

import io
import os
import threading

import numpy as np
import pytest
import torch

from minio_tpu import hottier as jax_hottier
from minio_tpu.erasure import ErasureObjects as JaxObjects
from minio_tpu.storage import LocalDrive as JaxDrive
from minio_tpu_torch import hottier
from minio_tpu_torch.erasure.objects import ErasureObjects
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import errors as se

B = "hotbkt"
CPU = torch.device("cpu")


def _payload(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _sets(root):
    jes = JaxObjects([JaxDrive(str(root / f"j{i}")) for i in range(4)], parity=1)
    tes = ErasureObjects([LocalDrive(str(root / f"t{i}")) for i in range(4)],
                         parity=1, device="cpu")
    jes.make_bucket(B)
    tes.make_bucket(B)
    return jes, tes


@pytest.fixture()
def hot(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_HOTTIER", "1")
    monkeypatch.setenv("MTPU_HOTTIER_ADMIT_COOLDOWN_S", "0")
    hottier.reset_global()
    jax_hottier.reset_global()
    jes, tes = _sets(tmp_path)
    yield jes, tes
    jes.close()
    hottier.reset_global()
    jax_hottier.reset_global()


def _get(es, obj, off=0, ln=-1):
    info, it = es.get_object(B, obj, off, ln)
    return info, b"".join(bytes(c) for c in it)


def _oracle(es, obj, off=0, ln=-1):
    """The same read with the tier gated off: the drive path."""
    os.environ["MTPU_HOTTIER"] = "0"
    try:
        return _get(es, obj, off, ln)
    finally:
        os.environ["MTPU_HOTTIER"] = "1"


def _tier(es):
    return (hottier.get_tier(CPU) if isinstance(es, ErasureObjects)
            else jax_hottier.get_tier())


def _admit(es, obj, tries: int = 4) -> None:
    """Heat the key until the async admission lands."""
    tier = _tier(es)
    for _ in range(tries):
        _get(es, obj)
        assert tier.drain(30)
        if tier.resident(B, obj):
            return
    raise AssertionError(f"never admitted: {tier.stats()}")


def _put_both(hot, obj, body):
    for es in hot:
        es.put_object(B, obj, io.BytesIO(body), len(body))


# ---------------------------------------------------------------------------
# 1. byte equality
# ---------------------------------------------------------------------------

def test_hit_full_and_ranged_equal_jax_tier(hot):
    jes, tes = hot
    body = _payload((1 << 20) + 12345, seed=1)
    _put_both(hot, "o1", body)
    for es in hot:
        _admit(es, "o1")
    tier = _tier(tes)
    h0 = tier.stats()["hits"]
    info, got = _get(tes, "o1")
    jinfo, jgot = _get(jes, "o1")
    oinfo, want = _oracle(tes, "o1")
    assert got == jgot == want == body
    assert info.etag == jinfo.etag == oinfo.etag
    assert tier.stats()["hits"] == h0 + 1, "resident object did not hit"
    rng = np.random.default_rng(7)
    for _ in range(24):
        off = int(rng.integers(len(body)))
        ln = int(rng.integers(1, len(body) - off + 1))
        _info, got = _get(tes, "o1", off, ln)
        _jinfo, jgot = _get(jes, "o1", off, ln)
        assert got == jgot == body[off:off + ln], (off, ln)
    assert tier.stats()["hits"] == h0 + 25


def test_sixteen_concurrent_readers_byte_equal_and_etag(hot):
    jes, tes = hot
    bodies = {f"c{i}": _payload(256 << 10, seed=10 + i) for i in range(3)}
    etags = {}
    for k, v in bodies.items():
        _put_both(hot, k, v)
        etags[k] = _oracle(jes, k)[0].etag
        _admit(tes, k)
    failures: list[str] = []

    def reader(wid: int) -> None:
        rng = np.random.default_rng(wid)
        for _ in range(8):
            k = list(bodies)[int(rng.integers(3))]
            body = bodies[k]
            off = int(rng.integers(len(body))) if wid % 2 else 0
            ln = int(rng.integers(1, len(body) - off + 1)) if wid % 2 else -1
            info, got = _get(tes, k, off, ln)
            if got != (body[off:off + ln] if ln > 0 else body):
                failures.append(f"w{wid} {k}: bytes")
            if info.etag != etags[k]:
                failures.append(f"w{wid} {k}: etag")

    threads = [threading.Thread(target=reader, args=(w,)) for w in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]
    assert _tier(tes).stats()["hits"] >= 16 * 8


# ---------------------------------------------------------------------------
# 2. coherence
# ---------------------------------------------------------------------------

def test_overwrite_serves_new_bytes_and_readmits(hot):
    _jes, tes = hot
    b1 = _payload(300 << 10, seed=2)
    b2 = _payload(300 << 10, seed=3)
    tes.put_object(B, "ow", io.BytesIO(b1), len(b1))
    _admit(tes, "ow")
    tes.put_object(B, "ow", io.BytesIO(b2), len(b2))
    assert _get(tes, "ow")[1] == b2, "stale bytes after overwrite"
    assert _tier(tes).drain(30)
    _admit(tes, "ow")
    h0 = _tier(tes).stats()["hits"]
    assert _get(tes, "ow")[1] == b2
    assert _tier(tes).stats()["hits"] == h0 + 1


def test_delete_then_404(hot):
    _jes, tes = hot
    body = _payload(200 << 10, seed=4)
    tes.put_object(B, "del", io.BytesIO(body), len(body))
    _admit(tes, "del")
    tes.delete_object(B, "del")
    assert not _tier(tes).resident(B, "del")
    with pytest.raises(se.ObjectNotFound):
        tes.get_object(B, "del")


def test_heal_under_resident_object_stays_byte_equal(hot, tmp_path):
    _jes, tes = hot
    body = _payload(400 << 10, seed=5)
    tes.put_object(B, "healme", io.BytesIO(body), len(body))
    _admit(tes, "healme")
    victim = next(p for d in range(4)
                  for p in (tmp_path / f"t{d}" / B / "healme").glob("*/part.1"))
    victim.unlink()
    assert tes.heal_object(B, "healme").healed_count == 1
    assert victim.exists(), "heal did not rewrite the shard"
    assert _get(tes, "healme")[1] == _oracle(tes, "healme")[1] == body
    _admit(tes, "healme")
    assert _get(tes, "healme")[1] == body


# ---------------------------------------------------------------------------
# 3. residence
# ---------------------------------------------------------------------------

def test_inline_objects_never_admitted(hot):
    jes, tes = hot
    body = _payload(4 << 10, seed=8)
    _put_both(hot, "tiny", body)
    for _ in range(4):
        for es in hot:
            assert _get(es, "tiny")[1] == body
    for es in hot:
        assert _tier(es).drain(10)
        assert not _tier(es).resident(B, "tiny")


def test_budget_evicts_coldest_first(tmp_path, monkeypatch):
    """The JAX test's budget (4 MiB) and objects (2 MiB at k=3): one entry
    at a time fits, and the hotter key takes the cold one's place in both
    packages."""
    monkeypatch.setenv("MTPU_HOTTIER", "1")
    monkeypatch.setenv("MTPU_HOTTIER_ADMIT_COOLDOWN_S", "0")
    monkeypatch.setenv("MTPU_HOTTIER_BYTES", str(4 << 20))
    hottier.reset_global()
    jax_hottier.reset_global()
    jes, tes = _sets(tmp_path)
    try:
        cold = _payload(2 << 20, seed=9)
        hot_ = _payload(2 << 20, seed=10)
        _put_both((jes, tes), "cold", cold)
        _put_both((jes, tes), "hot", hot_)
        for es in (jes, tes):
            _admit(es, "cold")
            tier = _tier(es)
            for _ in range(6):
                _get(es, "hot")
                tier.drain(30)
            assert tier.resident(B, "hot"), tier.stats()
            assert not tier.resident(B, "cold")
            st = tier.stats()
            assert st["evictions"] >= 1
            assert st["resident_bytes"] <= 4 << 20
            assert _get(es, "hot")[1] == hot_
            assert _get(es, "cold")[1] == cold
        assert _tier(tes).stats()["resident_bytes"] == \
            _tier(jes).stats()["resident_bytes"]
    finally:
        jes.close()
        hottier.reset_global()
        jax_hottier.reset_global()


@pytest.mark.parametrize("what", ["baseline", "resident byte"])
def test_digest_mismatch_falls_back_to_drive_path(hot, what):
    _jes, tes = hot
    body = _payload(128 << 10, seed=11)
    tes.put_object(B, "rot", io.BytesIO(body), len(body))
    _admit(tes, "rot")
    tier = _tier(tes)
    with tier._mu:
        entry = tier._entries[(B, "rot")]
    if what == "baseline":
        entry.digs[0, 0, 0] ^= 0xFF
    else:
        entry.data[0, 0, 0] ^= 0xFF      # the resident tensor itself
    h0 = tier.stats()["hits"]
    assert _get(tes, "rot")[1] == body, "fallback did not serve the drive path"
    assert tier.stats()["hits"] == h0
    assert tier.stats()["evictions"] >= 1
    # The still-hot key may re-admit at once (write-through), but never
    # with the rotted entry.
    with tier._mu:
        assert tier._entries.get((B, "rot")) is not entry, "rotted entry kept"
    assert tier.drain(30)
    assert _get(tes, "rot")[1] == body


def test_corrupted_upload_is_refused_at_seal(hot, monkeypatch):
    """The admit-time re-hash of the resident copy: an upload that differs
    from the staged bytes is never installed and leaves no charge."""
    _jes, tes = hot
    body = _payload(128 << 10, seed=13)
    tes.put_object(B, "bad", io.BytesIO(body), len(body))
    tier = _tier(tes)
    seal = tier.arena.seal

    def corrupt_seal(shape, staging, stream):
        dev = seal(shape, staging, stream)
        dev[0, 1, 7] ^= 0x01
        return dev

    monkeypatch.setattr(tier.arena, "seal", corrupt_seal)
    for _ in range(3):
        assert _get(tes, "bad")[1] == body
        assert tier.drain(30)
    assert not tier.resident(B, "bad")
    assert tier.stats()["admits"] == 0
    assert tier.arena.used_bytes == 0
    monkeypatch.setattr(tier.arena, "seal", seal)
    _admit(tes, "bad")
    assert _get(tes, "bad")[1] == body


def test_tier_off_by_default(monkeypatch):
    monkeypatch.delenv("MTPU_HOTTIER", raising=False)
    assert not hottier.enabled() and not jax_hottier.enabled()
    assert hottier.maybe_tier(CPU) is None


def test_default_reader_admission_and_bucket_invalidation(hot):
    """A miss noted without a reader of its own admits through the
    process-wide reader (hottier.set_reader) on the default grid; a newer
    elected identity only misses; invalidate_bucket drops every resident
    key of the bucket."""
    tier = _tier(hot[1])
    body = _payload(200 << 10, seed=12)

    class Info:
        etag, size, mod_time, version_id = "e-r", len(body), 42.5, ""

    reads = []

    def reader(b, o):
        reads.append((b, o))
        return Info(), iter([body[:1000], body[1000:]])

    hottier.set_reader(reader)
    try:
        for key in ("r1", "r2"):
            for _ in range(2):
                tier.note_miss(B, key, len(body))
            assert tier.drain(30) and tier.resident(B, key), tier.stats()
        assert reads == [(B, "r1"), (B, "r2")]
        ident = ("", "e-r", len(body), 42.5)
        out = tier.serve_ident(B, "r1", ident, 1000, 5000)
        assert b"".join(bytes(c) for c in out) == body[1000:6000]
        assert tier.serve_ident(B, "r1", ("", "e-r2", len(body), 43.0), 0, 16) is None
        assert not tier.resident(B, "r1") and tier.resident(B, "r2")
        tier.invalidate_bucket(B)
        assert not tier.resident(B, "r2")
        assert tier.stats()["resident_bytes"] == 0
    finally:
        hottier.set_reader(None)
