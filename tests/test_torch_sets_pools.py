"""Erasure sets and server pools of the port (minio_tpu_torch, plain
PyTorch on the CPU) against the JAX package's, on the same tmp drives:
SipHash routing, the multi-set format.json, objects routed to the same
set, and pool placement. The JAX side runs with both batch planes off and
bitrot_algorithm="mxsum256"; block_size is cut to 64 KiB to keep the CPU
run short. Tolerance: exact bytes."""

import glob
import hashlib
import io
import json
import os
import random
import shutil
import uuid

import numpy as np
import pytest

from minio_tpu.erasure.format import init_format_erasure as jax_init_format
from minio_tpu.erasure.pools import ErasureServerPools as JaxPools
from minio_tpu.erasure.sets import ErasureSets as JaxSets
from minio_tpu.erasure.types import CompletePart as JaxPart
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu.utils import siphash as jax_siphash
from minio_tpu_torch.erasure.format import init_format_erasure as torch_init_format
from minio_tpu_torch.erasure.pools import ErasureServerPools as TorchPools
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.erasure.types import CompletePart as TorchPart
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.utils import siphash as torch_siphash

BS = 64 << 10
BUCKET = "sets"
SIZES = [100, 20 << 10, 300 << 10, (1 << 20) + 7]


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture
def planes_off(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")


def _paths(root, n):
    return [str(root / f"d{i:02d}") for i in range(n)]


def _get(layer, key, offset=0, length=-1):
    _info, it = layer.get_object(BUCKET, key, offset, length)
    return b"".join(bytes(c) for c in it)


# -- SipHash --

def test_siphash_reference_vectors():
    """The SipHash-2-4 paper's vectors (key 00..0f, messages 00..0n-1)."""
    key = bytes(range(16))
    for msg_len, want in ((0, 0x726FDB47DD0E0E31), (1, 0x74F839C593DC67FD),
                          (8, 0x93F5F5799A932462), (15, 0xA129CA6149BE45E5)):
        msg = bytes(range(msg_len))
        assert torch_siphash.siphash24(key, msg) == want
        assert jax_siphash.siphash24(key, msg) == want


@pytest.mark.parametrize("cardinality", [1, 2, 3, 4, 16])
def test_sip_hash_mod_equals_jax(cardinality):
    rng = random.Random(cardinality)
    dep = str(uuid.UUID(int=rng.getrandbits(128)))
    keys = ["".join(rng.choice("abcdefgh/._-0123456789é")
                    for _ in range(rng.randint(0, 40))) for _ in range(10_000)]
    got = [torch_siphash.sip_hash_mod(k, cardinality, dep) for k in keys]
    assert got == [jax_siphash.sip_hash_mod(k, cardinality, dep) for k in keys]
    assert set(got) == set(range(cardinality))


# -- format.json --

_INIT = {"jax": (jax_init_format, JaxDrive), "torch": (torch_init_format, TorchDrive)}


def _format_docs(paths):
    """Each drive's format.json bytes (None where there is none)."""
    out = []
    for p in paths:
        try:
            out.append(open(os.path.join(p, ".mtpu.sys", "format.json"), "rb").read())
        except FileNotFoundError:
            out.append(None)
    return out


def _trackers(paths):
    out = []
    for p in paths:
        try:
            doc = json.load(open(os.path.join(p, ".mtpu.sys", "healing.json")))
        except FileNotFoundError:
            out.append(None)
            continue
        doc.pop("started")
        out.append(doc)
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_32_drive_format_loads_in_the_other(tmp_path, writer, reader):
    paths = _paths(tmp_path, 32)
    init_w, drive_w = _INIT[writer]
    init_r, drive_r = _INIT[reader]
    wdrives = [drive_w(p) for p in paths]
    fmt_w = init_w(wdrives, 8)
    assert len(fmt_w.sets) == 4 and all(len(s) == 8 for s in fmt_w.sets)
    # A drive's WAL has one owner at a time: the writer's let go first.
    for d in wdrives:
        d.close_wal()
    shuffled = list(paths)
    random.Random(1).shuffle(shuffled)
    rdrives = [drive_r(p) for p in shuffled]
    fmt_r = init_r(rdrives, 8)
    assert (fmt_r.deployment_id, fmt_r.sets) == (fmt_w.deployment_id, fmt_w.sets)
    # Both order the drives by their format's slot, whatever the argument order.
    assert [d.root for d in rdrives] == [d.root for d in wdrives] == paths
    docs = [json.loads(d) for d in _format_docs(paths)]
    assert [d["erasure"]["this"] for d in docs] == [u for s in fmt_w.sets for u in s]
    for d in rdrives:
        d.close_wal()


def _mutate(paths, case):
    """Damage drive 5 of a formatted 32-drive layout as `case` says."""
    fp = os.path.join(paths[5], ".mtpu.sys", "format.json")
    doc = json.load(open(fp))
    if case in ("blank", "blank-twice"):
        os.remove(fp)
        if case == "blank-twice":
            os.remove(os.path.join(paths[17], ".mtpu.sys", "format.json"))
    elif case == "stale":
        doc["erasure"]["this"] = str(uuid.uuid4())
        json.dump(doc, open(fp, "w"))
    elif case == "foreign":
        doc["id"] = str(uuid.uuid4())
        json.dump(doc, open(fp, "w"))
    elif case == "corrupt":
        open(fp, "w").write("{not json")


@pytest.mark.parametrize("case,sdc", [("blank", 8), ("blank-twice", 8), ("stale", 8),
                                      ("foreign", 8), ("corrupt", 8), ("layout", 16)])
def test_format_reload_cases_match_jax(tmp_path, case, sdc):
    """A blank drive (one or two), a stale UUID of this deployment, a
    foreign deployment's drive, an unreadable format and a layout change:
    on two copies of the same drives, the JAX package and the port reach
    the same outcome (the same error, or the same format documents, drive
    order and healing trackers)."""
    base = _paths(tmp_path / "base", 32)
    torch_init_format([TorchDrive(p) for p in base], 8)
    _mutate(base, case)
    outcomes = []
    for name in ("jax", "torch"):
        shutil.copytree(tmp_path / "base", tmp_path / name)
        paths = _paths(tmp_path / name, 32)
        init, drive = _INIT[name]
        drives = [drive(p) for p in reversed(paths)]
        try:
            fmt = init(drives, sdc)
        except Exception as e:  # noqa: BLE001 - the outcome under test
            outcomes.append(type(e).__name__)
            continue
        outcomes.append((fmt.deployment_id, fmt.sets,
                         [os.path.basename(d.root) for d in drives],
                         _format_docs(paths), _trackers(paths)))
    assert outcomes[0] == outcomes[1]
    if case in ("foreign", "layout"):
        assert outcomes[1] == "CorruptedFormat"
    elif case == "corrupt":
        # Placed but not reformatted while a drive cannot be read.
        assert outcomes[1][3][5] == b"{not json" and outcomes[1][4][5] is None
    else:
        _dep, sets, order, raw, trackers = outcomes[1]
        docs = [json.loads(d) for d in raw]
        slot_uuids = [u for s in sets for u in s]
        for slot, name in enumerate(order):     # every drive holds its slot's UUID
            assert docs[int(name[1:])]["erasure"]["this"] == slot_uuids[slot]
        claimed = [i for i, t in enumerate(trackers) if t is not None]
        assert claimed == ([5, 17] if case == "blank-twice" else [5])
        for i in claimed:
            assert trackers[i] == {"drive_uuid": docs[i]["erasure"]["this"],
                                   "bucket": "", "object": "", "healed": 0,
                                   "failed": 0, "finished_buckets": []}


# -- sets --

def _jax_sets(paths, sdc):
    return JaxSets([JaxDrive(p) for p in paths], set_drive_count=sdc, parity=2,
                   block_size=BS, bitrot_algorithm="mxsum256")


def _torch_sets(paths, sdc):
    return TorchSets([TorchDrive(p) for p in paths], set_drive_count=sdc, parity=2,
                     block_size=BS, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_objects_routed_to_the_same_set(tmp_path, planes_off, writer):
    paths = _paths(tmp_path, 32)
    first = _jax_sets if writer == "jax" else _torch_sets
    w = first(paths, 8)
    r = (_torch_sets if writer == "jax" else _jax_sets)(paths, 8)
    w.make_bucket(BUCKET)
    objects = {f"dir{i % 3}/obj-{i}": _payload(SIZES[i % len(SIZES)], i)
               for i in range(12)}
    for key, data in objects.items():
        w.put_object(BUCKET, key, io.BytesIO(data), len(data))
    hit_sets = set()
    for key, data in objects.items():
        assert _get(r, key) == data
        assert r.get_object_info(BUCKET, key).size == len(data)
        si = r.sets.index(r.get_hashed_set(key))
        assert si == w.sets.index(w.get_hashed_set(key))
        holders = sorted(i for i, p in enumerate(paths)
                         if os.path.exists(os.path.join(p, BUCKET, key)))
        assert holders == list(range(si * 8, si * 8 + 8))
        hit_sets.add(si)
    assert len(hit_sets) > 1
    key = next(iter(objects))
    r.delete_object(BUCKET, key)
    with pytest.raises(Exception) as ei:
        w.get_object_info(BUCKET, key)
    assert type(ei.value).__name__ == "ObjectNotFound"


def test_sets_multipart_and_heal_route_by_hash(tmp_path, planes_off):
    paths = _paths(tmp_path, 16)
    ts, js = _torch_sets(paths, 4), _jax_sets(paths, 4)
    ts.make_bucket(BUCKET)
    keys = [f"mp-{i}" for i in range(6)]
    uploads = {k: ts.new_multipart_upload(BUCKET, k) for k in keys}
    parts = [_payload(5 << 20, 1), _payload(777, 2)]
    for k, uid in uploads.items():
        for n, data in enumerate(parts, 1):
            ts.put_object_part(BUCKET, k, uid, n, io.BytesIO(data), len(data))
    assert [(u.object, u.upload_id) for u in ts.list_multipart_uploads(BUCKET)] == \
        [(u.object, u.upload_id) for u in js.list_multipart_uploads(BUCKET)] == \
        sorted(uploads.items())
    etags = [hashlib.md5(p).hexdigest() for p in parts]
    for i, (k, uid) in enumerate(uploads.items()):
        if i % 2:
            js.complete_multipart_upload(BUCKET, k, uid,
                                         [JaxPart(n, e) for n, e in enumerate(etags, 1)])
        else:
            ts.complete_multipart_upload(BUCKET, k, uid,
                                         [TorchPart(n, e) for n, e in enumerate(etags, 1)])
    assert ts.list_multipart_uploads(BUCKET) == []
    key = keys[0]
    si = ts.sets.index(ts.get_hashed_set(key))
    shutil.rmtree(glob.glob(os.path.join(paths[si * 4], BUCKET, key, "*", ""))[0])
    assert ts.heal_object(BUCKET, key).healed_count == 1
    for layer in (ts, js):
        assert _get(layer, key) == b"".join(parts)


# -- pools --

def _pools(root, cls_sets, cls_pools, n_pools=2, per_pool=8, sdc=4):
    return cls_pools([cls_sets(_paths(root / f"pool{i}", per_pool), sdc)
                      for i in range(n_pools)])


def test_pools_roundtrip_and_placement(tmp_path, planes_off):
    tp = _pools(tmp_path, _torch_sets, TorchPools)
    jp = _pools(tmp_path, _jax_sets, JaxPools)
    tp.make_bucket(BUCKET)
    objects = {f"p{i}": _payload(SIZES[i % len(SIZES)], 10 + i) for i in range(6)}
    for key, data in objects.items():
        tp.put_object(BUCKET, key, io.BytesIO(data), len(data))
    for key, data in objects.items():
        for layer in (tp, jp):
            assert _get(layer, key) == data
            assert _get(layer, key, 10, 50) == data[10:60]
        assert tp.pool_of(BUCKET, key) == jp._get_pool_idx_existing(BUCKET, key)
    # An object in pool 1 stays there on overwrite, whatever pool 0's space.
    data = _payload(300 << 10, 99)
    tp.pools[1].put_object(BUCKET, "pinned", io.BytesIO(data), len(data))
    new = _payload(200 << 10, 98)
    tp.put_object(BUCKET, "pinned", io.BytesIO(new), len(new))
    assert tp.pool_of(BUCKET, "pinned") == 1
    assert _get(jp, "pinned") == new
    with pytest.raises(Exception) as ei:
        tp.pools[0].get_object_info(BUCKET, "pinned")
    assert type(ei.value).__name__ == "ObjectNotFound"


def test_pools_delete_goes_to_the_owner(tmp_path, planes_off):
    tp = _pools(tmp_path, _torch_sets, TorchPools)
    jp = _pools(tmp_path, _jax_sets, JaxPools)
    tp.make_bucket(BUCKET)
    for i, layer in enumerate(tp.pools):
        data = _payload(40 << 10, i)
        layer.put_object(BUCKET, f"in-{i}", io.BytesIO(data), len(data))
    tp.delete_object(BUCKET, "in-1")
    jp.delete_object(BUCKET, "in-0")
    for layer in (tp, jp):
        for key in ("in-0", "in-1"):
            with pytest.raises(Exception) as ei:
                layer.get_object_info(BUCKET, key)
            assert type(ei.value).__name__ == "ObjectNotFound"
        with pytest.raises(Exception) as ei:
            layer.delete_object(BUCKET, "never")
        assert type(ei.value).__name__ == "ObjectNotFound"


@pytest.mark.parametrize("completer", ["jax", "torch"])
def test_pools_multipart_finds_its_upload(tmp_path, planes_off, completer):
    tp = _pools(tmp_path, _torch_sets, TorchPools)
    jp = _pools(tmp_path, _jax_sets, JaxPools)
    tp.make_bucket(BUCKET)
    uid = tp.pools[1].new_multipart_upload(BUCKET, "big")
    parts = [_payload(5 << 20, 7), _payload(4321, 8)]
    etags = [tp.put_object_part(BUCKET, "big", uid, n, io.BytesIO(d), len(d)).etag
             for n, d in enumerate(parts, 1)]
    assert [p.etag for p in jp.list_parts(BUCKET, "big", uid)] == etags
    assert [u.upload_id for u in tp.list_multipart_uploads(BUCKET)] == [uid]
    if completer == "jax":
        info = jp.complete_multipart_upload(BUCKET, "big", uid,
                                            [JaxPart(n, e) for n, e in enumerate(etags, 1)])
    else:
        info = tp.complete_multipart_upload(BUCKET, "big", uid,
                                            [TorchPart(n, e) for n, e in enumerate(etags, 1)])
    assert info.etag.endswith("-2")
    assert tp.pool_of(BUCKET, "big") == 1
    for layer in (tp, jp):
        assert _get(layer, "big") == b"".join(parts)
    with pytest.raises(Exception) as ei:
        tp.abort_multipart_upload(BUCKET, "big", uid)
    assert type(ei.value).__name__ == "InvalidUploadID"
