"""S3 versioning of the port (minio_tpu_torch, plain PyTorch on the CPU)
against the JAX package's, on the same tmp drives: bucket metadata
documents, multi-version journals written by one package and continued by
the other, delete markers and deletes by version, ListObjectVersions pages
(through the pools' metacache too), DeleteObjects with versions, tags,
versioned Complete, heal of a noncurrent version and the hot tier's
bypass of versioned reads. Every test on drives runs twice, with both
packages' group-commit metadata plane at its default (on) and with
MTPU_METAPLANE=0 (tests/torch_planes.py); the batched data plane is off,
and the JAX side writes bitrot_algorithm="mxsum256" (the only algorithm
of the two that the port reads); block_size is cut to 64 KiB to keep the
CPU run short. Tolerance: exact bytes."""

import glob
import hashlib
import io
import itertools
import os
import shutil
import time
import types
import uuid

import numpy as np
import pytest

import minio_tpu.erasure.objects as jax_objects_mod
import minio_tpu.storage.fileinfo as jax_fileinfo_mod
import minio_tpu_torch.erasure.objects as torch_objects_mod
import minio_tpu_torch.storage.fileinfo as torch_fileinfo_mod
from minio_tpu.bucket.meta import BucketMetadata as JaxBucketMetadata
from minio_tpu.bucket.meta import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.erasure.pools import ErasureServerPools as JaxPools
from minio_tpu.erasure.sets import ErasureSets as JaxSets
from minio_tpu.erasure.types import CompletePart as JaxPart
from minio_tpu.erasure.types import ObjectOptions as JaxOpts
from minio_tpu.erasure.types import ObjectToDelete as JaxDel
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu_torch.bucket.meta import BucketMetadata as TorchBucketMetadata
from minio_tpu_torch.bucket.meta import BucketMetadataSys as TorchBucketMetadataSys
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.erasure.pools import ErasureServerPools as TorchPools
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.erasure.types import CompletePart as TorchPart
from minio_tpu_torch.erasure.types import ObjectOptions as TorchOpts
from minio_tpu_torch.erasure.types import ObjectToDelete as TorchDel
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from tests.torch_planes import planes  # noqa: F401 - the fixture

BS = 64 << 10
BUCKET = "vers"
OPTS = {"jax": JaxOpts, "torch": TorchOpts}


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _layers(planes, paths):
    jl, tl = planes.layers(
        paths,
        lambda: JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=BS,
                           bitrot_algorithm="mxsum256"),
        lambda: TorchObjects([TorchDrive(p) for p in paths], parity=4,
                             block_size=BS, device="cpu"))
    return {"jax": jl, "torch": tl}


def _paths(root, n=12):
    return [str(root / f"d{i:02d}") for i in range(n)]


def _get(layer, key, version_id="", pkg="torch"):
    _info, it = layer.get_object(BUCKET, key, opts=OPTS[pkg](version_id=version_id))
    return b"".join(bytes(c) for c in it)


def _versions(layer, prefix=""):
    """[(name, version_id, is_latest, delete_marker, etag, size)], all pages."""
    out, marker, vmarker = [], "", ""
    while True:
        res = layer.list_object_versions(BUCKET, prefix, marker, vmarker, "", 1000)
        out += [(o.name, o.version_id, o.is_latest, o.delete_marker, o.etag, o.size)
                for o in res.objects]
        if not res.is_truncated:
            return out
        marker, vmarker = res.next_marker, res.next_version_id_marker


def _tree(paths):
    """{(drive, relative path): bytes} of every file under the bucket."""
    out = {}
    for i, p in enumerate(paths):
        base = os.path.join(p, BUCKET)
        for root, _dirs, files in os.walk(base):
            for f in files:
                full = os.path.join(root, f)
                with open(full, "rb") as fh:
                    out[(i, os.path.relpath(full, base))] = fh.read()
    return out


# -- bucket metadata documents --

def _bucket_fields(seed):
    rng = np.random.default_rng(seed)
    blob = lambda n: rng.bytes(int(rng.integers(0, n)))  # noqa: E731
    return dict(name=f"bkt{seed}", created=float(rng.uniform(1e9, 2e9)),
                versioning_status=["", "Enabled", "Suspended"][seed % 3],
                policy_json=blob(300), lifecycle_xml=blob(200), tagging_xml=blob(50),
                sse_xml=blob(80), object_lock_xml=blob(90), quota_json=blob(20),
                notification_xml=blob(400), replication_xml=blob(70000))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_metadata_serializes_as_jax(seed):
    fields = _bucket_fields(seed)
    raw = JaxBucketMetadata(**fields).serialize()
    assert TorchBucketMetadata(**fields).serialize() == raw
    assert TorchBucketMetadata.parse(raw) == TorchBucketMetadata(**fields)
    assert TorchBucketMetadata.parse(raw).serialize() == raw


def test_bucket_metadata_cache_rereads_only_a_rewritten_doc(tmp_path, planes,
                                                           monkeypatch):
    """The port's BucketMetadataSys reads a bucket's document once while
    no drive's copy changes, and again after the JAX package rewrites it
    (a JAX server on the same drives tells the port nothing); a document
    written just now is never cached."""
    from minio_tpu_torch.bucket import meta as meta_mod

    paths = _paths(tmp_path)
    layers = _layers(planes, paths)
    es = layers["torch"]
    es.make_bucket(BUCKET)
    reads = []
    real = TorchObjects.read_sys_config   # every port layer the test mounts
    monkeypatch.setattr(TorchObjects, "read_sys_config",
                        lambda self, p: reads.append(p) or real(self, p))
    port = TorchBucketMetadataSys(es)
    # "Just written" for as long as this part of the test takes.
    monkeypatch.setattr(meta_mod.BucketMetadataSys, "_RACY_STAT_NS", 10**12)
    port.update(BUCKET, versioning_status="Suspended")
    # The rule under test is a file's racy stat: the document on disk. (A
    # pending WAL copy answers an exact signature instead, which
    # test_torch_metaplane.py holds.)
    planes.settle()
    assert port.get(BUCKET).versioning_status == "Suspended"
    assert port.get(BUCKET).versioning_status == "Suspended"
    assert len(reads) == 3                 # update's get, then twice: just written
    monkeypatch.setattr(meta_mod.BucketMetadataSys, "_RACY_STAT_NS", -1)
    for _ in range(3):
        assert not port.get(BUCKET).versioning_enabled
    assert len(reads) == 4
    JaxBucketMetadataSys(layers["jax"]).update(BUCKET, versioning_status="Enabled")
    for _ in range(3):
        assert port.get(BUCKET).versioning_enabled
    assert len(reads) == 5
    assert port.get("other").versioning_status == ""
    assert port.get("other").versioning_status == ""
    assert len(reads) == 6


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bucket_metadata_doc_on_the_drives_both_ways(tmp_path, planes, writer):
    """A document one package's BucketMetadataSys stored is read by the
    other's, which writes back byte-equal documents and keeps every field
    it does not serve."""
    paths = _paths(tmp_path)
    layers = _layers(planes, paths)
    sys_cls = {"jax": JaxBucketMetadataSys, "torch": TorchBucketMetadataSys}
    reader = "torch" if writer == "jax" else "jax"
    fields = _bucket_fields(7)
    fields.pop("name")
    # The JAX package validates a policy before it stores one.
    fields["policy_json"] = (
        b'{"Version":"2012-10-17","Statement":[{"Effect":"Allow","Principal":'
        b'{"AWS":["*"]},"Action":["s3:GetObject"],"Resource":["arn:aws:s3:::b1/*"]}]}')
    sys_cls[writer](layers[writer]).update("b1", **fields)

    def docs():
        planes.settle()
        return [open(os.path.join(p, ".mtpu.sys", "config", "buckets", "b1",
                                  "metadata.mp"), "rb").read() for p in paths]

    first = docs()
    assert len(set(first)) == 1
    assert first[0] == TorchBucketMetadata(name="b1", **fields).serialize()
    other = sys_cls[reader](layers[reader])
    assert other.get("b1").versioning_status == fields["versioning_status"]
    other.update("b1", versioning_status="Enabled")
    second = docs()
    assert len(set(second)) == 1
    assert second[0] == JaxBucketMetadata(
        name="b1", **{**fields, "versioning_status": "Enabled"}).serialize()
    assert sys_cls[writer](layers[writer]).get("b1").versioning_enabled
    other.drop_bucket("b1")
    planes.settle()
    assert not any(os.path.exists(os.path.join(p, ".mtpu.sys", "config", "buckets",
                                               "b1", "metadata.mp")) for p in paths)


# -- multi-version journals: the same operations, the same bytes --

def _pin(monkeypatch, objects_mod, fileinfo_mod, clock):
    """Version ids, data dirs and clocks drawn from a counter and `clock`
    instead of uuid4 and the wall clock, so two packages running the same
    operations write the same bytes."""
    counter = itertools.count(1)
    fake_uuid = types.SimpleNamespace(**{k: getattr(uuid, k) for k in dir(uuid)
                                         if not k.startswith("__")})
    fake_uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    fake_time = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                         if not k.startswith("__")})
    fake_time.time = lambda: clock[0]
    for mod in (objects_mod, fileinfo_mod):
        monkeypatch.setattr(mod, "uuid", fake_uuid)
        monkeypatch.setattr(mod, "time", fake_time)


_KEY_SIZES = {"inl": 1 << 10, "mid": 300 << 10, "big": (1 << 20) + 12345, "tiny": 2 << 10}


def _phase_one(layer, pkg, clock):
    o = OPTS[pkg]
    infos = {}
    for t, (name, key, size, versioned) in enumerate((
            ("null", "k", _KEY_SIZES["inl"], False),
            ("v1", "k", _KEY_SIZES["mid"], True),
            ("v2", "k", _KEY_SIZES["big"], True),
            ("v3", "k", _KEY_SIZES["tiny"], True),
            ("n1", "k2", _KEY_SIZES["mid"], False),
            ("n2", "k2", _KEY_SIZES["big"], False))):
        clock[0] = 1_000_000.0 + t
        infos[name] = layer.put_object(BUCKET, key, io.BytesIO(_payload(size, t)),
                                       size, o(versioned=versioned))
    clock[0] = 1_000_010.0
    layer.put_object_tags(BUCKET, "k", "a=1&b=two", o(version_id=infos["v1"].version_id))
    return {k: v.version_id for k, v in infos.items()}


def _phase_two(layer, pkg, clock, vids):
    o = OPTS[pkg]
    clock[0] = 1_000_020.0
    dm = layer.delete_object(BUCKET, "k", o(versioned=True))
    clock[0] = 1_000_021.0
    layer.delete_object(BUCKET, "k", o(version_id=vids["v2"], versioned=True))
    clock[0] = 1_000_022.0
    layer.put_object(BUCKET, "k", io.BytesIO(_payload(5000, 40)), 5000, o(versioned=True))
    clock[0] = 1_000_023.0
    layer.put_object(BUCKET, "k2", io.BytesIO(_payload(200 << 10, 41)), 200 << 10,
                     o(versioned=True))
    clock[0] = 1_000_024.0
    layer.delete_object(BUCKET, "k", o(version_id="null"))
    clock[0] = 1_000_025.0
    layer.delete_object_tags(BUCKET, "k", o(version_id=vids["v1"]))
    return dm.version_id


def test_multi_version_journals_byte_equal_both_ways(tmp_path, planes, monkeypatch):
    """The same versioned operations (null and versioned PUTs, inline and
    streamed, an overwrite of the null version, tags on a noncurrent
    version) leave byte-equal journals and part files on two drive sets,
    one written by each package; then each package continues the other's
    drives (a delete marker, deletes by id and of the null version, more
    versions) and the sets are still byte-equal."""
    a, b = _paths(tmp_path / "a"), _paths(tmp_path / "b")
    ja, tb = _layers(planes, a)["jax"], _layers(planes, b)["torch"]
    jclock, tclock = [0.0], [0.0]
    _pin(monkeypatch, jax_objects_mod, jax_fileinfo_mod, jclock)
    _pin(monkeypatch, torch_objects_mod, torch_fileinfo_mod, tclock)
    ja.make_bucket(BUCKET)
    tb.make_bucket(BUCKET)
    jv = _phase_one(ja, "jax", jclock)
    tv = _phase_one(tb, "torch", tclock)
    assert jv == tv and len(set(jv.values())) == 4     # 3 ids and the null ""
    planes.settle()
    first = _tree(a)
    assert any(k[1].endswith("part.1") for k in first)
    assert _tree(b) == first
    # Swap: each package continues the other's drives.
    tb_on_a, ja_on_b = _layers(planes, a)["torch"], _layers(planes, b)["jax"]
    dm_a = _phase_two(tb_on_a, "torch", tclock, jv)
    dm_b = _phase_two(ja_on_b, "jax", jclock, tv)
    assert dm_a == dm_b
    planes.settle()
    assert _tree(a) == _tree(b)
    for layer, pkg in ((ja, "jax"), (tb_on_a, "torch")):
        got = _versions(layer)
        assert [(n, v, lat, dm) for n, v, lat, dm, _e, _s in got] == [
            ("k", got[0][1], True, False), ("k", dm_a, False, True),
            ("k", jv["v3"], False, False), ("k", jv["v1"], False, False),
            ("k2", got[4][1], True, False), ("k2", "", False, False)]
        assert _get(layer, "k", jv["v1"], pkg) == _payload(_KEY_SIZES["mid"], 1)
        assert _get(layer, "k2", "null", pkg) == _payload(_KEY_SIZES["big"], 5)
        assert layer.get_object_tags(BUCKET, "k", OPTS[pkg](version_id=jv["v1"])) == ""


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_versioned_put_and_delete_marker(tmp_path, planes, writer):
    """tests/test_erasure_objects.py:193, written by one package and read
    by the other."""
    layers = _layers(planes, _paths(tmp_path))
    reader = "torch" if writer == "jax" else "jax"
    w, r = layers[writer], layers[reader]
    v = OPTS[writer](versioned=True)
    w.make_bucket(BUCKET)
    i1 = w.put_object(BUCKET, "obj", io.BytesIO(b"v1"), 2, v)
    big = _payload(200 << 10, 3)
    i2 = w.put_object(BUCKET, "obj", io.BytesIO(big), len(big), v)
    assert i1.version_id and i2.version_id and i1.version_id != i2.version_id
    for layer, pkg in ((w, writer), (r, reader)):
        assert _get(layer, "obj", pkg=pkg) == big
        assert _get(layer, "obj", i1.version_id, pkg) == b"v1"
    dm = w.delete_object(BUCKET, "obj", OPTS[writer](versioned=True))
    assert dm.delete_marker and dm.version_id
    for layer, pkg in ((w, writer), (r, reader)):
        with pytest.raises(Exception) as ei:
            _get(layer, "obj", pkg=pkg)
        assert type(ei.value).__name__ in ("ObjectNotFound", "ObjectIsDeleteMarker")
        assert _get(layer, "obj", i2.version_id, pkg) == big
        got = _versions(layer)
        assert [(x[1], x[3]) for x in got] == [(dm.version_id, True),
                                               (i2.version_id, False),
                                               (i1.version_id, False)]
    # The reader deletes the marker by its id: the newest version answers.
    out = r.delete_object(BUCKET, "obj", OPTS[reader](version_id=dm.version_id,
                                                      versioned=True))
    assert out.delete_marker and out.version_id == dm.version_id
    assert _get(w, "obj", pkg=writer) == big


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_version_id_null_names_the_null_version(tmp_path, planes, writer):
    """tests/test_erasure_objects.py:349 across packages."""
    layers = _layers(planes, _paths(tmp_path))
    reader = "torch" if writer == "jax" else "jax"
    w, r = layers[writer], layers[reader]
    w.make_bucket(BUCKET)
    null_body, v2_body = _payload(30 << 10, 1), b"versioned-generation-2"
    w.put_object(BUCKET, "k", io.BytesIO(null_body), len(null_body))
    info2 = r.put_object(BUCKET, "k", io.BytesIO(v2_body), len(v2_body),
                         OPTS[reader](versioned=True))
    assert info2.version_id
    assert _get(w, "k", pkg=writer) == v2_body
    assert _get(w, "k", "null", writer) == null_body
    r.delete_object(BUCKET, "k", OPTS[reader](version_id="null", versioned=True))
    assert _get(w, "k", pkg=writer) == v2_body
    for layer, pkg in ((w, writer), (r, reader)):
        with pytest.raises(Exception) as ei:
            _get(layer, "k", "null", pkg)
        assert type(ei.value).__name__ == "VersionNotFound"


def test_version_pages_equal_jax(tmp_path, planes):
    """tests/test_erasure_objects.py:297: every page of the port's
    ListObjectVersions over versions, markers and prefixes equals the JAX
    package's on the same drives, and no version repeats."""
    layers = _layers(planes, _paths(tmp_path))
    jl, tl = layers["jax"], layers["torch"]
    tl.make_bucket(BUCKET)
    for i in range(5):
        tl.put_object(BUCKET, "obj", io.BytesIO(b"%d" % i), 1, TorchOpts(versioned=True))
    for i, key in enumerate(("a/1", "a/2", "b", "c/d/e")):
        layer = (jl, tl)[i % 2]
        layer.put_object(BUCKET, key, io.BytesIO(b"x"), 1, OPTS[("jax", "torch")[i % 2]]())
        layer.put_object(BUCKET, key, io.BytesIO(b"yy"), 2,
                         OPTS[("jax", "torch")[i % 2]](versioned=True))
    jl.delete_object(BUCKET, "b", JaxOpts(versioned=True))
    for max_keys in (1, 2, 3, 1000):
        for delimiter in ("", "/"):
            pages = {}
            for pkg, layer in (("jax", jl), ("torch", tl)):
                seq, marker, vmarker = [], "", ""
                while True:
                    res = layer.list_object_versions(BUCKET, "", marker, vmarker,
                                                     delimiter, max_keys)
                    seq.append(([(o.name, o.version_id, o.is_latest, o.delete_marker,
                                  o.etag, o.size, o.mod_time) for o in res.objects],
                                res.prefixes, res.is_truncated, res.next_marker,
                                res.next_version_id_marker))
                    if not res.is_truncated:
                        break
                    marker, vmarker = res.next_marker, res.next_version_id_marker
                pages[pkg] = seq
            assert pages["torch"] == pages["jax"], (max_keys, delimiter)
            seen = [(e[0], e[1]) for p in pages["torch"] for e in p[0]]
            assert len(seen) == len(set(seen))
    assert len(_versions(tl)) == 5 + 4 * 2 + 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_object_tags_across_packages(tmp_path, planes, writer):
    """tests/test_erasure_objects.py:338, tags set by one package on a
    noncurrent version and read by the other; the data stays intact."""
    layers = _layers(planes, _paths(tmp_path))
    reader = "torch" if writer == "jax" else "jax"
    w, r = layers[writer], layers[reader]
    w.make_bucket(BUCKET)
    body = _payload(100 << 10, 5)
    first = w.put_object(BUCKET, "obj", io.BytesIO(body), len(body),
                         OPTS[writer](versioned=True))
    w.put_object(BUCKET, "obj", io.BytesIO(b"d" * 100), 100, OPTS[writer](versioned=True))
    pinned = OPTS[writer](version_id=first.version_id)
    w.put_object_tags(BUCKET, "obj", "k1=v1&k2=v2", pinned)
    ropts = OPTS[reader](version_id=first.version_id)
    assert r.get_object_tags(BUCKET, "obj", ropts) == "k1=v1&k2=v2"
    assert r.get_object_tags(BUCKET, "obj", OPTS[reader]()) == ""
    r.delete_object_tags(BUCKET, "obj", ropts)
    assert w.get_object_tags(BUCKET, "obj", pinned) == ""
    for layer, pkg in ((w, writer), (r, reader)):
        assert _get(layer, "obj", first.version_id, pkg) == body
        assert _get(layer, "obj", pkg=pkg) == b"d" * 100


@pytest.mark.parametrize("layer_kind", ["set", "pools"])
def test_delete_objects_with_versions_equal_jax(tmp_path, planes, layer_kind):
    """DeleteObjects naming VersionIds, markers among them, and keys
    without one on a versioned bucket: the port's per-key results equal
    the JAX package's on twin drive sets."""
    results = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        if layer_kind == "set":
            layer = _layers(planes, _paths(root))[pkg]
        else:
            layer = _pools(planes, root)[pkg]
        o = OPTS[pkg]
        layer.make_bucket(BUCKET)
        vids = {}
        for i in range(4):
            for j in range(2):
                vids[(i, j)] = layer.put_object(BUCKET, f"k{i}", io.BytesIO(b"v%d" % j),
                                                2, o(versioned=True)).version_id
        marker = layer.delete_object(BUCKET, "k3", o(versioned=True)).version_id
        dcls = JaxDel if pkg == "jax" else TorchDel
        out = layer.delete_objects(BUCKET, [
            dcls("k0", vids[(0, 0)]), dcls("k1"), dcls("k2", vids[(2, 1)]),
            dcls("k3", marker), dcls("k9", "00000000-0000-0000-0000-000000000001")],
            o(versioned=True))
        rows = []
        for r in out:
            if isinstance(r, Exception):
                rows.append(type(r).__name__)
            else:
                ids = {v: k for k, v in vids.items()}
                ids[marker] = "marker"
                rows.append((r.object_name, ids.get(r.version_id, bool(r.version_id)),
                             r.delete_marker,
                             ids.get(r.delete_marker_version_id,
                                     bool(r.delete_marker_version_id))))
        left = [(n, dm) for n, _v, _l, dm, _e, _s in _versions(layer)]
        results[pkg] = (rows, left)
        if layer_kind == "pools":
            layer.close()
    assert results["torch"] == results["jax"]
    rows, left = results["torch"]
    assert rows[1][2] is True and rows[3][1] == "marker"
    assert left == [("k0", False), ("k1", True), ("k1", False), ("k1", False),
                    ("k2", False), ("k3", False), ("k3", False)]


# -- sets and pools --

def _pools(planes, root, n_pools=2, n=4):
    """{package: its pools over root's drives}."""
    paths = [[str(root / f"pool{p}" / f"d{i}") for i in range(n)]
             for p in range(n_pools)]

    def build(pkg):
        if pkg == "jax":
            return JaxPools([JaxSets([JaxDrive(x) for x in ps], parity=2, block_size=BS,
                                     bitrot_algorithm="mxsum256") for ps in paths])
        return TorchPools([TorchSets([TorchDrive(x) for x in ps], parity=2,
                                     block_size=BS, device="cpu") for ps in paths])

    jl, tl = planes.layers([x for ps in paths for x in ps],
                           lambda: build("jax"), lambda: build("torch"))
    return {"jax": jl, "torch": tl}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pools_versioned_delete_marker(tmp_path, planes, writer):
    """tests/test_sets_pools.py:259, the marker landing in the owner pool."""
    pools = _pools(planes, tmp_path)
    w = pools[writer]
    w.make_bucket(BUCKET)
    body = b"versioned body"
    w.pools[1].put_object(BUCKET, "v", io.BytesIO(body), len(body),
                          OPTS[writer](versioned=True))
    info = pools["torch"].delete_object(BUCKET, "v", TorchOpts(versioned=True))
    assert info.delete_marker
    for pkg, layer in pools.items():
        res = layer.list_object_versions(BUCKET, prefix="v")
        assert len(res.objects) == 2 and res.objects[0].delete_marker
        assert layer._get_pool_idx_existing(BUCKET, "v") == 1
        layer.close()


def test_pools_versioned_reput_stays_in_owner_pool(tmp_path, planes, monkeypatch):
    """tests/test_sets_pools.py:342 on the port, read back by the JAX
    package: one pool holds the whole history."""
    pools = _pools(planes, tmp_path)
    tp, jp = pools["torch"], pools["jax"]
    tp.make_bucket(BUCKET)
    tp.put_object(BUCKET, "vv", io.BytesIO(b"one"), 3, TorchOpts(versioned=True))
    owner = tp._get_pool_idx_existing(BUCKET, "vv")
    assert owner is not None
    tp.delete_object(BUCKET, "vv", TorchOpts(versioned=True))
    assert tp._get_pool_idx_existing(BUCKET, "vv") == owner
    other = 1 - owner
    monkeypatch.setattr(tp, "_pool_free",
                        lambda p: 10**12 if p is tp.pools[other] else 1)
    tp.put_object(BUCKET, "vv", io.BytesIO(b"two"), 3, TorchOpts(versioned=True))
    assert tp._get_pool_idx_existing(BUCKET, "vv") == owner
    for layer in (tp, jp):
        res = layer.list_object_versions(BUCKET, prefix="vv")
        assert len(res.objects) == 3
        assert sum(1 for o in res.objects if o.delete_marker) == 1
        assert layer._get_pool_idx_existing(BUCKET, "vv") == owner
        layer.close()


def test_sets_version_listing_counts_prefixes_against_max_keys(tmp_path, planes):
    """tests/test_sets_pools.py:366 on the port's ErasureSets."""
    sets = TorchSets([TorchDrive(p) for p in _paths(tmp_path, 8)], set_drive_count=4,
                     parity=2, block_size=BS, device="cpu")
    sets.make_bucket(BUCKET)
    for i in range(3):
        sets.put_object(BUCKET, f"vp/a/{i}", io.BytesIO(b"x"), 1)
    for n in ("b", "c", "d"):
        sets.put_object(BUCKET, f"vp/{n}", io.BytesIO(b"x"), 1)
    res = sets.list_object_versions(BUCKET, prefix="vp/", delimiter="/", max_keys=2)
    assert len(res.objects) + len(res.prefixes) <= 2
    assert res.is_truncated


@pytest.mark.parametrize("renderer", ["jax", "torch"])
def test_version_pages_through_the_metacache(tmp_path, planes, renderer):
    """Page 1 of ListObjectVersions through one package's pools renders a
    kind "v" block stream; the other package serves every continuation
    page from it, equal to a walk."""
    pools = _pools(planes, tmp_path)
    jp, tp = pools["jax"], pools["torch"]
    r, s = (jp, tp) if renderer == "jax" else (tp, jp)
    r.make_bucket(BUCKET)
    for i in range(30):
        layer = tp if i % 2 else jp
        pkg = "torch" if i % 2 else "jax"
        for j in range(1 + i % 3):
            layer.put_object(BUCKET, f"o{i:03d}", io.BytesIO(b"%d" % j), 1,
                             OPTS[pkg](versioned=True))
        if i % 7 == 0:
            layer.delete_object(BUCKET, f"o{i:03d}", OPTS[pkg](versioned=True))

    def walk(layer, marker="", vmarker=""):
        pages = []
        while True:
            res = layer.list_object_versions(BUCKET, "", marker, vmarker, "", 7)
            pages.append(([(o.name, o.version_id, o.is_latest, o.delete_marker,
                            o.etag, o.size) for o in res.objects],
                          res.is_truncated, res.next_marker,
                          res.next_version_id_marker))
            if not res.is_truncated:
                return pages
            marker, vmarker = res.next_marker, res.next_version_id_marker

    first = r.list_object_versions(BUCKET, max_keys=7)
    assert first.is_truncated and r.metacache.stream_complete(BUCKET, kind="v")
    got = walk(s, first.next_marker, first.next_version_id_marker)
    assert s.metacache.hits == len(got) and s.metacache.misses == 0
    s.metacache.drop(BUCKET, kind="v")
    walked = walk(s, first.next_marker, first.next_version_id_marker)
    assert walked == got and s.metacache.hits == len(got)
    assert len(first.objects) + sum(len(p[0]) for p in got) == 30 + 30 + 5
    for layer in (jp, tp):
        layer.close()


# -- multipart, heal, the hot tier --

@pytest.mark.parametrize("completer", ["jax", "torch"])
def test_versioned_complete_adds_a_version(tmp_path, planes, completer):
    """tests/test_multipart.py versioned Complete: the upload becomes a new
    version beside the null one, readable by both packages."""
    layers = _layers(planes, _paths(tmp_path))
    jl, tl = layers["jax"], layers["torch"]
    tl.make_bucket(BUCKET)
    null_body = _payload(50 << 10, 9)
    jl.put_object(BUCKET, "mp", io.BytesIO(null_body), len(null_body))
    uid = tl.new_multipart_upload(BUCKET, "mp")
    parts = [_payload(5 << 20, 10), _payload(4321, 11)]
    etags = [tl.put_object_part(BUCKET, "mp", uid, n, io.BytesIO(d), len(d)).etag
             for n, d in enumerate(parts, 1)]
    if completer == "jax":
        info = jl.complete_multipart_upload(
            BUCKET, "mp", uid, [JaxPart(n, e) for n, e in enumerate(etags, 1)],
            JaxOpts(versioned=True))
    else:
        info = tl.complete_multipart_upload(
            BUCKET, "mp", uid, [TorchPart(n, e) for n, e in enumerate(etags, 1)],
            TorchOpts(versioned=True))
    assert info.version_id and info.etag.endswith("-2")
    for layer, pkg in ((jl, "jax"), (tl, "torch")):
        assert _get(layer, "mp", info.version_id, pkg) == b"".join(parts)
        assert _get(layer, "mp", "null", pkg) == null_body
        assert [(v[1], v[2]) for v in _versions(layer)] == [(info.version_id, True),
                                                            ("", False)]


@pytest.mark.parametrize("inline", [False, True])
def test_heal_of_a_noncurrent_version(tmp_path, planes, inline):
    """The port heals a noncurrent version (not the latest) lost on 4
    drives: the rebuilt shard files equal the originals, the other
    versions are untouched, the healed tree is the JAX package's heal of
    the same damage byte for byte, and the JAX package reads every
    version. (An inline version's healed journals carry shard index
    pos + 1, as the JAX heal writes them, where its PUT wrote 0.)"""
    paths = _paths(tmp_path)
    layers = _layers(planes, paths)
    jl, tl = layers["jax"], layers["torch"]
    jl.make_bucket(BUCKET)
    size = 3 << 10 if inline else (1 << 20) + 777
    old = _payload(size, 21)
    i_old = jl.put_object(BUCKET, "h", io.BytesIO(old), size, JaxOpts(versioned=True))
    new = _payload(200 << 10, 22)
    i_new = jl.put_object(BUCKET, "h", io.BytesIO(new), len(new), JaxOpts(versioned=True))
    planes.settle()
    before = _tree(paths)
    fi = tl.latest_fileinfo(BUCKET, "h", i_old.version_id)
    lost = [i for i, shard in enumerate(fi.erasure.distribution) if shard <= 4]
    for i in lost:
        with planes.drive(TorchDrive, paths[i]) as d:
            if fi.data_dir:
                shutil.rmtree(os.path.join(paths[i], BUCKET, "h", fi.data_dir))
            # The drive forgets the version too (its journal keeps the newer
            # one).
            meta = d._load_meta(BUCKET, "h")
            meta.delete_version(i_old.version_id, BUCKET, "h")
            d._store_meta(BUCKET, "h", meta)
    jax_paths = _paths(tmp_path / "jax-heal")
    for src, dst in zip(paths, jax_paths):
        shutil.copytree(src, dst)
    res = tl.heal_object(BUCKET, "h", i_old.version_id)
    assert res.version_id == i_old.version_id and res.healed_count == 4
    jres = _layers(planes, jax_paths)["jax"].heal_object(BUCKET, "h", i_old.version_id)
    assert jres.healed_count == 4
    planes.settle()
    assert _tree(paths) == _tree(jax_paths)
    if inline:
        changed = {key for key, raw in _tree(paths).items() if before[key] != raw}
        assert changed == {(i, "h/meta.mp") for i in lost}
    else:
        assert _tree(paths) == before
    for layer, pkg in ((jl, "jax"), (tl, "torch")):
        assert _get(layer, "h", i_old.version_id, pkg) == old
        assert _get(layer, "h", pkg=pkg) == new
    assert tl.heal_object(BUCKET, "h", i_new.version_id).healed_count == 0


def test_versioned_read_bypasses_the_hot_tier(tmp_path, monkeypatch):
    """tests/test_hottier.py:215 on the port: a read that names a version
    never comes from the tier (no hit, no miss noted, no admission), and
    the latest still hits."""
    from minio_tpu_torch import hottier

    monkeypatch.setenv("MTPU_HOTTIER", "1")
    monkeypatch.setenv("MTPU_HOTTIER_ADMIT_COOLDOWN_S", "0")
    hottier.reset_global()
    try:
        es = TorchObjects([TorchDrive(p) for p in _paths(tmp_path, 4)], parity=2,
                          block_size=BS, device="cpu")
        es.make_bucket(BUCKET)
        b1, b2 = _payload(100 << 10, 6), _payload(100 << 10, 7)
        i1 = es.put_object(BUCKET, "ver", io.BytesIO(b1), len(b1),
                           TorchOpts(versioned=True))
        es.put_object(BUCKET, "ver", io.BytesIO(b2), len(b2), TorchOpts(versioned=True))
        tier = hottier.get_tier(es.device)
        deadline = time.monotonic() + 30
        while not tier.resident(BUCKET, "ver"):
            assert _get(es, "ver") == b2
            tier.drain()
            assert time.monotonic() < deadline, "the latest version was never admitted"
        before = tier.stats()
        for _ in range(3):
            assert _get(es, "ver", i1.version_id) == b1
        tier.drain()
        after = tier.stats()
        assert {k: after[k] for k in ("hits", "misses", "admits")} == \
            {k: before[k] for k in ("hits", "misses", "admits")}
        assert _get(es, "ver") == b2
        assert tier.stats()["hits"] == before["hits"] + 1
    finally:
        hottier.reset_global()


# -- the S3 routes, against the JAX server --

S3 = "{http://s3.amazonaws.com/doc/2006-03-01/}"
_TIMES = ("LastModified", "Initiated", "CreationDate")
_HEADERS = ("ETag", "Content-Length", "Content-Range", "Content-Type",
            "x-amz-version-id", "x-amz-delete-marker", "x-amz-tagging-count",
            "x-amz-meta-tier")


@pytest.fixture(scope="module")
def torch_server(tmp_path_factory):
    from minio_tpu_torch.s3.server import build_server
    from tests.conftest import S3_ACCESS, S3_SECRET

    root = tmp_path_factory.mktemp("torch-versioning-drives")
    srv = build_server([str(root / f"d{i}") for i in range(4)], S3_ACCESS,
                       S3_SECRET, device="cpu").start()
    yield srv.url
    srv.close()


class _Views:
    """One server's answers, its version ids renamed V1, V2, ... in the
    order they first appear (ids are random per server) and times masked."""

    def __init__(self):
        self.ids: dict[str, str] = {}

    def vid(self, v):
        if not v or v == "null":
            return v
        return self.ids.setdefault(v, f"V{len(self.ids) + 1}")

    def xml(self, body):
        def walk(e):
            tag = e.tag.rsplit("}", 1)[-1]
            text = (e.text or "").strip()
            if tag in _TIMES:
                text = "<masked>"
            elif tag in ("VersionId", "NextVersionIdMarker", "DeleteMarkerVersionId"):
                text = self.vid(text)
            elif tag in ("RequestId", "HostId"):
                return None
            return (e.tag, text, [c for c in map(walk, e) if c is not None])
        import xml.etree.ElementTree as ET
        return walk(ET.fromstring(body))

    def view(self, r, skip=()):
        h = {k: r.headers.get(k) for k in _HEADERS if k not in skip}
        if h.get("x-amz-version-id"):
            h["x-amz-version-id"] = self.vid(h["x-amz-version-id"])
        body = r.content
        if body and (r.status_code >= 300 or r.headers.get("Content-Type")
                     == "application/xml"):
            body = self.xml(body)
        return r.status_code, h, body


def _versioning_script(cl, bucket):
    """Versioning, version ids, tags and conditional requests over HTTP,
    in one order; -> [(step, view)] and the raw responses by step."""
    views, out, raw = _Views(), [], {}
    vbody = (b'<VersioningConfiguration xmlns="http://s3.amazonaws.com/doc/'
             b'2006-03-01/"><Status>Enabled</Status></VersioningConfiguration>')

    def step(name, method, path, query=None, body=b"", headers=None, skip=()):
        r = cl.request(method, path, query=query, headers=headers, data=body)
        out.append((name, views.view(r, skip)))
        raw[name] = r
        return r

    k = f"/{bucket}/nv"
    step("create", "PUT", f"/{bucket}")
    step("versioning-unset", "GET", f"/{bucket}", {"versioning": ""})
    step("put-null", "PUT", k, body=b"null-version-body")
    step("versioning-enable", "PUT", f"/{bucket}", {"versioning": ""}, vbody)
    step("versioning-get", "GET", f"/{bucket}", {"versioning": ""})
    step("versioning-bogus", "PUT", f"/{bucket}", {"versioning": ""},
         b"<VersioningConfiguration><Status>Bogus</Status></VersioningConfiguration>")
    step("versioning-no-bucket", "GET", f"/{bucket}-none", {"versioning": ""})
    v1 = step("put-v1", "PUT", k, body=_payload(40 << 10, 1),
              headers={"x-amz-meta-tier": "hot"}).headers["x-amz-version-id"]
    step("put-v2", "PUT", k, body=_payload(3000, 2),
         headers={"x-amz-tagging": "a=1&b=2"})
    step("get-latest", "GET", k)
    step("head-latest", "HEAD", k)
    step("get-null", "GET", k, {"versionId": "null"})
    step("head-null", "HEAD", k, {"versionId": "null"})
    step("get-v1", "GET", k, {"versionId": v1})
    step("range-v1", "GET", k, {"versionId": v1}, headers={"Range": "bytes=10-99"})
    step("get-bogus-version", "GET", k,
         {"versionId": "00000000-0000-0000-0000-000000000000"})
    step("versions", "GET", f"/{bucket}", {"versions": ""})
    dm = step("delete-marker", "DELETE", k).headers["x-amz-version-id"]
    # The port also names the marker on the 404 (S3's headers); the JAX
    # server sends none: compared without them, checked below.
    step("get-after-marker", "GET", k, skip=("x-amz-delete-marker", "x-amz-version-id"))
    step("head-after-marker", "HEAD", k,
         skip=("x-amz-delete-marker", "x-amz-version-id"))
    step("versions-with-marker", "GET", f"/{bucket}", {"versions": ""})
    step("versions-page-1", "GET", f"/{bucket}", {"versions": "", "max-keys": "2"})
    page = raw["versions-page-1"]
    import xml.etree.ElementTree as ET
    root = ET.fromstring(page.content)
    step("versions-page-2", "GET", f"/{bucket}",
         {"versions": "", "max-keys": "2",
          "key-marker": root.findtext(f"{S3}NextKeyMarker"),
          "version-id-marker": root.findtext(f"{S3}NextVersionIdMarker")})
    step("versions-prefix", "GET", f"/{bucket}", {"versions": "", "prefix": "zz"})
    step("delete-the-marker", "DELETE", k, {"versionId": dm})
    step("get-after-unmarking", "GET", k)
    tags = (b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
            b"<Tag><Key>team</Key><Value>s3</Value></Tag></TagSet></Tagging>")
    step("tag-v1", "PUT", k, {"tagging": "", "versionId": v1}, tags)
    step("tags-v1", "GET", k, {"tagging": "", "versionId": v1})
    step("tags-latest", "GET", k, {"tagging": ""})
    step("head-v1-tagged", "HEAD", k, {"versionId": v1})
    step("untag-v1", "DELETE", k, {"tagging": "", "versionId": v1})
    step("tags-v1-after", "GET", k, {"tagging": "", "versionId": v1})
    step("tags-missing-key", "GET", f"/{bucket}/nope", {"tagging": ""})
    step("tag-malformed", "PUT", k, {"tagging": ""}, b"<Tagging")
    etag = raw["get-latest"].headers["ETag"]
    step("if-match", "GET", k, headers={"If-Match": etag})
    step("if-match-star", "GET", k, headers={"If-Match": "*"})
    step("if-match-wrong", "GET", k, headers={"If-Match": '"deadbeef"'})
    step("if-none-match", "GET", k, headers={"If-None-Match": etag})
    step("if-none-match-star", "GET", k, headers={"If-None-Match": "*"})
    step("if-none-match-other", "GET", k, headers={"If-None-Match": '"deadbeef"'})
    step("head-if-none-match", "HEAD", k, headers={"If-None-Match": etag})
    step("head-if-match-wrong", "HEAD", k, headers={"If-Match": "deadbeef"})
    step("range-if-match-wrong", "GET", k,
         headers={"If-Match": "deadbeef", "Range": "bytes=0-9"})
    step("v1-if-none-match", "GET", k, {"versionId": v1},
         headers={"If-None-Match": etag})
    step("delete-null", "DELETE", k, {"versionId": "null"})
    step("get-null-gone", "GET", k, {"versionId": "null"})
    step("delete-v1", "DELETE", k, {"versionId": v1})
    step("versions-end", "GET", f"/{bucket}", {"versions": ""})
    return out, raw, views


def test_versioning_routes_match_jax(server, torch_server):
    """tests/test_s3_bucket_config.py:75,92, tests/test_s3_api.py:253,455
    and the conditional GETs, as one script sent to both servers: equal
    statuses, headers and documents (version ids renamed in order of
    appearance, times masked)."""
    from tests.conftest import S3_ACCESS, S3_SECRET
    from tests.s3client import SigV4Client

    bucket = f"ver-{uuid.uuid4().hex[:12]}"
    want, _jraw, _ = _versioning_script(SigV4Client(server, S3_ACCESS, S3_SECRET), bucket)
    got, traw, tviews = _versioning_script(
        SigV4Client(torch_server, S3_ACCESS, S3_SECRET), bucket)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, w), (_, g) in zip(want, got):
        assert g == w, name
    codes = dict((n, v[0]) for n, v in got)
    assert codes["if-match-wrong"] == codes["head-if-match-wrong"] == 412
    assert codes["if-none-match"] == codes["head-if-none-match"] == 304
    assert codes["get-after-marker"] == 404 and codes["delete-marker"] == 204
    assert dict(got)["head-v1-tagged"][1]["x-amz-tagging-count"] == "2"
    # S3's delete-marker headers on the 404, from the port.
    r = traw["get-after-marker"]
    assert r.headers["x-amz-delete-marker"] == "true"
    assert tviews.vid(r.headers["x-amz-version-id"]) == \
        dict(got)["delete-marker"][1]["x-amz-version-id"]


def test_a_named_delete_marker_answers_405(torch_server):
    """GET or HEAD of a delete marker by its id: 405 MethodNotAllowed with
    x-amz-delete-marker, as S3 answers (the JAX server's HEAD answers 200
    with the marker's empty headers, its GET 404)."""
    from tests.conftest import S3_ACCESS, S3_SECRET
    from tests.s3client import SigV4Client

    cl = SigV4Client(torch_server, S3_ACCESS, S3_SECRET)
    bucket = f"dm-{uuid.uuid4().hex[:12]}"
    cl.put(f"/{bucket}")
    cl.put(f"/{bucket}", query={"versioning": ""},
           data=b"<VersioningConfiguration><Status>Enabled</Status>"
                b"</VersioningConfiguration>")
    cl.put(f"/{bucket}/k", data=b"x")
    dm = cl.delete(f"/{bucket}/k").headers["x-amz-version-id"]
    for method in ("GET", "HEAD"):
        r = cl.request(method, f"/{bucket}/k", query={"versionId": dm})
        assert r.status_code == 405
        assert r.headers["x-amz-delete-marker"] == "true"
        assert r.headers["x-amz-version-id"] == dm


def test_a_write_takes_no_version_id(torch_server):
    """PUT, CopyObject, UploadPart and CompleteMultipartUpload that name a
    versionId answer 400 InvalidArgument: a noncurrent version keeps its
    bytes and the bucket no new version (the JAX server would give the
    new version the client's id and replace that version's data)."""
    from tests.conftest import S3_ACCESS, S3_SECRET
    from tests.s3client import SigV4Client

    cl = SigV4Client(torch_server, S3_ACCESS, S3_SECRET)
    bucket = f"wv-{uuid.uuid4().hex[:12]}"
    cl.put(f"/{bucket}")
    cl.put(f"/{bucket}", query={"versioning": ""},
           data=b"<VersioningConfiguration><Status>Enabled</Status>"
                b"</VersioningConfiguration>")
    first = _payload(70 << 10, 4)
    v1 = cl.put(f"/{bucket}/k", data=first).headers["x-amz-version-id"]
    cl.put(f"/{bucket}/k", data=b"second")
    uid = cl.post(f"/{bucket}/k", query={"uploads": ""}).content.split(
        b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    answers = [
        cl.put(f"/{bucket}/k", query={"versionId": v1}, data=b"replaced"),
        cl.put(f"/{bucket}/k", query={"versionId": v1},
               headers={"x-amz-copy-source": f"/{bucket}/k"}),
        cl.put(f"/{bucket}/k", query={"versionId": v1, "uploadId": uid,
                                     "partNumber": "1"}, data=b"part"),
        cl.post(f"/{bucket}/k", query={"versionId": v1, "uploadId": uid},
                data=b"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
                     b"<ETag>x</ETag></Part></CompleteMultipartUpload>"),
    ]
    assert [r.status_code for r in answers] == [400] * 4
    assert all(b"<Code>InvalidArgument</Code>" in r.content for r in answers)
    assert cl.get(f"/{bucket}/k", query={"versionId": v1}).content == first
    assert cl.get(f"/{bucket}/k").content == b"second"
    r = cl.get(f"/{bucket}", query={"versions": ""})
    assert r.content.count(b"<Version>") == 2


# -- the journal read cache of LocalDrive.read_version --

def test_read_version_cache_parses_once_and_hands_out_copies(tmp_path, planes,
                                                             monkeypatch):
    """Reads of an unchanged journal parse it once; every read gets its
    own FileInfo, so a caller's mutation never reaches the next reader."""
    from minio_tpu_torch.storage import local as local_mod

    es = _layers(planes, _paths(tmp_path))["torch"]
    es.make_bucket(BUCKET)
    body = _payload(200 << 10, 1)
    es.put_object(BUCKET, "k", io.BytesIO(body), len(body))
    planes.settle()   # the cache under test is of journals on disk
    d = es.drives[0]
    monkeypatch.setattr(local_mod.LocalDrive, "_RACY_STAT_NS", -1)
    parses = []
    real = local_mod.XLMeta.parse
    monkeypatch.setattr(local_mod.XLMeta, "parse",
                        staticmethod(lambda raw: parses.append(1) or real(raw)))
    first = d.read_version(BUCKET, "k")
    first.erasure.index = 99
    first.parts[0].size = -1
    first.metadata["etag"] = "mutated"
    for _ in range(4):
        again = d.read_version(BUCKET, "k")
        assert (again.erasure.index, again.parts[0].size, again.metadata["etag"]) != \
            (99, -1, "mutated")
    assert len(parses) == 1
    with pytest.raises(Exception) as ei:
        d.read_version(BUCKET, "k", "00000000-0000-0000-0000-000000000001")
    assert type(ei.value).__name__ == "FileVersionNotFound"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_read_version_cache_sees_every_rewrite(tmp_path, planes, monkeypatch,
                                              writer):
    """A journal rewritten after it was cached (a new version by either
    package, a delete, a file replaced out of band) is read anew."""
    from minio_tpu_torch.storage import local as local_mod

    monkeypatch.setattr(local_mod.LocalDrive, "_RACY_STAT_NS", -1)
    paths = _paths(tmp_path)
    layers = _layers(planes, paths)
    tl, w = layers["torch"], layers[writer]
    tl.make_bucket(BUCKET)
    tl.put_object(BUCKET, "k", io.BytesIO(b"first"), 5)
    assert _get(tl, "k") == b"first"
    info = w.put_object(BUCKET, "k", io.BytesIO(b"second!"), 7,
                        OPTS[writer](versioned=True))
    assert _get(tl, "k") == b"second!"
    assert tl.get_object_info(BUCKET, "k").version_id == info.version_id
    w.delete_object(BUCKET, "k", OPTS[writer](version_id=info.version_id))
    assert _get(tl, "k") == b"first"
    # Out of band: drive 0's journal replaced by another drive's copy of a
    # different object's journal.
    tl.put_object(BUCKET, "other", io.BytesIO(b"other"), 5)
    planes.settle()
    src = os.path.join(paths[1], BUCKET, "other", "meta.mp")
    dst = os.path.join(paths[0], BUCKET, "k", "meta.mp")
    shutil.copyfile(src, dst + ".new")
    os.replace(dst + ".new", dst)
    assert tl.drives[0].read_version(BUCKET, "k").metadata["etag"] == \
        hashlib.md5(b"other").hexdigest()


def test_read_version_cache_skips_a_journal_written_just_now(tmp_path, planes,
                                                            monkeypatch):
    """A journal whose mtime is within the racy window of its read is not
    cached: a second write in the same mtime tick could keep its
    (inode, mtime, size)."""
    from minio_tpu_torch.storage import local as local_mod

    monkeypatch.setattr(local_mod.LocalDrive, "_RACY_STAT_NS", 3600 * 10**9)
    es = _layers(planes, _paths(tmp_path))["torch"]
    es.make_bucket(BUCKET)
    es.put_object(BUCKET, "k", io.BytesIO(b"x"), 1)
    planes.settle()
    d = es.drives[0]
    d.read_version(BUCKET, "k")
    assert not d._meta_cache


def test_server_wide_versioning(tmp_path):
    """build_server(versioned=True), the JAX build_server's flag: every
    bucket answers Enabled without a document of its own, PUTs get
    version ids, and DeleteObjects without VersionIds writes markers."""
    from minio_tpu_torch.s3.server import build_server
    from tests.conftest import S3_ACCESS, S3_SECRET
    from tests.s3client import SigV4Client

    srv = build_server(_paths(tmp_path, 4), S3_ACCESS, S3_SECRET, device="cpu",
                       versioned=True).start()
    try:
        cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
        cl.put(f"/{BUCKET}")
        assert b"<Status>Enabled</Status>" in cl.get(f"/{BUCKET}",
                                                     query={"versioning": ""}).content
        vids = [cl.put(f"/{BUCKET}/k", data=b"v%d" % i).headers["x-amz-version-id"]
                for i in range(2)]
        assert all(vids) and vids[0] != vids[1]
        r = cl.post(f"/{BUCKET}", query={"delete": ""},
                    data=b"<Delete><Object><Key>k</Key></Object></Delete>")
        assert b"<DeleteMarker>true</DeleteMarker>" in r.content
        r = cl.get(f"/{BUCKET}", query={"versions": ""})
        assert r.content.count(b"<Version>") == 2 and r.content.count(b"<DeleteMarker>") == 1
        assert cl.get(f"/{BUCKET}/k", query={"versionId": vids[0]}).content == b"v0"
    finally:
        srv.close()
