"""Listing and the bucket calls of the port (minio_tpu_torch, plain
PyTorch on the CPU) against the JAX package's, on the same tmp drives:
walk_dir order, the paginators over a grid of prefix x marker x delimiter
x max-keys, list_objects on one set and across two pools, DeleteObjects,
DeleteBucket, ListBuckets, metacache blocks rendered by one package and
served by the other, and the streamed-walk parse counts of
tests/test_streamed_listing.py run against the port. Object names, sizes
and the grid come from fixed seeds. Every interop test on drives runs
twice, with both packages' group-commit metadata plane at its default
(on) and with MTPU_METAPLANE=0 (tests/torch_planes.py); the batched data
plane is off. Tolerance: exact (names, etags, sizes, mod times, markers)."""

import io
import os

import numpy as np
import pytest

from minio_tpu.erasure import listing as jax_listing
from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.erasure.pools import ErasureServerPools as JaxPools
from minio_tpu.erasure.sets import ErasureSets as JaxSets
from minio_tpu.erasure.types import ObjectOptions as JaxOptions
from minio_tpu.erasure.types import ObjectToDelete as JaxToDelete
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu.utils.synthbucket import make_synthetic_bucket as jax_synth
from minio_tpu_torch.erasure import listing as torch_listing
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.erasure.pools import ErasureServerPools as TorchPools
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.erasure.types import CompletePart as TorchPart
from minio_tpu_torch.erasure.types import ObjectToDelete as TorchToDelete
from minio_tpu_torch.storage import xlmeta as torch_xlm
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.utils import msgpack
from minio_tpu_torch.utils.synthbucket import make_synthetic_bucket as torch_synth
from tests.torch_planes import planes  # noqa: F401 - the fixture

BS = 64 << 10
BUCKET = "lst"
# Names with '.' and '-' (both sort before '/') and keys nested under an
# object key, the cases a per-component sort gets wrong.
FIXED_KEYS = ["a", "a.txt", "a/b", "a/c", "a-1", "a0", "b/x/y", "b.z",
              "docs/r1", "docs/r2/x", "docs/r2.y", "docs/r2/z/w"]
COMPONENTS = ["a", "b", "c", "ab", "a.b", "a-b", "x_y", "9"]


def _keys(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    out = set(FIXED_KEYS)
    while len(out) < len(FIXED_KEYS) + n:
        depth = int(rng.integers(1, 4))
        out.add("/".join(COMPONENTS[int(i)] for i in
                         rng.integers(0, len(COMPONENTS), depth)))
    return sorted(out)


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _objects(paths):
    """(JAX builder, port builder) of an object layer over paths."""
    return (lambda: JaxObjects([JaxDrive(p) for p in paths], parity=2, block_size=BS,
                               bitrot_algorithm="mxsum256"),
            lambda: TorchObjects([TorchDrive(p) for p in paths], parity=2,
                                 block_size=BS, device="cpu"))


def _set_layers(planes, root, n=4):
    paths = [str(root / f"d{i}") for i in range(n)]
    jl, tl = planes.layers(paths, *_objects(paths))
    return paths, jl, tl


def _fill(layer, keys, seed=0):
    """PUT every key: mostly inline sizes, every 5th above the inline limit."""
    for i, k in enumerate(keys):
        size = 20 << 10 if i % 5 == 4 else 1 + i
        layer.put_object(BUCKET, k, io.BytesIO(_payload(size, seed + i)), size)


def _oview(o):
    return (o.name, o.etag, o.size, o.mod_time, o.version_id, o.is_latest,
            o.delete_marker, o.content_type, sorted(o.user_defined.items()),
            o.parity_blocks, o.data_blocks, o.num_versions,
            [tuple(p) for p in o.parts])


def _view(res):
    return ([_oview(o) for o in res.objects], list(res.prefixes),
            res.is_truncated, res.next_marker)


def _vview(res):
    return ([_oview(o) for o in res.objects], list(res.prefixes), res.is_truncated,
            res.next_marker, res.next_version_id_marker)


GRID_PREFIXES = ["", "a", "a/", "b", "docs/", "docs/r2", "zz"]
GRID_MARKERS = ["", "a", "a/", "a.b", "b/x", "docs/r2/", "docs/r2/x", "c/a"]


# -- walk_dir --

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_walk_dir_order_equals_jax(tmp_path, planes, writer):
    paths, jl, tl = _set_layers(planes, tmp_path)
    w = jl if writer == "jax" else tl
    w.make_bucket(BUCKET)
    keys = _keys(1, 30)
    _fill(w, keys)
    grid = [(prefix, start_after) for prefix in GRID_PREFIXES
            for start_after in GRID_MARKERS + ["a/" + "\U0010ffff" * 1025]]
    for p in paths[:2]:
        walks = {}
        for pkg, make in (("jax", JaxDrive), ("torch", TorchDrive)):
            with planes.drive(make, p) as d:
                walks[pkg] = [[(e.name, e.meta) for e in d.walk_dir(BUCKET, *args)]
                              for args in grid]
                names = [e.name for e in d.walk_dir(BUCKET)]
        for args, got, want in zip(grid, walks["torch"], walks["jax"]):
            assert got == want, args
        assert names == keys


# -- the paginators (pure functions) --

@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """One set written by the JAX package, versioned keys and a delete
    marker among them; -> (JAX journal map, port journal map). The
    paginators are pure functions of these maps: the metadata plane is
    off."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MTPU_METAPLANE", "0")
    mp.setenv("MTPU_BATCHED_DATAPLANE", "0")
    try:
        root = tmp_path_factory.mktemp("pag")
        jl, tl = (build() for build in _objects([str(root / f"d{i}")
                                                 for i in range(4)]))
        jl.make_bucket(BUCKET)
        keys = _keys(2, 40)
        _fill(jl, keys)
        for i, k in enumerate(keys[::7]):
            jl.put_object(BUCKET, k, io.BytesIO(b"v2"), 2,
                          JaxOptions(versioned=True))
            if i % 2:
                jl.delete_object(BUCKET, k, JaxOptions(versioned=True))
        jmap = jl.merged_journals(BUCKET, "")
        tmap = tl.merged_journals(BUCKET, "")
        jl.close()
    finally:
        mp.undo()
    assert list(jmap) == list(tmap) == keys
    return jmap, tmap


@pytest.mark.parametrize("max_keys", [1, 2, 5, 1000])
@pytest.mark.parametrize("delimiter", ["", "/"])
def test_paginators_equal_jax(journals, delimiter, max_keys):
    jmap, tmap = journals
    jinfo = lambda n, fi: jax_listing.fi_to_object_info(BUCKET, n, fi)  # noqa: E731
    tinfo = lambda n, fi: torch_listing.fi_to_object_info(BUCKET, n, fi)  # noqa: E731
    jentries = list(jax_listing.iter_entries_from_journals(jmap, jinfo))
    tentries = list(torch_listing.iter_entries_from_journals(tmap, tinfo))
    assert [(n, _oview(o)) for n, o in tentries] == [(n, _oview(o)) for n, o in jentries]
    jvent = list(jax_listing.iter_version_entries_from_journals(jmap, jinfo))
    tvent = list(torch_listing.iter_version_entries_from_journals(tmap, tinfo))
    assert [(n, [_oview(o) for o in v]) for n, v in tvent] == \
        [(n, [_oview(o) for o in v]) for n, v in jvent]
    for prefix in GRID_PREFIXES:
        pj = {n: m for n, m in jmap.items() if n.startswith(prefix)}
        pt = {n: m for n, m in tmap.items() if n.startswith(prefix)}
        for marker in GRID_MARKERS:
            args = (prefix, marker, delimiter, max_keys)
            want = jax_listing.paginate_objects(pj, jinfo, *args)
            assert _view(torch_listing.paginate_objects(pt, tinfo, *args)) == \
                _view(want), args
            assert _view(torch_listing.paginate_cached(tentries, *args)) == \
                _view(jax_listing.paginate_cached(jentries, *args)), args

            def tstream(sa, pt=pt):
                return ((n, pt[n]) for n in sorted(pt) if not sa or n > sa)

            def jstream(sa, pj=pj):
                return ((n, pj[n]) for n in sorted(pj) if not sa or n > sa)

            got = torch_listing.paginate_objects(
                torch_listing.pushdown_stream(tstream, prefix, marker, delimiter),
                tinfo, *args)
            assert _view(got) == _view(jax_listing.paginate_objects(
                jax_listing.pushdown_stream(jstream, prefix, marker, delimiter),
                jinfo, *args)) == _view(want), args
            vms = [""] + ([jmap[marker].to_fileinfo("", marker).version_id]
                          if marker in jmap else [])
            for vm in vms:
                vargs = (prefix, marker, vm, delimiter, max_keys)
                assert _vview(torch_listing.paginate_versions(pt, tinfo, *vargs)) == \
                    _vview(jax_listing.paginate_versions(pj, jinfo, *vargs)), vargs
                assert _vview(torch_listing.paginate_versions_cached(tvent, *vargs)) == \
                    _vview(jax_listing.paginate_versions_cached(jvent, *vargs)), vargs


def test_version_paginator_resumes_mid_object(journals):
    """A versioned key holds several versions: a page that ends inside it
    resumes after the version marker, in both packages."""
    jmap, tmap = journals
    jinfo = lambda n, fi: jax_listing.fi_to_object_info(BUCKET, n, fi)  # noqa: E731
    tinfo = lambda n, fi: torch_listing.fi_to_object_info(BUCKET, n, fi)  # noqa: E731
    multi = [n for n, m in jmap.items() if m.version_count > 1]
    assert multi
    for name in multi:
        vids = [fi.version_id for fi in tmap[name].list_versions(BUCKET, name)]
        for vm in vids:
            args = ("", name, vm, "", 2)
            got = torch_listing.paginate_versions(tmap, tinfo, *args)
            assert _vview(got) == _vview(jax_listing.paginate_versions(jmap, jinfo, *args))


# -- one set: list_objects, stream, bucket calls --

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_set_list_objects_equal_jax(tmp_path, planes, writer):
    _paths, jl, tl = _set_layers(planes, tmp_path)
    w = jl if writer == "jax" else tl
    w.make_bucket(BUCKET)
    keys = _keys(3, 30)
    _fill(w, keys)
    assert [n for n, _m in tl.stream_journals(BUCKET)] == keys
    for prefix in GRID_PREFIXES:
        for marker in GRID_MARKERS:
            for delimiter in ("", "/"):
                for max_keys in (3, 1000):
                    args = (BUCKET, prefix, marker, delimiter, max_keys)
                    assert _view(tl.list_objects(*args)) == \
                        _view(jl.list_objects(*args)), args


def test_bucket_calls_equal_jax(tmp_path, planes):
    _paths, jl, tl = _set_layers(planes, tmp_path)
    for name in ("zeta", "alpha", "mid-1"):
        tl.make_bucket(name)
    jl.make_bucket("beta")
    want = [(b.name, b.created) for b in jl.list_buckets()]
    assert [(b.name, b.created) for b in tl.list_buckets()] == want
    assert [n for n, _c in want] == ["alpha", "beta", "mid-1", "zeta"]
    tl.put_object("zeta", "k", io.BytesIO(b"x"), 1)
    for layer in (tl, jl):
        with pytest.raises(Exception) as ei:
            layer.delete_bucket("zeta")
        assert type(ei.value).__name__ == "BucketNotEmpty"
        with pytest.raises(Exception) as ei:
            layer.delete_bucket("nope")
        assert type(ei.value).__name__ == "BucketNotFound"
    tl.delete_bucket("alpha")
    jl.delete_bucket("mid-1")
    assert [b.name for b in tl.list_buckets()] == \
        [b.name for b in jl.list_buckets()] == ["beta", "zeta"]


def _dview(results):
    return [(type(r).__name__,) if isinstance(r, Exception) else
            (r.object_name, r.version_id, r.delete_marker, r.delete_marker_version_id)
            for r in results]


@pytest.mark.parametrize("layer_kind", ["set", "pools"])
def test_delete_objects_equal_jax(tmp_path, planes, layer_kind):
    """The same DeleteObjects (present, missing and invalid keys) on two
    copies of one bucket, one per package: equal per-key results, and the
    same keys left."""
    layers = []
    for pkg in ("jax", "torch"):
        paths = [str(tmp_path / pkg / f"d{i}") for i in range(4)]
        if layer_kind == "pools":
            layer = _pools(planes, tmp_path / pkg, n_pools=1)[pkg]
        else:
            layer = planes.layers(paths, *_sets(paths))[0 if pkg == "jax" else 1]
        layer.make_bucket(BUCKET)
        _fill(layer, _keys(4, 10))
        layers.append(layer)
    keys = _keys(4, 10)
    doomed = keys[::2] + ["missing", "a/missing", "../x", keys[0]]
    jr = layers[0].delete_objects(BUCKET, [JaxToDelete(k) for k in doomed])
    tr = layers[1].delete_objects(BUCKET, [TorchToDelete(k) for k in doomed])
    assert _dview(tr) == _dview(jr)
    assert {type(r).__name__ for r in tr} == {"DeletedObject", "ObjectNotFound",
                                              "FileAccessDenied"}
    left = [[o.name for o in layer.list_objects(BUCKET).objects] for layer in layers]
    assert left[0] == left[1] == keys[1::2]


# -- pools: the k-way merge and the metacache --

def _sets(paths):
    """(JAX builder, port builder) of a set over paths."""
    return (lambda: JaxSets([JaxDrive(x) for x in paths], parity=2, block_size=BS,
                            bitrot_algorithm="mxsum256"),
            lambda: TorchSets([TorchDrive(x) for x in paths], parity=2,
                              block_size=BS, device="cpu"))


def _pools(planes, root, n_pools=2, n=4):
    """{package: its pools over root's drives}."""
    paths = [[str(root / f"pool{p}" / f"d{i}") for i in range(n)]
             for p in range(n_pools)]
    jl, tl = planes.layers(
        [x for ps in paths for x in ps],
        lambda: JaxPools([_sets(ps)[0]() for ps in paths]),
        lambda: TorchPools([_sets(ps)[1]() for ps in paths]))
    return {"jax": jl, "torch": tl}


def _walk_pages(layer, max_keys, prefix="", delimiter=""):
    pages, marker = [], ""
    while True:
        res = layer.list_objects(BUCKET, prefix, marker, delimiter, max_keys)
        pages.append(_view(res))
        if not res.is_truncated:
            return pages
        marker = res.next_marker


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_two_pool_merge_equals_jax(tmp_path, planes, writer):
    pools = _pools(planes, tmp_path)
    jp, tp = pools["jax"], pools["torch"]
    w = jp if writer == "jax" else tp
    w.make_bucket(BUCKET)
    keys = _keys(5, 24)
    for i, k in enumerate(keys):
        w.pools[i % 2].put_object(BUCKET, k, io.BytesIO(_payload(7 + i, i)), 7 + i)
    # One key in both pools: the newer journal wins the merge.
    w.pools[0].put_object(BUCKET, keys[3], io.BytesIO(b"newest"), 6)
    assert [n for n, _m in tp.stream_journals(BUCKET)] == keys
    assert [(n, m.latest_mt) for n, m in tp.stream_journals(BUCKET)] == \
        [(n, m.latest_mt) for n, m in jp.stream_journals(BUCKET)]
    for max_keys in (5, 1000):
        for delimiter in ("", "/"):
            assert _walk_pages(tp, max_keys, "", delimiter) == \
                _walk_pages(jp, max_keys, "", delimiter)
    assert next(o for o in tp.list_objects(BUCKET).objects
                if o.name == keys[3]).size == 6


@pytest.mark.parametrize("renderer", ["jax", "torch"])
def test_metacache_blocks_serve_the_other_package(tmp_path, planes, renderer,
                                                  monkeypatch):
    """Page 1 through one package renders the bucket into metacache blocks
    (the whole stream synchronously here); the other package serves every
    continuation page from those blocks, equal to the renderer's own
    walk. Both packages render the same entries."""
    pools = _pools(planes, tmp_path, n_pools=1)
    jp, tp = pools["jax"], pools["torch"]
    r, s = (jp, tp) if renderer == "jax" else (tp, jp)
    for cls in (JaxPools, TorchPools):
        monkeypatch.setattr(cls, "METACACHE_MAX_ENTRIES", 1000)
    r.make_bucket(BUCKET)
    torch_synth(tp.pools[0].drives, BUCKET, 150)
    _fill(r.pools[0], ["zz/" + k for k in _keys(6, 20)])
    want = [_view(r.pools[0].list_objects(BUCKET, "", m, "", 40))
            for m in ("", "p000/o000039", "p000/o000079", "p000/o000119",
                      "zz/a.b")]
    first = r.list_objects(BUCKET, max_keys=40)
    assert _view(first) == want[0] and r.metacache.stream_complete(BUCKET)
    own = _walk_pages(r.pools[0], 40)
    got = _walk_pages(s, 40)
    assert s.metacache.hits == len(got) - 1 and s.metacache.misses == 0
    assert got[0] == want[0] and got == own
    # The entries either package renders decode to the same documents.
    base = os.path.join(tp.pools[0].drives[0].root, ".mtpu.sys", "config",
                        tp.metacache._base(BUCKET, "", "o"))
    planes.settle()
    first_doc = msgpack.unpackb(open(os.path.join(base, "blk0"), "rb").read())
    s.metacache.drop(BUCKET)
    planes.release()   # the other package's layer mounts afresh
    fresh = pools["torch" if renderer == "jax" else "jax"]
    fresh.list_objects(BUCKET, max_keys=40)
    planes.settle()
    second_doc = msgpack.unpackb(open(os.path.join(base, "blk0"), "rb").read())
    assert second_doc["entries"] == first_doc["entries"]
    assert len(first_doc["entries"]) == 150 + len(_keys(6, 20))


@pytest.mark.parametrize("mutation", ["put", "delete", "complete"])
def test_mutation_retires_the_rendered_stream(tmp_path, planes, mutation):
    tp = _pools(planes, tmp_path, n_pools=1)["torch"]
    tp.make_bucket(BUCKET)
    torch_synth(tp.pools[0].drives, BUCKET, 120)
    tp.METACACHE_MAX_ENTRIES = 1000
    first = tp.list_objects(BUCKET, max_keys=50)
    assert tp.list_objects(BUCKET, marker=first.next_marker, max_keys=50).is_truncated
    assert tp.metacache.hits == 1
    if mutation == "put":
        tp.put_object(BUCKET, "p000/o000077x", io.BytesIO(b"new"), 3)
    elif mutation == "delete":
        tp.delete_object(BUCKET, "p000/o000077")
    else:
        uid = tp.new_multipart_upload(BUCKET, "p000/o000077x")
        data = b"part"
        info = tp.put_object_part(BUCKET, "p000/o000077x", uid, 1, io.BytesIO(data), 4)
        tp.complete_multipart_upload(BUCKET, "p000/o000077x", uid,
                                     [TorchPart(1, info.etag)])
    page = tp.list_objects(BUCKET, marker=first.next_marker, max_keys=50)
    assert tp.metacache.hits == 1            # the stale stream was not served
    names = [o.name for o in page.objects]
    assert ("p000/o000077x" in names) == (mutation != "delete")
    assert ("p000/o000077" in names) == (mutation != "delete")


def test_jax_mutation_retires_a_port_rendered_stream(tmp_path, planes, monkeypatch):
    """A stream the port rendered is not served by the JAX package once
    the JAX package has mutated the bucket (each package's mutations
    retire the streams it would serve; across packages, as across the JAX
    package's nodes, only the TTL bounds staleness otherwise)."""
    pools = _pools(planes, tmp_path, n_pools=1)
    jp, tp = pools["jax"], pools["torch"]
    for cls in (JaxPools, TorchPools):
        monkeypatch.setattr(cls, "METACACHE_MAX_ENTRIES", 1000)
    tp.make_bucket(BUCKET)
    torch_synth(tp.pools[0].drives, BUCKET, 60)
    first = tp.list_objects(BUCKET, max_keys=25)
    jp.put_object(BUCKET, "p000/o000030x", io.BytesIO(b"n"), 1)
    page = jp.list_objects(BUCKET, marker=first.next_marker, max_keys=25)
    assert "p000/o000030x" in [o.name for o in page.objects]
    assert jp.metacache.hits == 0


def test_sys_config_store_equals_jax(tmp_path, planes):
    """Mirrored system documents: what either package writes the other
    reads (majority election, read-repair of a diverged copy), lists and
    deletes."""
    paths, jl, tl = _set_layers(planes, tmp_path)
    docs = {f"buckets/b{i}/metacache/o-{i}/blk{j}": _payload(50 + i * j, i * 7 + j)
            for i in range(3) for j in range(2)}
    for i, (path, data) in enumerate(docs.items()):
        (jl if i % 2 else tl).write_sys_config(path, data)
    for layer in (jl, tl):
        assert {p: layer.read_sys_config(p) for p in docs} == docs
    assert tl.list_sys_config("buckets/b1") == jl.list_sys_config("buckets/b1") == \
        sorted(p for p in docs if p.startswith("buckets/b1/"))
    stale = os.path.join(paths[1], ".mtpu.sys", "config", next(iter(docs)))
    planes.settle()
    with open(stale, "wb") as f:
        f.write(b"stale")
    assert tl.read_sys_config(next(iter(docs))) == docs[next(iter(docs))]
    planes.settle()
    assert open(stale, "rb").read() == docs[next(iter(docs))]   # repaired
    tl.delete_sys_config(next(iter(docs)))
    for layer in (jl, tl):
        with pytest.raises(Exception) as ei:
            layer.read_sys_config(next(iter(docs)))
        assert type(ei.value).__name__ == "FileNotFound"


def test_synthetic_bucket_equals_jax(tmp_path):
    jd = [JaxDrive(str(tmp_path / "j" / f"d{i}")) for i in range(2)]
    td = [TorchDrive(str(tmp_path / "t" / f"d{i}")) for i in range(2)]
    for d in jd + td:
        d.make_vol(BUCKET)
    jax_synth(jd, BUCKET, 2100)
    torch_synth(td, BUCKET, 2100)
    for a, b in zip(jd, td):
        want = [(e.name, e.meta) for e in a.walk_dir(BUCKET)]
        assert [(e.name, e.meta) for e in b.walk_dir(BUCKET)] == want
        assert len(want) == 2100 and want[-1][0] == "p002/o002099"


# -- the streamed walk: O(page) parsing (tests/test_streamed_listing.py) --

N_OBJECTS = 600
N_DRIVES = 4


@pytest.fixture(scope="module")
def big_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("drives")
    drives = [TorchDrive(str(root / f"d{i}")) for i in range(N_DRIVES)]
    es = TorchObjects(drives, parity=1, block_size=1 << 16, device="cpu")
    es.make_bucket("big")
    for i in range(N_OBJECTS):
        es.put_object("big", f"obj/{i:06d}", io.BytesIO(b"x"), 1)
    return es


@pytest.fixture
def parse_counter(monkeypatch):
    counter = {"n": 0}
    orig = torch_xlm.XLMeta.parse.__func__

    def counting(cls, raw):
        counter["n"] += 1
        return orig(cls, raw)

    monkeypatch.setattr(torch_xlm.XLMeta, "parse", classmethod(counting))
    return counter


def test_page_parses_o_page_journals(big_set, parse_counter):
    res = big_set.list_objects("big", max_keys=50)
    assert len(res.objects) == 50 and res.is_truncated
    assert res.objects[0].name == "obj/000000"
    assert parse_counter["n"] <= N_DRIVES * 50 * 6
    assert parse_counter["n"] < N_DRIVES * N_OBJECTS / 2


def test_stream_is_lazy(big_set, parse_counter):
    stream = big_set.stream_journals("big")
    for _ in range(10):
        next(stream)
    assert parse_counter["n"] <= N_DRIVES * (10 + 32 + 10)
    stream.close()


def test_marker_resume_skips_without_parsing(big_set, parse_counter):
    stream = big_set.stream_journals("big", start_after="obj/000550")
    names = [n for n, _m in stream]
    assert names == [f"obj/{i:06d}" for i in range(551, N_OBJECTS)]
    assert parse_counter["n"] <= N_DRIVES * (N_OBJECTS - 551 + 2)


def test_pagination_equivalence_with_materialized(big_set):
    to_info = lambda n, fi: torch_listing.fi_to_object_info("big", n, fi)  # noqa: E731
    for kwargs in ({"max_keys": 37}, {"marker": "obj/000100", "max_keys": 10},
                   {"prefix": "obj/0001", "max_keys": 1000},
                   {"delimiter": "/", "max_keys": 10}):
        pfx = kwargs.get("prefix", "")
        a = torch_listing.paginate_objects(big_set.stream_journals("big", pfx),
                                           to_info, **kwargs)
        b = torch_listing.paginate_objects(big_set.merged_journals("big", pfx),
                                           to_info, **kwargs)
        assert _view(a) == _view(b)


def test_full_listing_paged_is_complete(big_set):
    seen, marker = [], ""
    while True:
        res = big_set.list_objects("big", marker=marker, max_keys=97)
        seen.extend(o.name for o in res.objects)
        if not res.is_truncated:
            break
        marker = res.next_marker
    assert seen == [f"obj/{i:06d}" for i in range(N_OBJECTS)]


def test_pools_metacache_partial_bounded(tmp_path, monkeypatch):
    """A capped stream: pages within the cap hit the cache, pages past it
    walk, and every page stays right."""
    s1 = TorchSets([TorchDrive(str(tmp_path / f"d{i}")) for i in range(4)], parity=1,
                   device="cpu")
    pools = TorchPools([s1])
    monkeypatch.setattr(TorchPools, "METACACHE_MAX_ENTRIES", 40)
    monkeypatch.setattr(TorchPools, "METACACHE_MAX_STREAM", 40)
    pools.make_bucket("pbkt")
    for i in range(120):
        pools.put_object("pbkt", f"k{i:04d}", io.BytesIO(b"x"), 1)
    names, marker = [], ""
    while True:
        res = pools.list_objects("pbkt", marker=marker, max_keys=25)
        names.extend(o.name for o in res.objects)
        if not res.is_truncated:
            break
        marker = res.next_marker
    assert names == [f"k{i:04d}" for i in range(120)]
    assert pools.metacache.hits >= 1
    assert pools.metacache.misses >= 1
    pools.close()


def test_lexicographic_order_with_dot_and_nested_keys(tmp_path):
    drives = [TorchDrive(str(tmp_path / f"d{i}")) for i in range(4)]
    es = TorchObjects(drives, parity=1, block_size=1 << 16, device="cpu")
    es.make_bucket("lex")
    keys = ["a/b", "a.txt", "a0", "a/c", "a", "a-1", "b/x/y", "b.z"]
    for k in keys:
        es.put_object("lex", k, io.BytesIO(b"p"), 1)
    want = sorted(keys)
    for d in drives:
        assert [e.name for e in d.walk_dir("lex")] == want
    assert [o.name for o in es.list_objects("lex", max_keys=1000).objects] == want
    seen, marker = [], ""
    while True:
        page = es.list_objects("lex", marker=marker, max_keys=2)
        seen.extend(o.name for o in page.objects)
        if not page.is_truncated:
            break
        marker = page.next_marker
    assert seen == want
    for k in keys:
        _, stream = es.get_object("lex", k)
        assert b"".join(bytes(c) for c in stream) == b"p"


def test_corrupt_copy_is_outvoted_and_a_hung_drive_left_behind(tmp_path, monkeypatch):
    """A corrupt journal copy drops out of the merge and the other drives
    elect; a drive whose walk stalls past the deadline is left behind and
    the listing completes from the rest."""
    import threading
    import time

    drives = [TorchDrive(str(tmp_path / f"d{i}")) for i in range(4)]
    es = TorchObjects(drives, parity=1, block_size=1 << 16, device="cpu")
    es.make_bucket("cor")
    for k in ("k1", "k2", "k3"):
        es.put_object("cor", k, io.BytesIO(b"v"), 1)
    drives[1]._wal.flush()   # the journal on disk, then damaged out of band
    with open(os.path.join(drives[1].root, "cor", "k2", "meta.mp"), "r+b") as f:
        f.seek(20)
        f.write(b"\xff\xff")
    assert [n for n, _m in es.stream_journals("cor")] == ["k1", "k2", "k3"]
    release = threading.Event()
    orig = drives[2].walk_dir

    def hung(volume, prefix="", start_after=""):
        release.wait(10)
        yield from orig(volume, prefix, start_after)

    monkeypatch.setattr(drives[2], "walk_dir", hung)
    monkeypatch.setattr(es, "_walk_deadline", lambda: 0.3)
    t0 = time.perf_counter()
    assert [o.name for o in es.list_objects("cor").objects] == ["k1", "k2", "k3"]
    assert time.perf_counter() - t0 < 5
    release.set()


HANG_OBJECTS = 6000   # 47 prefetch batches of 128 per drive
HANG_DEADLINE = 2.0


def _synthetic_set(root, bucket, n):
    """A 4-drive set holding n synthetic one-byte objects (p{NNN}/o{NNNNNN})."""
    from minio_tpu_torch.utils.synthbucket import fill_drive, synthetic_journal

    drives = [TorchDrive(str(root / f"d{i}")) for i in range(4)]
    es = TorchObjects(drives, parity=1, block_size=1 << 16, device="cpu")
    es.make_bucket(bucket)
    raw = synthetic_journal(bucket)
    for d in drives:
        fill_drive(d.root, bucket, n, raw)
    return drives, es


def _timed_walk(es, bucket):
    import time

    t0 = time.perf_counter()
    names = [n for n, _m in es.stream_journals(bucket)]
    return names, time.perf_counter() - t0


def _hang_walk(monkeypatch, drive, after: int):
    """Make drive's walk_dir block after `after` entries until the returned
    event is set; `entered` is set once it blocks."""
    import threading

    release, entered = threading.Event(), threading.Event()
    orig = drive.walk_dir

    def hung(volume, prefix="", start_after=""):
        for i, e in enumerate(orig(volume, prefix, start_after)):
            if i == after:
                entered.set()
                release.wait(60)
            yield e

    monkeypatch.setattr(drive, "walk_dir", hung)
    return release, entered


def test_a_hung_drive_costs_a_long_walk_one_wait(tmp_path, monkeypatch):
    """A drive that hangs mid-walk costs the walk one deadline, not one
    wait per batch: the other drives' producers stop taking turns once
    the hung one keeps the walk's baton, and the walk lists every name
    at quorum from the rest."""
    from minio_tpu_torch.utils.synthbucket import synthetic_key

    drives, es = _synthetic_set(tmp_path, "big", HANG_OBJECTS)
    want = [synthetic_key(i) for i in range(HANG_OBJECTS)]
    names, base = _timed_walk(es, "big")
    assert names == want
    monkeypatch.setattr(es, "_walk_deadline", lambda: HANG_DEADLINE)
    release, _entered = _hang_walk(monkeypatch, drives[2], after=300)
    try:
        names, hung = _timed_walk(es, "big")
    finally:
        release.set()
    assert names == want
    # Waiting a quarter deadline for every later batch would add
    # 40+ x 0.5 s; one deadline and a slower walk fit well under this.
    assert hung < 2 * base + HANG_DEADLINE + 3, (hung, base)


def test_a_hung_walk_leaves_other_walks_alone(tmp_path, monkeypatch):
    """While one walk's producer is stuck on a hung drive holding that
    walk's baton, a walk of another set in the process runs at its own
    speed: the baton belongs to one walk."""
    hung_drives, hung_es = _synthetic_set(tmp_path / "a", "hung", 300)
    _drives, es = _synthetic_set(tmp_path / "b", "free", HANG_OBJECTS)
    for s in (hung_es, es):
        monkeypatch.setattr(s, "_walk_deadline", lambda: HANG_DEADLINE)
    names, base = _timed_walk(es, "free")
    release, entered = _hang_walk(monkeypatch, hung_drives[0], after=0)
    stuck = hung_es.stream_journals("hung")
    try:
        assert next(stuck)[0] == "p000/o000000"
        assert entered.wait(10)
        again, during = _timed_walk(es, "free")
    finally:
        release.set()
        stuck.close()
    assert again == names
    assert during < 2 * base + 2, (during, base)
