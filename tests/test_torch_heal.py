"""heal_object, heal_bucket and heal_objects of the port (minio_tpu_torch,
plain PyTorch on the CPU) against the JAX package's on the same drive
states.

Each case writes with one package on 12 tmp drives at EC 8+4 (64 KiB
blocks to keep the CPU run short), copies the drive tree, does the same
damage to both copies, heals one copy with the JAX package and the other
with the port, and asserts the per-drive states of the two results equal
and the two healed trees byte-equal (journals and shard files; the tmp
area and the WAL aside). Both ways: the JAX package writes and both
heal, the port writes and both heal. Every case runs twice, with both
packages' group-commit metadata plane at its default (on) and with
MTPU_METAPLANE=0 (tests/torch_planes.py): drive trees are copied and
compared with every WAL closed. The batched data plane is off, and the
JAX side writes bitrot_algorithm="mxsum256", the checksum the port
writes. Tolerance: exact bytes."""

import glob
import io
import os
import shutil

import numpy as np
import pytest

from minio_tpu.erasure.multipart import MIN_PART_SIZE
from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.erasure.pools import ErasureServerPools as JaxPools
from minio_tpu.erasure.sets import ErasureSets as JaxSets
from minio_tpu.erasure.types import CompletePart as JaxPart
from minio_tpu.erasure.types import ObjectOptions as JaxOpts
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu_torch.erasure.healing import TRANSITION_TIER_KEY
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.erasure.pools import ErasureServerPools as TorchPools
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.erasure.types import CompletePart as TorchPart
from minio_tpu_torch.erasure.types import ObjectOptions as TorchOpts
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from tests.torch_planes import planes  # noqa: F401 - the fixture

BS = 64 << 10
BUCKET = "heal"
N = 12


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _paths(root, n=N):
    return [str(root / f"d{i:02d}") for i in range(n)]


def _layer(planes, pkg, paths):
    jl, tl = planes.layers(
        paths,
        lambda: JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=BS,
                           bitrot_algorithm="mxsum256"),
        lambda: TorchObjects([TorchDrive(p) for p in paths], parity=4, block_size=BS,
                             device="cpu"))
    return jl if pkg == "jax" else tl


def _opts(pkg, **kw):
    return (JaxOpts if pkg == "jax" else TorchOpts)(**kw)


def _tree(planes, paths):
    """{(drive, relative path): bytes} of every file but the tmp area's and
    the WAL's, with every layer's WAL closed first."""
    planes.release()
    out = {}
    for i, p in enumerate(paths):
        for root, dirs, files in os.walk(p):
            rel = os.path.relpath(root, p)
            if rel.split(os.sep)[:2] in ([".mtpu.sys", "tmp"], [".mtpu.sys", "wal"]):
                dirs[:] = []
                continue
            for f in files:
                full = os.path.join(root, f)
                with open(full, "rb") as fh:
                    out[(i, os.path.relpath(full, p))] = fh.read()
    return out


def _copy(planes, paths, root):
    planes.release()   # every journal on disk, no WAL left to copy
    dst = _paths(root, len(paths))
    for a, b in zip(paths, dst):
        shutil.copytree(a, b)
    return dst


def _part_file(path, key, part=1):
    hits = glob.glob(os.path.join(path, BUCKET, key, "*", f"part.{part}"))
    return hits[0] if hits else None


def _states(res):
    return [s.state for s in res.before], [s.state for s in res.after]


def _heal_both(planes, tmp_path, paths, damage, *args, **kw):
    """Copy `paths`, apply damage(paths') to both copies, heal the first
    with the JAX package and the second with the port: -> (jax result or
    exception, port result or exception, jax paths, port paths)."""
    out = []
    for pkg in ("jax", "torch"):
        cp = _copy(planes, paths, tmp_path / f"heal-{pkg}")
        damage(cp)
        try:
            res = _layer(planes, pkg, cp).heal_object(BUCKET, *args, **kw)
        except Exception as e:  # noqa: BLE001 - compared by name below
            res = e
        out += [res, cp]
    jres, jp, tres, tp = out
    if isinstance(jres, Exception) or isinstance(tres, Exception):
        assert type(jres).__name__ == type(tres).__name__, (jres, tres)
    else:
        assert _states(jres) == _states(tres)
        assert (jres.purged, jres.dry_run, jres.version_id) == \
            (tres.purged, tres.dry_run, tres.version_id)
    return jres, tres, jp, tp


def _written(planes, tmp_path, writer, objects, versioned=False):
    """Write {key: payload} with `writer`; -> (paths, {key: version id})."""
    paths = _paths(tmp_path / "orig")
    layer = _layer(planes, writer, paths)
    layer.make_bucket(BUCKET)
    vids = {}
    for key, data in objects.items():
        info = layer.put_object(BUCKET, key, io.BytesIO(data), len(data),
                                _opts(writer, versioned=versioned))
        vids[key] = info.version_id
    return paths, vids


def _flip(path, at=100):
    raw = bytearray(open(path, "rb").read())
    raw[at] ^= 0x5A
    open(path, "wb").write(bytes(raw))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


# -- heal_object per drive state --

DAMAGE = {
    # drives -> what happens to the object's part file on each
    "missing": lambda p: shutil.rmtree(os.path.dirname(p)),
    "corrupt": _flip,
    "truncated": _truncate,
}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind,deep", [("missing", False), ("corrupt", True),
                                       ("truncated", False), ("corrupt", False)])
def test_heal_object_per_drive_state(tmp_path, planes, writer, kind, deep):
    """Missing, corrupt and truncated shards on 3 drives: both packages
    classify them alike and rebuild byte-equal files; a flipped byte is
    seen by the deep scan only."""
    data = _payload((1 << 20) + 12345, 1)
    paths, _ = _written(planes, tmp_path, writer, {"obj": data})
    before = _tree(planes, paths)

    def damage(cp):
        for i in (1, 5, 9):
            DAMAGE[kind](_part_file(cp[i], "obj"))

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "obj", scan_deep=deep)
    assert _tree(planes, jp) == _tree(planes, tp)
    if kind == "corrupt" and not deep:
        assert tres.healed_count == 0
    else:
        assert tres.healed_count == 3
        assert _tree(planes, tp) == before
    info, it = _layer(planes, "jax", tp).get_object(BUCKET, "obj")
    assert b"".join(bytes(c) for c in it) == data


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heal_inline_object(tmp_path, planes, writer):
    """An inline object's journal lost on 3 drives comes back with shard
    index pos + 1, as the JAX heal writes it, byte-equal in both."""
    data = _payload(3000, 2)
    paths, _ = _written(planes, tmp_path, writer, {"tiny": data})

    def damage(cp):
        for i in (0, 4, 7):
            shutil.rmtree(os.path.join(cp[i], BUCKET, "tiny"))

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "tiny")
    assert tres.healed_count == 3
    assert _tree(planes, jp) == _tree(planes, tp)
    for pkg in ("jax", "torch"):
        _info, it = _layer(planes, pkg, tp).get_object(BUCKET, "tiny")
        assert b"".join(bytes(c) for c in it) == data


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heal_delete_marker(tmp_path, planes, writer):
    """A delete marker that 3 drives missed is healed onto them (a
    journal-only heal), where the port used to answer ObjectNotFound."""
    data = _payload(200 << 10, 3)
    paths, _ = _written(planes, tmp_path, writer, {"obj": data}, versioned=True)
    planes.release()
    saved = {i: open(os.path.join(paths[i], BUCKET, "obj", "meta.mp"), "rb").read()
             for i in (2, 3, 11)}
    layer = _layer(planes, writer, paths)
    marker = layer.delete_object(BUCKET, "obj", _opts(writer, versioned=True))
    assert marker.delete_marker
    planes.release()
    for i, raw in saved.items():          # these drives never saw the marker
        open(os.path.join(paths[i], BUCKET, "obj", "meta.mp"), "wb").write(raw)

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, lambda cp: None, "obj")
    assert tres.version_id == marker.version_id
    assert [s.state for s in tres.before].count("missing") == 3
    assert all(s.state == "ok" for s in tres.after)
    assert _tree(planes, jp) == _tree(planes, tp)
    for i in saved:                       # the marker is now their latest
        with planes.drive(TorchDrive, tp[i]) as d:
            fi = d.read_version(BUCKET, "obj")
        assert fi.deleted and fi.version_id == marker.version_id


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heal_multipart_object(tmp_path, planes, writer):
    """A 3-part object with its part files lost on 4 drives."""
    paths = _paths(tmp_path / "orig")
    layer = _layer(planes, writer, paths)
    layer.make_bucket(BUCKET)
    parts = [_payload(MIN_PART_SIZE, 10), _payload(MIN_PART_SIZE, 11),
             _payload(70_000, 12)]
    uid = layer.new_multipart_upload(BUCKET, "mp")
    etags = [layer.put_object_part(BUCKET, "mp", uid, n, io.BytesIO(p), len(p)).etag
             for n, p in enumerate(parts, 1)]
    Part = JaxPart if writer == "jax" else TorchPart
    layer.complete_multipart_upload(BUCKET, "mp", uid,
                                    [Part(n, e) for n, e in enumerate(etags, 1)])
    before = _tree(planes, paths)

    def damage(cp):
        for i in (0, 3, 6, 10):
            shutil.rmtree(os.path.dirname(_part_file(cp[i], "mp")))

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "mp")
    assert tres.healed_count == 4
    assert _tree(planes, jp) == _tree(planes, tp) == before


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heal_noncurrent_version_by_id(tmp_path, planes, writer):
    paths = _paths(tmp_path / "orig")
    layer = _layer(planes, writer, paths)
    layer.make_bucket(BUCKET)
    old, new = _payload(300 << 10, 20), _payload(150 << 10, 21)
    v1 = layer.put_object(BUCKET, "v", io.BytesIO(old), len(old),
                          _opts(writer, versioned=True)).version_id
    layer.put_object(BUCKET, "v", io.BytesIO(new), len(new),
                     _opts(writer, versioned=True))
    before = _tree(planes, paths)
    with planes.drive(TorchDrive, paths[0]) as d:
        fi = d.read_version(BUCKET, "v", v1)

    def damage(cp):
        for i in (1, 2):
            shutil.rmtree(os.path.join(cp[i], BUCKET, "v", fi.data_dir))

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "v", v1)
    assert tres.version_id == v1 and tres.healed_count == 2
    assert _tree(planes, jp) == _tree(planes, tp) == before


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dry_run_changes_nothing(tmp_path, planes, writer):
    paths, _ = _written(planes, tmp_path, writer, {"obj": _payload(400 << 10, 4)})

    def damage(cp):
        for i in (2, 8):
            shutil.rmtree(os.path.dirname(_part_file(cp[i], "obj")))

    damaged = _copy(planes, paths, tmp_path / "damaged")
    damage(damaged)
    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "obj", dry_run=True)
    assert tres.dry_run and tres.healed_count == 0
    # A journal without its part file classifies corrupt, in both.
    assert [s.state for s in tres.before].count("corrupt") == 2
    assert _tree(planes, jp) == _tree(planes, tp) == _tree(planes, damaged)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("remove_dangling", [True, False])
def test_dangling_object(tmp_path, planes, writer, remove_dangling):
    """Journal gone from 5 drives (> parity 4): both packages purge it,
    or, with remove_dangling=False, both raise InsufficientReadQuorum."""
    paths, _ = _written(planes, tmp_path, writer, {"obj": _payload(300 << 10, 5),
                                           "keep": _payload(1000, 6)})

    def damage(cp):
        for i in range(5):
            shutil.rmtree(os.path.join(cp[i], BUCKET, "obj"))

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "obj",
                                    remove_dangling=remove_dangling)
    assert _tree(planes, jp) == _tree(planes, tp)
    if remove_dangling:
        assert tres.purged and jres.purged
        assert not any(k[1].startswith(f"{BUCKET}/obj") for k in _tree(planes, tp))
        for pkg in ("jax", "torch"):
            with pytest.raises(Exception) as ei:
                _layer(planes, pkg, tp).get_object_info(BUCKET, "obj")
            assert type(ei.value).__name__ == "ObjectNotFound"
    else:
        assert type(tres).__name__ == "InsufficientReadQuorum"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_unhealable_but_not_dangling_raises(tmp_path, planes, writer):
    """Shard files gone from 5 drives, journals kept: not dangling, so
    both raise InsufficientReadQuorum and purge nothing."""
    paths, _ = _written(planes, tmp_path, writer, {"obj": _payload(300 << 10, 7)})

    def damage(cp):
        for i in range(5):
            shutil.rmtree(os.path.dirname(_part_file(cp[i], "obj")))

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "obj")
    assert type(tres).__name__ == "InsufficientReadQuorum"
    assert _tree(planes, jp) == _tree(planes, tp)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_transitioned_stub_heals_journal_only(tmp_path, planes, writer):
    """A version whose data moved to a remote tier (the transition key, no
    data dir), with its journal gone from 5 drives: healed journal-only,
    never reconstructed and never purged as dangling."""
    paths, _ = _written(planes, tmp_path, writer, {"obj": _payload(300 << 10, 8)})
    for p in paths:
        with planes.drive(TorchDrive, p) as d:
            fi = d.read_version(BUCKET, "obj")
            shutil.rmtree(os.path.join(p, BUCKET, "obj", fi.data_dir))
            fi.data_dir = ""
            fi.metadata[TRANSITION_TIER_KEY] = "WARM"
            d.write_metadata(BUCKET, "obj", fi)

    def damage(cp):
        for i in range(5):
            shutil.rmtree(os.path.join(cp[i], BUCKET, "obj"))

    jres, tres, jp, tp = _heal_both(planes, tmp_path, paths, damage, "obj")
    assert not tres.purged and tres.healed_count == 5
    assert _tree(planes, jp) == _tree(planes, tp)
    planes.release()
    assert all(os.path.exists(os.path.join(p, BUCKET, "obj", "meta.mp")) for p in tp)


# -- heal_bucket and heal_objects --

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heal_bucket(tmp_path, planes, writer):
    paths, _ = _written(planes, tmp_path, writer, {"a": _payload(1000, 9)})

    def damage(cp):
        for i in (2, 5):
            shutil.rmtree(os.path.join(cp[i], BUCKET))

    out = {}
    for pkg in ("jax", "torch"):
        cp = _copy(planes, paths, tmp_path / f"bucket-{pkg}")
        damage(cp)
        res = _layer(planes, pkg, cp).heal_bucket(BUCKET)
        out[pkg] = (_states(res), res.heal_type, cp)
    assert out["jax"][:2] == out["torch"][:2]
    before, after = out["torch"][0]
    assert before.count("missing") == 2 and set(after) == {"ok"}
    planes.release()
    assert all(os.path.isdir(os.path.join(p, BUCKET)) for p in out["torch"][2])
    assert _tree(planes, out["jax"][2]) == _tree(planes, out["torch"][2])


def _two_set_layers(pkg, paths):
    if pkg == "jax":
        return JaxSets([JaxDrive(p) for p in paths], set_drive_count=6, parity=2,
                       block_size=BS, bitrot_algorithm="mxsum256")
    return TorchSets([TorchDrive(p) for p in paths], set_drive_count=6, parity=2,
                     block_size=BS, device="cpu")


@pytest.mark.parametrize("top", ["sets", "pools"])
def test_heal_objects_over_sets_and_pools(tmp_path, planes, top):
    """heal_objects over a prefix on 2 sets of 6 (and on 2 pools of them):
    both packages heal the same names in the same order, with the same
    drive states, and leave byte-equal trees."""
    n_pools = 2 if top == "pools" else 1
    roots = [_paths(tmp_path / f"orig{p}") for p in range(n_pools)]

    def build(pkg, rs):
        def make(pkg):
            sets = [_two_set_layers(pkg, r) for r in rs]
            if top == "sets":
                return sets[0]
            return (JaxPools if pkg == "jax" else TorchPools)(sets)

        jl, tl = planes.layers([p for r in rs for p in r],
                               lambda: make("jax"), lambda: make("torch"))
        return jl if pkg == "jax" else tl

    layer = build("torch", roots)
    layer.make_bucket(BUCKET)
    keys = [f"pre/{i:02d}" for i in range(10)] + ["other/x"]
    for i, key in enumerate(keys):
        data = _payload(20_000 + 7000 * i, 30 + i)
        layer.put_object(BUCKET, key, io.BytesIO(data), len(data))
    results = {}
    for pkg in ("jax", "torch"):
        cps = [_copy(planes, r, tmp_path / f"objs-{pkg}-{p}") for p, r in enumerate(roots)]
        for cp in cps:
            for i in (1, 7):
                for obj_dir in glob.glob(os.path.join(cp[i], BUCKET, "pre", "*")):
                    shutil.rmtree(obj_dir)
        lay = build(pkg, cps)
        got = list(lay.heal_objects(BUCKET, "pre/"))
        results[pkg] = ([(r.object, _states(r)) for r in got], cps)
    assert results["jax"][0] == results["torch"][0]
    names = [n for n, _ in results["torch"][0]]
    assert sorted(names) == keys[:10]
    for pj, pt in zip(results["jax"][1], results["torch"][1]):
        assert _tree(planes, pj) == _tree(planes, pt)
