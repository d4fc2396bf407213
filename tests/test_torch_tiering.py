"""ILM tiers of the port (minio_tpu_torch/scanner/tiers.py and the object
layer's transition_version / restore_transitioned) against the JAX
package's, on the CPU.

- transition, read-through (whole and ranged) and restore, through an FS
  tier and through an S3 tier served by a port server on localhost, the
  transition made by the scanner under a Transition rule;
- the stub journals a transition leaves are byte-equal to the JAX ones
  (both packages transition copies of the same drive directories);
- a version the JAX package transitioned is read through and restored by
  the port, and the JAX package reads what the port restored;
- the transition's TOCTOU guard: a client overwrite between the tier
  copy and the stub commit keeps the new version and removes the tier
  copy; a restore raced the same way keeps the client's write; the
  conditional write's guard holds on every commit path (streamed, inline,
  multipart);
- POST ?restore over HTTP answers as the JAX server does.

Planes off (MTPU_METAPLANE=0, MTPU_BATCHED_DATAPLANE=0); the JAX side
writes mxsum256. Tolerance: exact bytes.
"""

import glob
import io
import os
import shutil
import time

import numpy as np
import pytest

from minio_tpu.erasure.pools import ErasureServerPools as JaxPools
from minio_tpu.erasure.sets import ErasureSets as JaxSets
from minio_tpu.scanner import tiers as jtiers
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu_torch.bucket.meta import BucketMetadataSys as TorchMeta
from minio_tpu_torch.erasure.pools import ErasureServerPools as TorchPools
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.erasure.types import CompletePart, ObjectOptions
from minio_tpu_torch.scanner import scanner as tscan
from minio_tpu_torch.scanner import tiers as ttiers
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.utils import errors as tse
from tests.conftest import S3_ACCESS, S3_SECRET
from tests.torch_atrest import JaxServer, client, port_server

BS = 64 << 10
DAY = 86400.0
BUCKET = "tiered"
LC = (b"<LifecycleConfiguration><Rule><ID>cold</ID><Status>Enabled</Status>"
      b"<Filter><Prefix></Prefix></Filter><Transition><Days>1</Days>"
      b"<StorageClass>%s</StorageClass></Transition></Rule></LifecycleConfiguration>")


@pytest.fixture(autouse=True)
def _planes_off(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    yield
    ttiers.set_global(None)
    jtiers.set_global(None)


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _paths(root, n=6):
    return [str(root / f"d{i}") for i in range(n)]


def _torch(paths):
    return TorchPools([TorchSets([TorchDrive(p) for p in paths], parity=2,
                                 block_size=BS, device="cpu")])


def _jax(paths):
    return JaxPools([JaxSets([JaxDrive(p) for p in paths], parity=2, block_size=BS,
                             bitrot_algorithm="mxsum256")])


def _read(layer, key, offset=0, length=-1, bucket=BUCKET):
    _info, it = layer.get_object(bucket, key, offset, length)
    return b"".join(bytes(c) for c in it)


def _shard_bytes(paths, key, bucket=BUCKET):
    return sum(os.path.getsize(f) for p in paths
               for f in glob.glob(os.path.join(p, bucket, key, "*", "part.*")))


def _journals(paths, key, bucket=BUCKET):
    return [open(os.path.join(p, bucket, key, "meta.mp"), "rb").read() for p in paths]


@pytest.fixture(params=["fs", "s3"])
def tier(request, tmp_path):
    """The tier "COLD": a directory, or a bucket (with a key prefix) of a
    port server on localhost."""
    if request.param == "fs":
        yield ttiers.FSTier("COLD", str(tmp_path / "cold")), None
        return
    srv = port_server(_paths(tmp_path / "remote", 4))
    try:
        client(srv.url).put("/warm")
        yield ttiers.S3Tier("COLD", srv.url, S3_ACCESS, S3_SECRET, "warm", "pre/"), srv
    finally:
        srv.close()


def test_scanner_transition_read_through_restore(tmp_path, tier):
    t, remote = tier
    paths = _paths(tmp_path)
    pools = _torch(paths)
    reg = ttiers.TierRegistry(pools)
    reg.add(t)
    ttiers.set_global(reg)
    meta = TorchMeta(pools)
    pools.make_bucket(BUCKET)
    meta.update(BUCKET, lifecycle_xml=LC % b"COLD")
    data = _payload(300_000, 1)
    small = _payload(5_000, 2)   # inline: too small to tier
    pools.put_object(BUCKET, "big", io.BytesIO(data), len(data))
    pools.put_object(BUCKET, "small", io.BytesIO(small), len(small))
    assert _shard_bytes(paths, "big") > 0
    tscan.DataScanner(pools, meta).scan_once(now=time.time() + 2 * DAY)
    info = pools.get_object_info(BUCKET, "big")
    assert info.size == len(data) and info.storage_class == "COLD"
    assert info.user_defined[ttiers.TRANSITION_TIER] == "COLD"
    assert info.user_defined[ttiers.TRANSITION_KEY] == f"{BUCKET}/big/null"
    assert _shard_bytes(paths, "big") == 0          # only the stub is local
    assert ttiers.TRANSITION_TIER not in pools.get_object_info(BUCKET, "small").user_defined
    if remote is not None:   # the tier bucket holds the stored bytes
        _i, it = remote.obj.get_object("warm", f"pre/{BUCKET}/big/null")
        assert b"".join(bytes(c) for c in it) == data
    assert _read(pools, "big") == data
    for off, ln in ((0, 1), (1000, 70_000), (299_999, 1), (65_536, 131_072)):
        assert _read(pools, "big", off, ln) == data[off:off + ln]
    # A second cycle leaves a transitioned version alone.
    tscan.DataScanner(pools, meta).scan_once(now=time.time() + 4 * DAY)
    assert _read(pools, "big") == data
    pools.restore_transitioned(BUCKET, "big")
    info = pools.get_object_info(BUCKET, "big")
    assert not any(k.startswith("x-mtpu-internal-transition") for k in info.user_defined)
    assert _shard_bytes(paths, "big") > 0 and _read(pools, "big") == data
    with pytest.raises(ttiers.TierError):   # the tier copy is gone
        b"".join(t.get(f"{BUCKET}/big/null"))
    pools.restore_transitioned(BUCKET, "big")   # nothing left to restore
    pools.close()


def test_stub_journals_equal_jax(tmp_path):
    src = _paths(tmp_path / "src")
    jl = _jax(src)
    jl.make_bucket(BUCKET)
    data = _payload(400_000, 3)
    jl.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    jl.close()
    shutil.copytree(tmp_path / "src", tmp_path / "j")
    shutil.copytree(tmp_path / "src", tmp_path / "t")
    jp, tp = _paths(tmp_path / "j"), _paths(tmp_path / "t")
    jl, tl = _jax(jp), _torch(tp)
    mod = jl.get_object_info(BUCKET, "obj").mod_time
    jl.transition_version(BUCKET, "obj", "", "COLD", f"{BUCKET}/obj/null",
                          storage_class="COLD", expect_mod_time=mod)
    tl.transition_version(BUCKET, "obj", "", "COLD", f"{BUCKET}/obj/null",
                          storage_class="COLD", expect_mod_time=mod)
    assert _journals(tp, "obj") == _journals(jp, "obj")
    assert _shard_bytes(tp, "obj") == _shard_bytes(jp, "obj") == 0
    # A transition whose copy went stale aborts in both.
    for layer, err in ((jl, Exception), (tl, tse.ObjectError)):
        with pytest.raises(err):
            layer.transition_version(BUCKET, "obj", "", "COLD", "k", expect_mod_time=mod + 1)
    jl.close()
    tl.close()


def test_jax_transitioned_stub_read_and_restored_by_port(tmp_path):
    paths = _paths(tmp_path)
    cold = str(tmp_path / "cold")
    jl = _jax(paths)
    jreg = jtiers.TierRegistry(None)
    jreg.add(jtiers.FSTier("COLD", cold))
    jtiers.set_global(jreg)
    jl.make_bucket(BUCKET)
    data = _payload(250_000, 4)
    jl.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    _i, stream = jl.get_object(BUCKET, "obj")
    jreg.get("COLD").put(f"{BUCKET}/obj/null", stream)
    jl.transition_version(BUCKET, "obj", "", "COLD", f"{BUCKET}/obj/null",
                          storage_class="COLD")
    jl.close()
    tl = _torch(paths)
    treg = ttiers.TierRegistry(None)
    treg.add(ttiers.FSTier("COLD", cold))
    ttiers.set_global(treg)
    assert _read(tl, "obj") == data
    assert _read(tl, "obj", 12_345, 100_000) == data[12_345:112_345]
    tl.restore_transitioned(BUCKET, "obj")
    assert not os.path.exists(os.path.join(cold, BUCKET, "obj", "null"))
    tl.close()
    jl = _jax(paths)
    assert _read(jl, "obj") == data
    jl.close()


def test_unreachable_tier_answers_not_found(tmp_path):
    paths = _paths(tmp_path)
    pools = _torch(paths)
    reg = ttiers.TierRegistry(None)
    reg.add(ttiers.FSTier("COLD", str(tmp_path / "cold")))
    ttiers.set_global(reg)
    pools.make_bucket(BUCKET)
    data = _payload(100_000, 5)
    pools.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    pools.transition_version(BUCKET, "obj", "", "COLD", f"{BUCKET}/obj/null")
    with pytest.raises(tse.ObjectNotFound):   # the copy never reached the tier
        _read(pools, "obj")
    reg.remove("COLD", force=True)
    with pytest.raises(tse.ObjectNotFound):
        _read(pools, "obj")
    with pytest.raises(ttiers.TierError):
        reg.remove("COLD")   # without force
    pools.close()


def test_overwrite_between_tier_copy_and_stub_commit(tmp_path):
    """The scanner copies a due version to the tier, then commits the stub
    under expect_mod_time: a client PUT in between makes the commit fail,
    and the tier copy is removed."""
    paths = _paths(tmp_path)
    pools = _torch(paths)
    cold = ttiers.FSTier("COLD", str(tmp_path / "cold"))
    reg = ttiers.TierRegistry(None)
    reg.add(cold)
    ttiers.set_global(reg)
    meta = TorchMeta(pools)
    pools.make_bucket(BUCKET)
    meta.update(BUCKET, lifecycle_xml=LC % b"COLD")
    old, new = _payload(200_000, 6), _payload(180_000, 7)
    pools.put_object(BUCKET, "race", io.BytesIO(old), len(old))
    real_put = cold.put
    copied = []

    def put_then_overwrite(key, stream):
        n = real_put(key, stream)
        copied.append(os.path.exists(cold._path(key)))
        pools.put_object(BUCKET, "race", io.BytesIO(new), len(new))
        return n

    cold.put = put_then_overwrite
    tscan.DataScanner(pools, meta).scan_once(now=time.time() + 2 * DAY)
    assert copied == [True]
    info = pools.get_object_info(BUCKET, "race")
    assert ttiers.TRANSITION_TIER not in info.user_defined
    assert _read(pools, "race") == new
    assert not os.path.exists(cold._path(f"{BUCKET}/race/null"))
    pools.close()


def test_restore_never_clobbers_a_newer_write(tmp_path):
    paths = _paths(tmp_path)
    pools = _torch(paths)
    cold = ttiers.FSTier("COLD", str(tmp_path / "cold"))
    reg = ttiers.TierRegistry(None)
    reg.add(cold)
    ttiers.set_global(reg)
    pools.make_bucket(BUCKET)
    old, new = _payload(150_000, 8), _payload(90_000, 9)
    pools.put_object(BUCKET, "obj", io.BytesIO(old), len(old))
    _i, stream = pools.get_object(BUCKET, "obj")
    cold.put(f"{BUCKET}/obj/null", stream)
    pools.transition_version(BUCKET, "obj", "", "COLD", f"{BUCKET}/obj/null")
    real_get = cold.get

    def get_then_overwrite(key, offset=0, length=-1):
        pools.put_object(BUCKET, "obj", io.BytesIO(new), len(new))
        return real_get(key, offset, length)

    cold.get = get_then_overwrite
    with pytest.raises(tse.ObjectError):
        pools.restore_transitioned(BUCKET, "obj")
    assert _read(pools, "obj") == new
    pools.close()


@pytest.mark.parametrize("path", ["inline", "streamed", "multipart"])
def test_conditional_write_guard_on_every_commit_path(tmp_path, path):
    paths = _paths(tmp_path)
    pools = _torch(paths)
    pools.make_bucket(BUCKET)
    first = _payload(70_000, 10)
    pools.put_object(BUCKET, "k", io.BytesIO(first), len(first))
    mod = pools.get_object_info(BUCKET, "k").mod_time
    body = _payload({"inline": 900, "streamed": 200_000, "multipart": 5 << 20}[path], 11)

    def write(expect):
        opts = ObjectOptions(expect_mod_time=expect)
        if path != "multipart":
            return pools.put_object(BUCKET, "k", io.BytesIO(body), len(body), opts)
        up = pools.new_multipart_upload(BUCKET, "k", ObjectOptions())
        part = pools.put_object_part(BUCKET, "k", up, 1, io.BytesIO(body), len(body))
        return pools.complete_multipart_upload(BUCKET, "k", up,
                                               [CompletePart(1, part.etag)], opts)

    with pytest.raises(tse.ObjectError):
        write(mod + 5.0)
    assert _read(pools, "k") == first
    write(mod)
    assert _read(pools, "k") == body
    with pytest.raises(tse.ObjectError):   # the object vanished
        pools.delete_object(BUCKET, "k")
        write(mod)
    pools.close()


def _tiered_server(srv, root, kind):
    """Add the FS tier "COLD" to a JAX or port server and transition
    /tiered/obj there through its object layer."""
    mod = jtiers if kind == "jax" else ttiers
    srv.tiers.add(mod.FSTier("COLD", str(root / f"cold-{kind}")))
    tier = srv.tiers.get("COLD")
    _i, stream = srv.obj.get_object(BUCKET, "obj")
    tier.put(f"{BUCKET}/obj/null", stream)
    srv.obj.transition_version(BUCKET, "obj", "", "COLD", f"{BUCKET}/obj/null",
                               storage_class="COLD")


def test_restore_over_http_answers_as_jax(tmp_path):
    js = JaxServer(_paths(tmp_path / "j", 4))
    ts = port_server(_paths(tmp_path / "t", 4))
    data = _payload(200_000, 12)
    try:
        out = {}
        for kind, srv, obj_srv in (("jax", js, js.srv), ("torch", ts, ts)):
            cl = client(srv.url)
            seq = [cl.put(f"/{BUCKET}").status_code,
                   cl.put(f"/{BUCKET}/obj", data=data).status_code]
            _tiered_server(obj_srv, tmp_path, kind)
            r = cl.get(f"/{BUCKET}/obj")
            seq += [r.status_code, r.content == data, r.headers.get("x-amz-storage-class")]
            r = cl.request("GET", f"/{BUCKET}/obj", headers={"Range": "bytes=100-999"})
            seq += [r.status_code, r.content == data[100:1000]]
            for path in (f"/{BUCKET}/obj", f"/{BUCKET}/obj", f"/{BUCKET}/missing"):
                r = cl.request("POST", path, query={"restore": ""},
                               data=b"<RestoreRequest><Days>1</Days></RestoreRequest>")
                seq.append(r.status_code)
            r = cl.get(f"/{BUCKET}/obj")
            seq += [r.status_code, r.content == data]
            out[kind] = seq
        assert out["torch"] == out["jax"]
        assert out["torch"][-2:] == [200, True] and 202 in out["torch"]
    finally:
        js.close()
        ts.close()


def _sse_script(cl, srv_obj, kind, root, data, mp_parts):
    """SSE-S3 objects, one PUT and one multipart, transitioned to the FS
    tier through the object layer (their stored bytes), then read through
    the server (whole and ranged, decrypted) and restored."""
    from minio_tpu.scanner import tiers as jt

    sse = {"x-amz-server-side-encryption": "AES256"}
    out = [cl.put(f"/{BUCKET}").status_code,
           cl.put(f"/{BUCKET}/enc", data=data, headers=sse).status_code]
    r = cl.request("POST", f"/{BUCKET}/mp", query={"uploads": ""}, headers=sse)
    upload = r.content.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    etags = []
    for n, part in enumerate(mp_parts, 1):
        r = cl.put(f"/{BUCKET}/mp", query={"partNumber": str(n), "uploadId": upload},
                   data=part)
        etags.append(r.headers["ETag"])
    body = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>").encode()
    out.append(cl.request("POST", f"/{BUCKET}/mp", query={"uploadId": upload},
                          data=body).status_code)
    mod = jt if kind == "jax" else ttiers
    srv_obj.tiers.add(mod.FSTier("COLD", str(root / f"cold-{kind}")))
    tier = srv_obj.tiers.get("COLD")
    for key in ("enc", "mp"):
        _i, stream = srv_obj.obj.get_object(BUCKET, key)   # the stored bytes
        tier.put(f"{BUCKET}/{key}/null", stream)
        srv_obj.obj.transition_version(BUCKET, key, "", "COLD", f"{BUCKET}/{key}/null",
                                       storage_class="COLD")
    whole = b"".join(mp_parts)
    for key, want in (("enc", data), ("mp", whole)):
        r = cl.get(f"/{BUCKET}/{key}")
        out += [r.status_code, r.content == want,
                r.headers.get("x-amz-server-side-encryption")]
        for lo, hi in ((0, 0), (65530, 65540), (len(want) - 10, len(want) - 1)):
            r = cl.request("GET", f"/{BUCKET}/{key}",
                           headers={"Range": f"bytes={lo}-{hi}"})
            out += [r.status_code, r.content == want[lo:hi + 1]]
    for key in ("enc", "mp"):
        r = cl.request("POST", f"/{BUCKET}/{key}", query={"restore": ""})
        out.append(r.status_code)
    r = cl.get(f"/{BUCKET}/enc")
    out += [r.status_code, r.content == data]
    r = cl.get(f"/{BUCKET}/mp")   # a multipart SSE version stays on the tier
    out += [r.status_code, r.content == whole]
    return out


def test_sse_read_through_and_restore_answer_as_jax(tmp_path, monkeypatch):
    from tests import torch_atrest as ta

    monkeypatch.setenv("MTPU_KMS_KEY_FILE", ta.write_key_file(tmp_path / "kms-keys"))
    monkeypatch.setenv("MTPU_KMS_DEFAULT_KEY", "k1")
    data = _payload(300_000, 13)
    parts = [_payload(5 << 20, 14), _payload(70_000, 15)]
    got = {}
    for kind in ("jax", "torch"):
        paths = _paths(tmp_path / kind, 4)
        srv = JaxServer(paths) if kind == "jax" else port_server(paths)
        try:
            got[kind] = _sse_script(client(srv.url), srv.srv if kind == "jax" else srv,
                                    kind, tmp_path, data, parts)
        finally:
            srv.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == [200, 200, 200]
    assert got["torch"][-4:] == [200, True, 200, True]
