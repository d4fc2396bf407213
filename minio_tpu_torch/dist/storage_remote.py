"""Storage RPC: StorageAPI served over the node fabric + the remote client
(counterpart of minio_tpu/dist/storage_remote.py: the same routes,
parameters and msgpack documents, so a port node and a JAX node serve
each other's drives).

Role-equivalent of cmd/storage-rest-server.go / cmd/storage-rest-client.go:
every StorageAPI method becomes one route under /rpc/storage/v1/, bodies
stream for file data, structured values ride msgpack. The client implements
StorageAPI so the erasure engine cannot tell a remote drive from a local one
— the exact seam the reference uses to make "distributed" transparent
(SURVEY §1 L1).

FileInfo crosses the wire with the same doc encoding the xl.meta journal
uses (storage/xlmeta.py), plus volume/name/fresh envelope fields.

The port's LocalDrive has entries the wire has no route for: stat_file's
(inode, mtime, size) signature, the WAL's two-phase submits
(journal_commit_async, write_all_async), meta_sig, journal_known_absent,
sys_volume, flush_wal and close_wal. A RemoteDrive answers stat_file as a
drive that cannot say (None) and lacks the rest, so its callers take
their synchronous paths or skip it (the drive's own node runs its WAL).
"""

from __future__ import annotations

import io
from typing import BinaryIO, Iterable, Iterator

from minio_tpu_torch import obs
from minio_tpu_torch.dist.rpc import RestClient, pack, unpack
from minio_tpu_torch.ops import bitrot
from minio_tpu_torch.storage.api import DiskInfo, StorageAPI, VolInfo, WalkEntry
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.storage.xlmeta import XLMeta, _doc_to_fi, _fi_to_doc
from minio_tpu_torch.utils import errors as se

PLANE = "storage"
_READAHEAD = 1 << 20  # ranged-read granularity for remote shard streams


def fi_to_wire(fi: FileInfo) -> dict:
    doc = _fi_to_doc(fi)
    doc["_vol"] = fi.volume
    doc["_name"] = fi.name
    doc["_fresh"] = fi.fresh
    return doc


def fi_from_wire(doc: dict) -> FileInfo:
    fi = _doc_to_fi(doc, doc.get("_vol", ""), doc.get("_name", ""))
    fi.fresh = bool(doc.get("_fresh", False))
    return fi


# --- server side -------------------------------------------------------------

def verify_local_file(drive: LocalDrive, volume: str, path: str, fi: FileInfo,
                      device) -> None:
    """Deep-verify every part file of `fi` on a local drive (the JAX
    LocalDrive.verify_file): raises FileNotFound or FileCorrupt."""
    from minio_tpu_torch.utils import device as device_mod

    dev = device_mod.resolve(device)
    shard_size = fi.erasure.shard_size()
    algo = next((c.algorithm for c in fi.erasure.checksums),
                bitrot.WRITE_ALGORITHM)
    for part in fi.parts:
        rel = f"{path}/{fi.data_dir}/part.{part.number}"
        with drive.read_file_stream(volume, rel) as f:
            bitrot.verify_shard_file(f, fi.erasure.shard_file_size(part.size),
                                     shard_size, algo, dev)

def storage_routes(drives: dict[str, LocalDrive], device="cuda") -> dict:
    """Build the /rpc/storage/v1/* handler table for this node's local
    drives. `drives` maps the drive's on-node path (the endpoint path part,
    e.g. "/data/disk3") to its LocalDrive; `device` verifies shard digests
    for verify_file (resolved at the first such call)."""

    def drive(params: dict) -> LocalDrive:
        d = drives.get(params.get("disk", ""))
        if d is None:
            raise se.DiskNotFound(f"no local drive {params.get('disk', '')!r}")
        return d

    def h_disk_info(p, body):
        di = drive(p).disk_info()
        # The JAX document: its error and health-metrics fields are empty
        # for a bare local drive.
        return pack({
            "total": di.total, "free": di.free, "used": di.used,
            "used_inodes": di.used_inodes, "endpoint": di.endpoint,
            "mount_path": di.mount_path, "id": di.id,
            "healing": di.healing, "error": "", "metrics": {},
        })

    def h_get_disk_id(p, body):
        return pack({"id": drive(p).get_disk_id()})

    def h_set_disk_id(p, body):
        drive(p).set_disk_id(p["id"])

    def h_read_format(p, body):
        return pack(drive(p).read_format())

    def h_write_format(p, body):
        drive(p).write_format(unpack(body.read(-1)))

    def h_make_vol(p, body):
        drive(p).make_vol(p["vol"])

    def h_list_vols(p, body):
        return pack([{"name": v.name, "created": v.created}
                     for v in drive(p).list_vols()])

    def h_stat_vol(p, body):
        v = drive(p).stat_vol(p["vol"])
        return pack({"name": v.name, "created": v.created})

    def h_delete_vol(p, body):
        drive(p).delete_vol(p["vol"], force=p.get("force") == "1")

    def h_write_all(p, body):
        drive(p).write_all(p["vol"], p["path"], body.read(-1))

    def h_read_all(p, body):
        return drive(p).read_all(p["vol"], p["path"])

    def h_delete(p, body):
        drive(p).delete(p["vol"], p["path"], recursive=p.get("rec") == "1")

    def h_list_dir(p, body):
        names = drive(p).list_dir(p["vol"], p["path"])
        count = int(p.get("count", "-1"))
        return pack(names[:count] if count > 0 else names)

    def h_create_file(p, body):
        def chunks() -> Iterator[bytes]:
            while True:
                c = body.read(1 << 20)
                if not c:
                    return
                yield c
        n = drive(p).create_file(p["vol"], p["path"], chunks())
        return pack({"n": n})

    def h_append_file(p, body):
        drive(p).append_file(p["vol"], p["path"], body.read(-1))

    def h_stat_file(p, body):
        with drive(p).read_file_stream(p["vol"], p["path"]) as f:
            f.seek(0, 2)
            return pack({"size": f.tell()})

    def h_read_file_stream(p, body):
        off = int(p.get("off", "0"))
        length = int(p.get("len", "-1"))
        f = drive(p).read_file_stream(p["vol"], p["path"])

        def gen() -> Iterator[bytes]:
            try:
                f.seek(off)
                remaining = length
                while remaining != 0:
                    take = (1 << 20) if remaining < 0 else min(1 << 20, remaining)
                    c = f.read(take)
                    if not c:
                        return
                    if remaining > 0:
                        remaining -= len(c)
                    yield c
            finally:
                f.close()
        return gen()

    def h_rename_file(p, body):
        drive(p).rename_file(p["svol"], p["spath"], p["dvol"], p["dpath"])

    def h_write_metadata(p, body):
        drive(p).write_metadata(p["vol"], p["path"],
                                fi_from_wire(unpack(body.read(-1))))

    def h_write_metadata_single(p, body):
        # `raw` IS a journal holding exactly the one version being
        # written — reconstruct fi (and the journal-cache seed) from it
        # instead of shipping the inline body twice on the wire.
        raw = body.read(-1)
        journal = XLMeta.parse(raw)
        fi = journal.to_fileinfo(p["vol"], p["path"])
        tok = drive(p).write_metadata_single(
            p["vol"], p["path"], fi, raw,
            defer_reclaim=p.get("defer") == "1")
        return pack({"token": tok or ""})

    def h_read_version(p, body):
        # Inline data always comes back, as from the JAX drive (whose
        # read_data flag selects nothing).
        fi = drive(p).read_version(p["vol"], p["path"],
                                   version_id=p.get("vid", ""))
        return pack(fi_to_wire(fi))

    def h_read_xl(p, body):
        return drive(p).read_xl(p["vol"], p["path"])

    def h_delete_version(p, body):
        drive(p).delete_version(p["vol"], p["path"],
                                fi_from_wire(unpack(body.read(-1))))

    def h_rename_data(p, body):
        tok = drive(p).rename_data(
            p["svol"], p["spath"], fi_from_wire(unpack(body.read(-1))),
            p["dvol"], p["dpath"],
            defer_reclaim=p.get("defer") == "1")
        return pack({"token": tok or ""})

    def h_commit_rename(p, body):
        drive(p).commit_rename(p.get("token", ""))

    def h_undo_rename(p, body):
        drive(p).undo_rename(p["vol"], p["path"],
                             fi_from_wire(unpack(body.read(-1))),
                             p.get("token", "") or None)

    def h_verify_file(p, body):
        d = drive(p)
        fi = fi_from_wire(unpack(body.read(-1)))
        verify_local_file(d, p["vol"], p["path"], fi, device)

    def h_check_parts(p, body):
        drive(p).check_parts(p["vol"], p["path"],
                             fi_from_wire(unpack(body.read(-1))))

    def h_walk_dir(p, body):
        def gen() -> Iterator[bytes]:
            for e in drive(p).walk_dir(p["vol"], p.get("prefix", ""),
                                       p.get("start_after", "")):
                yield pack({"n": e.name, "m": e.meta})
        return gen()

    return {name[2:]: fn for name, fn in locals().items()
            if name.startswith("h_")}


# --- client side -------------------------------------------------------------

class _RemoteFile(io.RawIOBase):
    """Seekable read-only view of a remote file via ranged read RPCs.

    BitrotReader seeks to [digest][chunk] record offsets and reads
    sequentially; a 1 MiB read-ahead buffer turns that into ~one RPC per
    MiB of shard data (the reference instead pre-computes the ranged
    ReadFileStream per part, cmd/erasure-decode.go)."""

    def __init__(self, drv: "RemoteDrive", volume: str, path: str):
        super().__init__()
        self._drv = drv
        self._volume = volume
        self._path = path
        self._pos = 0
        self._size: int | None = None
        self._buf = b""
        self._buf_off = 0
        # Fail fast (and typed) if the file is missing: mirrors local
        # open() raising FileNotFound at stream-open time.
        self._stat()

    def _stat(self) -> int:
        if self._size is None:
            doc = self._drv._client.call_msgpack(
                self._drv._path("stat_file"),
                self._drv._params(vol=self._volume, path=self._path))
            self._size = int(doc["size"])
        return self._size

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        elif whence == 2:
            self._pos = self._stat() + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        size = self._stat()
        if n is None or n < 0:
            n = max(0, size - self._pos)
        if n == 0 or self._pos >= size:
            return b""
        # Serve from buffer when possible.
        rel = self._pos - self._buf_off
        if 0 <= rel < len(self._buf):
            chunk = self._buf[rel:rel + n]
            self._pos += len(chunk)
            if len(chunk) == n:
                return chunk
            return chunk + self.read(n - len(chunk))
        # Refill.
        want = max(n, _READAHEAD)
        want = min(want, size - self._pos)
        st = self._drv._client.call(
            self._drv._path("read_file_stream"),
            self._drv._params(vol=self._volume, path=self._path,
                              off=str(self._pos), len=str(want)),
            stream=True)
        try:
            data = st.read(want)
            rest = bytearray(data)
            while len(rest) < want:
                c = st.read(want - len(rest))
                if not c:
                    break
                rest += c
            data = bytes(rest)
        finally:
            st.close()
        self._buf = data
        self._buf_off = self._pos
        chunk = data[:n]
        self._pos += len(chunk)
        return chunk


_DISK_INFO_FIELDS = tuple(DiskInfo.__dataclass_fields__)


class RemoteDrive(StorageAPI):
    """StorageAPI over the node fabric — one per (peer node, drive path)."""

    def __init__(self, client: RestClient, disk_path: str, endpoint: str = ""):
        self._client = client
        self._disk = disk_path
        self._endpoint = endpoint or f"{client.host}:{client.port}{disk_path}"
        self._disk_id = ""
        # Remote drives feed the SAME drive-latency family + storage
        # trace shape LocalDrive uses — the whole fleet as seen from this
        # node, with the fabric hop included in the duration.
        self._observe_op = obs.drive_op_observer(self._endpoint)

    def _path(self, method: str) -> str:
        return f"/rpc/{PLANE}/v1/{method}"

    def _params(self, **kw) -> dict:
        kw["disk"] = self._disk
        return kw

    def _call(self, method: str, body=None, **kw):
        return self._client.call_msgpack(self._path(method),
                                         self._params(**kw), body=body)

    # -- identity / health --

    def disk_info(self, *, with_id: bool = True) -> DiskInfo:
        doc = self._call("disk_info")
        return DiskInfo(**{k: doc[k] for k in _DISK_INFO_FIELDS if k in doc})

    def get_disk_id(self) -> str:
        doc = self._call("get_disk_id")
        self._disk_id = doc["id"]
        return self._disk_id

    def set_disk_id(self, disk_id: str) -> None:
        self._call("set_disk_id", id=disk_id)
        self._disk_id = disk_id

    def is_online(self) -> bool:
        return self._client.is_online()

    def is_local(self) -> bool:
        return False

    def endpoint(self) -> str:
        return self._endpoint

    def close(self) -> None:
        pass  # client is shared per-node; closed by the cluster

    def read_format(self) -> dict:
        return self._call("read_format")

    def write_format(self, fmt: dict) -> None:
        self._call("write_format", body=pack(fmt))

    # -- volumes --

    def make_vol(self, volume: str) -> None:
        self._call("make_vol", vol=volume)

    def list_vols(self) -> list[VolInfo]:
        return [VolInfo(**v) for v in self._call("list_vols")]

    def stat_vol(self, volume: str) -> VolInfo:
        return VolInfo(**self._call("stat_vol", vol=volume))

    def delete_vol(self, volume: str, force: bool = False) -> None:
        self._call("delete_vol", vol=volume, force="1" if force else "0")

    # -- small files --

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._call("write_all", body=data, vol=volume, path=path)

    def read_all(self, volume: str, path: str) -> bytes:
        return self._client.call(self._path("read_all"),
                                 self._params(vol=volume, path=path))

    def stat_file(self, volume: str, path: str):
        """None: the wire's stat_file answers only a size, which cannot
        tell a rewrite of the same length, so a remote drive cannot give
        the (inode, mtime, size) signature (bucket documents in a cluster
        are kept fresh by the peer plane's invalidations)."""
        return None

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        self._call("delete", vol=volume, path=path,
                   rec="1" if recursive else "0")

    def list_dir(self, volume: str, dir_path: str, count: int = -1) -> list[str]:
        return self._call("list_dir", vol=volume, path=dir_path,
                          count=str(count))

    # -- file streams --

    def create_file(self, volume: str, path: str,
                    chunks: Iterable[bytes]) -> int:
        with obs.timed_op(self._observe_op, "create_file", volume, path):
            doc = self._call("create_file", body=chunks, vol=volume,
                             path=path)
            return doc["n"]

    def append_file(self, volume: str, path: str, data: bytes) -> None:
        self._call("append_file", body=data, vol=volume, path=path)

    def read_file_stream(self, volume: str, path: str) -> BinaryIO:
        return _RemoteFile(self, volume, path)

    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None:
        self._call("rename_file", svol=src_volume, spath=src_path,
                   dvol=dst_volume, dpath=dst_path)

    # -- versioned metadata --

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call("write_metadata", body=pack(fi_to_wire(fi)),
                   vol=volume, path=path)

    def write_metadata_single(self, volume: str, path: str, fi: FileInfo,
                              raw: bytes,
                              defer_reclaim: bool = False) -> "str | None":
        """Ships ONLY the pre-serialized journal (which holds exactly
        `fi`, inline body included) — the server reconstructs fi and the
        cache seed from it — keeping the single-serialize fast path AND
        the deferred-reclaim contract over the wire (the base-class
        default would fall back to the merge path with no undo
        capsule)."""
        with obs.timed_op(self._observe_op, "write_metadata_single",
                          volume, path):
            doc = self._call("write_metadata_single", body=raw,
                             vol=volume, path=path,
                             defer="1" if defer_reclaim else "0")
            tok = (doc or {}).get("token", "")
            return tok or None

    def read_version(self, volume: str, path: str, version_id: str = "",
                     read_data: bool = False) -> FileInfo:
        with obs.timed_op(self._observe_op, "read_version", volume, path):
            doc = self._call("read_version", vol=volume, path=path,
                             vid=version_id, data="1" if read_data else "0")
            return fi_from_wire(doc)

    def read_xl(self, volume: str, path: str) -> bytes:
        return self._client.call(self._path("read_xl"),
                                 self._params(vol=volume, path=path))

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call("delete_version", body=pack(fi_to_wire(fi)),
                   vol=volume, path=path)

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str,
                    defer_reclaim: bool = False) -> "str | None":
        with obs.timed_op(self._observe_op, "rename_data",
                          dst_volume, dst_path):
            doc = self._call("rename_data", body=pack(fi_to_wire(fi)),
                             svol=src_volume, spath=src_path,
                             dvol=dst_volume, dpath=dst_path,
                             defer="1" if defer_reclaim else "0")
            tok = (doc or {}).get("token", "")
            return tok or None

    def commit_rename(self, token: str) -> None:
        self._call("commit_rename", token=token or "")

    def undo_rename(self, volume: str, path: str, fi: FileInfo,
                    token: "str | None") -> None:
        self._call("undo_rename", body=pack(fi_to_wire(fi)),
                   vol=volume, path=path, token=token or "")

    # -- verification / listing --

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep verify on the drive's node (its device hashes)."""
        self._call("verify_file", body=pack(fi_to_wire(fi)),
                   vol=volume, path=path)

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        self._call("check_parts", body=pack(fi_to_wire(fi)),
                   vol=volume, path=path)

    def walk_dir(self, volume: str, prefix: str = "",
                 start_after: str = "") -> Iterator[WalkEntry]:
        params = self._params(vol=volume, prefix=prefix)
        if start_after:
            params["start_after"] = start_after
        for doc in self._client.iter_msgpack(
                self._path("walk_dir"), params):
            yield WalkEntry(name=doc["n"], meta=doc["m"])
