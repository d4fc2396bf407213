"""Mirrored system documents across a drive set (counterpart of
minio_tpu/erasure/sysstore.py).

Small documents (multipart session and part journals, metacache blocks)
are not striped: each is written whole to every drive, and reads elect
the content by majority, so they survive the drive losses the data path
survives. SysConfigStore keeps them under `.mtpu.sys/config/`, the JAX
package's layout, so either package reads what the other wrote.
"""

from __future__ import annotations

import hashlib

from minio_tpu_torch.erasure.metadata import parallel_map, reduce_write_quorum
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.utils import errors as se

CONFIG_PREFIX = "config"


def mirror_write_all(drives, vol: str, rel: str, data: bytes) -> list:
    """Write `data` to `vol/rel` on every drive in parallel, each with its
    own fsync (the JAX function's branch for drives without a group-commit
    WAL, which the port's drives do not have). Returns per-drive outcomes
    (None | Exception) for the caller's quorum reducer."""
    return parallel_map([lambda d=d: d.write_all(vol, rel, data) for d in drives])


class SysConfigStore:
    """Mirrored key -> bytes store over one drive set (the host class
    provides `drives` and `_write_quorum_meta()`)."""

    def read_sys_config(self, path: str) -> bytes:
        """The majority's content, with read-repair: drives whose copy is
        missing or differs get the elected content rewritten, but only
        when it holds a true write-quorum majority (a plurality among a
        minority of visible drives may be the old generation)."""
        rel = f"{CONFIG_PREFIX}/{path}"
        results = parallel_map([lambda d=d: d.read_all(SYS_VOL, rel)
                                for d in self.drives])
        tally: dict[bytes, tuple[int, bytes]] = {}
        for r in results:
            if isinstance(r, (bytes, bytearray)):
                h = hashlib.sha256(r).digest()
                n, _ = tally.get(h, (0, b""))
                tally[h] = (n + 1, bytes(r))
        if not tally:
            if all(isinstance(r, se.FileNotFound) for r in results):
                raise se.FileNotFound(path)
            raise se.InsufficientReadQuorum("", path, "no readable config copy")
        count, data = max(tally.values(), key=lambda v: v[0])
        if count >= self._write_quorum_meta():
            lag = [d for d, r in zip(self.drives, results)
                   if not (isinstance(r, (bytes, bytearray)) and bytes(r) == data)]
            if lag:
                # Best effort: a drive that fails the repair stays
                # divergent and is retried on the next read.
                parallel_map([lambda d=d: d.write_all(SYS_VOL, rel, data)
                              for d in lag])
        return data

    def write_sys_config(self, path: str, data: bytes) -> None:
        results = mirror_write_all(self.drives, SYS_VOL,
                                   f"{CONFIG_PREFIX}/{path}", data)
        reduce_write_quorum(results, self._write_quorum_meta(), SYS_VOL, path)

    def delete_sys_config(self, path: str) -> None:
        rel = f"{CONFIG_PREFIX}/{path}"
        results = parallel_map([lambda d=d: d.delete(SYS_VOL, rel)
                                for d in self.drives])
        results = [None if isinstance(r, se.FileNotFound) else r for r in results]
        reduce_write_quorum(results, self._write_quorum_meta(), SYS_VOL, path)

    def sys_config_signature(self, path: str) -> tuple:
        """Each drive's (inode, mtime, size) of the document, None where it
        has none or cannot say: every write replaces the file by a rename,
        so an equal signature means no copy was rewritten in between."""
        rel = f"{CONFIG_PREFIX}/{path}"
        sig = []
        for d in self.drives:
            try:
                sig.append(d.stat_file(SYS_VOL, rel))
            except se.StorageError:
                sig.append(None)
        return tuple(sig)

    def list_sys_config(self, prefix: str = "") -> list[str]:
        """Sorted keys under prefix, the union across drives (a key exists
        if any drive has it; stale deletes resolve on read)."""
        rel = f"{CONFIG_PREFIX}/{prefix}".rstrip("/")
        names: set[str] = set()
        for r in parallel_map([lambda d=d: _walk_names(d, rel) for d in self.drives]):
            if isinstance(r, set):
                names |= r
        strip = len(CONFIG_PREFIX) + 1
        return sorted(n[strip:] for n in names)


def _walk_names(drive, rel: str) -> set:
    out = set()
    try:
        stack = [rel]
        while stack:
            d = stack.pop()
            for name in drive.list_dir(SYS_VOL, d):
                full = f"{d}/{name}" if d else name
                if name.endswith("/"):
                    stack.append(full.rstrip("/"))
                else:
                    out.add(full)
    except (se.FileNotFound, se.VolumeNotFound):
        pass
    return out
