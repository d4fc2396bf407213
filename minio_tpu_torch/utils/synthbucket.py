"""Synthetic-namespace builder for listing tests and the smoke's listing
phase (the port's copy of minio_tpu/utils/synthbucket.py): fans one
serialized inline journal out to N objects per drive directly on disk (the
journal body does not embed the object name, which is a storage-call
parameter), so a bucket of 100k+ objects appears in seconds instead of
minutes through put_object. The layout and the journal bytes are the JAX
function's, so both packages list the same bucket."""

from __future__ import annotations

import os
import subprocess
import sys

from minio_tpu_torch.storage.fileinfo import FileInfo, PartInfo
from minio_tpu_torch.storage.xlmeta import XLMeta


def synthetic_journal(bucket: str) -> bytes:
    """The one-byte inline object's journal every synthetic key carries."""
    fi = FileInfo.new(bucket, "x")
    fi.size, fi.inline_data, fi.data_dir = 1, b"x", ""
    fi.mod_time = 1700000000.0
    fi.metadata = {"etag": "0" * 32}
    fi.parts = [PartInfo(1, 1, 1, fi.mod_time)]
    journal = XLMeta()
    journal.add_version(fi)
    return journal.serialize()


def synthetic_key(i: int) -> str:
    return f"p{i // 1000:03d}/o{i:06d}"


def fill_drive(root: str, bucket: str, n_objects: int, raw: bytes) -> None:
    """One drive's share of make_synthetic_bucket."""
    broot = os.path.join(root, bucket)
    for p in range(-(-n_objects // 1000)):
        os.makedirs(os.path.join(broot, f"p{p:03d}"), exist_ok=True)
    # One mkdir and one open/write/close of raw syscalls per object:
    # buffered io doubles the wall time at this file count.
    for i in range(n_objects):
        odir = os.path.join(broot, synthetic_key(i))
        os.mkdir(odir)
        fd = os.open(os.path.join(odir, "meta.mp"), os.O_WRONLY | os.O_CREAT, 0o644)
        os.write(fd, raw)
        os.close(fd)


def make_synthetic_bucket(drives, bucket: str, n_objects: int) -> None:
    """Write n_objects inline-object journals under every drive's bucket
    dir, two levels deep (p{NNN}/o{NNNNNN}, 1000 keys per prefix, to keep
    each directory's entry count sane). The bucket volume must exist.
    Each drive is filled by a child interpreter of its own, all at once:
    threads in one process fill drives no faster than one thread (the
    interpreter lock changes hands at every syscall), while processes run
    side by side."""
    raw = synthetic_journal(bucket)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from minio_tpu_torch.utils.synthbucket import fill_drive; "
            "fill_drive(sys.argv[2], sys.argv[3], int(sys.argv[4]), "
            "bytes.fromhex(sys.argv[5]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, pkg_root, d.root, bucket,
                               str(n_objects), raw.hex()]) for d in drives]
    failed = [p.args[3] for p in procs if p.wait() != 0]
    if failed:
        raise OSError(f"synthetic bucket fill failed on {failed}")
