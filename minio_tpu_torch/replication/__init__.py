"""Cross-cluster S3 client (counterpart of minio_tpu/replication/).

Only the client has landed: `RemoteS3Client`, the fault-aware SigV4
client that the S3 tier (scanner/tiers.py) rides. The replication pool,
its intent journal and its rules come in a later slice.
"""

from minio_tpu_torch.replication.client import (  # noqa: F401
    RemoteS3Client,
    RemoteS3Error,
    RemoteS3Unreachable,
)
