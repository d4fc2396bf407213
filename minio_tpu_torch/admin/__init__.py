"""Admin plane of the port: the /minio/admin/v3 API, trace pubsub, HTTP
stats, Prometheus metrics and profiling (counterpart of
minio_tpu/admin/, less its config KV subsystem, which comes with the
crypto slice; ROADMAP.md).
"""

from minio_tpu_torch.admin.pubsub import PubSub
from minio_tpu_torch.admin.stats import HTTPStats

__all__ = ["PubSub", "HTTPStats"]
