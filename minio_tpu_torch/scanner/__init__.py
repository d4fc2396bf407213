"""Background data scanner, usage accounting, ILM lifecycle evaluation and
tiers (counterpart of minio_tpu/scanner/; reference cmd/data-scanner.go,
cmd/data-usage-cache.go, pkg/bucket/lifecycle, cmd/bucket-lifecycle.go).
"""

from minio_tpu_torch.scanner.lifecycle import Lifecycle, parse_lifecycle_xml
from minio_tpu_torch.scanner.scanner import DataScanner
from minio_tpu_torch.scanner.usage import DataUsageCache, UsageEntry

__all__ = ["Lifecycle", "parse_lifecycle_xml", "DataScanner",
           "DataUsageCache", "UsageEntry"]
