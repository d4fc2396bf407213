"""IAM of the port (counterpart of minio_tpu/iam/): identities (users,
groups, service accounts, STS), policy documents and their conditions,
and request authorization. Role-equivalent of cmd/iam.go +
pkg/iam/policy."""

from minio_tpu_torch.iam.policy import Policy, PolicyArgs
from minio_tpu_torch.iam.sys import IAMSys, Identity

__all__ = ["Policy", "PolicyArgs", "IAMSys", "Identity"]
