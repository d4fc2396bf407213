"""Distributed plane: node-to-node RPC fabric (counterpart of
minio_tpu/dist/, on the same wire; the etcd store, federation and the
fabric over TLS are not ported yet, ROADMAP.md).

Four planes share one generic HTTP client/server pair, the reference's
layering (SURVEY §5.8; cmd/rest/client.go):

  storage  - per-drive StorageAPI served remotely (cmd/storage-rest-*.go)
  lock     - dsync NetLocker quorum locks       (cmd/lock-rest-*.go)
  peer     - control plane fan-out              (cmd/peer-rest-*.go)
  bootstrap- startup topology verification      (cmd/bootstrap-peer-server.go)

The data plane keeps the StorageAPI seam, so a remote drive is
transparent to the erasure engine: a request that lands on any node
encodes or verifies on that node's card, and the shard bytes go over the
storage plane to the drives of the other nodes.
"""

from minio_tpu_torch.dist.rpc import RestClient, sign_token, verify_token
from minio_tpu_torch.dist.server import NodeServer

__all__ = ["RestClient", "NodeServer", "sign_token", "verify_token"]
