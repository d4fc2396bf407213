#!/usr/bin/env python3
"""Chip smoke test of minio_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It needs CUDA, nvcc and no network, and
exits non-zero (printing no result) without a CUDA device or without the
package beside it. Phases, each raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the build of the hand-written kernels from minio_tpu_torch/csrc/;
2. kernels, each held byte-equal to its plain PyTorch version on the same
   inputs (tolerance: exact, all integer work) and timed with CUDA events
   (median of 20 runs after warm-up, L2 flushed and the launches queued
   behind a short device spin before each run, so host launch overhead
   stays out of the device time) beside its bound, its plain version and
   torch._int_mm (the library call that computes its main contraction:
   for K1 the bit-plane product [B*S, kin*8] @ [kin*8, t*8] before mod 2
   and repacking, checked to give K1's parity once reduced; no single call
   takes K1's per-block weights). Shapes: at EC 8+4 with 1 MiB blocks (B=16, k=8,
   S=131072), K1 gf2_matmul for encode, a 4-missing reconstruct,
   per-block weights with 3 failure patterns and a ragged S=87382, and K2
   mxsum_digest over [B*12, S] with lengths 0, 1, 513 and S among the rows
   (PUT), [B*8, S] (GET verify) and [B*4, S] (heal); the batched data
   plane's lanes, K1 encode [32, 8, 65536]->4, K1 reconstruct
   [32, 8, 16384]->4 with a decode matrix per row over 4 survivor
   patterns, K2 [128, 65536] and [128, 512] with ragged lengths; the hot
   tier's serve, K2 over the [256, 131072] window of a resident 32 MiB
   object; at EC 12+4 with 1 MiB blocks (the 16-drive sets of phase 6:
   87,382-byte chunks, K1's ragged byte path), K1 encode [16,12,87382]->4
   and a 4-missing reconstruct, K2 [256, 87382] (PUT digests) and
   [256, 87382] with 192 rows of data and 64 of length 0 (GET verify, as
   the GET path stages it); a one-drive heal's, K1 reconstruct
   [16,8,131072]->1 and K2 over the rebuilt chunks [16, 131072]; and,
   checked but not timed, fused.reconstruct_with_digests and
   reconstruct_only (K1 then K2, 4 missing) against the same compositions
   of the plain versions. Then what the plane's width gates cost: one
   lane call against the 32 per-object calls it replaces, at 16 and 64 KiB
   chunks. Then K3 mxhash256 at the bitrot phase's shapes, [192, 131072]
   (PUT), [128, 131072] (GET verify), [64, 131072] and [16, 131072]
   (heal) and [256, 87382] (EC 12+4 PUT), rows of lengths 0, 1, 503,
   504, 512, 700 and 4096 among full ones in every launch, beside its
   plain version (the chain) and, as its library yardstick, torch._int_mm
   of the data term alone ([blocks, 4096] bits x [4096, 256] int8; no
   library call computes the chain); K3 also held against the split plain
   version at the PUT shape; mxhash.encode_with_bitrot (K1 then K3)
   checked against the plain composition; and the mxsum256 and mxhash256
   keys and the table of SK powers this machine's numpy derives held
   against their pinned SHA-256;
3. S3: the port's server on 12 tmp drives (device="cuda"), driven over
   http.client with the port's SigV4 signer: PUT 256 MiB, 9 MiB + 12,345 B
   and 1 KiB objects; GET back byte-equal with ETag == md5; a ranged GET;
   4 drives' shard files copied then deleted and a degraded GET; a deep
   heal that must rebuild files byte-equal to the copies; one byte of a
   fifth drive's shard flipped, a GET that reads around it and a deep heal
   that rewrites it; then a GET with 4 OTHER drives removed;
4. the batched data plane at its defaults, through a fresh server: 64
   client threads PUT PLANE_OBJECTS objects of 1 KiB-512 KiB (log-uniform),
   GET them back byte-equal, lose 2 drives' shard files, GET those of
   16-128 KiB (up to 256) concurrently and heal one; launches < requests
   on PUT, a
   reconstruct lane launched for the degraded GETs and for the heal. The
   same traffic again with the plane off (MTPU_BATCHED_DATAPLANE=0), in
   turns on, off, and each stage's objects/s side by side;
5. the hot tier (MTPU_HOTTIER=1, 2 GiB budget): PUT ~2.5 GiB of 4-32 MiB
   objects, heat them until admission and eviction have run, then hot
   GETs byte-equal and ETag-identical to the drive path with one K2
   launch each, ranged hits, an overwrite served new, and a flipped
   resident byte falling back to the drive path;
6. multipart over erasure sets and pools (BASELINE.json configs 5 and 4):
   64 tmp drives as 4 pools of 16, each pool ErasureSets(set_drive_count=
   16) at EC 12+4, 1 MiB blocks, behind the port's S3 server over HTTP with
   SigV4. One object of MP_PARTS parts of 16 MiB (2 GiB; minio-go's
   part size) with 4 part uploads in flight (minio-go's default), its
   bytes made from --seed part by part and never held whole; a streamed GET
   compared by SHA-256, a Range GET across a part boundary, HEAD with the
   "-N" ETag, ListParts and Abort of a second upload; then 4 of the 16
   drives of the object's set wiped, a degraded GET, a deep heal whose
   rebuilt shard files must equal the originals, and a GET again. The
   object halves (down to 1 GiB) when the tmp filesystem cannot hold it.
   Its pools keep serving the object until phase 9 has listed it;
7. versioning, server-side copies, tags and conditional requests
   (versioning_phase): on 12 drives in /dev/shm at EC 8+4, a 256 MiB object PUT
   as the null version and, with the bucket's versioning enabled, 3
   times more; every version read by its id; the noncurrent one read with
   4 drives lost, deep-healed and read with 4 other drives lost; a delete
   marker and its removal; CopyObject of the noncurrent version (COPY and
   REPLACE); tags on a version; If-Match and If-None-Match; 64 clients
   PUT 64 keys x 4 versions of 1-512 KiB, ListObjectVersions walks them
   in pages of 1000 and one DeleteObjects removes 250 by VersionId; then
   on phase 6's pools, UploadPartCopy of the object's first 32 parts,
   part by part, into a versioned bucket;
8. heal (heal_phase): on 12 drives in /dev/shm at EC 8+4, the server at
   build_server's defaults (MRF on) and the auto-healer started as main()
   starts it, with a 1 s interval. 2 objects of 256 MiB, 256 warp-mix
   objects PUT by 64 clients, a multipart object of 16 parts of 16 MiB,
   64 versioned keys x 3 versions with 16 delete markers; 64 PUTs while
   2 drives refuse every call, drained by the MRF queue once they are
   back; a GET over a flipped byte and the deep heal it queued;
   heal_bucket and a dangling object purged; then live replacement: drive
   5 wiped under the running server and rebuilt by the auto-healer, its
   format.json, latest journal entries and shard files equal to a copy
   taken before, and every latest object read with 4 other drives
   removed. The phases before this one build their servers with
   enable_mrf=False and no auto-healer, so their degraded reads queue no
   background heal and their launch counts stay comparable with the
   earlier runs recorded in PERF.md;
9. listing and the bucket calls (listing_phase): 12 drives on /dev/shm
   at EC 8+4 behind the S3 server, a bucket of LIST_OBJECTS synthetic
   objects (halved down to 6,250 to fit the 1,000 s budget, and below only
   to keep the script under 1,100 s) plus 500 real
   ones PUT through the server; ListObjectsV2 over the whole bucket in
   pages of 1,000 (every name once, in order; the real objects' ETag and
   Size), a delimiter listing, a v1 marker resume, ListBuckets, GETs of
   every 50th real object, one DeleteObjects of the 500, DeleteBucket
   refused on the full bucket and done on an emptied one, then one
   ListObjectsV2 on phase 6's 4 pools naming the multipart object once;
10. bitrot (bitrot_phase, run before phase 9): every algorithm of the
   JAX registry on config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB
   blocks), each through the port's S3Server over
   ErasureSets(..., bitrot_algorithm=): one 256 MiB object under mxhash256
   and under sip256, one of 16 MiB under highwayhash256, sha256, xxh64 and
   blake2b256; PUT, GET (bytes and ETag), GET with 4 of 12 drives' shard
   files removed, a deep heal of the 4 (files equal their copies,
   verify_shard_file over each), sampled chunk digests against the plain
   versions; K3 launched once per batch (the mxhash256 PUT: as often as
   K1); the host hashes' MB/s on one thread and on 12;
11. observability and the admin plane (obs_phase, run first, right after
   the build: on the card's machine torch.profiler drops the GPU events
   of a process more than a minute or two old, their device timestamps
   drifting out of the capture's window, so the profiling route is
   checked while the process is young):
   config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB blocks, mxsum256,
   the plane at its default, MRF off) behind the port's S3 server. A
   trace subscriber streams /minio/admin/v3/trace while a 256 MiB object
   is PUT, GET and range-GET; 4 drives' shard files copied and removed, a
   degraded GET, POST /minio/admin/v3/heal/<bucket> (scanMode 2) whose
   rebuilt files must equal the copies, a GET again. The cluster and node
   scrapes pass the strict 0.0.4 parse of tests/test_observability.py;
   their minio_tpu_kernel_launches_total{backend="gpu"} per label equals
   K1's and K2's own counts over the PUT/GET stages and over the heal
   (labels to kernels as in ops/fused.py: OBS_K1, OBS_K2), their request
   counts equal the requests sent, the drive latency covers all 12 drives
   and 12 disks are online. The trace holds the PUT's http, storage and
   kernel records; perf/timeline?traceid= its stages auth, rx_drain,
   encode, commit, resp_drain. profiling/start?profilerType=cpu,device
   around one 32 MiB PUT+GET: the zip holds cpu.txt and a device trace
   naming K1's and K2's CUDA kernels. Then the cost of observing, printed
   and not gated: 3 PUTs and GETs of the 256 MiB object with no
   subscriber, with a trace subscriber and under MTPU_KERNEL_SYNC=1, and
   one PUT+GET's kernel seconds under sync (each hand-written kernel's
   device time, between events around its launch) beside torch.profiler's
   device times of K1 and K2 in another PUT+GET. After phase 10, late_profile_check asks the
   route for a device profile again, on a process by then many minutes
   old, around a 32 MiB PUT+GET on a new server: the download must hold
   an event of every K1 and K2 launch or answer InternalError saying the
   capture lost some; a 200 without them fails.

12. the metadata plane and drive resilience (meta_phase, run after
   phase 10): config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB
   blocks) behind the server at build_server's defaults (the group-commit
   metadata plane on, MRF on) with the auto-healer every 1 s. K1 at the
   PUT shape and K2 at the GET-verify shape are held against their plain
   versions and timed, and the GET verify's host path (ops/fused.py
   stage_and_digest: staging into the pinned pool, the upload, K2 and the
   download) is timed at the same shape. (a) 64 clients
   PUT 256 warp-mix objects (1-512 KiB, log-uniform) and GET them back
   byte-equal; objects/s and the node scrape's
   minio_tpu_metaplane_commits_total and _fsyncs_total deltas; (b) a child
   process runs the server's entry point (python -m
   minio_tpu_torch.s3.server) on fresh drives, 16 clients each cycle
   three keys through PUT, overwrite and delete, out of step, for
   META_CRASH_S seconds, the child is SIGKILLed, and the port mounts the
   drives (replaying their WALs): every key whose last operation was
   acknowledged reads back in that state (bytes and ETag, verified by K2;
   absent after a delete), and acknowledged overwrites and deletes must
   be among them; the replay's record count and seconds; (c) with DynamicTimeout(0.5, 0.1) on every
   drive and deadline class, one drive hung by a wrapper: first its shard
   reads (a 256 MiB GET hedges around it), then every call (a 256 MiB PUT
   and its GET at quorum); the drive walks to OFFLINE through FAULTY, in
   the scrape and in admin info; hedged reads launched and won; (d)
   released: the probe restores it, and the auto-healer rebuilds the
   shard it missed, equal to a copy of the same shard of an object of the
   same bytes taken before the hang.

13. data at rest and the config plane (atrest_phase, run after phase 12):
   config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB blocks) behind
   the server at build_server's defaults with MRF off, LocalKMS over a key
   file in the phase's directory. The AEAD provider in use is printed
   (AES-GCM from `cryptography`, else the stdlib fallback). (a) config-kv
   PUT of `storageclass standard=EC:2`, a 64 MiB PUT stored at 10+2 (its
   journal says so; K1 at [16, 10, 104858] is held and timed in phase 2),
   EC:4 restored, the server restarted over the same drives: the config
   reads back, sealed with argon2id on the drives, and one derivation's ms
   is printed; (b) one 256 MiB object under each of SSE-S3, SSE-C and
   SSE-KMS: PUT, GET and three Range GETs across 64 KiB DARE chunks and
   1 MiB blocks, each byte-equal; the SSE-KMS object read with 4 of 12
   drives' shard files removed and deep-healed, the rebuilt files equal
   to copies taken before; a 64 MiB PUT under the bucket's ?encryption
   AES256 default; (c) a 64 MiB SSE-KMS multipart upload of 4 parts of
   16 MiB, a Range GET across a part boundary, and CopyObject of the
   SSE-C object to SSE-S3; (d) `compression enable=on` and a 256 MiB
   access log: its stored/plain ratio, GET and a 1 MiB Range GET (which
   decompresses from the start). Each step's GiB/s is printed with its
   K1/K2 launches.

14. identity and access (iam_phase, run after phase 13): config 1's set
   (12 drives on /dev/shm, EC 8+4, 1 MiB blocks) behind the server at
   build_server's defaults with MRF off; the IAM store sealed on the
   drives, its load timed by a fresh IAMSys. Through the front door, as a
   non-root IAM user whose policy allows s3:* on one bucket: (a) a 256 MiB
   aws-chunked PUT in 64 KiB signed chunks (the port's signer,
   sigv4.sign_chunked, before the clock starts), then the same bytes
   header-signed: both timed, their K1/K2 launches equal, both ETags the
   payload's md5, the first chunk of every shard of each read from the
   drives with its digest equal to K2's plain version and the parity
   chunks equal to K1's plain version over the data chunks, each object
   read back byte-equal; (b) a presigned SigV4 GET and a SigV2 presigned
   GET, byte-equal and timed; (c) STS AssumeRole, a 16 MiB PUT and GET with
   the session token, and the GET without it answering InvalidToken; (d)
   a user-policy Deny and a bucket-policy Deny (binding the root) each
   answering AccessDenied to a 1 MiB PUT with no K1 or K2 launch, and an
   anonymous GET the bucket policy allows, byte-equal; (e) on a bucket
   with object lock, a COMPLIANCE version's DELETE by id answering
   AccessDenied (bypass header or not) and the version reading back, a
   GOVERNANCE version's refused without the bypass header and deleted
   with it; (f) a byte flipped in the middle chunk of an aws-chunked
   overwrite answering SignatureDoesNotMatch, the key reading as before.

15. the multi-process front door and the QoS plane (frontdoor_phase, run
   before phase 9): config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB
   blocks) behind a supervisor (frontdoor/supervisor.py, the router
   shard) and W = min(4, CPUs) workers, the metaplane and the dataplane
   at their defaults, shared lanes on, MTPU_QOS=1 with the root's two
   buckets fd-a and fd-b weighted 3:1, MTPU_HOTTIER=1 with a 64 MiB
   budget in worker 0. (a) 64 clients PUT then GET 128 warp-mix objects
   (1-512 KiB) over both buckets through the pool, then the same through
   one server process (python -m minio_tpu_torch.s3.server) on fresh
   drives: objects/s and GiB/s of each, requests per worker from
   X-Mtpu-Worker, and per worker, from its own scrape (a connection the
   router pinned to it), K1/K2 launches by label and the ring's submits,
   served and fallbacks by reason; every worker must serve, worker 0 must
   serve ring encodes and launch K1 and K2; (b) one 256 MiB PUT and GET
   through the pool (its 1 MiB blocks do not fit a slot: the worker that
   takes it launches K1 in its own CUDA context); (c) a 16 MiB object read
   whole twice by worker 0 (admitted to its tier), whole once by a
   sibling (too large for a slot: an oversize fallback), then 5 Range
   GETs of 200 KiB by the siblings, which must hit over OP_HOTGET; (d)
   worker 1 SIGKILLed with 64 small PUTs in flight (clients retry a cut
   PUT): every acknowledged PUT reads back byte-equal, the pool returns
   to W workers, respawns_total reads 1; (e) SIGTERM drain: every worker
   exits 0, every drive holds journal.w<i>.wal for each worker, each
   worker's exact launch counts come from its drain log line, and one
   server mounted on the drives reads every key back byte-equal, with
   sampled shard digests and parity equal to the plain versions.

16. the distributed cluster (cluster_phase, run before phase 9): four
   node processes of the port (python -m minio_tpu_torch.s3.server with
   the cluster's URL endpoints, each with its own CUDA context), 4 drives
   each on /dev/shm, one 16-drive set at the default parity EC:4 (12+4),
   1 MiB blocks: the upstream distributed quickstart `minio server
   http://host{1...4}/export{1...4}` at n = m = 4. Cut: the four nodes
   share one host and one card (each drive path names its node, and the
   S3 and RPC ports are free ones; the RPC port is the S3 port + 1000).
   (a) all four boot together and pass bootstrap: seconds to quorum;
   (b) one 256 MiB object PUT through node 1 and GET through node 3,
   byte-equal with the md5 as ETag; K1/K2 launches of every node by its
   scrape (node 1 must launch K1 and K2, node 3 K2); all 16 drives hold a
   shard file; the first chunk of every shard, read from the drives, with
   its digest equal to K2's plain version and the parity chunks equal to
   K1's plain version; (c) 256 warp-mix objects (1-512 KiB) PUT by 32
   clients across the 4 nodes, each read back through another node,
   objects/s both ways; (d) the script holds a dsync lock over the 4
   nodes' lock planes: top/locks of node 2 lists it and a PUT of its key
   waits for it; then 8 concurrent PUTs of one key through the 4 nodes
   leave one body whole; (e) node 4 SIGKILLed and its copy of (b)'s shard
   files removed: (b)'s object GET through node 1 byte-equal, a 16 MiB PUT
   at quorum, node 1's cluster scrape within the peer deadline counting
   the peer scrape error; node 4 restarted, a heal through it rebuilds its
   shard files equal to copies taken before the kill and the object it
   missed; (f) SIGTERM: every node exits 0 and prints its exact kernel
   launches (node 1's exact K1 less its labeled K1 is the reconstructs of
   its degraded GET, which must be launched).

17. the background plane (background_phase, run before phase 9): config
   1's set (12 drives on /dev/shm, EC 8+4, 1 MiB blocks) behind the
   server built in this process with its data scanner built as the CLI
   builds it (heal_objects on) but its loop not started: each cycle is one
   scan_once, with the scanner's pacing off (`scanner delay=0` by
   config-kv, so a cycle's seconds are its crawl's own). Event and audit
   targets are local webhooks (notify_webhook, audit_webhook by
   config-kv), the FS tier COLD lives on /dev/shm (admin `tier`). (a) a
   bucket of BG_SYNTH synthetic keys (utils/synthbucket.py, inline
   journals dated 2023) and BG_MIX warp-mix objects PUT by 16 clients; one
   cycle: its seconds and objects scanned/s, and datausageinfo's counts
   and bytes equal to what was written; (b) an Expiration rule (1 day) on
   BG_EXPIRE_PREFIX: the next cycle expires exactly its 100 keys (expired
   keys/s), every other key of their directory stays, and the event
   webhook receives one s3:ObjectRemoved:Delete from minio_tpu:ilm for
   each; (c) BG_TIER
   objects of 256 MiB under a Transition rule, the cycle at now + 2 days:
   the transition's GiB/s with K2 launched as a GET of them launches it
   and no K1, the shard files gone; a GET and a Range GET read through
   byte-equal and launch no kernel; POST ?restore answers 202 at a restore
   GiB/s whose K1/K2 equal a 256 MiB PUT's, the tier copy gone, the GET
   from the drives byte-equal, sampled digests and parity equal to the
   plain versions; (d) `heal bitrotscan=on`, one byte flipped in a shard
   file of a 64 MiB object, the synthetic bucket dropped from the drives
   (its inline keys hold no shard), every real bucket marked in the
   update tracker as a write marks it, and the usage document persisted
   one cycle short of a deep one and reloaded (a deep cycle comes every
   HEAL_EVERY_N_CYCLES-th cycle, counted from that document): the deep
   cycle rebuilds the shard equal to its copy, K2 digests at least every
   block of every real object's 12 shards (the rows counted around
   mxsum.digest), K1 reconstructs, its GiB/s verified; (e) every request's
   audit entry arrives at the audit webhook under the request id its
   answer carried. The servers that phases 12, 15 and 16 start through
   the CLI run with --scan-interval 0, so no scanner launches a kernel
   in their counts. Depth cut for phase 17 itself: 5,000 synthetic keys
   and 100 expiries (of 20,000 and 1,000; alone on the card it took 231.3
   s at those, run 68: 3 ms a key a cycle, 48 ms an expiry).

18. the SLO plane and the composed chaos plane (chaos_phase, run before
   phase 9): config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB blocks)
   behind the server's CLI in a child process (as phases 12, 15 and 16
   start it, --scan-interval 0) with MTPU_CHAOS_DRIVE_WRAP=1 (an inert
   NaughtyDisk over each drive), MTPU_FAULT_INJECTION=1 (the admin
   `faults` route), MTPU_CHAOS_SEED=--seed and its SLO ring sampled every
   second (MTPU_SLO_SAMPLE_S=1). CH_BIG objects of 64 MiB PUT first; then
   one ChaosProgram from the seed, applied over the admin route by the
   ChaosScheduler: a hang of read_file_stream on the drive holding a data
   shard of the most big objects, create_file errors on two other drives
   and a 20 ms trickle on every read of a fourth's streams, each cleared
   before the storm ends; under it, for CH_STORM_S seconds, a
   MixedWorkload of CH_CLIENTS stdlib clients (warp-mix sizes 1-512 KiB,
   deletes, lists and 5 MiB multipart uploads) recording every
   acknowledged write in a WriteLedger, and the big objects read while
   the hang holds (degraded: K1 reconstructs around the hung shard). Then
   the faults cleared and the four invariants: heal convergence (every
   drive back online, a deep heal leaving every object's shards ok, its
   seconds), zero lost and zero torn acknowledged writes, agreement of two
   connections, and the SLO check (PUT and GET p99 within CH_P99_S, 5xx
   within CH_ERR) on a window of the server's own ring read back from
   `slo/history` through window_from_ring; GET /minio/admin/v3/slo's burn
   rates and breaches printed. The server's exact K1/K2 launches come
   from its drain line (a fresh process: counted from 0 over the phase),
   the labeled ones from its scrape; K1 beyond the labeled is the
   degraded GETs' decodes and must be launched. Sampled shard digests and
   parity of the big objects and of warp-mix ones, read from the drives,
   equal the plain versions. Phase 15 also asks its pool's `slo` route,
   whose answer must merge every worker's StateSpool mailbox.

Depth cut to make room under SMOKE_BUDGET_S, no width changed: for
phase 11, phase 4 runs twice (on, off) instead of four times, phase 7
copies 32 of phase 6's parts instead of 64, and the listing phase may
halve down to 25,000 objects instead of 50,000; for phase 15, phase 6's
object is 160 parts (2.5 GiB) instead of 320, phase 8 PUTs 4 objects of
256 MiB instead of 8, and the listing phase may halve down to 12,500
objects; for phase 16, phase 6's object is 128 parts (2 GiB) instead of
160, phase 8 PUTs 2 objects of 256 MiB instead of 4 and 256 warp-mix
objects instead of 512, phases 4 and 12 PUT 256 warp-mix objects a run
instead of 512, phase 15's warp mix is 128 objects instead of 512
(through the pool and through the one process alike), and the listing
PUTs 500 real objects instead of 1,000 and may halve down to 6,250
synthetic ones (12,500). Phase 18 cut nothing else: the listing's halving
to fit SMOKE_BUDGET_S takes up its time.

The launch count of each kernel is reset just before each of phases 3-14
and 17 (each run of phase 4) and read after it (phase 15's workers, phase
16's nodes and phase 18's server count in their own processes: their
scrapes and drain logs);
the JSON line carries phase 4's
counts from its first run, the plane at its default. It prints a JSON line with every kernel's numbers at
every shape, then, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import http.client
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.parse

ACCESS, SECRET = "smokeadmin", "smokesecret123"
T_START = time.perf_counter()   # the script's start: process age in prints
MXSUM_KERNELS = ("gf2_matmul", "mxsum_digest")   # the paths of the mxsum256 phases
K, M, B, S = 8, 4, 16, 131072   # EC 8+4, 1 MiB blocks: S = 1 MiB / 8
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor rate
PLANE_OBJECTS = 256             # plane phase: small objects PUT by 64 clients, per run
PLANE_RUNS = (True, False)      # the plane on, then off
HOT_WORKING_SET = 5 << 29       # hot-tier phase: 2.5 GiB of 4-32 MiB objects
MP_PARTS, MP_PART_SIZE = 128, 16 << 20    # multipart phase: 2 GiB in 16 MiB parts
MP_INFLIGHT = 4                 # part uploads in flight
K12, M12, S12 = 12, 4, 87382    # EC 12+4, 1 MiB blocks: S = ceil(1 MiB / 12)
K10, M10, S10 = 10, 2, 104858   # storageclass EC:2 on 12 drives: S = ceil(1 MiB / 10)
VER_SIZE, VER_VERSIONS = 256 << 20, 4   # versioning phase: 4 versions of 256 MiB
VER_KEYS = 64                   # ... and 64 small keys of 4 versions, 1-512 KiB
VER_DELETE = 250                # ... of which one DeleteObjects removes 250
VER_COPY_PARTS = 32             # ... and UploadPartCopy of phase 6's first 32 parts
HEAL_BIG, HEAL_BIG_SIZE = 2, 256 << 20   # heal phase: 2 objects of 256 MiB,
HEAL_SMALL = 256                # ... 256 warp-mix objects,
HEAL_MP_PARTS = 16              # ... a multipart object of 16 parts of 16 MiB,
HEAL_VER_KEYS = 64              # ... 64 versioned keys x 3 versions,
HEAL_MRF_PUTS = 64              # ... and 64 PUTs with 2 drives refusing
BITROT_BIG, BITROT_SMALL = 256 << 20, 16 << 20   # bitrot phase: one object each
BITROT_ALGOS = (("mxhash256", BITROT_BIG), ("sip256", BITROT_BIG),
                ("highwayhash256", BITROT_SMALL), ("sha256", BITROT_SMALL),
                ("xxh64", BITROT_SMALL), ("blake2b256", BITROT_SMALL))
META_BIG = 256 << 20            # phase 12: the objects PUT and GET with a drive hung,
ATREST_BIG = 256 << 20          # phase 13: each SSE object and the compressed .log,
ATREST_SMALL = 64 << 20         # ... the EC:2 object, the bucket-default and multipart ones,
ATREST_PART = 16 << 20          # ... the multipart object's parts (4 of them)
IAM_BIG = 256 << 20             # phase 14: the aws-chunked and header-signed PUTs,
IAM_CHUNK = 64 << 10            # ... in aws-chunked chunks of minio-go's 64 KiB
META_CRASH_S = 8.0              # ... and the seconds of traffic before the SIGKILL
OBS_SIZE = 256 << 20            # obs phase: the object PUT, GET and healed
OBS_PROFILE_SIZE = 32 << 20     # ... the object PUT and GET under the profilers
OBS_RUNS = 3                    # ... PUT+GET of OBS_SIZE per observing mode
LIST_OBJECTS = 200_000          # listing phase: synthetic objects, 200 prefixes of 1000
LIST_MIN_OBJECTS = 6_250        # ... never cut below this to meet SMOKE_BUDGET_S
LIST_REAL = 500                 # ... and real objects of 1-512 KiB PUT through S3
LIST_PAGE = 1000                # ListObjectsV2 max-keys
# The listing phase's cost on the card's machine (NVIDIA H100 80GB HBM3,
# 12 drives on /dev/shm), bounded from above by this script's runs there
# at 12,500, 25,000, 50,000 and 100,000 objects (115, 156, 282-353 and
# 337 s; PERF.md 5, 6.12; the 353 s on a slower host): seconds per
# synthetic object (build, walk, removal), the rest of the phase, and
# tmpfs bytes per synthetic object (12 journal files and their
# directories, with room to spare).
LIST_S_PER_OBJECT = 0.005
LIST_FIXED_S = 110.0
LIST_BYTES_PER_OBJECT = 12 * 8192
BG_SYNTH = 5_000                # phase 17: synthetic keys scanned (inline journals),
BG_EXPIRE_PREFIX = "p003/o0030"  # ... of which this prefix's 100 expire by rule,
BG_MIX = 64                     # ... warp-mix objects (1-512 KiB) PUT by 16 clients,
BG_TIER, BG_TIER_SIZE = 2, 256 << 20   # ... objects transitioned to the FS tier,
BG_DEEP_SIZE = 64 << 20         # ... and the object whose flipped byte the deep cycle heals
NOTIFY_ILM = (b"<NotificationConfiguration><QueueConfiguration><Id>ilm</Id>"
              b"<Queue>arn:minio_tpu:sqs::webhook:webhook</Queue>"
              b"<Event>s3:ObjectRemoved:*</Event></QueueConfiguration>"
              b"</NotificationConfiguration>")
BG_EXPIRE_RULE = (b"<LifecycleConfiguration><Rule><ID>expire-p003-o0030</ID><Status>Enabled"
                  b"</Status><Filter><Prefix>" + BG_EXPIRE_PREFIX.encode() +
                  b"</Prefix></Filter><Expiration><Days>1</Days></Expiration></Rule>"
                  b"</LifecycleConfiguration>")
BG_TIER_RULE = (b"<LifecycleConfiguration><Rule><ID>cold</ID><Status>Enabled</Status>"
                b"<Filter><Prefix></Prefix></Filter><Transition><Days>1</Days>"
                b"<StorageClass>COLD</StorageClass></Transition></Rule>"
                b"</LifecycleConfiguration>")
SMOKE_BUDGET_S = 1000.0         # what the whole script should stay under
SMOKE_LIMIT_S = 1100.0          # what it must stay under: 1200 s less a margin
S3_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, flush, runs: int = 20, warm: int = 3) -> float:
    """Median device time of fn() over `runs` runs, in ms. Before each run
    the L2 cache is flushed (the caller's data is not in L2): `flush` is a
    tensor larger than L2, zeroed (which leaves L2 full of dirty lines).
    Then the card spins for ~1 ms, so the host has queued both events and
    fn's launches before the card reaches them: the time between the
    events is the card's work, not the Python launch overhead."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for moving `nbytes` through HBM and doing `ops` int8
    operations, and which of the two sets it ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gf2_bound_ms(b: int, kin: int, tout: int, s: int,
                  per_block_weights: bool = False) -> tuple[float, str]:
    """K1's bound: x in, out written, the weight read once (per block when
    per-block), against the bit contraction the TPU kernel runs."""
    w = kin * 8 * tout * 8 * (b if per_block_weights else 1)
    return _bound_ms(b * kin * s + b * tout * s + w,
                     2.0 * b * s * (kin * 8) * (tout * 8))


def _mxsum_bound_ms(n: int, s: int) -> tuple[float, str]:
    """K2's bound: data and key in, lengths and length key in, digests
    out, against 16 int8 operations per data byte."""
    return _bound_ms(n * s + 8 * s + 4 * n + 32 + 32 * n, 2.0 * n * s * 8)


def _record(kernel: str, label: str, path: str, ms: float, plain: float,
            bound: tuple[float, str], library: float | None) -> dict:
    """One entry of the result line: a kernel at one shape. `path` names
    the phase whose launch count the entry carries (s3, plane or hot)."""
    src = {"gf2_matmul": ("minio_tpu_torch/csrc/gf2_matmul.cu",
                          "minio_tpu/ops/rs_pallas.py:48"),
           "mxsum_digest": ("minio_tpu_torch/csrc/mxsum_digest.cu",
                            "minio_tpu/ops/mxsum.py:153"),
           "mxhash256": ("minio_tpu_torch/csrc/mxhash256.cu",
                         "minio_tpu/ops/mxhash.py:104")}[kernel]
    return {"name": f"{kernel} {label}", "route": "cuda", "source": src[0],
            "replaces": src[1], "launches": 0, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library, "kernel": kernel, "path": path}


def _k1_bit_planes(x):
    """K1's input as the bit planes it contracts: x [B, kin, S] u8 ->
    [B*S, kin*8] int8 of 0/1, bit j of input i in column i*8 + j."""
    import torch

    b, kin, s = x.shape
    shifts = torch.arange(8, device=x.device, dtype=torch.uint8)
    return (((x.unsqueeze(-1) >> shifts) & 1).permute(0, 2, 1, 3)
            .reshape(b * s, kin * 8).to(torch.int8).contiguous())


def _k1_library_matches(x, w, out) -> bool:
    """Whether torch._int_mm of the bit planes, taken mod 2 and repacked,
    is K1's output `out`: the library call computes K1's function."""
    import torch

    b, _kin, s = x.shape
    t = w.shape[1] // 8
    shifts = torch.arange(8, device=x.device, dtype=torch.int32)
    y = torch._int_mm(_k1_bit_planes(x), w) & 1
    got = (y.reshape(b, s, t, 8) << shifts).sum(3).to(torch.uint8).permute(0, 2, 1)
    return torch.equal(got, out)


def _time_k1(records, label, path, args, bound, flush):
    """K1 at one shape beside its plain version and torch._int_mm of its
    bit-plane product [B*S, kin*8] @ [kin*8, t*8] (the GF(2) contraction
    before mod 2 and repacking; no single library call takes per-block
    weights, so those rows have none)."""
    import torch

    from minio_tpu_torch.ops import rs

    ms = _median_ms(lambda: rs.gf2_matmul(*args), flush)
    plain = _median_ms(lambda: rs.gf2_matmul_plain(*args), flush)
    lib = None
    if args[1].dim() == 2:
        bits = _k1_bit_planes(args[0])
        lib = _median_ms(lambda: torch._int_mm(bits, args[1]), flush)
        del bits
    print(f"  K1 {label}: {ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}), "
          f"{100 * bound[0] / ms:.1f}% of the bound; plain {plain:.6f} ms; "
          + (f"torch._int_mm of the bit planes {lib:.6f} ms" if lib is not None
             else "no library call (per-block weights)"))
    records.append(_record("gf2_matmul", label, path, ms, plain, bound, lib))


def _time_k2(records, label, path, chunks, lens, flush, bound_rows=None):
    """K2 at [N, S] beside its plain version and torch._int_mm, the library
    call that computes its main contraction [N, S] @ [S, 8]. The bound
    counts `bound_rows` rows of data (default N): rows of length 0 carry
    none."""
    import torch

    from minio_tpu_torch.ops import mxsum

    n, s = chunks.shape
    key = mxsum.device_key(s, chunks.device).t().contiguous()     # [S, 8]
    ci8 = chunks.view(torch.int8)
    if s % 8:
        # torch._int_mm takes an inner size that is a multiple of 8: zero
        # columns of the data against zero rows of the key add nothing.
        pad = 8 - s % 8
        ci8 = torch.nn.functional.pad(ci8, (0, pad))
        key = torch.nn.functional.pad(key, (0, 0, 0, pad))
    if n <= 16:
        # ... and more than 16 rows: zero rows added up to 24 (its time is
        # then that of a third more rows than K2's).
        ci8 = torch.nn.functional.pad(ci8, (0, 0, 0, 24 - n))
    ms = _median_ms(lambda: mxsum.digest(chunks, lens), flush)
    plain = _median_ms(lambda: mxsum.digest_plain(chunks, lens), flush)
    lib = _median_ms(lambda: torch._int_mm(ci8, key), flush)
    bound = _mxsum_bound_ms(bound_rows or n, s)
    print(f"  K2 {label} [{n}, {s}]: {ms:.6f} ms, bound {bound[0]:.6f} ms "
          f"({bound[1]}), {100 * bound[0] / ms:.1f}% of the bound; plain "
          f"{plain:.6f} ms; torch._int_mm {lib:.6f} ms")
    records.append(_record("mxsum_digest", f"{label} [{n},{s}]", path, ms, plain,
                           bound, lib))


def _mxhash_bound_ms(lens) -> tuple[float, str]:
    """K3's bound from this run's lengths: each row's bytes read once, the
    data key DK packed, the lengths and the digests, against the data term
    of every block the rows need, 2 * 4096 * 256 operations a block,
    counted at the int8 rate as K1's are. Folding the chain's state in
    (SK's 256 rows) costs 2 * 256 * 256 a folded term, and a term may take
    any number of blocks (K3's take 4), so that part shrinks toward none
    and is not counted: the chain form's 2 * 4352 * 256 a block counts
    6.25% more than the function needs."""
    from minio_tpu_torch.ops import mxhash

    lens = [int(x) for x in lens]
    blocks = sum(mxhash._pad_blocks(ln) for ln in lens)
    return _bound_ms(sum(lens) + mxhash.BLOCK_BITS * mxhash.STATE_BITS // 8 + 36 * len(lens),
                     2.0 * blocks * mxhash.BLOCK_BITS * mxhash.STATE_BITS)


def _kernel_us(fn, runs: int = 10) -> dict[str, float]:
    """Device microseconds per call of each CUDA kernel fn launches, from
    torch.profiler (CUPTI); empty where the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if ev.count and total:
            out[ev.key] = total / ev.count
    return out


def _k3_data_bits(chunks, lens):
    """The bits of every block the rows need, one block a row as 0/1 int8
    [sum of blocks, 4096], and DK as int8 [4096, 256]: the operands of
    torch._int_mm computing the data term (block bits @ DK) of every block,
    K3's yardstick. Built before any timing."""
    import torch

    from minio_tpu_torch.ops import mxhash

    msg, nb = mxhash._padded_messages(chunks, lens)
    n = chunks.shape[0]
    blocks = msg.reshape(n, -1, mxhash.BLOCK_BYTES)
    keep = torch.arange(blocks.shape[1], device=chunks.device) < nb.unsqueeze(1)
    shifts = torch.arange(8, device=chunks.device, dtype=torch.uint8)
    bits = ((blocks[keep].unsqueeze(-1) >> shifts) & 1).reshape(-1, mxhash.BLOCK_BITS)
    dk = torch.from_numpy(mxhash._key_matrix()[mxhash.STATE_BITS:]).to(chunks.device)
    return bits.to(torch.int8).contiguous(), dk.to(torch.int8).contiguous()


def _time_k3(records, label, chunks, lens, flush):
    """K3 at [N, S] beside its plain version (the chain) and, as its
    library yardstick, torch._int_mm of the data term of every block alone
    (no one PyTorch call computes the chain), with DK row-major and
    column-major, the faster kept. Then each of K3's two kernels' device
    time from torch.profiler, and the bound over the group-term kernel's
    alone. Its launches come from the bitrot phase."""
    import torch

    from minio_tpu_torch.ops import mxhash

    n, s = chunks.shape
    bits, dk = _k3_data_bits(chunks, lens)
    dk_cols = dk.t().contiguous().t()
    if not torch.equal(torch._int_mm(bits, dk), torch._int_mm(bits, dk_cols)):
        raise AssertionError(f"K3 {label}: torch._int_mm differs between DK's layouts")
    ms = _median_ms(lambda: mxhash.mxhash256(chunks, lens), flush)
    plain = _median_ms(lambda: mxhash.mxhash256_plain(chunks, lens), flush)
    lib_rows = _median_ms(lambda: torch._int_mm(bits, dk), flush)
    lib_cols = _median_ms(lambda: torch._int_mm(bits, dk_cols), flush)
    del bits
    bound = _mxhash_bound_ms(lens.tolist())
    us = _kernel_us(lambda: mxhash.mxhash256(chunks, lens))
    stage1 = sum(v for name, v in us.items() if "group_term_kernel" in name)
    combine = sum(v for name, v in us.items() if "combine_kernel" in name)
    print(f"  K3 {label} [{n}, {s}]: {ms:.6f} ms, bound {bound[0]:.6f} ms "
          f"({bound[1]}), {100 * bound[0] / ms:.1f}% of the bound; plain "
          f"{plain:.6f} ms; torch._int_mm of the data term {lib_rows:.6f} ms "
          f"(DK row-major), {lib_cols:.6f} ms (column-major)")
    groups = sum(-(-mxhash._pad_blocks(int(x)) // mxhash.GROUP_BLOCKS) for x in lens.tolist())
    if stage1 and combine:
        print(f"    K3 {label} by kernel (torch.profiler): group terms {stage1:.3f} us "
              f"({1e3 * stage1 / groups:.3f} ns for each of {groups} groups; alone at "
              f"{100 * bound[0] / (stage1 / 1e3):.1f}% of the bound), combine "
              f"{combine:.3f} us")
    else:
        print(f"    K3 {label} by kernel: not measured (the profiler recorded {sorted(us)})")
    records.append(_record("mxhash256", f"{label} [{n},{s}]", "bitrot", ms, plain,
                           bound, min(lib_rows, lib_cols)))


def mxhash_shapes(rng, dev, flush, check, records) -> None:
    """K3 at the bitrot phase's shapes, rows of mixed lengths (0 among
    them) in every launch, against its plain version (and at the PUT shape
    against the split plain version too); encode_with_bitrot (K1 then K3)
    against the same composition of the plain versions; the digest keys of
    mxsum256 and mxhash256 and the table of SK powers derived by this
    machine's numpy against their pinned SHA-256."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import mxhash, mxsum, rs

    keys = (("mxhash256", mxhash._key_matrix(), mxhash.KEY_SHA256),
            ("mxhash256 SK powers", mxhash.sk_powers(), mxhash.POWERS_SHA256),
            ("mxsum256", mxsum._key_rows(mxsum._KEY_CHUNK), mxsum.KEY_SHA256),
            ("mxsum256 length", mxsum._len_key(), mxsum.LEN_KEY_SHA256))
    for name, key, want in keys:
        got = hashlib.sha256(np.ascontiguousarray(key).tobytes()).hexdigest()
        if got != want:
            raise AssertionError(f"{name} key: SHA-256 {got} != pinned {want}")
    print(f"  keys pinned (numpy {np.__version__}): "
          + ", ".join(f"{name} {want[:16]}" for name, _k, want in keys))
    mixed = (0, 1, 503, 504, 512, 700, 4096)
    shapes = (("PUT", B * (K + M), S), ("GET verify", B * K, S),
              ("heal", B * 4, S), ("heal 1 target", B, S),
              (f"PUT {K12}+{M12}", B * (K12 + M12), S12))
    cases = []
    for label, n, s in shapes:
        x = torch.from_numpy(rng.integers(0, 256, (n, s), dtype=np.uint8)).to(dev)
        lens_np = np.full(n, s, dtype=np.int32)
        lens_np[:len(mixed)] = mixed
        lens = torch.from_numpy(lens_np).to(dev)
        got = mxhash.mxhash256(x, lens)
        check("mxhash256", f"K3 {label} (lengths {', '.join(map(str, mixed))}, "
              f"{s} ...)", got, mxhash.mxhash256_plain(x, lens))
        host = mxhash.digest_host(x[2, :503].cpu().numpy().tobytes())
        if got[2].cpu().numpy().tobytes() != host:
            raise AssertionError(f"K3 {label}: disagrees with the CPU digest_host")
        if label == "PUT":
            check("mxhash256", f"K3 {label} against the split plain version", got,
                  mxhash.mxhash256_split_plain(x, lens))
        cases.append((label, x, lens))
    x3 = torch.from_numpy(rng.integers(0, 256, (B, K, S), dtype=np.uint8)).to(dev)
    par, digs = mxhash.encode_with_bitrot(x3, K, M)
    w_enc = rs.device_encode_weights(K, M, dev)
    ppar = rs.gf2_matmul_plain(x3, w_enc, M)
    pdigs = mxhash.mxhash256_plain(torch.cat([x3, ppar], 1).reshape(B * (K + M), S),
                                   torch.full((B * (K + M),), S, dtype=torch.int32,
                                              device=dev)).reshape(B, K + M, 32)
    check("gf2_matmul", "mxhash.encode_with_bitrot (parity)", par, ppar)
    check("mxhash256", "mxhash.encode_with_bitrot (digests)", digs, pdigs)
    print("  timed at the bitrot phase's shapes (EC 8+4 and 12+4, 1 MiB blocks):")
    for label, x, lens in cases:
        _time_k3(records, label, x, lens, flush)


def kernel_phase(seed: int) -> list[dict]:
    """K1 and K2 on the card against their plain versions, at the S3
    path's shapes and at the lane shapes of the batched data plane and the
    hot tier; returns the entries of the result line (launches filled in
    by the phases that drive those paths)."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import fused, gf, mxsum, rs

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    errs = {"gf2_matmul": 0, "mxsum_digest": 0, "mxhash256": 0}

    def check(kernel, name, got, want):
        if got.shape != want.shape:
            raise AssertionError(
                f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        errs[kernel] = max(errs[kernel], err)
        if err:
            raise AssertionError(f"{name}: kernel disagrees with plain (max err {err})")
        print(f"  {name}: {tuple(got.shape)} byte-equal to plain")

    x_np = rng.integers(0, 256, (B, K, S), dtype=np.uint8)
    x = torch.from_numpy(x_np).to(dev)
    w_enc = rs.device_encode_weights(K, M, dev)
    parity = rs.gf2_matmul(x, w_enc, M)
    check("gf2_matmul", "K1 encode", parity, rs.gf2_matmul_plain(x, w_enc, M))
    if not np.array_equal(parity[0].cpu().numpy(), gf.encode_ref(x_np[0], M)):
        raise AssertionError("K1 encode disagrees with gf.encode_ref")
    shards = torch.cat([x, parity], dim=1)                     # [B, 12, S]

    surv, targets = (0, 2, 4, 5, 8, 9, 10, 11), (1, 3, 6, 7)
    xs = shards[:, list(surv)].contiguous()
    w_dec = rs.device_decode_weights(K, K + M, surv, targets, dev)
    rebuilt = rs.gf2_matmul(xs, w_dec, len(targets))
    check("gf2_matmul", "K1 reconstruct (4 missing)", rebuilt,
          rs.gf2_matmul_plain(xs, w_dec, 4))
    if not torch.equal(rebuilt, shards[:, list(targets)]):
        raise AssertionError("K1 reconstruct did not rebuild the lost shards")

    # A one-drive heal (the heal phase's shapes): K1 rebuilds 1 target from
    # the first 8 survivors, K2 digests the rebuilt chunks.
    surv1, tgt1 = (0, 1, 2, 3, 4, 6, 7, 8), (5,)
    xs1 = shards[:, list(surv1)].contiguous()
    w_dec1 = rs.device_decode_weights(K, K + M, surv1, tgt1, dev)
    rebuilt1 = rs.gf2_matmul(xs1, w_dec1, 1)
    check("gf2_matmul", "K1 reconstruct (1 missing)", rebuilt1,
          rs.gf2_matmul_plain(xs1, w_dec1, 1))
    if not torch.equal(rebuilt1, shards[:, list(tgt1)]):
        raise AssertionError("K1 reconstruct did not rebuild the lost shard")
    heal_chunks = rebuilt1.reshape(B, S)
    heal_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    check("mxsum_digest", "K2 digest of the rebuilt chunks",
          mxsum.digest(heal_chunks, heal_lens), mxsum.digest_plain(heal_chunks, heal_lens))

    # The static-pattern compositions on K1 then K2, at the S3 shape with
    # 4 missing, against the same compositions of the plain versions.
    got, gdig = fused.reconstruct_with_digests(shards, K, K + M, surv, targets)
    want, wdig = fused.reconstruct_with_digests_plain(shards, K, K + M, surv, targets)
    check("gf2_matmul", "fused.reconstruct_with_digests (rebuilt)", got, want)
    check("mxsum_digest", "fused.reconstruct_with_digests (digests)", gdig, wdig)
    check("gf2_matmul", "fused.reconstruct_only",
          fused.reconstruct_only(shards, K, K + M, surv, targets),
          fused.reconstruct_only_plain(shards, K, K + M, surv, targets))

    pats = [((0, 1, 2, 3, 4, 5, 6, 7), (8, 9, 10, 11)),
            ((2, 3, 4, 5, 6, 7, 8, 9), (0, 1)),
            ((0, 1, 2, 3, 8, 9, 10, 11), (4, 5, 6))]
    w_multi = np.zeros((B, K * 8, 32), dtype=np.int8)
    xm = torch.empty_like(x)
    for b in range(B):
        sv, tg = pats[b % 3]
        w_multi[b, :, :len(tg) * 8] = rs.decode_weights_np(K, K + M, sv, tg)
        xm[b] = shards[b, list(sv)]
    w_multi_d = torch.from_numpy(w_multi).to(dev)
    check("gf2_matmul", "K1 per-block weights (3 patterns)",
          rs.gf2_matmul_multi(xm, w_multi_d, 4),
          rs.gf2_matmul_plain(xm, w_multi_d, 4))

    xr = x[:, :, :87382].contiguous()
    check("gf2_matmul", "K1 ragged S=87382", rs.gf2_matmul(xr, w_enc, M),
          rs.gf2_matmul_plain(xr, w_enc, M))

    n_rows = B * (K + M)
    chunks = shards.reshape(n_rows, S).clone()
    lens = torch.full((n_rows,), S, dtype=torch.int32, device=dev)
    for row, ln in ((0, 0), (1, 1), (2, 513), (3, S)):
        chunks[row, ln:] = 0
        lens[row] = ln
    digs = mxsum.digest(chunks, lens)
    check("mxsum_digest", "K2 digest", digs, mxsum.digest_plain(chunks, lens))
    if digs[2].cpu().numpy().tobytes() != mxsum.digest_np(
            chunks[2, :513].cpu().numpy().tobytes()):
        raise AssertionError("K2 digest disagrees with the host digest")
    for rows in (B * K, B * 4):
        check("mxsum_digest", f"K2 digest [{rows}, S]",
              mxsum.digest(chunks[:rows], lens[:rows]),
              mxsum.digest_plain(chunks[:rows], lens[:rows]))
    # Whether torch._int_mm's int32 sums wrap as K2's uint32 ones do is
    # checked on this run's data, not assumed.
    key = mxsum.device_key(S, dev).t().contiguous()
    lterm = (mxsum._len_bytes(lens).to(torch.float64)
             @ mxsum.device_len_key(dev).to(torch.float64)).to(torch.int64)
    lib_out = torch._int_mm(chunks.view(torch.int8), key)
    print("  torch._int_mm with the length term and packing equals K2's "
          f"digests: {torch.equal(mxsum._pack_words(lib_out.to(torch.int64) + lterm), digs)}")

    print("  torch._int_mm of K1's bit planes, mod 2 and repacked, equals K1's "
          f"parity: {_k1_library_matches(x, w_enc, parity)}")

    records: list[dict] = []
    print("  timed at the S3 path's shapes (EC 8+4, 1 MiB blocks):")
    _time_k1(records, "encode [16,8,131072]->4", "s3", (x, w_enc, M),
             _gf2_bound_ms(B, K, M, S), flush)
    _time_k1(records, "reconstruct 4 missing [16,8,131072]->4", "s3",
             (xs, w_dec, 4), _gf2_bound_ms(B, K, 4, S), flush)
    _time_k1(records, "per-block weights, 3 patterns [16,8,131072]->4", "s3",
             (xm, w_multi_d, 4), _gf2_bound_ms(B, K, 4, S, per_block_weights=True),
             flush)
    _time_k1(records, "ragged [16,8,87382]->4", "s3", (xr, w_enc, M),
             _gf2_bound_ms(B, K, M, xr.shape[2]), flush)
    for label, rows in (("PUT", n_rows), ("GET verify", B * K), ("heal", B * 4)):
        _time_k2(records, label, "s3", chunks[:rows], lens[:rows], flush)
    print("  timed at a one-drive heal's shapes (EC 8+4, 1 MiB blocks):")
    _time_k1(records, "reconstruct 1 missing [16,8,131072]->1", "heal",
             (xs1, w_dec1, 1), _gf2_bound_ms(B, K, 1, S), flush)
    _time_k2(records, "heal 1 target", "heal", heal_chunks, heal_lens, flush)

    lane_shapes(rng, dev, flush, check, records)
    ec12_shapes(rng, dev, flush, check, records)
    ec2_shapes(rng, dev, flush, check, records)
    mxhash_shapes(rng, dev, flush, check, records)
    for r in records:
        r["max_abs_err"] = errs[r["kernel"]]
    return records


def lane_shapes(rng, dev, flush, check, records) -> None:
    """K1 and K2 at the lane shapes of the batched data plane (the widest
    full encode lane, the widest reconstruct lane with a decode matrix per
    row, the widest and narrowest verify lanes) and at the hot tier's
    serve window; then what the plane's width gates cost: one lane launch
    against the per-object launches it replaces, at 16 and 64 KiB."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import fused, mxsum, rs

    print("  lane shapes (dataplane defaults: 32 encode/reconstruct rows, "
          "128 verify rows):")
    xe = torch.from_numpy(rng.integers(0, 256, (32, K, 65536), dtype=np.uint8)).to(dev)
    w_enc = rs.device_encode_weights(K, M, dev)
    check("gf2_matmul", "K1 encode lane", rs.gf2_matmul(xe, w_enc, M),
          rs.gf2_matmul_plain(xe, w_enc, M))

    # Reconstruct lane: 32 rows over 4 survivor patterns, each row its own
    # [64, 32] decode matrix with the padded target columns zero.
    data = torch.from_numpy(rng.integers(0, 256, (32, K, 16384), dtype=np.uint8)).to(dev)
    full = torch.cat([data, rs.gf2_matmul(data, w_enc, M)], dim=1)
    pats = [(0, 2, 4, 5, 8, 9, 10, 11), (2, 3, 4, 5, 6, 7, 8, 9),
            (0, 1, 2, 3, 8, 9, 10, 11), (1, 3, 5, 7, 8, 9, 10, 11)]
    w_rows = np.zeros((32, K * 8, 32), dtype=np.int8)
    xr = torch.empty_like(data)
    lost = []
    for r in range(32):
        sv = pats[r % 4]
        tg = tuple(i for i in range(K) if i not in sv)
        w_rows[r, :, :len(tg) * 8] = rs.decode_weights_np(K, K + M, sv, tg)
        xr[r] = full[r, list(sv)]
        lost.append(tg)
    w_rows_d = torch.from_numpy(w_rows).to(dev)
    rebuilt = rs.gf2_matmul_multi(xr, w_rows_d, 4)
    check("gf2_matmul", "K1 reconstruct lane (4 patterns)", rebuilt,
          rs.gf2_matmul_plain(xr, w_rows_d, 4))
    for r in range(32):
        if not torch.equal(rebuilt[r, :len(lost[r])], full[r, list(lost[r])]):
            raise AssertionError("K1 reconstruct lane did not rebuild row "
                                 f"{r}'s lost shards")

    def ragged(n, s):
        ln = rng.integers(0, s + 1, n).astype(np.int32)
        c = rng.integers(0, 256, (n, s), dtype=np.uint8)
        c[np.arange(s)[None, :] >= ln[:, None]] = 0
        return torch.from_numpy(c).to(dev), torch.from_numpy(ln).to(dev)

    cv, lv = ragged(128, 65536)
    check("mxsum_digest", "K2 verify lane (ragged)", mxsum.digest(cv, lv),
          mxsum.digest_plain(cv, lv))
    cn, ln = ragged(128, 512)
    check("mxsum_digest", "K2 narrowest lane (ragged)", mxsum.digest(cn, ln),
          mxsum.digest_plain(cn, ln))
    # Hot tier: a 32 MiB object resident as [32, 8, 131072], served whole:
    # K2 over the window's view [256, 131072], the last block ragged.
    resident = torch.from_numpy(rng.integers(0, 256, (32, K, S), dtype=np.uint8)).to(dev)
    rlens = torch.full((32,), S, dtype=torch.int32, device=dev)
    rlens[31] = 70001
    resident[31, :, 70001:] = 0
    win = resident[0:32].reshape(32 * K, S)
    wl = rlens.repeat_interleave(K)
    check("mxsum_digest", "K2 hot-tier window", mxsum.digest(win, wl),
          mxsum.digest_plain(win, wl))

    _time_k1(records, "encode lane [32,8,65536]->4", "plane", (xe, w_enc, M),
             _gf2_bound_ms(32, K, M, 65536), flush)
    _time_k1(records, "reconstruct lane, 4 patterns [32,8,16384]->4", "plane",
             (xr, w_rows_d, 4), _gf2_bound_ms(32, K, 4, 16384, per_block_weights=True),
             flush)
    _time_k2(records, "verify lane, ragged", "plane", cv, lv, flush)
    _time_k2(records, "narrowest lane, ragged", "plane", cn, ln, flush)
    _time_k2(records, "hot-tier window", "hot", win, wl, flush)

    print("  width gates (MTPU_DP_MAX_WIDTH=65536, MTPU_DP_MAX_RECON_WIDTH=16384): "
          "one lane call against the 32 per-object calls it replaces")
    for w in (16384, 65536):
        xw = xe[:, :, :w].contiguous()
        lw = torch.full((32,), w, dtype=torch.int32, device=dev)
        xrw = torch.from_numpy(rng.integers(0, 256, (32, K, w), dtype=np.uint8)).to(dev)
        singles = [(xw[i:i + 1], lw[i:i + 1]) for i in range(32)]
        rsingles = [(xrw[i:i + 1], rs.device_decode_weights(
            K, K + M, pats[i % 4], lost[i], dev), len(lost[i])) for i in range(32)]
        cases = {
            "encode+digests": (
                lambda: fused.encode_with_digests(xw, K, M, lw),
                lambda: [fused.encode_with_digests(a, K, M, b) for a, b in singles]),
            "reconstruct": (
                lambda: rs.gf2_matmul_multi(xrw, w_rows_d, 4),
                lambda: [rs.gf2_matmul(a, wt, t) for a, wt, t in rsingles]),
        }
        for name, (lane, per_object) in cases.items():
            lane_ms = _median_ms(lane, flush)
            obj_ms = _median_ms(per_object, flush)
            lane_host = _host_ms(lane)
            obj_host = _host_ms(per_object)
            print(f"    {name} at {w} B chunks: lane {lane_ms:.6f} ms device "
                  f"({lane_host:.6f} ms host, launch to sync); 32 per-object "
                  f"{obj_ms:.6f} ms device ({obj_host:.6f} ms host)")


def ec12_shapes(rng, dev, flush, check, records) -> None:
    """K1 and K2 at the multipart phase's shapes: EC 12+4 with 1 MiB blocks,
    one 16-block batch of a 16 MiB part. The 87,382-byte chunks are not a
    multiple of 16 bytes, so K1 takes its byte path on every block."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, mxsum, rs

    print(f"  EC {K12}+{M12} shapes (16-drive sets, 1 MiB blocks, S={S12}):")
    x_np = rng.integers(0, 256, (B, K12, S12), dtype=np.uint8)
    x = torch.from_numpy(x_np).to(dev)
    w_enc = rs.device_encode_weights(K12, M12, dev)
    parity = rs.gf2_matmul(x, w_enc, M12)
    check("gf2_matmul", "K1 encode 12+4", parity, rs.gf2_matmul_plain(x, w_enc, M12))
    if not np.array_equal(parity[0].cpu().numpy(), gf.encode_ref(x_np[0], M12)):
        raise AssertionError("K1 encode 12+4 disagrees with gf.encode_ref")
    shards = torch.cat([x, parity], dim=1)                     # [B, 16, S]
    surv = (0, 1, 3, 4, 5, 7, 8, 10, 12, 13, 14, 15)
    targets = (2, 6, 9, 11)
    xs = shards[:, list(surv)].contiguous()
    w_dec = rs.device_decode_weights(K12, K12 + M12, surv, targets, dev)
    rebuilt = rs.gf2_matmul(xs, w_dec, len(targets))
    check("gf2_matmul", "K1 reconstruct 12+4 (4 missing)", rebuilt,
          rs.gf2_matmul_plain(xs, w_dec, len(targets)))
    if not torch.equal(rebuilt, shards[:, list(targets)]):
        raise AssertionError("K1 reconstruct 12+4 did not rebuild the lost shards")
    put_rows = shards.reshape(B * (K12 + M12), S12).clone()   # [256, S]
    put_lens = torch.full((B * (K12 + M12),), S12, dtype=torch.int32, device=dev)
    for row, ln in ((0, 0), (1, 1), (2, 513)):
        put_rows[row, ln:] = 0
        put_lens[row] = ln
    check("mxsum_digest", "K2 PUT digests 12+4", mxsum.digest(put_rows, put_lens),
          mxsum.digest_plain(put_rows, put_lens))
    # The GET path stages its 16 x 12 = 192 chunks as fused.digest_chunks_host
    # does: rows padded to the next power of two, the last 64 of length 0.
    get_rows = torch.zeros((256, S12), dtype=torch.uint8, device=dev)
    get_rows[:B * K12] = xs.reshape(B * K12, S12)
    get_lens = torch.zeros((256,), dtype=torch.int32, device=dev)
    get_lens[:B * K12] = S12
    check("mxsum_digest", "K2 GET verify 12+4", mxsum.digest(get_rows, get_lens),
          mxsum.digest_plain(get_rows, get_lens))
    _time_k1(records, f"encode 12+4 [16,12,{S12}]->4", "multipart",
             (x, w_enc, M12), _gf2_bound_ms(B, K12, M12, S12), flush)
    _time_k1(records, f"reconstruct 4 missing 12+4 [16,12,{S12}]->4", "multipart",
             (xs, w_dec, len(targets)), _gf2_bound_ms(B, K12, 4, S12), flush)
    _time_k2(records, "PUT 12+4", "multipart", put_rows, put_lens, flush)
    _time_k2(records, "GET verify 12+4, 64 rows empty", "multipart", get_rows,
             get_lens, flush, bound_rows=B * K12)


def ec2_shapes(rng, dev, flush, check, records) -> None:
    """K1 at the shape `storageclass standard=EC:2` gives config 1's 12
    drives (phase 13): EC 10+2 with 1 MiB blocks, one 16-block batch. The
    104,858-byte chunks are not a multiple of 16 bytes (K1's byte path on
    every block), and a 1 MiB block leaves the last chunk 2 bytes short."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, rs

    print(f"  EC {K10}+{M10} shapes (storageclass EC:2 on 12 drives, 1 MiB blocks, "
          f"S={S10}):")
    x_np = rng.integers(0, 256, (B, K10, S10), dtype=np.uint8)
    x_np[:, -1, -2:] = 0                   # the block's zero padding
    x = torch.from_numpy(x_np).to(dev)
    w_enc = rs.device_encode_weights(K10, M10, dev)
    parity = rs.gf2_matmul(x, w_enc, M10)
    check("gf2_matmul", "K1 encode 10+2", parity, rs.gf2_matmul_plain(x, w_enc, M10))
    if not np.array_equal(parity[0].cpu().numpy(), gf.encode_ref(x_np[0], M10)):
        raise AssertionError("K1 encode 10+2 disagrees with gf.encode_ref")
    _time_k1(records, f"encode 10+2 [16,10,{S10}]->2", "atrest", (x, w_enc, M10),
             _gf2_bound_ms(B, K10, M10, S10), flush)


def _host_ms(fn, runs: int = 20) -> float:
    """Median host time of fn() from its first launch to the card's
    synchronize, in ms (the launch overhead a caller pays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class _Client:
    """S3 over http.client, signed with the port's SigV4 code (as the root,
    or as another identity; a temporary one adds its session token)."""

    def __init__(self, url: str, access: str = ACCESS, secret: str = SECRET,
                 token: str = ""):
        from minio_tpu_torch.s3.sigv4 import Credentials

        self.host = urllib.parse.urlparse(url).netloc
        self.creds = Credentials(access, secret)
        self.token = token
        self.conn = http.client.HTTPConnection(self.host, timeout=600)

    def send(self, method: str, path: str, body: bytes = b"",
             headers: dict | None = None, query: dict | None = None,
             check: bool = True):
        """Send one request; -> the response, its body not yet read. With
        `check`, an answer of 300 or above raises."""
        from minio_tpu_torch.s3.sigv4 import UNSIGNED_PAYLOAD, sign_request

        query = query or {}
        headers = dict(headers or {})
        if self.token:
            headers["x-amz-security-token"] = self.token
        signed = sign_request(method, path, query, headers, self.host,
                              self.creds, UNSIGNED_PAYLOAD)
        url = urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        self.conn.request(method, url, body=body, headers=signed)
        r = self.conn.getresponse()
        if check and r.status >= 300:
            raise AssertionError(f"{method} {path}: {r.status} {r.read()[:300]!r}")
        return r

    def request(self, method: str, path: str, body: bytes = b"",
                headers: dict | None = None, query: dict | None = None,
                check: bool = True):
        r = self.send(method, path, body, headers, query, check)
        return r, r.read()

    def raw(self, method: str, url: str, body=b"", headers: dict | None = None):
        """A request signed by the caller (presigned, aws-chunked, or none);
        -> (response, body)."""
        self.conn.request(method, url, body=body, headers=headers or {})
        r = self.conn.getresponse()
        return r, r.read()

    def close(self):
        self.conn.close()


S3_SIZES = {"big": 256 << 20, "mid": (9 << 20) + 12345, "tiny": 1 << 10}


def _fill_launches(records: list[dict], path: str, counts: dict) -> None:
    """Set the launch count of every entry of `path` from the counts of
    that path's run; a kernel of the path that never launched fails."""
    for r in records:
        if r["path"] == path:
            r["launches"] = counts[r["kernel"]]
            if r["launches"] <= 0:
                raise AssertionError(f"{r['kernel']} never launched on the "
                                     f"{path} path")


def s3_phase(seed: int, card: str, records: list[dict], device: str = "cuda") -> None:
    """Phase 3 (see the module's docstring). The server runs with
    enable_mrf=False: a background heal queued by the degraded GETs would
    race the phase's own deep heals and change its launch counts."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    rng = np.random.default_rng(seed + 1)
    objects = {key: rng.bytes(size) for key, size in S3_SIZES.items()}
    work = tempfile.mkdtemp(prefix="mtpu-torch-smoke-")
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    cl = _Client(srv.url)
    stages = {}
    try:
        obj = srv.obj.pools[0].sets[0]
        print(f"  server {srv.url}: EC {obj.n - obj.parity}+{obj.parity}, "
              f"block {obj.block_size} B, bitrot {obj.bitrot_algorithm}")

        def mark(stage):
            stages[stage] = kernels.launches()

        kernels.reset_launches()
        mark("start")
        cl.request("PUT", "/smoke")
        t0 = time.perf_counter()
        cl.request("PUT", "/smoke/big", objects["big"])
        put_s = time.perf_counter() - t0
        for key in ("mid", "tiny"):
            cl.request("PUT", f"/smoke/{key}", objects[key])
        mark("put")

        def get_ok(key, what):
            r, data = cl.request("GET", f"/smoke/{key}")
            if data != objects[key]:
                raise AssertionError(f"{what}: GET {key} bytes differ")
            if r.getheader("ETag") != f'"{hashlib.md5(objects[key]).hexdigest()}"':
                raise AssertionError(f"{what}: GET {key} ETag is not the md5")

        t0 = time.perf_counter()
        get_ok("big", "intact")
        get_s = time.perf_counter() - t0
        for key in ("mid", "tiny"):
            get_ok(key, "intact")
        r, data = cl.request("GET", "/smoke/big",
                             headers={"Range": "bytes=1000000-3999999"})
        if r.status != 206 or data != objects["big"][1000000:4000000]:
            raise AssertionError("ranged GET")
        mark("get")

        def part_file(i):
            hits = glob.glob(os.path.join(paths[i], "smoke", "big", "*", "part.1"))
            return hits[0] if hits else None

        originals = {i: open(part_file(i), "rb").read() for i in range(12)}
        lost = [0, 1, 2, 3]
        for i in lost:
            shutil.rmtree(os.path.dirname(part_file(i)))
        t0 = time.perf_counter()
        get_ok("big", "degraded (4 drives lost)")
        deg_s = time.perf_counter() - t0
        mark("degraded_get")

        t0 = time.perf_counter()
        res = obj.heal_object("smoke", "big", scan_deep=True)
        heal_s = time.perf_counter() - t0
        if res.healed_count != 4 or any(open(part_file(i), "rb").read() != originals[i]
                                        for i in lost):
            raise AssertionError(f"heal: {res.healed_count} healed or files differ")
        mark("heal")

        f = part_file(4)
        raw = bytearray(originals[4])
        raw[32 + 4096] ^= 0xA5
        with open(f, "wb") as fh:
            fh.write(raw)
        get_ok("big", "one shard byte flipped")
        if obj.heal_object("smoke", "big", scan_deep=True).healed_count != 1 \
                or open(part_file(4), "rb").read() != originals[4]:
            raise AssertionError("deep heal did not rewrite the flipped shard")
        mark("bitrot_heal")

        for i in (8, 9, 10, 11):
            shutil.rmtree(os.path.dirname(part_file(i)))
        get_ok("big", "4 other drives lost after heal")
        mark("end")
    finally:
        cl.close()
        _close_server(srv)
        shutil.rmtree(work, ignore_errors=True)

    def delta(a, b, name):
        return stages[b][name] - stages[a][name]

    order = ["start", "put", "get", "degraded_get", "heal", "bitrot_heal", "end"]
    for a, b in zip(order, order[1:]):
        print(f"  launches {b}: " + ", ".join(
            f"{n} {delta(a, b, n)}" for n in kernels.KERNELS))
    for stage, need in (("put", "encode"), ("degraded_get", "decode"), ("heal", "heal")):
        prev = order[order.index(stage) - 1]
        if delta(prev, stage, "gf2_matmul") <= 0:
            raise AssertionError(f"K1 did not launch for {need}")
    _fill_launches(records, "s3", {n: delta("start", "end", n)
                                   for n in kernels.KERNELS})
    gib = len(objects["big"]) / (1 << 30)
    print(f"  S3 {len(objects['big']) >> 20} MiB on {card}: "
          f"PUT {gib / put_s:.6f} GiB/s ({put_s:.6f} s), "
          f"GET {gib / get_s:.6f} GiB/s ({get_s:.6f} s), degraded GET "
          f"{gib / deg_s:.6f} GiB/s ({deg_s:.6f} s), deep heal of 4 shards "
          f"{heal_s:.6f} s")


class _Pool:
    """`n` client threads, each with its own S3 connection."""

    def __init__(self, url: str, n: int):
        from concurrent.futures import ThreadPoolExecutor
        import threading

        self._url = url
        self._local = threading.local()
        self._clients: list[_Client] = []
        self._mu = threading.Lock()
        self._ex = ThreadPoolExecutor(max_workers=n, thread_name_prefix="smoke-client")

    def client(self) -> _Client:
        cl = getattr(self._local, "cl", None)
        if cl is None:
            cl = self._local.cl = _Client(self._url)
            with self._mu:
                self._clients.append(cl)
        return cl

    def run(self, fn, items) -> list:
        """fn(client, item) for every item; re-raises the first failure."""
        futs = [self._ex.submit(lambda it=it: fn(self.client(), it)) for it in items]
        return [f.result() for f in futs]

    def close(self) -> None:
        self._ex.shutdown(wait=True)
        for cl in self._clients:
            cl.close()


def _md5_etag(data: bytes) -> str:
    return f'"{hashlib.md5(data).hexdigest()}"'


def plane_phase(seed: int, card: str, records: list[dict] | None,
                n_objects: int, plane_on: bool = True, n_clients: int = 64,
                n_degraded: int = 256, device: str = "cuda") -> dict:
    """Small-object traffic through the S3 server on 12 tmp drives at EC
    8+4, with the batched data plane at its default (on) or opted out
    (MTPU_BATCHED_DATAPLANE=0, the per-object codec path): `n_clients`
    client threads PUT `n_objects` objects of sizes drawn log-uniformly
    from 1 KiB to 512 KiB (the small-object mix of MinIO's warp tool,
    --obj.size/--concurrent), GET them all back byte-equal, then with the
    shard files of 2 drives lost GET `n_degraded` objects of 16-128 KiB
    concurrently (reconstruct lanes when on) and heal one of them (the
    digest-fused reconstruct lane when on). Launch counts go into
    `records` unless it is None. Returns each stage's objects/s. The
    server runs with enable_mrf=False, so the degraded GETs queue no
    background heal."""
    import numpy as np

    from minio_tpu_torch import dataplane
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    if plane_on:
        os.environ.pop("MTPU_BATCHED_DATAPLANE", None)   # the default: on
    else:
        os.environ["MTPU_BATCHED_DATAPLANE"] = "0"
    rng = np.random.default_rng(seed + 2)
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                               n_objects)).astype(np.int64)
    objects = {f"o{i:05d}": rng.bytes(int(n)) for i, n in enumerate(sizes)}
    total = int(sizes.sum())
    work = tempfile.mkdtemp(prefix="mtpu-torch-plane-")
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    pool = _Pool(srv.url, n_clients)
    plane = dataplane.get_plane(srv.obj.device) if plane_on else None
    stages, marks = {}, {}

    def mark(stage):
        stages[stage] = (kernels.launches(), plane.stats() if plane else None)
        marks[stage] = time.perf_counter()

    try:
        print(f"  plane {'on' if plane_on else 'off'}: {n_objects} objects, "
              f"{total} B ({total / (1 << 20):.1f} MiB), "
              f"{int((sizes <= 16 << 10).sum())} inline (<= 16 KiB), "
              f"{n_clients} client threads")
        _Client(srv.url).request("PUT", "/plane")
        kernels.reset_launches()
        mark("start")
        pool.run(lambda cl, kv: cl.request("PUT", f"/plane/{kv[0]}", kv[1]),
                 objects.items())
        mark("put")

        def get_ok(cl, key):
            r, data = cl.request("GET", f"/plane/{key}")
            if data != objects[key] or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"plane GET {key}: bytes or ETag differ")

        pool.run(get_ok, objects)
        mark("get")

        def part(i, key):
            hits = glob.glob(os.path.join(paths[i], "plane", key, "*", "part.1"))
            return hits[0] if hits else None

        lost = (2, 7)
        degraded = [k for k, v in objects.items() if 16 << 10 < len(v) <= 128 << 10]
        degraded = degraded[:n_degraded]
        heal_key = degraded[0]
        originals = {i: open(part(i, heal_key), "rb").read() for i in lost}
        for i in lost:
            for f in glob.glob(os.path.join(paths[i], "plane", "*", "*", "part.1")):
                shutil.rmtree(os.path.dirname(f))
        mark("lose")
        pool.run(get_ok, degraded)
        mark("degraded_get")
        res = srv.obj.heal_object("plane", heal_key)
        if res.healed_count != 2 or any(open(part(i, heal_key), "rb").read()
                                        != originals[i] for i in lost):
            raise AssertionError(f"plane heal: {res.healed_count} healed or files differ")
        mark("heal")
    finally:
        pool.close()
        _close_server(srv)
        os.environ.pop("MTPU_BATCHED_DATAPLANE", None)
        shutil.rmtree(work, ignore_errors=True)

    for a, b in (("start", "put"), ("put", "get"), ("lose", "degraded_get"),
                 ("degraded_get", "heal")):
        ka, pa = stages[a]
        kb, pb = stages[b]
        k1 = kb["gf2_matmul"] - ka["gf2_matmul"]
        line = "kernel launches " + ", ".join(
            f"{n} {kb[n] - ka[n]}" for n in kernels.KERNELS)
        if b in ("degraded_get", "heal") and k1 <= 0:
            raise AssertionError(f"plane {'on' if plane_on else 'off'} {b}: "
                                 "K1 never launched")
        if plane_on:
            d = {f: pb[f] - pa[f] for f in ("launches", "requests", "rows",
                                            "capacity", "rejected")}
            recon = (pb["op_launches"]["reconstruct"]
                     - pa["op_launches"]["reconstruct"])
            line = (f"plane launches {d['launches']} ({recon} reconstruct), "
                    f"requests {d['requests']}, rows {d['rows']}, capacity "
                    f"{d['capacity']}, rejected {d['rejected']}; " + line)
            if b == "put" and not d["launches"] < d["requests"]:
                raise AssertionError("plane PUT: no coalescing (launches >= requests)")
            if b in ("degraded_get", "heal") and recon <= 0:
                raise AssertionError(f"plane {b}: no reconstruct lane launched")
        print(f"  {b}: {line}")
    if records is not None:
        _fill_launches(records, "plane", {
            n: stages["heal"][0][n] - stages["start"][0][n] for n in kernels.KERNELS})
    put_s = marks["put"] - marks["start"]
    get_s = marks["get"] - marks["put"]
    deg_s = marks["degraded_get"] - marks["lose"]
    deg_bytes = sum(len(objects[k]) for k in degraded)
    gib = total / (1 << 30)
    print(f"  plane {'on' if plane_on else 'off'} on {card}: PUT "
          f"{n_objects / put_s:.3f} objects/s, {gib / put_s:.6f} GiB/s "
          f"({put_s:.6f} s); GET {n_objects / get_s:.3f} objects/s, "
          f"{gib / get_s:.6f} GiB/s ({get_s:.6f} s); degraded GET of "
          f"{len(degraded)}: {len(degraded) / deg_s:.3f} objects/s, "
          f"{deg_bytes / (1 << 30) / deg_s:.6f} GiB/s ({deg_s:.6f} s)")
    return {"put": n_objects / put_s, "get": n_objects / get_s,
            "degraded_get": len(degraded) / deg_s}


def hot_tier_phase(seed: int, card: str, records: list[dict], working_set: int,
                   budget: int = 2 << 30, device: str = "cuda") -> None:
    """The HBM hot tier (MTPU_HOTTIER=1, admit cooldown 0, a `budget`-byte
    budget cut from an 80 GB card to fit the run's time) through the S3
    server on 12 tmp drives: PUT about `working_set` bytes of 4-32 MiB
    objects, heat them until admission lands and eviction has run, then
    hold every hot GET byte-equal and ETag-identical to the drive-path GET
    with K2 launched once per hit, ranged hits byte-equal, an overwrite
    served new, and a flipped resident byte falling back to the drive
    path. The server runs with enable_mrf=False, as phase 3's does."""
    import numpy as np
    import torch

    from minio_tpu_torch import hottier
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    env = {"MTPU_HOTTIER": "1", "MTPU_HOTTIER_ADMIT_COOLDOWN_S": "0",
           "MTPU_HOTTIER_BYTES": str(budget),
           "MTPU_HOTTIER_MAX_OBJECT": str(32 << 20)}
    os.environ.update(env)
    hottier.reset_global()
    rng = np.random.default_rng(seed + 3)
    objects: dict[str, bytes] = {}
    total = 0
    while total < working_set:
        n = int(rng.integers(4 << 20, (32 << 20) + 1))
        objects[f"h{len(objects):04d}"] = rng.bytes(n)
        total += n
    work = tempfile.mkdtemp(prefix="mtpu-torch-hot-")
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    pool = _Pool(srv.url, 8)
    cl = _Client(srv.url)
    try:
        tier = hottier.get_tier(srv.obj.device)
        print(f"  {len(objects)} objects, {total} B ({total / (1 << 30):.3f} GiB); "
              f"budget {budget} B; " + ", ".join(f"{k}={v}" for k, v in env.items()))
        cl.request("PUT", "/hot")
        kernels.reset_launches()
        start = kernels.launches()
        pool.run(lambda c, kv: c.request("PUT", f"/hot/{kv[0]}", kv[1]),
                 objects.items())

        def get_ok(c, key):
            r, data = c.request("GET", f"/hot/{key}")
            if data != objects[key] or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"hot phase GET {key}: bytes or ETag differ")

        t0 = time.perf_counter()
        for _ in range(2):                    # the second GET admits
            pool.run(get_ok, objects)
        if not tier.drain(600):
            raise AssertionError(f"hot tier admission never settled: {tier.stats()}")
        heat_s = time.perf_counter() - t0
        st = tier.stats()
        cold = [k for k in objects if not tier.resident("hot", k)]
        print(f"  after 2 GETs each ({heat_s:.3f} s): {st}")
        if st["resident_objects"] == 0 or not cold:
            raise AssertionError("hot tier: want some objects resident and some not")
        for _ in range(4):                    # 3 cold keys get hotter
            pool.run(get_ok, cold[:3])
        if not tier.drain(600):
            raise AssertionError(f"hot tier admission never settled: {tier.stats()}")
        st = tier.stats()
        print(f"  after 4 more GETs of 3 non-resident objects: {st}")
        if st["evictions"] < 1 or not any(tier.resident("hot", k) for k in cold[:3]):
            raise AssertionError("hot tier: the hotter keys did not evict colder ones")
        if st["resident_bytes"] > budget:
            raise AssertionError("hot tier: over its budget")

        resident = [k for k in objects if tier.resident("hot", k)]
        drive_s = hot_s = 0.0
        hits0 = tier.stats()["hits"]
        k2 = 0
        for key in resident:
            os.environ["MTPU_HOTTIER"] = "0"
            t0 = time.perf_counter()
            r, drive = cl.request("GET", f"/hot/{key}")
            drive_s += time.perf_counter() - t0
            drive_etag = r.getheader("ETag")
            os.environ["MTPU_HOTTIER"] = "1"
            before = kernels.launches()["mxsum_digest"]
            t0 = time.perf_counter()
            r, hot = cl.request("GET", f"/hot/{key}")
            hot_s += time.perf_counter() - t0
            k2 += kernels.launches()["mxsum_digest"] - before
            if not (hot == drive == objects[key]) or r.getheader("ETag") != drive_etag:
                raise AssertionError(f"hot GET {key}: not equal to the drive-path GET")
        hits = tier.stats()["hits"] - hits0
        if hits != len(resident) or k2 != hits:
            raise AssertionError(f"hot GETs: {hits} hits and {k2} K2 launches for "
                                 f"{len(resident)} resident objects")
        nbytes = sum(len(objects[k]) for k in resident)
        print(f"  hot GETs of {len(resident)} resident objects ({nbytes} B) on "
              f"{card}: {hits} hits, {k2} K2 launches; hot {hot_s:.6f} s "
              f"({nbytes / (1 << 30) / hot_s:.6f} GiB/s), drive path "
              f"{drive_s:.6f} s ({nbytes / (1 << 30) / drive_s:.6f} GiB/s)")

        hits0 = tier.stats()["hits"]
        for _ in range(16):
            key = resident[int(rng.integers(len(resident)))]
            size = len(objects[key])
            off = int(rng.integers(size))
            end = int(rng.integers(off, size))
            r, data = cl.request("GET", f"/hot/{key}",
                                 headers={"Range": f"bytes={off}-{end}"})
            if r.status != 206 or data != objects[key][off:end + 1]:
                raise AssertionError(f"hot ranged GET {key} {off}-{end}")
        if tier.stats()["hits"] - hits0 != 16:
            raise AssertionError("hot ranged GETs did not all hit")

        key = resident[0]
        new = rng.bytes(len(objects[key]))
        cl.request("PUT", f"/hot/{key}", new)
        objects[key] = new
        get_ok(cl, key)
        print(f"  overwrite of resident {key}: the next GET served the new bytes")

        key = resident[1]
        with tier._mu:
            entry = tier._entries[("hot", key)]
        entry.data[0, 0, 0] ^= 0xFF
        if entry.data.is_cuda:
            torch.cuda.synchronize()
        st0 = tier.stats()
        get_ok(cl, key)
        st1 = tier.stats()
        if st1["hits"] != st0["hits"] or st1["evictions"] <= st0["evictions"]:
            raise AssertionError("flipped resident byte: the GET did not fall back")
        print(f"  flipped byte in resident {key}: the GET fell back to the "
              f"drive path, byte-equal; {st1}")
        end = kernels.launches()
        _fill_launches(records, "hot", {n: end[n] - start[n] for n in kernels.KERNELS})
        print("  launches hot-tier phase: " + ", ".join(
            f"{n} {end[n] - start[n]}" for n in kernels.KERNELS))
    finally:
        pool.close()
        cl.close()
        _close_server(srv)
        hottier.reset_global()
        for k in env:
            os.environ.pop(k, None)
        shutil.rmtree(work, ignore_errors=True)


def _mp_part(seed: int, i: int) -> bytes:
    """Part i of the multipart phase's object, made from the seed."""
    import numpy as np

    return np.random.default_rng([seed, 6, i]).bytes(MP_PART_SIZE)


def _mp_parts_for(free_bytes: int) -> int:
    """MP_PARTS, halved (down to 64 parts, 1 GiB) until the drives' copy of
    the object (16/12 of it, plus room for a second upload and heal's tmp
    files) fits in `free_bytes`."""
    parts = MP_PARTS
    while parts > 64 and parts * MP_PART_SIZE * 16 / 12 * 1.25 > free_bytes:
        parts //= 2
    return parts


def _upload_id(doc: bytes) -> str:
    import xml.etree.ElementTree as ET

    return ET.fromstring(doc).find(
        "{http://s3.amazonaws.com/doc/2006-03-01/}UploadId").text


def _complete_doc(etags: list[str]) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>").encode()


class _Kept:
    """A phase's deployment kept serving for later phases: its S3 URL,
    what it holds (the object's part md5s and SHA-256), and close() to
    stop it and remove its drives."""

    def __init__(self, url: str, bucket: str, key: str, size: int, md5s: list,
                 sha256: str, close):
        self.url, self.bucket, self.key, self.size = url, bucket, key, size
        self.md5s, self.sha256 = md5s, sha256
        self.close = close


def multipart_phase(seed: int, card: str, records: list[dict] | None,
                    n_parts: int | None = None, device: str = "cuda",
                    keep: bool = False) -> _Kept | None:
    """BASELINE.json config 5 (erasure-server-pool PutObject, 4x16-drive
    pools, multipart) and config 4 (HealObject of a 16-drive set with 4
    drives offline) through the port's S3 server; see phase 6 above. With
    `keep`, the pools keep serving the object after the phase, for the
    listing phase, until the caller closes the returned _Kept."""
    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.local import LocalDrive

    work = tempfile.mkdtemp(prefix="mtpu-torch-mp-")
    free = shutil.disk_usage(work).free
    parts = n_parts or _mp_parts_for(free)
    size = parts * MP_PART_SIZE
    gib = size / (1 << 30)
    print(f"  tmp filesystem: {free} B free; object {parts} parts x "
          f"{MP_PART_SIZE} B = {size} B ({gib:.3f} GiB), {MP_INFLIGHT} part "
          f"uploads in flight" + ("" if parts == MP_PARTS else
                                  f" (cut from {MP_PARTS} parts to fit)"))
    pool_paths = [[os.path.join(work, f"pool{p}", f"d{i:02d}") for i in range(16)]
                  for p in range(4)]
    layer = ErasureServerPools([
        ErasureSets([LocalDrive(d) for d in paths], set_drive_count=16,
                    device=device) for paths in pool_paths])
    srv = S3Server(layer, sigv4.Credentials(ACCESS, SECRET)).start()
    pool = _Pool(srv.url, MP_INFLIGHT)
    cl = _Client(srv.url)
    stages, marks = {}, {}

    def mark(stage):
        stages[stage] = kernels.launches()
        marks[stage] = time.perf_counter()

    def get_sha(path, headers=None) -> tuple[str, int]:
        r = cl.send("GET", path, headers=headers)
        sha, n = hashlib.sha256(), 0
        while chunk := r.read(4 << 20):
            sha.update(chunk)
            n += len(chunk)
        return sha.hexdigest(), n

    try:
        es0 = layer.pools[0].sets[0]
        print(f"  4 pools x {layer.pools[0].set_count} set of 16 drives, EC "
              f"{es0.n - es0.parity}+{es0.parity}, block {es0.block_size} B, "
              f"bitrot {es0.bitrot_algorithm}")
        want_sha, md5s = hashlib.sha256(), []
        for i in range(parts):
            part = _mp_part(seed, i)
            want_sha.update(part)
            md5s.append(hashlib.md5(part).hexdigest())
        want_sha = want_sha.hexdigest()
        want_etag = hashlib.md5(b"".join(bytes.fromhex(e) for e in md5s)).hexdigest()
        key = "/mpu/object-5g"
        cl.request("PUT", "/mpu")
        frees = [layer._pool_free(p) for p in layer.pools]
        kernels.reset_launches()
        mark("start")
        _r, doc = cl.request("POST", key, query={"uploads": ""})
        uid = _upload_id(doc)

        def put_part(c, i):
            r, _ = c.request("PUT", key, _mp_part(seed, i),
                             query={"partNumber": str(i + 1), "uploadId": uid})
            if r.getheader("ETag") != f'"{md5s[i]}"':
                raise AssertionError(f"part {i + 1}: ETag {r.getheader('ETag')}")

        pool.run(put_part, range(parts))
        _r, doc = cl.request("POST", key, _complete_doc(md5s), query={"uploadId": uid})
        if f"{want_etag}-{parts}".encode() not in doc:
            raise AssertionError(f"complete: {doc[:300]!r}")
        mark("put")
        owner = layer.pool_of("mpu", "object-5g")
        es = layer.pools[owner].get_hashed_set("object-5g")
        print(f"  the object went to pool {owner} (free bytes per pool before "
              f"the upload: {frees})")

        got_sha, n = get_sha(key)
        if (got_sha, n) != (want_sha, size):
            raise AssertionError(f"GET: {n} B, sha256 {got_sha} != {want_sha}")
        mark("get")
        lo = MP_PART_SIZE - 1000
        _r, data = cl.request("GET", key, headers={"Range": f"bytes={lo}-{lo + 1999}"})
        if data != _mp_part(seed, 0)[-1000:] + _mp_part(seed, 1)[:1000]:
            raise AssertionError("Range GET across the part 1/2 boundary")
        r, _ = cl.request("HEAD", key)
        if r.getheader("ETag") != f'"{want_etag}-{parts}"' or \
                int(r.getheader("Content-Length")) != size:
            raise AssertionError(f"HEAD: {r.getheader('ETag')}")

        key2 = "/mpu/second"
        _r, doc = cl.request("POST", key2, query={"uploads": ""})
        uid2 = _upload_id(doc)
        small = [_mp_part(seed + 1, 0)[:5 << 20], b"tail" * 1000]
        for i, body in enumerate(small):
            cl.request("PUT", key2, body, query={"partNumber": str(i + 1),
                                                 "uploadId": uid2})
        _r, doc = cl.request("GET", key2, query={"uploadId": uid2})
        for i, body in enumerate(small):
            if hashlib.md5(body).hexdigest().encode() not in doc:
                raise AssertionError(f"ListParts: part {i + 1} missing: {doc[:300]!r}")
        r, _ = cl.request("DELETE", key2, query={"uploadId": uid2})
        left = [d for paths in pool_paths for d in paths
                if glob.glob(os.path.join(d, ".mtpu.sys", "multipart", "*", uid2))]
        if r.status != 204 or left:
            raise AssertionError(f"Abort: {r.status}, session left on {left}")
        print(f"  GET, Range GET, HEAD (ETag {want_etag}-{parts}), ListParts and "
              "Abort of a second upload: ok")

        # BASELINE.json config 4: 4 of the set's 16 drives lose the object,
        # the 4 that hold data shards 1-4, so a read must rebuild.
        dist = es.latest_fileinfo("mpu", "object-5g").erasure.distribution
        lost = [d.root for d, shard in zip(es.drives, dist) if shard <= 4]
        _settle(es.drives)
        originals = {}
        for d in lost:
            for f in glob.glob(os.path.join(d, "mpu", "object-5g", "*", "part.*")):
                with open(f, "rb") as fh:
                    originals[f] = hashlib.sha256(fh.read()).hexdigest()
        if len(originals) != 4 * parts:
            raise AssertionError(f"{len(originals)} shard files on the lost drives")
        for d in lost:
            shutil.rmtree(os.path.join(d, "mpu", "object-5g"))
        mark("lose")
        got_sha, n = get_sha(key)
        if (got_sha, n) != (want_sha, size):
            raise AssertionError("degraded GET: bytes differ")
        mark("degraded_get")
        res = layer.heal_object("mpu", "object-5g", scan_deep=True)
        mark("heal")
        rebuilt = {}
        for f in originals:
            with open(f, "rb") as fh:
                rebuilt[f] = hashlib.sha256(fh.read()).hexdigest()
        if res.healed_count != 4 or rebuilt != originals:
            raise AssertionError(f"heal: {res.healed_count} healed, "
                                 f"{sum(rebuilt[f] != originals[f] for f in originals)}"
                                 " files differ")
        got_sha, n = get_sha(key)
        if (got_sha, n) != (want_sha, size):
            raise AssertionError("GET after heal: bytes differ")
        mark("end")
    except BaseException:
        keep = False
        raise
    finally:
        pool.close()
        cl.close()

        def close():
            _close_server(srv)
            shutil.rmtree(work, ignore_errors=True)

        if not keep:
            close()

    order = ["start", "put", "get", "lose", "degraded_get", "heal", "end"]
    for a, b in zip(order, order[1:]):
        if b != "lose":
            print(f"  launches {b}: " + ", ".join(
                f"{n} {stages[b][n] - stages[a][n]}" for n in kernels.KERNELS))
    for a, b, names in (("start", "put", MXSUM_KERNELS),
                        ("lose", "degraded_get", ("gf2_matmul", "mxsum_digest")),
                        ("degraded_get", "heal", ("gf2_matmul", "mxsum_digest"))):
        for name in names:
            if stages[b][name] - stages[a][name] <= 0:
                raise AssertionError(f"{name} did not launch for {b}")
    if records is not None:
        _fill_launches(records, "multipart", {
            n: stages["end"][n] - stages["start"][n] for n in kernels.KERNELS})
    put_s = marks["put"] - marks["start"]
    get_s = marks["get"] - marks["put"]
    deg_s = marks["degraded_get"] - marks["lose"]
    heal_s = marks["heal"] - marks["degraded_get"]
    print(f"  multipart {gib:.3f} GiB on {card}: PUT {gib / put_s:.6f} GiB/s "
          f"({put_s:.6f} s, Create to Complete), GET {gib / get_s:.6f} GiB/s "
          f"({get_s:.6f} s), degraded GET (4 of 16 lost) {gib / deg_s:.6f} GiB/s "
          f"({deg_s:.6f} s), deep heal of 4 drives {heal_s:.6f} s; pool {owner}")
    return (_Kept(srv.url, "mpu", "object-5g", size, md5s, want_sha, close)
            if keep else None)


_VERSIONING_ON = (b"<VersioningConfiguration><Status>Enabled</Status>"
                  b"</VersioningConfiguration>")


def _versions_page(doc: bytes):
    """A ListObjectVersions answer -> ([(key, version id, is latest, is a
    delete marker, etag, size)], truncated, next key marker, next
    version-id marker)."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(doc)
    out = []
    for e in root:
        tag = e.tag[len(S3_NS):]
        if tag in ("Version", "DeleteMarker"):
            out.append((e.findtext(S3_NS + "Key"), e.findtext(S3_NS + "VersionId"),
                        e.findtext(S3_NS + "IsLatest") == "true", tag == "DeleteMarker",
                        (e.findtext(S3_NS + "ETag") or "").strip('"'),
                        int(e.findtext(S3_NS + "Size") or 0)))
    return (out, root.findtext(S3_NS + "IsTruncated") == "true",
            root.findtext(S3_NS + "NextKeyMarker") or "",
            root.findtext(S3_NS + "NextVersionIdMarker") or "")


def _copy_etag(doc: bytes) -> str:
    import xml.etree.ElementTree as ET

    return ET.fromstring(doc).findtext(S3_NS + "ETag").strip('"')


class _Stages:
    """Kernel launch counts and the host clock at each named point of a
    phase; report() prints each stage's seconds, rate and launches."""

    def __init__(self):
        from minio_tpu_torch.ops import kernels

        self._kernels = kernels
        self.at: list[tuple[str, dict, float]] = []

    def mark(self, name: str) -> None:
        self.at.append((name, self._kernels.launches(), time.perf_counter()))

    def delta(self, name: str) -> tuple[float, dict]:
        i = [n for n, _l, _t in self.at].index(name)
        (_a, la, ta), (_b, lb, tb) = self.at[i - 1], self.at[i]
        return tb - ta, {k: lb[k] - la[k] for k in lb}

    def need(self, name: str, kernels=("gf2_matmul", "mxsum_digest")) -> None:
        _s, d = self.delta(name)
        for k in kernels:
            if d[k] <= 0:
                raise AssertionError(f"{k} did not launch for {name}")


def versioning_phase(seed: int, card: str, mp: _Kept | None, device: str = "cuda",
                     big_size: int = VER_SIZE, small_keys: int = VER_KEYS,
                     clients: int = 64) -> None:
    """S3 versioning, server-side copies, tags and conditional requests
    (phase 7) through the port's S3 server over HTTP with SigV4. On config
    1's deployment (12 drives on /dev/shm, EC 8+4, 1 MiB blocks): one object of
    `big_size` bytes PUT as the null version, then, with the bucket's
    versioning enabled, overwritten 3 times; each of the 4 versions read
    back by its id ("null" included); the first versioned one, now
    noncurrent, read with its shards lost on the 4 drives that hold data
    shards 1-4, deep-healed (the rebuilt files equal to the originals) and
    read with data shards 5-8 moved away; a DELETE without an id answers
    with a delete marker, a GET then 404 with x-amz-delete-marker, and the
    marker deleted by its id brings the newest version back; CopyObject of
    the noncurrent version with the metadata directives COPY and REPLACE;
    tags on a version; If-Match and If-None-Match on GET and HEAD. Then
    small versioned objects: `clients` clients PUT `small_keys` keys, 4
    versions each, of 1-512 KiB (log-uniform), the bucket walked with
    ListObjectVersions in pages of 1000 (every version once, one latest
    per key), and VER_DELETE versions removed by one DeleteObjects naming
    their VersionIds. Last, on phase 6's pools (`mp`), UploadPartCopy of
    the multipart object's first VER_COPY_PARTS parts into a versioned
    bucket, in its own 16 MiB parts, 4 in flight: every part's ETag the
    source part's md5, the Complete answered with a version id, each part
    of the copy read back with the source part's md5. The server runs
    with enable_mrf=False: the degraded GET queues no background heal to
    race the phase's deep heal."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    rng = np.random.default_rng(seed + 8)
    bodies = [rng.bytes(big_size) for _ in range(VER_VERSIONS)]  # null, then 3
    md5 = [hashlib.md5(b).hexdigest() for b in bodies]
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                               small_keys * VER_VERSIONS)).astype(np.int64)
    small = [(f"s{i // VER_VERSIONS:04d}", rng.bytes(int(n))) for i, n in enumerate(sizes)]
    # Drives on /dev/shm, as the listing phase's: the phase's rates then
    # do not hang on the write-back of the gigabytes that the earlier
    # phases left on the tmp filesystem.
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-ver-", dir=shm)
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    cl = _Client(srv.url)
    pool = _Pool(srv.url, clients)
    st = _Stages()
    big = "/ver/big"
    gib = big_size / (1 << 30)
    try:
        es = srv.obj.pools[0].sets[0]
        print(f"  server {srv.url}: EC {es.n - es.parity}+{es.parity}, block "
              f"{es.block_size} B, bitrot {es.bitrot_algorithm}; {VER_VERSIONS} versions "
              f"of {big_size} B, {small_keys} x {VER_VERSIONS} small versions, "
              f"{clients} client threads")
        cl.request("PUT", "/ver")
        kernels.reset_launches()
        st.mark("start")
        r, _ = cl.request("PUT", big, bodies[0], headers={"x-amz-meta-gen": "0"})
        if r.getheader("x-amz-version-id"):
            raise AssertionError("a PUT before versioning got a version id")
        cl.request("PUT", "/ver", _VERSIONING_ON, query={"versioning": ""})
        vids = ["null"]
        for i in range(1, VER_VERSIONS):
            r, _ = cl.request("PUT", big, bodies[i], headers={
                "x-amz-meta-gen": str(i), "Content-Type": f"application/x-v{i}"})
            if not r.getheader("x-amz-version-id") or r.getheader("ETag") != f'"{md5[i]}"':
                raise AssertionError(f"versioned PUT {i}: {r.getheader('x-amz-version-id')}")
            vids.append(r.getheader("x-amz-version-id"))
        st.mark("put")

        def get_version(i, what, headers=None):
            r, data = cl.request("GET", big, query={"versionId": vids[i]}, headers=headers)
            if data != bodies[i] or r.getheader("ETag") != f'"{md5[i]}"':
                raise AssertionError(f"{what}: GET of version {i} differs")
            if r.getheader("x-amz-version-id") != (vids[i] if i else None):
                raise AssertionError(f"{what}: x-amz-version-id {r.getheader('x-amz-version-id')}")

        for i in range(VER_VERSIONS):
            get_version(i, "intact")
        st.mark("get")

        # The first versioned one is noncurrent: lose its shards on the 4
        # drives of data shards 1-4, read it, deep-heal it.
        fi = es.latest_fileinfo("ver", "big", vids[1])
        by_shard = {shard: d for d, shard in zip(es.drives, fi.erasure.distribution)}

        def v1_dir(shard):
            return os.path.join(by_shard[shard].root, "ver", "big", fi.data_dir)

        originals = {s_: open(os.path.join(v1_dir(s_), "part.1"), "rb").read()
                     for s_ in (1, 2, 3, 4)}
        for s_ in originals:
            shutil.rmtree(v1_dir(s_))
        st.mark("lose")
        get_version(1, "degraded (4 of 12 drives lost)")
        st.mark("degraded_get")
        res = srv.obj.heal_object("ver", "big", vids[1], scan_deep=True)
        if res.healed_count != 4 or res.version_id != vids[1] or any(
                open(os.path.join(v1_dir(s_), "part.1"), "rb").read() != data
                for s_, data in originals.items()):
            raise AssertionError(f"heal of the noncurrent version: {res.healed_count} "
                                 "healed or files differ")
        st.mark("heal")
        aside = [(v1_dir(s_), os.path.join(work, f"aside-{s_}")) for s_ in (5, 6, 7, 8)]
        for src, dst in aside:
            os.replace(src, dst)
        get_version(1, "healed, 4 other drives lost")
        for src, dst in aside:
            os.replace(dst, src)
        st.mark("get_after_heal")

        r, _ = cl.request("DELETE", big)
        dm = r.getheader("x-amz-version-id")
        if r.status != 204 or r.getheader("x-amz-delete-marker") != "true" or not dm:
            raise AssertionError(f"DELETE without an id: {r.status}, no delete marker")
        r, doc = cl.request("GET", big, check=False)
        if (r.status != 404 or b"<Code>NoSuchKey</Code>" not in doc
                or r.getheader("x-amz-delete-marker") != "true"
                or r.getheader("x-amz-version-id") != dm):
            raise AssertionError(f"GET after the delete marker: {r.status}")
        r, _ = cl.request("DELETE", big, query={"versionId": dm})
        r, data = cl.request("GET", big, headers={"Range": "bytes=0-1048575"})
        if data != bodies[-1][:1 << 20] or r.getheader("x-amz-version-id") != vids[-1]:
            raise AssertionError("the newest version does not answer after its marker went")
        st.mark("markers")

        source = f"/ver/big?versionId={vids[1]}"
        _r, doc = cl.request("PUT", "/ver/copy-v1", headers={"x-amz-copy-source": source})
        _r, doc2 = cl.request("PUT", "/ver/copy-v1-replace", headers={
            "x-amz-copy-source": source, "x-amz-metadata-directive": "REPLACE",
            "x-amz-meta-new": "yes", "Content-Type": "text/plain"})
        st.mark("copy")
        if _copy_etag(doc) != md5[1] or _copy_etag(doc2) != md5[1]:
            raise AssertionError("CopyObject: ETag is not the source's md5")
        for key, want in (("copy-v1", {"x-amz-meta-gen": "1", "x-amz-meta-new": None,
                                       "Content-Type": "application/x-v1"}),
                          ("copy-v1-replace", {"x-amz-meta-gen": None, "x-amz-meta-new": "yes",
                                               "Content-Type": "text/plain"})):
            r, data = cl.request("GET", f"/ver/{key}")
            got = {h: r.getheader(h) for h in want}
            if data != bodies[1] or got != want or r.getheader("x-amz-version-id") is None:
                raise AssertionError(f"CopyObject {key}: bytes or metadata differ: {got}")
        st.mark("copy_get")

        tags = (b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
                b"<Tag><Key>gen</Key><Value>2</Value></Tag></TagSet></Tagging>")
        v2 = {"versionId": vids[2]}
        cl.request("PUT", big, tags, query={"tagging": "", **v2})
        _r, doc = cl.request("GET", big, query={"tagging": "", **v2})
        r, _ = cl.request("HEAD", big, query=v2)
        if b"<Key>env</Key><Value>prod</Value>" not in doc or \
                r.getheader("x-amz-tagging-count") != "2":
            raise AssertionError("tags on a version")
        r, _ = cl.request("DELETE", big, query={"tagging": "", **v2})
        _r, doc = cl.request("GET", big, query={"tagging": "", **v2})
        if r.status != 204 or b"<Tag>" in doc:
            raise AssertionError("DeleteObjectTagging")
        etag, other = f'"{md5[-1]}"', '"00000000000000000000000000000000"'
        for method, headers, want in (
                ("GET", {"If-Match": etag, "Range": "bytes=0-1023"}, 206),
                ("GET", {"If-Match": other}, 412),
                ("GET", {"If-None-Match": etag}, 304),
                ("GET", {"If-None-Match": other, "Range": "bytes=0-1023"}, 206),
                ("HEAD", {"If-None-Match": etag}, 304),
                ("HEAD", {"If-Match": other}, 412),
                ("HEAD", {"If-Match": etag}, 200)):
            r, data = cl.request(method, big, headers=headers, check=False)
            if r.status != want or (want == 206 and data != bodies[-1][:1024]):
                raise AssertionError(f"{method} {headers}: {r.status}, {want} expected")
        st.mark("tags")
        print(f"  {VER_VERSIONS} versions byte-equal by id (null included); the "
              "noncurrent one degraded, healed and read again; delete marker 404 and "
              "its removal; CopyObject COPY and REPLACE byte-equal with their metadata; "
              "tags on a version; If-Match/If-None-Match 206/412/304/200: ok")

        # Small versioned objects: the plane phase's mix, 4 versions a key.
        cl.request("PUT", "/vsmall")
        cl.request("PUT", "/vsmall", _VERSIONING_ON, query={"versioning": ""})
        st.mark("small_start")

        def put_small(c, item):
            key, data = item
            r, _ = c.request("PUT", f"/vsmall/{key}", data)
            vid = r.getheader("x-amz-version-id")
            if not vid or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"small versioned PUT {key}")
            return (key, vid), (hashlib.md5(data).hexdigest(), len(data))

        expected = dict(pool.run(put_small, small))
        st.mark("small_put")

        def walk_versions():
            seen, latest, km, vm, pages = {}, set(), "", "", 0
            while True:
                q = {"versions": "", "max-keys": "1000"}
                if km:
                    q.update({"key-marker": km, "version-id-marker": vm})
                page, truncated, km, vm = _versions_page(cl.request("GET", "/vsmall",
                                                                    query=q)[1])
                pages += 1
                for key, vid, is_latest, is_marker, etag, size in page:
                    if (key, vid) in seen or is_marker:
                        raise AssertionError(f"ListObjectVersions: {key} {vid} repeated")
                    seen[(key, vid)] = (etag, size)
                    if is_latest:
                        if key in latest:
                            raise AssertionError(f"two latest versions of {key}")
                        latest.add(key)
                if not truncated:
                    return seen, latest, pages

        seen, latest, pages = walk_versions()
        st.mark("small_list")
        if seen != expected or latest != {k for k, _v in expected}:
            raise AssertionError(f"ListObjectVersions: {len(seen)} versions, "
                                 f"{len(expected)} PUT")
        doomed = sorted(expected)[:VER_DELETE]
        doc = cl.request("POST", "/vsmall", ("<Delete>" + "".join(
            f"<Object><Key>{k}</Key><VersionId>{v}</VersionId></Object>"
            for k, v in doomed) + "</Delete>").encode(), query={"delete": ""})[1]
        st.mark("small_delete")
        if doc.count(b"<Deleted>") != len(doomed) or b"<Error>" in doc or any(
                f"<VersionId>{v}</VersionId>".encode() not in doc for _k, v in doomed):
            raise AssertionError(f"DeleteObjects of versions: {doc[:300]!r}")
        left, _latest, _p = walk_versions()
        if left != {kv: expected[kv] for kv in sorted(expected)[len(doomed):]}:
            raise AssertionError(f"{len(left)} versions left after DeleteObjects")
        print(f"  {len(small)} small versioned PUTs; ListObjectVersions: every version "
              f"once in {pages} pages, one latest per key; DeleteObjects of "
              f"{len(doomed)} VersionIds in one POST, {len(left)} versions left: ok")
    finally:
        pool.close()
        cl.close()
        _close_server(srv)
        shutil.rmtree(work, ignore_errors=True)

    if mp is not None:
        # UploadPartCopy on phase 6's pools, into a versioned bucket.
        c = _Client(mp.url)
        ppool = _Pool(mp.url, MP_INFLIGHT)
        try:
            c.request("PUT", "/mpver")
            c.request("PUT", "/mpver", _VERSIONING_ON, query={"versioning": ""})
            st.mark("part_copy_start")
            _r, doc = c.request("POST", "/mpver/copy", query={"uploads": ""})
            uid = _upload_id(doc)

            def copy_part(cc, i):
                _r, doc = cc.request("PUT", "/mpver/copy", query={
                    "partNumber": str(i + 1), "uploadId": uid}, headers={
                    "x-amz-copy-source": f"/{mp.bucket}/{mp.key}",
                    "x-amz-copy-source-range":
                        f"bytes={i * MP_PART_SIZE}-{(i + 1) * MP_PART_SIZE - 1}"})
                if _copy_etag(doc) != mp.md5s[i]:
                    raise AssertionError(f"UploadPartCopy {i + 1}: ETag {_copy_etag(doc)}")

            md5s = mp.md5s[:VER_COPY_PARTS]
            ppool.run(copy_part, range(len(md5s)))
            want_etag = hashlib.md5(b"".join(bytes.fromhex(e) for e in md5s)).hexdigest()
            r, doc = c.request("POST", "/mpver/copy", _complete_doc(md5s),
                               query={"uploadId": uid})
            st.mark("part_copy")
            if not r.getheader("x-amz-version-id") or \
                    f"{want_etag}-{len(md5s)}".encode() not in doc:
                raise AssertionError(f"Complete of the part copy: {doc[:300]!r}")
            # The copy read back part by part against the md5 of each
            # source part, taken when phase 6 PUT it.
            r = c.send("GET", "/mpver/copy")
            for i, want in enumerate(md5s):
                got = r.read(MP_PART_SIZE)
                if len(got) != MP_PART_SIZE or hashlib.md5(got).hexdigest() != want:
                    raise AssertionError(f"the part copy's part {i + 1} differs "
                                         "from the source's")
            if r.read(1):
                raise AssertionError("the part copy is longer than its parts")
            st.mark("part_copy_get")
            print(f"  UploadPartCopy of {mp.key}'s first {len(md5s)} parts of "
                  f"{MP_PART_SIZE} B, {MP_INFLIGHT} in flight, into a versioned bucket: "
                  f"every part ETag the source part's md5, version id "
                  f"{r.getheader('x-amz-version-id')}, every part's md5 read back: ok")
        finally:
            ppool.close()
            c.close()

    # Each stage: (amount, unit, what the amount counts).
    report = [("put", VER_VERSIONS * gib, "GiB", f"{VER_VERSIONS} PUTs"),
              ("get", VER_VERSIONS * gib, "GiB", f"{VER_VERSIONS} GETs by id"),
              ("degraded_get", gib, "GiB", "4 of 12 drives lost"),
              ("heal", 4, "shards", "deep heal of the noncurrent version"),
              ("get_after_heal", gib, "GiB", "4 other drives lost"),
              ("markers", 4, "requests", "DELETE, GET 404, DELETE of the marker, GET"),
              ("copy", 2 * gib, "GiB", "CopyObject COPY and REPLACE"),
              ("copy_get", 2 * gib, "GiB", "GETs of the copies"),
              ("tags", 12, "requests", "tags on a version and conditional requests"),
              ("small_put", len(small), "objects", "small versioned PUTs"),
              ("small_list", len(small), "versions", "ListObjectVersions walk"),
              ("small_delete", min(VER_DELETE, len(small)), "versions",
               "one DeleteObjects")]
    if mp is not None:
        n_copy = min(VER_COPY_PARTS, len(mp.md5s))
        mp_gib = n_copy * MP_PART_SIZE / (1 << 30)
        report += [("part_copy", mp_gib, "GiB",
                    f"UploadPartCopy of {n_copy} parts, Create to Complete"),
                   ("part_copy_get", mp_gib, "GiB", "GET of the copy")]
    for name, amount, unit, what in report:
        secs, d = st.delta(name)
        print(f"  versioning {name} on {card}: {secs:.6f} s, {amount / secs:.6f} "
              f"{unit}/s ({amount:g} {unit}, {what}); launches "
              + ", ".join(f"{k} {d[k]}" for k in kernels.KERNELS))
    for name in ("put", "degraded_get", "heal", "copy", "small_put") + (
            ("part_copy",) if mp is not None else ()):
        st.need(name)
    st.need("get", ("mxsum_digest",))
    st.need("get_after_heal")
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in kernels.KERNELS}
    print("  launches versioning phase: " + ", ".join(f"{k} {total[k]}"
                                                      for k in kernels.KERNELS))


def _settle(drives) -> None:
    """Every acknowledged journal of these set drives on disk, before the
    phase copies or damages their files directly: with the metadata plane
    on, a commit is acknowledged by its WAL fsync and its meta.mp written
    later."""
    from minio_tpu_torch.storage import healthcheck

    for d in drives:
        healthcheck.unwrap(d).flush_wal()


def _reader_drive(root: str):
    """A LocalDrive over `root` for reading its files, mounted with the
    metadata plane off so it leaves the server's WAL of the drive alone."""
    from minio_tpu_torch.storage.local import LocalDrive

    prev = os.environ.get("MTPU_METAPLANE")
    os.environ["MTPU_METAPLANE"] = "0"
    try:
        return LocalDrive(root)
    finally:
        if prev is None:
            os.environ.pop("MTPU_METAPLANE")
        else:
            os.environ["MTPU_METAPLANE"] = prev


def _close_server(srv) -> None:
    """Close a phase's server and its drives' WALs: a server owns its
    drives for the process's life in a deployment, but this script
    builds one per phase, and each idle committer left behind wakes twice
    a second for the interpreter lock the later phases' threads need."""
    from minio_tpu_torch.storage import healthcheck

    srv.close()
    for d in srv.obj.all_drives():
        base = healthcheck.unwrap(d)
        if hasattr(base, "close_wal"):
            base.close_wal()


class _Down:
    """A drive that refuses every call, as one pulled from its slot does
    (is_online false, every other method raising FaultyDisk)."""

    def __init__(self, drive):
        self.inner = drive

    def endpoint(self) -> str:
        return self.inner.endpoint()

    def is_online(self) -> bool:
        return False

    def __getattr__(self, name):
        from minio_tpu_torch.utils import errors as se

        def refuse(*_a, **_kw):
            raise se.FaultyDisk(f"{self.inner.endpoint()}: {name} refused")

        return refuse


def _wipe_keep_root(root: str) -> None:
    """Remove everything under a drive's root and keep the root (a blank
    drive mounted in its place). Retried: the server's healers write."""
    for _ in range(200):
        try:
            for name in os.listdir(root):
                full = os.path.join(root, name)
                if os.path.isdir(full):
                    shutil.rmtree(full)
                else:
                    os.remove(full)
            return
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"could not wipe {root}")


def _heal_bigs_for(free_bytes: int, n_big: int, big_size: int, rest: int) -> int:
    """n_big, halved (down to 1) until the drives' copy of the phase's data
    (12/8 of it) plus one drive's copy (1/8) fits in `free_bytes` with a
    quarter to spare."""
    while n_big > 1 and (n_big * big_size + rest) * 13 / 8 * 1.25 > free_bytes:
        n_big //= 2
    return n_big


def heal_phase(seed: int, card: str, records: list[dict] | None, device: str = "cuda",
               n_big: int = HEAL_BIG, big_size: int = HEAL_BIG_SIZE,
               n_small: int = HEAL_SMALL, mp_parts: int = HEAL_MP_PARTS,
               ver_keys: int = HEAL_VER_KEYS, mrf_puts: int = HEAL_MRF_PUTS,
               clients: int = 64, interval: float = 1.0) -> None:
    """Heal on config 1's set (12 drives on /dev/shm, EC 8+4, 1 MiB blocks)
    behind the port's server at build_server's defaults (each set's MRF
    healer on) with the auto-healer started as main() starts it (one
    AutoHealer per pool, `interval` s). Bucket A: `n_big` objects of
    `big_size`, `n_small` warp-mix objects (1-512 KiB, log-uniform) PUT by
    `clients` clients, one multipart object of `mp_parts` parts of 16 MiB;
    bucket B, versioned: `ver_keys` keys x 3 warp-mix versions, delete
    markers on a quarter of them. Then: `mrf_puts` warp-mix PUTs while 2
    drives refuse every call, all answered 200, and, once the drives are
    back, the MRF queue drained with every object ok on all 12 drives; a
    GET over a flipped byte of a big object, and the deep heal it queued
    rewriting the shard file equal to its copy; bucket C lost on 2 drives
    and healed by heal_bucket; an object whose journal is gone from 5
    drives purged as dangling, its GET then 404. Last, live replacement:
    drive 5's tree copied, then wiped with its root kept; the auto-healer
    claims the slot (format.json equal to the copy's) and rebuilds the
    drive, timed from the wipe until its healing tracker is gone; the shard
    files of every latest version equal the copy's, and so do their
    journal entries (inline ones but for the shard index, which the heal
    writes as pos + 1, as the JAX heal does); and every latest object GETs
    byte-equal, with its ETag, while 4 other drives are removed. Launch
    counts go into `records` unless it is None."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server
    
    rng = np.random.default_rng(seed + 9)

    def warp(n):
        return [int(x) for x in np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10), n))]

    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-heal-", dir=shm)
    small_sizes = warp(n_small)
    ver_sizes = warp(ver_keys * 3)
    mrf_sizes = warp(mrf_puts)
    rest = (sum(small_sizes) + sum(ver_sizes) + sum(mrf_sizes)
            + mp_parts * MP_PART_SIZE + (2 << 20))
    free = shutil.disk_usage(work).free
    cut = _heal_bigs_for(free, n_big, big_size, rest)
    data_bytes = cut * big_size + rest
    print(f"  drives' filesystem: {free} B free; {cut} objects of {big_size} B"
          + ("" if cut == n_big else f" (cut from {n_big} to fit)")
          + f", {n_small} warp-mix objects, {mp_parts} parts of {MP_PART_SIZE} B, "
          f"{ver_keys} x 3 versioned, {mrf_puts} MRF PUTs: {data_bytes} B of object data")
    bigs = {f"big-{i}": rng.bytes(big_size) for i in range(cut)}
    smalls = {f"s{i:04d}": rng.bytes(n) for i, n in enumerate(small_sizes)}
    parts = [rng.bytes(MP_PART_SIZE) for _ in range(mp_parts)]
    versions = [(f"v{i // 3:03d}", rng.bytes(n)) for i, n in enumerate(ver_sizes)]
    mrf_objs = {f"m{i:03d}": rng.bytes(n) for i, n in enumerate(mrf_sizes)}
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device).start()
    srv.start_auto_heal(interval=interval)
    es = srv.obj.pools[0].sets[0]
    cl = _Client(srv.url)
    pool = _Pool(srv.url, clients)
    st = _Stages()
    try:
        if es.mrf is None or len(srv.auto_healer) != 1:
            raise AssertionError("build_server's defaults: MRF and the auto-healer on")
        print(f"  server {srv.url}: EC {es.n - es.parity}+{es.parity}, block "
              f"{es.block_size} B, bitrot {es.bitrot_algorithm}, MRF on, auto-heal "
              f"every {interval} s, {clients} client threads")
        for b in ("/heal-a", "/heal-b", "/heal-c"):
            cl.request("PUT", b)
        cl.request("PUT", "/heal-b", _VERSIONING_ON, query={"versioning": ""})
        kernels.reset_launches()
        st.mark("start")

        def put(c, item, bucket="heal-a"):
            key, data = item
            r, _ = c.request("PUT", f"/{bucket}/{key}", data)
            if r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"PUT {bucket}/{key}: ETag")
            return r.getheader("x-amz-version-id")

        for item in bigs.items():
            put(cl, item)
        st.mark("put_big")
        pool.run(put, smalls.items())
        st.mark("put_small")
        _r, doc = cl.request("POST", "/heal-a/mp", query={"uploads": ""})
        uid = _upload_id(doc)
        md5s = [hashlib.md5(p).hexdigest() for p in parts]
        pool.run(lambda c, i: c.request("PUT", "/heal-a/mp", parts[i], query={
            "partNumber": str(i + 1), "uploadId": uid}), range(mp_parts))
        cl.request("POST", "/heal-a/mp", _complete_doc(md5s), query={"uploadId": uid})
        mp_body = b"".join(parts)
        mp_etag = '"' + hashlib.md5(b"".join(bytes.fromhex(e) for e in md5s)
                                    ).hexdigest() + f'-{mp_parts}"'
        st.mark("put_multipart")

        def put_versions(c, key):
            return [put(c, kv, "heal-b") for kv in versions if kv[0] == key]

        keys_b = sorted({k for k, _ in versions})
        vids = dict(zip(keys_b, pool.run(put_versions, keys_b)))
        marked = keys_b[::4]
        for key in marked:
            r, _ = cl.request("DELETE", f"/heal-b/{key}")
            if r.getheader("x-amz-delete-marker") != "true":
                raise AssertionError(f"DELETE heal-b/{key}: no delete marker")
        st.mark("put_versioned")
        latest_b = {k: [d for kk, d in versions if kk == k][-1]
                    for k in keys_b if k not in marked}
        print(f"  PUT {cut} x {big_size} B, {n_small} warp-mix, {mp_parts} parts, "
              f"{len(versions)} versions of {len(keys_b)} keys and {len(marked)} "
              "delete markers: ok")

        # MRF on PUT: 2 drives refuse every call while the PUTs run.
        real = {i: es.drives[i] for i in (3, 8)}
        for i, d in real.items():
            es.drives[i] = _Down(d)
        try:
            pool.run(put, mrf_objs.items())
        finally:
            for i, d in real.items():
                es.drives[i] = d
        st.mark("mrf_put")
        t0 = time.perf_counter()
        if not es.mrf.wait_idle(300):
            raise AssertionError("the MRF queue did not drain in 300 s")
        drain_s = time.perf_counter() - t0
        st.mark("mrf_drain")
        for key in mrf_objs:
            res = es.heal_object("heal-a", key, dry_run=True)
            if [s_.state for s_ in res.before] != ["ok"] * 12:
                raise AssertionError(f"after the MRF drain, {key}: "
                                     f"{[s_.state for s_ in res.before]}")
        print(f"  MRF on PUT: {mrf_puts} PUTs answered 200 with 2 of 12 drives "
              f"refusing; queue drained {drain_s:.6f} s after the drives came back "
              f"on {card}; every object ok on all 12 drives")

        # MRF on GET: a flipped byte in the shard a GET reads first.
        fi = es.latest_fileinfo("heal-a", "big-0")
        victim = es.drives[fi.erasure.distribution.index(1)]
        shard = glob.glob(os.path.join(victim.root, "heal-a", "big-0", "*", "part.1"))[0]
        original = open(shard, "rb").read()
        raw = bytearray(original)
        raw[32 + 4096] ^= 0x5A
        with open(shard, "wb") as fh:
            fh.write(raw)
        st.mark("flip")
        r, data = cl.request("GET", "/heal-a/big-0")
        if data != bigs["big-0"] or r.getheader("ETag") != _md5_etag(data):
            raise AssertionError("GET over a flipped byte: bytes or ETag differ")
        st.mark("mrf_get")
        if not es.mrf.wait_idle(300) or open(shard, "rb").read() != original:
            raise AssertionError("the deep heal queued by the GET did not rewrite "
                                 "the shard file")
        st.mark("mrf_deep_heal")
        print("  MRF on GET: byte-equal GET over a flipped byte; the deep heal it "
              "queued rewrote the shard file equal to its copy: ok")

        # heal_bucket and a dangling object.
        cl.request("PUT", "/heal-c/keep", b"k" * 1000)
        dangling = rng.bytes(1 << 20)
        cl.request("PUT", "/heal-c/dangling", dangling)
        _settle(es.drives)
        for i in (0, 1, 2, 3, 4):
            shutil.rmtree(os.path.join(paths[i], "heal-c", "dangling"))
        for i in (6, 7):
            shutil.rmtree(os.path.join(paths[i], "heal-c"))
        st.mark("damage_c")
        res = srv.obj.heal_bucket("heal-c")
        if ([s_.state for s_ in res.before].count("missing") != 2
                or any(s_.state != "ok" for s_ in res.after)
                or not all(os.path.isdir(os.path.join(p, "heal-c")) for p in paths)):
            raise AssertionError(f"heal_bucket: {[s_.state for s_ in res.after]}")
        res = srv.obj.heal_object("heal-c", "dangling")
        if not res.purged:
            raise AssertionError("the dangling object was not purged")
        r, doc = cl.request("GET", "/heal-c/dangling", check=False)
        if r.status != 404 or b"<Code>NoSuchKey</Code>" not in doc:
            raise AssertionError(f"GET of the purged object: {r.status}")
        st.mark("heal_bucket")
        print("  heal_bucket recreated heal-c on 2 drives; an object without its "
              "journal on 5 drives purged as dangling, GET 404 NoSuchKey: ok")

        # Live replacement of drive 5.
        if not es.mrf.wait_idle(300):
            raise AssertionError("the MRF queue did not drain before the replacement")
        drive = es.drives[5]
        copy = os.path.join(work, "copy-d05")
        _settle(es.drives)
        shutil.copytree(drive.root, copy)
        healer = srv.auto_healer[0]
        st.mark("copy")
        t0 = time.perf_counter()
        _wipe_keep_root(drive.root)
        tracker = os.path.join(drive.root, ".mtpu.sys", "healing.json")
        fmt = os.path.join(drive.root, ".mtpu.sys", "format.json")
        deadline = t0 + 600
        while not (os.path.exists(fmt) and not os.path.exists(tracker)
                   and healer.last_walk is not None):
            if time.perf_counter() > deadline:
                raise AssertionError("the wiped drive was not rebuilt in 600 s")
            time.sleep(0.02)
        replace_s = time.perf_counter() - t0
        st.mark("replace")
        walk = healer.last_walk
        if open(fmt, "rb").read() != open(
                os.path.join(copy, ".mtpu.sys", "format.json"), "rb").read():
            raise AssertionError("the rebuilt drive's format.json differs from its copy")
        _settle(es.drives)
        old, new = _reader_drive(copy), _reader_drive(drive.root)
        rebuilt = n_latest = inline_idx = 0
        for bucket in ("heal-a", "heal-b", "heal-c"):
            for key in sorted(os.listdir(os.path.join(copy, bucket))):
                want = old.read_version(bucket, key)
                got = new.read_version(bucket, key)
                # What the journal holds beside the entry: the walk heals
                # latest versions only, so a versioned key's journal on the
                # new drive holds one version where the copy's holds all.
                got.num_versions = want.num_versions
                got.successor_mod_time = want.successor_mod_time
                if want.inline_data and got.erasure.index != want.erasure.index:
                    got.erasure.index = want.erasure.index
                    inline_idx += 1
                if got != want:
                    raise AssertionError(f"{bucket}/{key}: the latest version's journal "
                                         "entry differs from the copy's")
                for part in want.parts if want.data_dir else ():
                    rel = os.path.join(bucket, key, want.data_dir, f"part.{part.number}")
                    body = open(os.path.join(drive.root, rel), "rb").read()
                    if body != open(os.path.join(copy, rel), "rb").read():
                        raise AssertionError(f"{rel}: rebuilt shard differs from the copy")
                    rebuilt += len(body)
                n_latest += 1
        st.mark("compare")
        print(f"  live replacement: format.json, the journal entries of {n_latest} "
              f"latest versions ({inline_idx} inline ones with the heal's shard "
              f"index) and {rebuilt} B of shard files equal to the copy's: ok")

        # Every latest object, with 4 other drives removed.
        removed = {i: es.drives[i] for i in (0, 1, 2, 3)}
        for i, d in removed.items():
            es.drives[i] = _Down(d)
        try:
            def get_ok(c, item):
                path, want, etag = item
                r, data = c.request("GET", path)
                if data != want or r.getheader("ETag") != (etag or _md5_etag(want)):
                    raise AssertionError(f"GET {path} with 4 drives removed: differs")

            items = ([(f"/heal-a/{k}", v, None) for k, v in bigs.items()]
                     + [("/heal-a/mp", mp_body, mp_etag)])
            for item in items:
                get_ok(cl, item)
            pool.run(get_ok, [(f"/heal-a/{k}", v, None) for k, v in smalls.items()]
                     + [(f"/heal-a/{k}", v, None) for k, v in mrf_objs.items()]
                     + [(f"/heal-b/{k}", v, None) for k, v in latest_b.items()]
                     + [("/heal-c/keep", b"k" * 1000, None)])
            for key in marked:
                r, _ = cl.request("GET", f"/heal-b/{key}", check=False)
                if r.status != 404:
                    raise AssertionError(f"GET heal-b/{key} behind its marker: {r.status}")
        finally:
            for i, d in removed.items():
                es.drives[i] = d
        st.mark("get_degraded")
        n_get = len(bigs) + 1 + len(smalls) + len(mrf_objs) + len(latest_b) + 1
        gib_s = rebuilt / (1 << 30) / replace_s
        _s, d = st.delta("replace")
        print(f"  live replacement on {card}: {replace_s:.6f} s from the wipe until "
              f"the tracker was gone; {rebuilt} B of shards rebuilt, "
              f"{gib_s:.6f} GiB/s; tracker healed {walk.healed}, failed "
              f"{walk.failed}, {walk.healed / replace_s:.6f} objects/s; launches "
              + ", ".join(f"{k} {d[k]}" for k in kernels.KERNELS))
        print(f"  {n_get} latest objects GET byte-equal with their ETags and "
              f"{len(marked)} markers 404, 4 other drives removed: ok")
        if walk.failed:
            raise AssertionError(f"the walk failed {walk.failed} objects")
    finally:
        pool.close()
        cl.close()
        backlog = es.mrf.backlog()
        _close_server(srv)
        shutil.rmtree(work, ignore_errors=True)
    print(f"  server closed with {backlog} MRF entries left (heals queued by the "
          "GETs with 4 drives removed, backing off; dropped at close)")
    gib = cut * big_size / (1 << 30)
    report = [("put_big", gib, "GiB", f"{cut} PUTs of {big_size} B"),
              ("put_small", n_small, "objects", "warp-mix PUTs"),
              ("put_multipart", mp_parts * MP_PART_SIZE / (1 << 30), "GiB",
               "multipart, Create to Complete"),
              ("put_versioned", len(versions) + len(marked), "requests",
               "versioned PUTs and delete markers"),
              ("mrf_put", mrf_puts, "objects", "PUTs with 2 drives refusing"),
              ("mrf_drain", mrf_puts, "objects", "MRF drain after the drives came back"),
              ("mrf_get", big_size / (1 << 30), "GiB", "GET over a flipped byte"),
              ("mrf_deep_heal", 1, "objects", "the deep heal the GET queued"),
              ("heal_bucket", 2, "calls", "heal_bucket and the dangling purge"),
              ("replace", n_latest, "objects", "live replacement of drive 5"),
              ("get_degraded", n_get, "objects", "GETs with 4 other drives removed")]
    for name, amount, unit, what in report:
        secs, d = st.delta(name)
        print(f"  heal {name} on {card}: {secs:.6f} s, {amount / secs:.6f} {unit}/s "
              f"({amount:g} {unit}, {what}); launches "
              + ", ".join(f"{k} {d[k]}" for k in kernels.KERNELS))
    for name in ("put_big", "put_small", "mrf_put", "mrf_deep_heal", "replace",
                 "get_degraded"):
        st.need(name)
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in kernels.KERNELS}
    print("  launches heal phase: " + ", ".join(f"{k} {total[k]}" for k in kernels.KERNELS))
    if records is not None:
        _fill_launches(records, "heal", total)


def _cpu_model() -> str:
    """The host CPU as lscpu (else /proc/cpuinfo) names it: its model name,
    or, where a virtual machine reports none, vendor, family, model and
    stepping."""
    try:
        text = subprocess.run(["lscpu"], capture_output=True, text=True,
                              timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        text = ""
    try:
        text += open("/proc/cpuinfo").read()
    except OSError:
        pass
    fields: dict[str, str] = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip().lower(), value.strip())
    name = fields.get("model name", "")
    if name and name.lower() not in ("unknown", "-"):
        return name
    return (f"{fields.get('vendor id') or fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')} "
            f"stepping {fields.get('stepping', '?')} (no model name)")


def _host_hash_rates(seed: int, threads: int = 12, reps: int = 64) -> dict:
    """MB/s of each host algorithm over 128 KiB chunks (a PUT's chunk at
    EC 8+4, 1 MiB blocks): one thread, and `threads` threads at once, as
    the writer threads of a 12-drive PUT hash (ctypes and hashlib release
    the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from minio_tpu_torch.ops import bitrot

    chunk = np.random.default_rng(seed).bytes(S)
    rates = {}
    with ThreadPoolExecutor(max_workers=threads) as ex:
        for name in ("sip256", "highwayhash256", "xxh64", "sha256", "blake2b256"):
            algo = bitrot.get_algorithm(name)
            algo.digest(chunk)
            t0 = time.perf_counter()
            for _ in range(reps):
                algo.digest(chunk)
            one = reps * S / (time.perf_counter() - t0) / 1e6
            t0 = time.perf_counter()
            list(ex.map(lambda _i: [algo.digest(chunk) for _ in range(reps)],
                        range(threads)))
            many = threads * reps * S / (time.perf_counter() - t0) / 1e6
            rates[name] = (one, many)
    return rates


def _plain_digest(algo: str, chunk: bytes, device: str) -> bytes:
    """A chunk's digest by the algorithm's plain version (the port's
    pure-Python host hashes, hashlib, or the plain PyTorch device digests
    on `device`)."""
    import numpy as np
    import torch

    from minio_tpu_torch.native import plain
    from minio_tpu_torch.ops import bitrot, mxhash, mxsum

    if algo in bitrot.DEVICE_ALGORITHMS:
        x = torch.from_numpy(np.frombuffer(chunk, dtype=np.uint8).copy())[None].to(device)
        lens = torch.tensor([len(chunk)], dtype=torch.int32, device=device)
        fn = mxhash.mxhash256_plain if algo == "mxhash256" else mxsum.digest_plain
        return fn(x, lens)[0].cpu().numpy().tobytes()
    return {"sip256": lambda c: plain.sip256_py(bitrot.BITROT_KEY, c),
            "highwayhash256": lambda c: plain.highwayhash256_py(bitrot.HH_BITROT_KEY, c),
            "xxh64": lambda c: plain.xxh64_py(c, bitrot.XXH64_SEED).to_bytes(8, "big"),
            "sha256": lambda c: hashlib.sha256(c).digest(),
            "blake2b256": lambda c: hashlib.blake2b(c, digest_size=32,
                                                    key=bitrot.BITROT_KEY).digest(),
            }[algo](chunk)


def bitrot_phase(seed: int, card: str, records: list[dict] | None,
                 device: str = "cuda", algos=BITROT_ALGOS) -> None:
    """Every bitrot algorithm of the JAX registry on config 1's set (12
    drives on /dev/shm, EC 8+4, 1 MiB blocks), each behind the port's S3
    server over ErasureSets(..., bitrot_algorithm=) in a bucket of its own:
    one object of the algorithm's size PUT, GET (bytes and ETag), GET with
    4 of 12 drives' shard files removed, deep-healed (the 4 rebuilt files
    equal their copies, verify_shard_file over each), and two sampled chunk
    digests of a data and a parity shard held against the algorithm's plain
    version. Under mxhash256 every digest comes from K3, one launch per
    batch: the PUT launches K3 as often as K1. Also the host hashes' MB/s.
    Launch counts go into `records` unless it is None."""
    import numpy as np

    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.ops import bitrot, kernels
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.local import LocalDrive

    rng = np.random.default_rng(seed + 10)
    rates = _host_hash_rates(seed)
    cpu = _cpu_model()
    for name, (one, many) in rates.items():
        print(f"  host {name} over {S} B chunks on {cpu} ({os.cpu_count()} "
              f"cores; card {card}): {one:.3f} MB/s one thread, {many:.3f} MB/s "
              "12 threads at once")
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-bitrot-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    st = _Stages()
    lost = (0, 1, 2, 3)
    try:
        kernels.reset_launches()
        st.mark("start")
        for algo, size in algos:
            data = rng.bytes(size)
            sets = ErasureSets([LocalDrive(p) for p in paths], set_drive_count=12,
                               parity=4, device=device, bitrot_algorithm=algo)
            srv = S3Server(ErasureServerPools([sets]),
                           sigv4.Credentials(ACCESS, SECRET)).start()
            es = sets.sets[0]
            cl = _Client(srv.url)
            bucket = f"bitrot-{algo}"
            try:
                cl.request("PUT", f"/{bucket}")
                st.mark(f"{algo}:bucket")
                r, _ = cl.request("PUT", f"/{bucket}/obj", data)
                if r.getheader("ETag") != _md5_etag(data):
                    raise AssertionError(f"{algo}: PUT ETag")
                st.mark(f"{algo}:put")

                def get_ok(what):
                    r, got = cl.request("GET", f"/{bucket}/obj")
                    if got != data or r.getheader("ETag") != _md5_etag(data):
                        raise AssertionError(f"{algo}: {what} GET: bytes or ETag differ")

                get_ok("intact")
                st.mark(f"{algo}:get")
                fi = es.latest_fileinfo(bucket, "obj")
                if [c.algorithm for c in fi.erasure.checksums] != [algo]:
                    raise AssertionError(f"{algo}: journal names "
                                         f"{fi.erasure.checksums}")
                pos = fi.erasure.distribution
                files = {i: glob.glob(os.path.join(paths[i], bucket, "obj", "*",
                                                   "part.1"))[0] for i in range(12)}
                originals = {i: open(f, "rb").read() for i, f in files.items()}
                for i in lost:
                    shutil.rmtree(os.path.dirname(files[i]))
                get_ok("degraded (4 drives lost)")
                st.mark(f"{algo}:degraded_get")
                res = es.heal_object(bucket, "obj", scan_deep=True)
                if res.healed_count != len(lost) or any(
                        open(files[i], "rb").read() != originals[i] for i in lost):
                    raise AssertionError(f"{algo}: heal {res.healed_count}, or files "
                                         "differ from their copies")
                st.mark(f"{algo}:heal")
                shard_data = fi.erasure.shard_file_size(size)
                for i in lost:
                    with open(files[i], "rb") as f:
                        bitrot.verify_shard_file(f, shard_data, fi.erasure.shard_size(),
                                                 algo, es.device)
                st.mark(f"{algo}:verify")
                dl = bitrot.digest_len(algo)
                n_chunks = -(-shard_data // fi.erasure.shard_size())
                for shard in (1, 12):   # a data shard and a parity shard
                    raw = originals[pos.index(shard)]
                    for ci in (0, n_chunks - 1):
                        with open(files[pos.index(shard)], "rb") as f:
                            want, chunk = bitrot.BitrotReader(
                                f, shard_data, fi.erasure.shard_size(),
                                algo).read_record(ci)
                        if want != _plain_digest(algo, chunk, device) or \
                                raw[ci * (dl + fi.erasure.shard_size()):][:dl] != want:
                            raise AssertionError(f"{algo}: shard {shard} chunk {ci}: "
                                                 "digest differs from the plain version")
            finally:
                cl.close()
                _close_server(srv)
            line = []
            for stage in ("put", "get", "degraded_get", "heal"):
                sec, d = st.delta(f"{algo}:{stage}")
                line.append(f"{stage} {sec:.6f} s ({size / (1 << 30) / sec:.6f} GiB/s; "
                            f"K1/K2/K3 {d['gf2_matmul']}/{d['mxsum_digest']}/"
                            f"{d['mxhash256']})")
            print(f"  {algo}, {size} B on {card}: " + "; ".join(line)
                  + "; verify of the 4 healed files, sampled digests: ok")
            _s, put = st.delta(f"{algo}:put")
            if algo == "mxhash256" and not put["mxhash256"] == put["gf2_matmul"] > 0:
                raise AssertionError(f"mxhash256 PUT: K3 {put['mxhash256']} launches, "
                                     f"K1 {put['gf2_matmul']}")
            if algo not in bitrot.DEVICE_ALGORITHMS and (
                    put["mxhash256"] or put["mxsum_digest"] or not put["gf2_matmul"]):
                raise AssertionError(f"{algo} PUT: launches {put}")
        st.mark("end")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in st.at[0][1]}
    print(f"  launches in the phase: {total}")
    if records is not None:
        _fill_launches(records, "bitrot", total)


# The strict Prometheus 0.0.4 text parse of tests/test_observability.py:
# every line HELP, TYPE or a sample, samples only of a TYPEd family,
# values numeric.
class _Hang:
    """Phase 12's hung drive: a wrapper whose calls named in `methods`
    (every call that reaches the disk when it is "all") block until
    `release` is set, as the verify skill's NaughtyDisk HANG does."""

    def __init__(self, inner):
        import threading

        self.inner = inner
        self.methods: str | set = set()
        self.release = threading.Event()

    def endpoint(self) -> str:
        return self.inner.endpoint()

    def is_online(self) -> bool:
        return self.inner.is_online()   # no I/O: a hung disk answers it

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if not callable(fn) or name.startswith("_"):
            return fn

        def call(*a, **kw):
            if self.methods == "all" or name in self.methods:
                self.release.wait()
            return fn(*a, **kw)

        return call


def _scrape_meta(cl: _Client, paths: list[str]) -> dict:
    """The node scrape's metadata-plane and drive-health samples for the
    drives at `paths`: {family: {drive: value}}."""
    _r, body = cl.request("GET", "/minio/v2/metrics/node")
    _fams, samples = parse_exposition(body.decode())
    roots = {os.path.abspath(p) for p in paths}
    out = {}
    for fam in ("minio_tpu_metaplane_commits_total", "minio_tpu_metaplane_fsyncs_total",
                "minio_tpu_drive_state", "minio_tpu_drive_timeouts_total"):
        out[fam] = {d: v for d, v in _by_label(samples, fam, "drive").items() if d in roots}
    return out


def _child_env(extra: dict | None = None) -> dict:
    """This process's environment for a child of the port: the root
    credentials, the checkout on PYTHONPATH, and `extra`."""
    env = dict(os.environ, MTPU_ROOT_USER=ACCESS, MTPU_ROOT_PASSWORD=SECRET,
               **(extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _crash_child(paths: list[str], port: int, device: str, extra_env: dict | None = None):
    """The port's server entry point (python -m minio_tpu_torch.s3.server)
    in a child process over `paths`; returns once it serves."""
    env = _child_env(extra_env)
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.s3.server", *paths,
         "--address", f"127.0.0.1:{port}", "--device", device, "--scan-interval", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
    line = proc.stdout.readline()
    if "serving S3" not in line:
        proc.kill()
        rest = proc.communicate(timeout=30)[0]
        raise AssertionError(f"crash child did not start: {line}{rest[-2000:]}")
    return proc


def _counter_value(name: str) -> float:
    """A counter family's total over its label sets, in this process."""
    from minio_tpu_torch import obs

    for vec in obs.registry():
        if vec.name == name:
            return sum(c.value for c in vec._children.values())
    return 0.0


class _StateLog:
    """The distinct states a health-checked drive passes through, sampled
    every 5 ms on a daemon thread."""

    def __init__(self, hc):
        import threading

        self.seen = [hc.state]
        self._stop = threading.Event()

        def run():
            while not self._stop.wait(0.005):
                if hc.state != self.seen[-1]:
                    self.seen.append(hc.state)

        self._t = threading.Thread(target=run, daemon=True, name="smoke-state-log")
        self._t.start()

    def stop(self) -> list[str]:
        self._stop.set()
        self._t.join()
        return self.seen


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def meta_phase(seed: int, card: str, records: list[dict] | None, device: str = "cuda",
               n_objects: int = PLANE_OBJECTS, clients: int = 64,
               big_size: int = META_BIG, crash_clients: int = 16,
               crash_s: float = META_CRASH_S, interval: float = 1.0) -> None:
    """Phase 12 (see the module's docstring): the metadata plane and drive
    resilience on config 1's set behind the server at build_server's
    defaults (the metadata plane on, MRF on) and the auto-healer."""
    import threading

    import numpy as np
    import torch

    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server
    from minio_tpu_torch.storage import healthcheck
    from minio_tpu_torch.storage.local import LocalDrive
    from minio_tpu_torch.utils import bufpool
    from minio_tpu_torch.utils.dyntimeout import DynamicTimeout

    if os.environ.get("MTPU_METAPLANE", "1") in ("0", "false", "off"):
        raise AssertionError("phase 12 runs the metadata plane at its default (on)")
    rng = np.random.default_rng(seed + 12)

    def warp(n):
        return [int(x) for x in np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10), n))]

    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-meta-", dir=shm)
    paths = [os.path.join(work, "a", f"d{i:02d}") for i in range(12)]
    objects = {f"w{i:04d}": rng.bytes(n) for i, n in enumerate(warp(n_objects))}
    st = _Stages()
    if records is not None:
        # K1 and K2 at the phase's main shapes, against their plain
        # versions: the PUT encode and the GET verify of 1 MiB blocks.
        dev = torch.device(device)
        flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
        x = torch.from_numpy(rng.integers(0, 256, (B, K, S), dtype=np.uint8)).to(dev)
        from minio_tpu_torch.ops import mxsum, rs

        w = rs.device_encode_weights(K, M, dev)
        if not torch.equal(rs.gf2_matmul(x, w, M), rs.gf2_matmul_plain(x, w, M)):
            raise AssertionError("K1 disagrees with plain at the phase-12 PUT shape")
        chunks = x.reshape(B * K, S)
        lens = torch.full((B * K,), S, dtype=torch.int32, device=dev)
        if not torch.equal(mxsum.digest(chunks, lens), mxsum.digest_plain(chunks, lens)):
            raise AssertionError("K2 disagrees with plain at the phase-12 GET shape")
        print("  K1 [16,8,131072]->4 and K2 [128,131072] byte-equal to plain")
        _time_k1(records, "encode [16,8,131072]->4, metadata plane", "meta",
                 (x, w, M), _gf2_bound_ms(B, K, M, S), flush)
        _time_k2(records, "GET verify digest [128,131072], metadata plane", "meta",
                 chunks, lens, flush)
        # The GET verify's host path around K2: stage_and_digest copies
        # the chunks into a pinned pool tensor, uploads it, digests and
        # downloads; its tensors come back to the pool after each call.
        from minio_tpu_torch.ops import fused
        from minio_tpu_torch.utils import bufpool

        host = [bytes(r) for r in chunks.cpu().numpy()]
        want = [bytes(r) for r in mxsum.digest_plain(chunks, lens).cpu().numpy()]
        if fused.stage_and_digest(host, S, dev, mxsum.digest) != want:
            raise AssertionError("stage_and_digest disagrees with K2's plain version")
        pooled = sum(len(v) for v in bufpool.GLOBAL_POOL._pools.values())
        n0 = kernels.launches()["mxsum_digest"]
        stage_ms = _host_ms(lambda: fused.stage_and_digest(host, S, dev, mxsum.digest))
        ran = kernels.launches()["mxsum_digest"] - n0
        if ran <= 0 or sum(len(v) for v in bufpool.GLOBAL_POOL._pools.values()) != pooled:
            raise AssertionError(f"stage_and_digest: {ran} K2 launches, pooled tensors "
                                 "not reused")
        print(f"  GET verify host path, stage_and_digest of {B * K} x {S} B through the "
              f"pinned pool on {card}: {stage_ms:.6f} ms median ({ran} K2 launches, "
              f"{pooled} pooled tensors reused)")
        del flush, x, host
    srv = build_server(paths, ACCESS, SECRET, device=device).start()
    srv.start_auto_heal(interval=interval)
    es = srv.obj.pools[0].sets[0]
    bases = [healthcheck.unwrap(d) for d in es.drives]
    hang = None
    cl = _Client(srv.url)
    pool = _Pool(srv.url, clients)
    child = None
    try:
        if es.mrf is None or es._setcache is None or len(srv.auto_healer) != 1:
            raise AssertionError("build_server's defaults: metadata plane, MRF and "
                                 "the auto-healer on")
        if any(getattr(healthcheck.unwrap(d), "_wal", None) is None for d in es.drives):
            raise AssertionError("a drive's WAL is not armed")
        print(f"  server {srv.url}: EC {es.n - es.parity}+{es.parity}, block "
              f"{es.block_size} B, bitrot {es.bitrot_algorithm}, metadata plane on, "
              f"MRF on, auto-heal every {interval} s")
        cl.request("PUT", "/meta")
        kernels.reset_launches()
        st.mark("start")

        # (a) a burst of the warp mix
        m0 = _scrape_meta(cl, paths)

        def put(c, item):
            key, data = item
            r, _ = c.request("PUT", f"/meta/{key}", data)
            if r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"PUT {key}: ETag")

        def get_ok(c, key, want=None):
            r, data = c.request("GET", f"/meta/{key}")
            want = objects[key] if want is None else want
            if data != want or r.getheader("ETag") != _md5_etag(want):
                raise AssertionError(f"GET {key}: bytes or ETag differ")

        t0 = time.perf_counter()
        pool.run(put, objects.items())
        put_s = time.perf_counter() - t0
        st.mark("burst_put")
        t0 = time.perf_counter()
        pool.run(get_ok, objects)
        get_s = time.perf_counter() - t0
        st.mark("burst_get")
        m1 = _scrape_meta(cl, paths)
        commits = sum(m1["minio_tpu_metaplane_commits_total"].values()) - sum(
            m0["minio_tpu_metaplane_commits_total"].values())
        fsyncs = sum(m1["minio_tpu_metaplane_fsyncs_total"].values()) - sum(
            m0["minio_tpu_metaplane_fsyncs_total"].values())
        if commits < len(objects) * es.n or fsyncs <= 0:
            raise AssertionError(f"burst: {commits} WAL commits, {fsyncs} fsyncs")
        pinned = [t for lst in bufpool.GLOBAL_POOL._pools.values() for t in lst]
        if not pinned or (torch.device(device).type == "cuda"
                          and not all(t.is_pinned() for t in pinned)):
            raise AssertionError("GET verify staged without the pinned pool")
        print(f"  (a) burst on {card}: {n_objects} warp-mix objects by {clients} "
              f"clients; PUT {n_objects / put_s:.3f} objects/s ({put_s:.6f} s), GET "
              f"{n_objects / get_s:.3f} objects/s ({get_s:.6f} s); scrape: "
              f"minio_tpu_metaplane_commits_total +{commits:.0f}, "
              f"_fsyncs_total +{fsyncs:.0f} ({commits / fsyncs:.3f} commits per fsync); "
              f"{len(pinned)} pinned staging tensors in the pool")

        # (b) a SIGKILL inside a burst of PUTs, overwrites and deletes
        cpaths = [os.path.join(work, "b", f"d{i:02d}") for i in range(12)]
        cport = _free_port()
        t0 = time.perf_counter()
        child = _crash_child(cpaths, cport, device)
        print(f"  (b) crash child serving after {time.perf_counter() - t0:.3f} s")
        curl = f"http://127.0.0.1:{cport}"
        _Client(curl).request("PUT", "/crash")
        stop = threading.Event()
        logs: list[list] = [[] for _ in range(crash_clients)]   # per client
        refused: list[str] = []
        crng = np.random.default_rng(seed + 13)
        bodies = [crng.bytes(n) for n in warp(256)]
        cycle = ("put", "overwrite", "delete")

        def crash_client(ci):
            # Three keys in turn, key k's j-th operation cycle[(j + k) % 3]:
            # the keys stay out of step, so whenever the kill lands the two
            # keys without a request in flight end on two different kinds
            # of operation. A PUT is an overwrite when the key was PUT
            # since its last delete.
            c = _Client(curl)
            log = logs[ci]
            live = [False] * 3
            n = 0
            try:
                while not stop.is_set():
                    k = n % 3
                    key = f"c{ci:02d}-{k}"
                    op = cycle[(n // 3 + k) % 3]
                    if op != "delete":
                        op = "overwrite" if live[k] else "put"
                    live[k] = op != "delete"
                    body = bodies[(ci * 7 + n) % len(bodies)] if live[k] else None
                    entry = [key, op, body, False]
                    log.append(entry)
                    if op == "delete":
                        # A key already absent answers NoSuchKey, as in
                        # the JAX server: acknowledged absent all the same.
                        r, _ = c.request("DELETE", f"/crash/{key}", check=False)
                        if r.status not in (204, 404):
                            raise AssertionError(f"DELETE {key}: {r.status}")
                    else:
                        c.request("PUT", f"/crash/{key}", body)
                    entry[3] = True
                    n += 1
            except (OSError, http.client.HTTPException):
                return   # the server died under the request: not acked
            except AssertionError as e:
                refused.append(str(e)[:200])   # answered, but with an error
            finally:
                c.close()

        threads = [threading.Thread(target=crash_client, args=(i,), daemon=True)
                   for i in range(crash_clients)]
        for t in threads:
            t.start()
        time.sleep(crash_s)
        child.kill()
        child.wait(timeout=60)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        child_out = child.stdout.read()
        child.stdout.close()
        child = None
        acked = {op: sum(e[3] and e[1] == op for log in logs for e in log)
                 for op in cycle}
        drives = [LocalDrive(p) for p in cpaths]
        replay = [d.last_replay for d in drives]
        if any(r is None for r in replay):
            raise AssertionError("a drive replayed nothing at mount")
        rec_n = sum(r[0] for r in replay)
        rec_s = sum(r[2] for r in replay)
        if any(r[1] for r in replay):
            raise AssertionError(f"replay failed records: {replay}")
        st.mark("crash")
        cs = ErasureSets(drives, enable_mrf=False, device=device)
        try:
            checked = {op: 0 for op in cycle}
            in_flight = split = 0
            for log in logs:
                last: dict = {}   # key -> (state, acknowledged, operation)
                for key, op, body, ok in log:
                    last[key] = (body, ok, op)
                for key, (want, ok, op) in last.items():
                    try:
                        info, it = cs.get_object("crash", key)
                        got = b"".join(bytes(c) for c in it)
                        if info.etag != hashlib.md5(got).hexdigest():
                            raise AssertionError(f"crash {key}: ETag is not the md5")
                    except Exception as e:  # noqa: BLE001 - the answer is checked
                        if ok and type(e).__name__ != "ObjectNotFound":
                            raise
                        got = None if type(e).__name__ == "ObjectNotFound" else e
                    if ok:
                        # The last op of the key was acknowledged: exactly it.
                        if got != want:
                            raise AssertionError(
                                f"crash {key}: acknowledged "
                                f"{op} reads back "
                                f"{'absent' if got is None else len(got)}")
                        checked[op] += 1
                    else:
                        # In flight at the kill, never acknowledged: it may
                        # have landed on some drives and not on others.
                        in_flight += 1
                        split += isinstance(got, Exception)
        finally:
            cs.close()
            for d in drives:
                d.close_wal()
        st.mark("crash_verify")
        if "Traceback" in child_out:
            raise AssertionError(f"crash child failed: {child_out[-2000:]}")
        if refused:
            raise AssertionError(f"crash child answered errors before the kill: {refused}")
        if not (acked["overwrite"] and acked["delete"]
                and checked["overwrite"] and checked["delete"]):
            raise AssertionError(f"crash: acknowledged {acked}, checked last "
                                 f"operations {checked}: overwrites and deletes must "
                                 "be acknowledged and read back")
        print(f"  (b) SIGKILL after {crash_s} s of {crash_clients} clients' PUTs, "
              f"overwrites and deletes: acknowledged "
              + ", ".join(f"{acked[op]} {op}s" for op in cycle)
              + "; after the port mounted the drives, the keys whose last operation "
              "was acknowledged each read back in that state: "
              + ", ".join(f"{checked[op]} after {'an' if op == 'overwrite' else 'a'} "
                          f"{op}" for op in cycle)
              + f" ({in_flight} keys had one in flight, {split} of them below read "
              f"quorum); replay applied {rec_n} records on 12 drives in {rec_s:.6f} s "
              "(summed over the drives)")

        # (c) one drive hung: every call of it blocks
        for d in es.drives:
            d._deadlines = {c: DynamicTimeout(0.5, 0.1)
                            for c in healthcheck.DEFAULT_DEADLINES}
        from minio_tpu_torch.erasure.metadata import hash_order

        big = rng.bytes(big_size)
        twin = rng.bytes(big_size)
        cl.request("PUT", "/meta/pre", big)
        cl.request("PUT", "/meta/twin", twin)
        get_ok(cl, "pre", big)
        # The victim holds data shard 1 of "pre": the GET's first,
        # data-first selection reads it, so the hedge must cover it.
        victim = hash_order("meta/pre", 12).index(1)
        hc = es.drives[victim]
        # "during" is PUT while the victim hangs, with the bytes of "twin":
        # the victim's shard of it must come back equal to twin's shard of
        # the same index, copied before the hang.
        during_shard = hash_order("meta/during", 12)[victim]
        twin_drive = hash_order("meta/twin", 12).index(during_shard)
        expected = open(glob.glob(os.path.join(paths[twin_drive], "meta", "twin", "*",
                                               "part.1"))[0], "rb").read()
        hang = _Hang(hc._inner)
        hc._inner = hang
        es.hedge_delay = 0.05   # pinned: the burst's latencies set no bound
        hedged0 = _counter_value("minio_tpu_hedged_reads_total")
        won0 = _counter_value("minio_tpu_hedged_reads_won_total")
        log = _StateLog(hc)
        # The shard reads hang first, so the GET meets the hang there and
        # hedges around it; then every call of the drive hangs.
        hang.methods = {"read_file_stream"}
        st.mark("hang")
        t0 = time.perf_counter()
        get_ok(cl, "pre", big)
        hget_s = time.perf_counter() - t0
        hang.methods = "all"
        t0 = time.perf_counter()
        cl.request("PUT", "/meta/during", twin)
        hput_s = time.perf_counter() - t0
        get_ok(cl, "during", twin)
        st.mark("hung_io")
        end = time.monotonic() + 30
        while hc.state != healthcheck.OFFLINE and time.monotonic() < end:
            time.sleep(0.05)
        walked = log.stop()
        states = _scrape_meta(cl, paths)
        root = os.path.abspath(paths[victim])
        _r, info_doc = cl.request("GET", "/minio/admin/v3/info")
        info = json.loads(info_doc)
        info_state = [d.get("healthState") for d in info["drives"]
                      if d.get("endpoint") == root]
        hedged = _counter_value("minio_tpu_hedged_reads_total") - hedged0
        won = _counter_value("minio_tpu_hedged_reads_won_total") - won0
        # A call that succeeds while the drive is FAULTY brings it back
        # ONLINE; the walk must end FAULTY -> OFFLINE.
        if (walked[0] != healthcheck.ONLINE
                or walked[-2:] != [healthcheck.FAULTY, healthcheck.OFFLINE]
                or states["minio_tpu_drive_state"].get(root) != 2.0
                or info_state != ["offline"]):
            raise AssertionError(f"hung drive: states {walked}, scrape "
                                 f"{states['minio_tpu_drive_state'].get(root)}, "
                                 f"info {info_state}")
        if hedged <= 0 or won <= 0:
            raise AssertionError(f"hung drive: hedged reads {hedged}, won {won}")
        print(f"  (c) drive {victim} hung (DynamicTimeout(0.5, 0.1) on every class): "
              f"GET of {big_size >> 20} MiB {hget_s:.6f} s, PUT {hput_s:.6f} s, both "
              f"at quorum and byte-equal; the drive went "
              f"{' -> '.join(walked)} "
              f"(scrape minio_tpu_drive_state 2.0, "
              f"minio_tpu_drive_timeouts_total "
              f"{states['minio_tpu_drive_timeouts_total'].get(root, 0):.0f}; admin info "
              f"healthState {info_state[0]}); hedged reads {hedged:.0f}, won {won:.0f}")

        # (d) released: the probe restores it, the auto-healer rebuilds it
        t0 = time.perf_counter()
        hang.methods = set()
        hang.release.set()
        rebuilt = os.path.join(paths[victim], "meta", "during")
        end = time.monotonic() + 120
        done = False
        while time.monotonic() < end:
            hits = glob.glob(os.path.join(rebuilt, "*", "part.1"))
            if (hc.state == healthcheck.ONLINE and hits
                    and open(hits[0], "rb").read() == expected
                    and not os.path.exists(os.path.join(paths[victim], ".mtpu.sys",
                                                        "healing.json"))):
                done = True
                break
            time.sleep(0.1)
        restore_s = time.perf_counter() - t0
        if not done:
            raise AssertionError(f"restore: state {hc.state}, the missed shard "
                                 "not rebuilt equal to the copy taken before the hang")
        get_ok(cl, "during", twin)
        st.mark("restore")
        walk = srv.auto_healer[0].last_walk
        if walk is None:
            raise AssertionError("restore: the auto-healer never walked the drive")
        print(f"  (d) released: probe restore and the missed shard rebuilt in "
              f"{restore_s:.6f} s, equal to shard {during_shard}'s copy taken before "
              f"the hang; the auto-healer's walk of the restored drive healed "
              f"{walk.healed} objects ({walk.failed} failed) and removed its tracker")
    finally:
        if child is not None:
            child.kill()
            child.wait(timeout=60)
        if hang is not None:
            hang.methods = set()
            hang.release.set()
        pool.close()
        cl.close()
        _close_server(srv)
        for base in bases:
            base.close_wal()
        shutil.rmtree(work, ignore_errors=True)
    for name in ("burst_put", "burst_get", "crash_verify", "hung_io", "restore"):
        secs, d = st.delta(name)
        print(f"  meta {name}: {secs:.6f} s; launches "
              + ", ".join(f"{k} {d[k]}" for k in kernels.KERNELS))
    st.need("burst_put")
    st.need("burst_get", ("mxsum_digest",))
    st.need("hung_io")
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in kernels.KERNELS}
    if records is not None:
        _fill_launches(records, "meta", total)
    print("  launches metadata-plane phase: " + ", ".join(
        f"{k} {total[k]}" for k in kernels.KERNELS))


_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) .*$")
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                      r"(counter|gauge|histogram|summary|untyped)$")
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str):
    """-> (families {name: type}, samples [(name, labels, value)]); raises
    on any line the 0.0.4 text format does not allow."""
    families: dict[str, str] = {}
    samples: list = []
    for ln, line in enumerate(text.split("\n"), 1):
        if not line or _HELP_RE.match(line):
            continue
        m = _TYPE_RE.match(line)
        if m:
            families[m.group(1)] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise AssertionError(f"scrape line {ln} is not HELP/TYPE/sample: {line!r}")
        name, rawlbl, rawval = m.groups()
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                base = name[: -len(suffix)]
        if base not in families:
            raise AssertionError(f"scrape line {ln}: sample {name} has no TYPE")
        labels = dict(_LABEL_RE.findall(rawlbl[1:-1])) if rawlbl else {}
        samples.append((name, labels, float("inf") if rawval == "+Inf" else float(rawval)))
    return families, samples


def _by_label(samples, name: str, key: str, **match) -> dict:
    out: dict = {}
    for n, lbl, v in samples:
        if n == name and all(lbl.get(k) == w for k, w in match.items()):
            out[lbl.get(key, "")] = out.get(lbl.get(key, ""), 0) + v
    return out


# Which of K1 and K2 each observed label launches (ops/fused.py's table;
# mxsum256 paths, so every label of a rebuild carries its digests).
OBS_K1 = ("encode", "encode_digests", "reconstruct", "reconstruct_digests",
          "reconstruct_weights", "dp_encode", "dp_reconstruct")
OBS_K2 = ("encode_digests", "reconstruct_digests", "reconstruct_weights",
          "verify_digests", "dp_encode", "dp_verify", "dp_reconstruct")


class _Tracer:
    """A `mc admin trace` client: streams GET /minio/admin/v3/trace in a
    thread and keeps every record; stop() leaves (the server sees the
    client gone at its next heartbeat and unsubscribes)."""

    def __init__(self, url: str):
        import threading

        self.records: list[dict] = []
        self._stop = threading.Event()
        self._cl = _Client(url)
        self._resp = self._cl.send("GET", "/minio/admin/v3/trace")
        self._t = threading.Thread(target=self._run, daemon=True, name="smoke-trace")
        self._t.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                line = self._resp.readline()
                if not line:
                    return
                if line.strip():
                    self.records.append(json.loads(line))
        except (OSError, ValueError):
            return

    def stop(self) -> None:
        self._stop.set()
        self._t.join(5)
        self._cl.close()
        self._t.join(5)


def _k12_window(name: str, launches: dict, before, after, backend: str) -> dict:
    """Check one stage's K1/K2 launches against the scrape's
    minio_tpu_kernel_launches_total{backend=...} deltas ("gpu" on the card)
    under OBS_K1 / OBS_K2; -> the per-label deltas."""
    a = _by_label(after[1], "minio_tpu_kernel_launches_total", "kernel", backend=backend)
    b = _by_label(before[1], "minio_tpu_kernel_launches_total", "kernel", backend=backend)
    delta = {k: int(v - b.get(k, 0)) for k, v in a.items() if v - b.get(k, 0)}
    k1 = sum(delta.get(k, 0) for k in OBS_K1)
    k2 = sum(delta.get(k, 0) for k in OBS_K2)
    print(f"  {name}: scrape kernel launches {delta}; K1 {launches['gf2_matmul']} "
          f"(labels {k1}), K2 {launches['mxsum_digest']} (labels {k2})")
    if (k1, k2) != (launches["gf2_matmul"], launches["mxsum_digest"]):
        raise AssertionError(f"{name}: scrape's kernel launches disagree with the "
                             "kernels' counts")
    return delta


def obs_phase(seed: int, card: str, device: str = "cuda", size: int = OBS_SIZE,
              profile_size: int = OBS_PROFILE_SIZE, runs: int = OBS_RUNS) -> dict:
    """Phase 11, observability and the admin plane: config 1's set (12
    drives on /dev/shm, EC 8+4, 1 MiB blocks, mxsum256, the plane at its
    default, MRF off) behind the port's S3 server, observed only through
    its own routes. A trace subscriber streams /minio/admin/v3/trace while
    one `size` object is PUT, GET and range-GET; 4 drives' shard files are
    copied and removed, a degraded GET, then POST
    /minio/admin/v3/heal/<bucket> (scanMode 2) must rebuild them equal to
    the copies, and a GET again. The cluster and node scrapes must pass
    the strict parse, their kernel launches per label must equal the
    kernels' own counts (OBS_K1, OBS_K2) over the PUT/GET and heal stages,
    their request counts the requests sent, and their drive latency must
    cover all 12 drives. The trace must hold the PUT's http, storage and
    kernel records, perf/timeline its JAX stage names. Profiling
    (cpu,device) around one PUT+GET must give cpu.txt and a device trace
    naming K1's and K2's CUDA kernels. Last, `runs` PUTs and GETs of the
    object with no subscriber, with one, and under MTPU_KERNEL_SYNC=1,
    and one PUT+GET's kernel seconds under sync against torch.profiler's
    device times of K1 and K2 in a second PUT+GET without sync; the times
    are printed, not gated."""
    import io
    import zipfile

    import numpy as np

    from minio_tpu_torch.obs import kernel as obs_kernel
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    cuda = device == "cuda"
    backend = "gpu" if cuda else device
    rng = np.random.default_rng(seed + 11)
    data = rng.bytes(size)
    small = rng.bytes(profile_size)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-obs-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    cl = _Client(srv.url)
    sent: dict[str, int] = {}
    out: dict = {}
    tracer = None

    def req(api, method, path, body=b"", headers=None, query=None):
        sent[api] = sent.get(api, 0) + 1
        return cl.request(method, path, body, headers, query)

    def scrape(path="/minio/v2/metrics/cluster"):
        return parse_exposition(cl.request("GET", path)[1].decode())

    def part_file(i):
        hits = glob.glob(os.path.join(paths[i], "obs", "big", "*", "part.1"))
        return hits[0] if hits else None

    try:
        kernels.reset_launches()
        phase0 = kernels.launches()
        req("CreateBucket", "PUT", "/obs")
        tracer = _Tracer(srv.url)
        time.sleep(0.5)
        s0, l0 = scrape(), kernels.launches()
        r, _ = req("PutObject", "PUT", "/obs/big", data)
        put_id = r.getheader("x-amz-request-id")
        r, got = req("GetObject", "GET", "/obs/big")
        if got != data:
            raise AssertionError("GET bytes differ")
        r, got = req("GetObject", "GET", "/obs/big",
                     headers={"Range": "bytes=1000000-3999999"})
        if r.status != 206 or got != data[1000000:4000000]:
            raise AssertionError("ranged GET")
        s1, l1 = scrape(), kernels.launches()
        _k12_window("PUT, GET, ranged GET", {k: l1[k] - l0[k] for k in l1}, s0, s1,
                    backend)

        originals = {i: open(part_file(i), "rb").read() for i in range(12)}
        for i in range(4):
            shutil.rmtree(os.path.dirname(part_file(i)))
        if req("GetObject", "GET", "/obs/big")[1] != data:
            raise AssertionError("degraded GET bytes differ")
        s2, l2 = scrape(), kernels.launches()
        t0 = time.perf_counter()
        r, doc = cl.request("POST", "/minio/admin/v3/heal/obs",
                            json.dumps({"scanMode": 2}).encode())
        heal_s = time.perf_counter() - t0
        items = json.loads(doc)["items"]
        s3, l3 = scrape(), kernels.launches()
        heal = _k12_window("admin heal", {k: l3[k] - l2[k] for k in l3}, s2, s3,
                           backend)
        big = [i for i in items if i["object"] == "big"]
        healed = sum(b["state"] != "ok" and a["state"] == "ok"
                     for b, a in zip(big[0]["before"], big[0]["after"])) if big else 0
        if healed != 4 or any(open(part_file(i), "rb").read() != originals[i]
                              for i in range(4)):
            raise AssertionError(f"admin heal: {healed} healed or files differ: {items}")
        if not heal.get("reconstruct_weights"):
            raise AssertionError("admin heal did not launch K1 through reconstruct_weights")
        if req("GetObject", "GET", "/obs/big")[1] != data:
            raise AssertionError("GET after heal")
        print(f"  admin heal (scanMode 2) of 4 shards: {heal_s:.6f} s, items "
              f"{[(i['object'], i.get('error', 'ok')) for i in items]}")

        fams, samples = scrape()
        node_fams, _ns = scrape("/minio/v2/metrics/node")
        reqs = _by_label(samples, "minio_tpu_s3_requests_total", "api")
        for api, n in sent.items():
            if reqs.get(api) != n:
                raise AssertionError(f"requests_total{{api={api}}}: {reqs.get(api)} "
                                     f"!= {n} sent")
        drives = {lbl["drive"] for n, lbl, v in samples
                  if n == "minio_tpu_drive_latency_seconds_count" and v > 0}
        if not set(paths) <= drives:
            raise AssertionError(f"drive latency covers {len(set(paths) & drives)} "
                                 "of 12 drives")
        online = sum(v for n, _l, v in samples
                     if n == "minio_tpu_cluster_disk_online_total")
        if online != 12:
            raise AssertionError(f"disk online {online}")
        hists = sorted(f for f, t in fams.items() if t == "histogram")
        print(f"  scrape: {len(fams)} families ({len(hists)} histograms), "
              f"{len(samples)} samples, node scrape {len(node_fams)} families; "
              f"requests {reqs}; drive latency on {len(set(paths) & drives)} drives; "
              f"disks online {online:.0f}")

        tracer.stop()
        mine = [x for x in tracer.records
                if put_id in (x.get("trace_id"), x.get("requestId"))]
        types = sorted({x["type"] for x in mine})
        print(f"  trace: {len(tracer.records)} records, {len(mine)} of the PUT "
              f"({put_id}): types {types}")
        if not {"http", "storage", "kernel"} <= set(types):
            raise AssertionError(f"trace of the PUT holds {types}")
        tracer = None

        doc = json.loads(cl.request("GET", "/minio/admin/v3/perf/timeline",
                                    query={"traceid": put_id})[1])
        stages = [(x["stage"], x["plane"], x["dur_ns"]) for x in
                  doc["timelines"][0]["stages"]] if doc["timelines"] else []
        print(f"  perf/timeline of the PUT: {stages}")
        if [x[0] for x in stages if x[0] in ("auth", "rx_drain", "encode", "commit",
                                              "resp_drain")] != \
                ["auth", "rx_drain", "encode", "commit", "resp_drain"]:
            raise AssertionError("the PUT's timeline lacks the JAX stage names")

        cl.request("POST", "/minio/admin/v3/profiling/start",
                   query={"profilerType": "cpu,device" if cuda else "cpu"})
        req("PutObject", "PUT", "/obs/profiled", small)
        if req("GetObject", "GET", "/obs/profiled")[1] != small:
            raise AssertionError("profiled GET")
        zdoc = cl.request("GET", "/minio/admin/v3/profiling/download")[1]
        z = zipfile.ZipFile(io.BytesIO(zdoc))
        names = sorted(z.namelist())
        trace = zipfile.ZipFile(io.BytesIO(z.read("local/device_trace.zip"))) \
            .read("trace.json").decode() if cuda else ""
        found = {k: k in trace for k in ("gf2_kernel", "mxsum_kernel") if cuda}
        cats: dict = {}
        for ev in (json.loads(trace).get("traceEvents", []) if trace else []):
            cats[ev.get("cat", "-")] = cats.get(ev.get("cat", "-"), 0) + 1
        print(f"  profiling zip {names}; device trace {len(trace)} B, events by "
              f"category {cats}, names {found}")
        if "local/cpu.txt" not in names or not all(found.values()):
            raise AssertionError("profiling: cpu.txt or K1/K2 missing from the zip")

        costs = {}
        for mode in ("no subscriber", "trace subscriber", "MTPU_KERNEL_SYNC=1"):
            if mode == "trace subscriber":
                tracer = _Tracer(srv.url)
            obs_kernel.set_sync(mode == "MTPU_KERNEL_SYNC=1")
            put_s, get_s = [], []
            for _ in range(runs):
                t0 = time.perf_counter()
                req("PutObject", "PUT", "/obs/cost", data)
                put_s.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                req("GetObject", "GET", "/obs/cost")
                get_s.append(time.perf_counter() - t0)
            if tracer is not None:
                tracer.stop()
                tracer = None
            costs[mode] = (put_s, get_s)
            print(f"  {size >> 20} MiB on {card}, {mode}: PUT s "
                  f"{', '.join(f'{x:.6f}' for x in put_s)}; GET s "
                  f"{', '.join(f'{x:.6f}' for x in get_s)}")
        out["costs"] = costs

        # Under sync, one PUT+GET's kernel seconds (the family's _sum)
        # against torch.profiler's device times of the same launches in
        # a second PUT+GET of the object, without sync: the profiler slows
        # every CUDA call it traces, which would stretch the gaps the
        # sync records' events see between the host's calls.
        import torch
        from torch.profiler import ProfilerActivity, profile

        def ksum():
            return sum(v for n, lbl, v in scrape()[1]
                       if n == "minio_tpu_kernel_seconds_sum"
                       and lbl.get("backend") == backend)

        obs_kernel.set_sync(True)
        k0, n0 = ksum(), kernels.launches()
        req("PutObject", "PUT", "/obs/cost", data)
        req("GetObject", "GET", "/obs/cost")
        k_s = ksum() - k0
        n_k = {k: v - n0[k] for k, v in kernels.launches().items()}
        obs_kernel.set_sync(False)
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            req("PutObject", "PUT", "/obs/cost", data)
            req("GetObject", "GET", "/obs/cost")
            if cuda:
                torch.cuda.synchronize()
        dev_us, dev_n = {}, {}
        for ev in prof.key_averages():
            total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            for name in ("gf2_kernel", "mxsum_kernel"):
                if name in ev.key and total:
                    dev_us[name] = dev_us.get(name, 0.0) + total
                    dev_n[name] = dev_n.get(name, 0) + ev.count
        dev_s = sum(dev_us.values()) / 1e6
        print(f"  under MTPU_KERNEL_SYNC=1, one PUT+GET: minio_tpu_kernel_seconds "
              f"{k_s:.6f} s over the launches (K1 {n_k['gf2_matmul']}, K2 "
              f"{n_k['mxsum_digest']}); torch.profiler, another PUT+GET without "
              f"sync: device time K1 {dev_us.get('gf2_kernel', 0) / 1e6:.6f} s, K2 "
              f"{dev_us.get('mxsum_kernel', 0) / 1e6:.6f} s over {dev_n} kernels; "
              f"ratio {k_s / dev_s if dev_s else float('nan'):.4f}")
        out["sync_vs_profiler"] = (k_s, dev_s)
    finally:
        obs_kernel.set_sync(False)
        if tracer is not None:
            tracer.stop()
        cl.close()
        _close_server(srv)
        shutil.rmtree(work, ignore_errors=True)
    total = {k: v - phase0[k] for k, v in kernels.launches().items()}
    print(f"  launches in the phase: {total}")
    for k in MXSUM_KERNELS:
        if total[k] <= 0:
            raise AssertionError(f"{k} never launched in the obs phase")
    return out


def late_profile_check(seed: int, card: str, size: int = OBS_PROFILE_SIZE,
                       device: str = "cuda") -> str:
    """profilerType=device as an operator uses it, on a process that has
    run for minutes: around one PUT+GET of `size` bytes the download must
    either hold every K1 and K2 launch of the capture as a kernel event or
    answer InternalError saying the capture lost some. A 200 whose trace
    lacks any of them fails. -> "captured" or "refused"."""
    import io
    import zipfile

    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    data = np.random.default_rng(seed + 12).bytes(size)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-lateprof-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    cl = _Client(srv.url)
    try:
        cl.request("PUT", "/late")
        cl.request("POST", "/minio/admin/v3/profiling/start",
                   query={"profilerType": "device"})
        before = kernels.launches()
        cl.request("PUT", "/late/o", data)
        if cl.request("GET", "/late/o")[1] != data:
            raise AssertionError("profiled GET bytes differ")
        launched = {k: n - before[k] for k, n in kernels.launches().items()}
        if not all(launched[k] for k in MXSUM_KERNELS):
            raise AssertionError(f"the profiled PUT+GET launched {launched}")
        r, doc = cl.request("GET", "/minio/admin/v3/profiling/download", check=False)
    finally:
        cl.close()
        _close_server(srv)
        shutil.rmtree(work, ignore_errors=True)
    if r.status == 500 and b"the profiler lost the card's events" in doc:
        print(f"  device profile after {time.perf_counter() - T_START:.1f} s of the "
              f"process on {card}: refused, {doc[:400]!r}")
        return "refused"
    if r.status != 200:
        raise AssertionError(f"profiling download: {r.status} {doc[:300]!r}")
    z = zipfile.ZipFile(io.BytesIO(doc))
    trace = zipfile.ZipFile(io.BytesIO(z.read("local/device_trace.zip"))).read("trace.json")
    events = json.loads(trace).get("traceEvents", [])
    names = [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]
    found = {k: min(sum(dn in n for n in names) for dn in kernels.DEVICE_NAMES[k])
             for k in MXSUM_KERNELS}
    print(f"  device profile after {time.perf_counter() - T_START:.1f} s of the process "
          f"on {card}: captured, {len(names)} kernel events, {found}; launches "
          f"{launched}")
    if any(found[k] < launched[k] for k in MXSUM_KERNELS):
        raise AssertionError(f"profiling answered 200 without every K1/K2 launch: "
                             f"{found}, launches {launched}")
    return "captured"


_SSE_DEFAULT_DOC = (b"<ServerSideEncryptionConfiguration><Rule>"
                    b"<ApplyServerSideEncryptionByDefault><SSEAlgorithm>AES256"
                    b"</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>"
                    b"</ServerSideEncryptionConfiguration>")


def _ssec_headers(key: bytes, copy_source: bool = False) -> dict:
    """The SSE-C headers of a request (or of a copy's source) under `key`."""
    import base64

    prefix = ("x-amz-copy-source-server-side-encryption-customer" if copy_source
              else "x-amz-server-side-encryption-customer")
    return {f"{prefix}-algorithm": "AES256",
            f"{prefix}-key": base64.b64encode(key).decode(),
            f"{prefix}-key-MD5": base64.b64encode(hashlib.md5(key).digest()).decode()}


def _log_payload(seed: int, size: int) -> bytes:
    """`size` bytes of access-log lines (compressible, S2's use case): a
    4 MiB block of lines with random fields, repeated."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lines = []
    n = 0
    while n < 4 << 20:
        line = (f"2026-10-18T12:{int(rng.integers(0, 60)):02d}:{int(rng.integers(0, 60)):02d}Z "
                f"10.0.{int(rng.integers(0, 255))}.{int(rng.integers(0, 255))} "
                f"{'GET' if rng.random() < 0.7 else 'PUT'} /bucket/obj-{int(rng.integers(0, 10**6))} "
                f"{int(rng.choice([200, 200, 200, 206, 404, 503]))} "
                f"{int(rng.integers(0, 1 << 24))} {rng.random():.6f}\n").encode()
        lines.append(line)
        n += len(line)
    block = b"".join(lines)
    return (block * (size // len(block) + 1))[:size]


def _shard_files(paths, bucket, key):
    return {i: glob.glob(os.path.join(p, bucket, key, "*", "part.1"))[0]
            for i, p in enumerate(paths)}


def atrest_phase(seed: int, card: str, records: list[dict] | None, device: str = "cuda",
                 big_size: int = ATREST_BIG, small_size: int = ATREST_SMALL,
                 part_size: int = ATREST_PART) -> None:
    """Phase 13 (see the module's docstring): data at rest on config 1's
    set. Launch counts go into `records` unless it is None."""
    import numpy as np

    from minio_tpu_torch.crypto import aead, configcrypt
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    rng = np.random.default_rng(seed + 13)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-atrest-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    old_key_file = os.environ.get("MTPU_KMS_KEY_FILE")
    os.environ["MTPU_KMS_KEY_FILE"] = os.path.join(work, "kms-keys")
    print(f"  AEAD provider: {aead.PROVIDER}")
    st = _Stages()
    srv = cl = None
    rates = []

    def rate(name, size):
        sec, d = st.delta(name)
        rates.append(f"{name} {size / (1 << 30) / sec:.6f} GiB/s ({sec:.6f} s; K1/K2 "
                     f"{d['gf2_matmul']}/{d['mxsum_digest']})")

    def start():
        nonlocal srv, cl
        srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
        cl = _Client(srv.url)

    def stop():
        cl.close()
        _close_server(srv)

    def get_ok(key, want, headers=None, rng_=None):
        h = dict(headers or {})
        if rng_ is not None:
            h["Range"] = f"bytes={rng_[0]}-{rng_[1] - 1}"
        r, got = cl.request("GET", f"/atrest/{key}", headers=h)
        exp = want if rng_ is None else want[rng_[0]:rng_[1]]
        if got != exp:
            raise AssertionError(f"GET {key} {rng_}: bytes differ")
        return r

    def config(doc):
        r, body = cl.request("PUT", "/minio/admin/v3/config-kv", json.dumps(doc).encode())
        return json.loads(body)

    try:
        kernels.reset_launches()
        st.mark("start")
        start()
        es = srv.obj.pools[0].sets[0]
        cl.request("PUT", "/atrest")
        # (a) the sealed config: EC:2 for the next PUT, then EC:4 again,
        # read back through argon2id after a restart.
        config({"storageclass": {"standard": "EC:2"}})
        small = rng.bytes(small_size)
        st.mark("config")
        cl.request("PUT", "/atrest/ec2", small)
        st.mark("EC:2 PUT")
        st.need("EC:2 PUT")
        rate("EC:2 PUT", small_size)
        fi = es.latest_fileinfo("atrest", "ec2")
        if (fi.erasure.data_blocks, fi.erasure.parity_blocks) != (K10, M10):
            raise AssertionError(f"EC:2 PUT stored at {fi.erasure.data_blocks}+"
                                 f"{fi.erasure.parity_blocks}")
        get_ok("ec2", small)
        config({"storageclass": {"standard": "EC:4"}})
        stop()
        start()
        es = srv.obj.pools[0].sets[0]
        if srv.config.get("storageclass", "standard") != "EC:4":
            raise AssertionError("the restarted server lost its storage class")
        sealed = [open(f, "rb").read() for f in glob.glob(
            os.path.join(paths[0], ".mtpu.sys", "config", "config", "config.json"))]
        if len(sealed) != 1 or not sealed[0].startswith(configcrypt.MAGIC) \
                or sealed[0][len(configcrypt.MAGIC)] != configcrypt.KDF_ARGON2ID:
            raise AssertionError("the config is not sealed with argon2id on the drives")
        t0 = time.perf_counter()
        configcrypt._derive(configcrypt.KDF_ARGON2ID, SECRET, os.urandom(16),
                            configcrypt.ARGON_T, configcrypt.ARGON_M_KIB,
                            configcrypt.ARGON_LANES)
        kdf_ms = (time.perf_counter() - t0) * 1e3
        print(f"  (a) storageclass EC:2: {small_size} B stored at {K10}+{M10}, K1 at "
              f"[16,{K10},{S10}]; config sealed with argon2id (t=1, 64 MiB, 4 lanes): "
              f"one derivation {kdf_ms:.3f} ms on the host; EC:4 read back after a restart")
        # (b) SSE-S3, SSE-C and SSE-KMS, 256 MiB each.
        cl.request("POST", "/minio/admin/v3/kms/key/create", query={"key-id": "smoke-key"})
        big = rng.bytes(big_size)
        ssec_key = rng.bytes(32)
        cases = {"sse-s3": {"x-amz-server-side-encryption": "AES256"},
                 "sse-c": _ssec_headers(ssec_key),
                 "sse-kms": {"x-amz-server-side-encryption": "aws:kms",
                             "x-amz-server-side-encryption-aws-kms-key-id": "smoke-key"}}
        ranges = [(65530, 65560), (1048000, 1049600),
                  (big_size - (3 << 20) - 77, big_size - (2 << 20) + 77)]
        for name, h in cases.items():
            key_h = h if name == "sse-c" else {}
            st.mark(f"{name} start")
            cl.request("PUT", f"/atrest/{name}", big, headers=h)
            st.mark(f"{name} PUT")
            st.need(f"{name} PUT")
            rate(f"{name} PUT", big_size)
            get_ok(name, big, key_h)
            st.mark(f"{name} GET")
            rate(f"{name} GET", big_size)
            for rg in ranges:
                r = get_ok(name, big, key_h, rg)
                if r.status != 206:
                    raise AssertionError(f"{name} range {rg}: {r.status}")
        _settle(es.drives)
        files = _shard_files(paths, "atrest", "sse-kms")
        originals = {i: open(f, "rb").read() for i, f in files.items()}
        for i in (0, 1, 2, 3):
            shutil.rmtree(os.path.dirname(files[i]))
        st.mark("degraded start")
        get_ok("sse-kms", big)
        st.mark("SSE-KMS degraded GET")
        st.need("SSE-KMS degraded GET")
        rate("SSE-KMS degraded GET", big_size)
        res = es.heal_object("atrest", "sse-kms", scan_deep=True)
        st.mark("SSE-KMS heal")
        if res.healed_count != 4 or any(open(files[i], "rb").read() != originals[i]
                                        for i in (0, 1, 2, 3)):
            raise AssertionError(f"SSE-KMS heal: {res.healed_count} healed, or files "
                                 "differ from their copies")
        rate("SSE-KMS heal", big_size)
        cl.request("PUT", "/atrest-dflt")
        cl.request("PUT", "/atrest-dflt", _SSE_DEFAULT_DOC, query={"encryption": ""})
        st.mark("default start")
        cl.request("PUT", "/atrest-dflt/obj", small)
        st.mark("bucket-default PUT")
        rate("bucket-default PUT", small_size)
        r, got = cl.request("GET", "/atrest-dflt/obj")
        if got != small or r.getheader("x-amz-server-side-encryption") != "AES256":
            raise AssertionError("bucket default: not SSE-S3, or bytes differ")
        # (c) multipart SSE-KMS, and a copy from SSE-C to SSE-S3.
        r, body = cl.request("POST", "/atrest/mp", query={"uploads": ""},
                             headers=cases["sse-kms"])
        uid = _upload_id(body)
        n_parts = small_size // part_size
        parts = [big[i * part_size:(i + 1) * part_size] for i in range(n_parts)]
        st.mark("mp start")
        etags = []
        for n, part in enumerate(parts, 1):
            r, _ = cl.request("PUT", "/atrest/mp", part,
                              query={"partNumber": str(n), "uploadId": uid})
            etags.append(r.getheader("ETag").strip('"'))
        cl.request("POST", "/atrest/mp", _complete_doc(etags), query={"uploadId": uid})
        st.mark("SSE-KMS multipart PUT")
        rate("SSE-KMS multipart PUT", small_size)
        mp_data = b"".join(parts)
        get_ok("mp", mp_data, rng_=(part_size - 1000, part_size + 1000))
        get_ok("mp", mp_data)
        st.mark("copy start")
        cl.request("PUT", "/atrest/copy", headers={
            "x-amz-copy-source": "/atrest/sse-c", "x-amz-server-side-encryption": "AES256",
            **_ssec_headers(ssec_key, copy_source=True)})
        st.mark("CopyObject SSE-C to SSE-S3")
        rate("CopyObject SSE-C to SSE-S3", big_size)
        r = get_ok("copy", big)
        if r.getheader("x-amz-server-side-encryption") != "AES256":
            raise AssertionError("the copy is not SSE-S3")
        # (d) compression.
        config({"compression": {"enable": "on"}})
        log = _log_payload(seed, big_size)
        st.mark("log start")
        cl.request("PUT", "/atrest/access.log", log)
        st.mark("S2 PUT")
        rate("S2 PUT", big_size)
        stored = es.latest_fileinfo("atrest", "access.log").size
        get_ok("access.log", log)
        st.mark("S2 GET")
        rate("S2 GET", big_size)
        get_ok("access.log", log, rng_=(big_size // 2, big_size // 2 + (1 << 20)))
        st.mark("S2 Range GET")
        rate("S2 Range GET", 1 << 20)
        print(f"  (d) S2: {big_size} B of access log stored as {stored} B, ratio "
              f"{stored / big_size:.6f}; a 1 MiB Range GET decompresses from offset 0")
        st.mark("end")
    finally:
        if srv is not None:
            stop()
        shutil.rmtree(work, ignore_errors=True)
        if old_key_file is None:
            os.environ.pop("MTPU_KMS_KEY_FILE", None)
        else:
            os.environ["MTPU_KMS_KEY_FILE"] = old_key_file
    for line in rates:
        print(f"  {line} on {card}, AEAD {aead.PROVIDER}")
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in st.at[0][1]}
    print(f"  launches in the phase: {total}")
    if records is not None:
        _fill_launches(records, "atrest", total)


IAM_POLICY = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:*"],
     "Resource": ["arn:aws:s3:::iamb", "arn:aws:s3:::iamb/*"]}]})
IAM_DENY_PUT = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:*"], "Resource": ["arn:aws:s3:::iamb/*"]},
    {"Effect": "Deny", "Action": ["s3:PutObject"], "Resource": ["arn:aws:s3:::iamb/*"]}]})
IAM_BUCKET_POLICY = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Deny", "Principal": "*", "Action": ["s3:PutObject"],
     "Resource": ["arn:aws:s3:::iamb/frozen/*"]},
    {"Effect": "Allow", "Principal": {"AWS": ["*"]}, "Action": ["s3:GetObject"],
     "Resource": ["arn:aws:s3:::iamb/public/*"]}]})


def _error_code(body: bytes) -> str:
    import xml.etree.ElementTree as ET

    return ET.fromstring(body).findtext("Code") if body else ""


def _sts_creds(doc: bytes) -> tuple[str, str, str]:
    import xml.etree.ElementTree as ET

    ns = "{https://sts.amazonaws.com/doc/2011-06-15/}"
    c = ET.fromstring(doc).find(f"{ns}AssumeRoleResult/{ns}Credentials")
    return tuple(c.findtext(ns + k) for k in ("AccessKeyId", "SecretAccessKey", "SessionToken"))


def _check_sampled_digests(paths, es, bucket, key, device) -> None:
    """The first block's chunk of every shard of `key`, read from the
    drives: each digest equal to K2's plain version over its chunk, and the
    4 parity chunks equal to K1's plain version over the 8 data chunks."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import bitrot, rs

    fi = es.latest_fileinfo(bucket, key)
    shard_data = fi.erasure.shard_file_size(fi.size)
    chunks = {}
    for i, path in _shard_files(paths, bucket, key).items():
        with open(path, "rb") as f:
            digest, chunk = bitrot.BitrotReader(f, shard_data, fi.erasure.shard_size(),
                                                "mxsum256").read_record(0)
        if digest != _plain_digest("mxsum256", chunk, device):
            raise AssertionError(f"{key}: drive {i}'s first digest differs from K2's "
                                 "plain version")
        chunks[fi.erasure.distribution[i]] = chunk
    k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
    x = torch.from_numpy(np.stack([np.frombuffer(chunks[j + 1], dtype=np.uint8)
                                   for j in range(k)]))[None].to(device)
    w_enc = rs.device_encode_weights(k, m, torch.device(device))
    parity = rs.gf2_matmul_plain(x, w_enc, m)[0].cpu()
    for j in range(m):
        if parity[j].numpy().tobytes() != chunks[k + j + 1]:
            raise AssertionError(f"{key}: parity shard {k + j + 1} differs from K1's "
                                 "plain version")


def iam_phase(seed: int, card: str, device: str = "cuda", size: int = IAM_BIG,
              chunk: int = IAM_CHUNK) -> None:
    """Phase 14 (see the module's docstring): identity and access on config
    1's set, through the front door, as a non-root IAM user."""
    import numpy as np

    from minio_tpu_torch.crypto.configcrypt import SealedSysStore
    from minio_tpu_torch.iam.sys import IAMSys
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3 import sigv2, sigv4
    from minio_tpu_torch.s3.server import build_server

    rng = np.random.default_rng(seed + 14)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-iam-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    st = _Stages()
    lines = []
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    root = _Client(srv.url)
    clients = [root]

    def rate(name, nbytes):
        sec, d = st.delta(name)
        lines.append(f"{name} {sec:.6f} s ({nbytes / (1 << 30) / sec:.6f} GiB/s; K1/K2 "
                     f"{d['gf2_matmul']}/{d['mxsum_digest']})")
        return d

    def expect(what, r, body, status, code=""):
        if r.status != status or (code and _error_code(body) != code):
            raise AssertionError(f"{what}: {r.status} {body[:300]!r}, want {status} {code}")

    def refused(what, cl, path, code="AccessDenied", **kw):
        """A refused PUT of 1 MiB: the error, and no kernel launched."""
        st.mark(f"{what} start")
        r, body = cl.request("PUT", path, rng.bytes(1 << 20), check=False, **kw)
        st.mark(what)
        expect(what, r, body, 403, code)
        _s, d = st.delta(what)
        if d["gf2_matmul"] or d["mxsum_digest"]:
            raise AssertionError(f"{what}: a refused request launched {d}")

    try:
        kernels.reset_launches()
        st.mark("start")
        es = srv.obj.pools[0].sets[0]
        root.request("PUT", "/iamb")
        root.request("PUT", "/minio/admin/v3/add-canned-policy", IAM_POLICY.encode(),
                     query={"name": "iamb-readwrite"})
        for ak, sk, pol in (("smokeuser", "smokeuser-secret", "iamb-readwrite"),
                            ("denieduser", "denieduser-secret", "iamb-deny-put")):
            if pol == "iamb-deny-put":
                root.request("PUT", "/minio/admin/v3/add-canned-policy",
                             IAM_DENY_PUT.encode(), query={"name": pol})
            root.request("PUT", "/minio/admin/v3/add-user", json.dumps(
                {"secretKey": sk}).encode(), query={"accessKey": ak})
            root.request("POST", "/minio/admin/v3/set-user-or-group-policy",
                         query={"userOrGroup": ak, "policyName": pol})
        t0 = time.perf_counter()
        fresh = IAMSys(ACCESS, SECRET, store=SealedSysStore(srv.obj, SECRET))
        load_ms = (time.perf_counter() - t0) * 1e3
        if set(fresh.users) != {"smokeuser", "denieduser"}:
            raise AssertionError(f"the IAM store reloaded {sorted(fresh.users)}")
        user = _Client(srv.url, "smokeuser", "smokeuser-secret")
        clients.append(user)
        creds = sigv4.Credentials("smokeuser", "smokeuser-secret")
        # (a) a 256 MiB aws-chunked PUT in 64 KiB signed chunks, then the
        # same object header-signed; both sampled against the plain kernels.
        data = rng.bytes(size)
        etag = _md5_etag(data)
        hdrs, body = sigv4.sign_chunked("PUT", "/iamb/chunked", {}, {}, user.host, creds,
                                        data, chunk)
        st.mark("chunked start")
        r, out = user.raw("PUT", "/iamb/chunked", body, hdrs)
        st.mark("aws-chunked PUT")
        expect("aws-chunked PUT", r, out, 200)
        del body
        if r.getheader("ETag") != etag:
            raise AssertionError("aws-chunked PUT: ETag is not the md5 of the payload")
        chunked = rate("aws-chunked PUT", size)
        r, _ = user.request("PUT", "/iamb/signed", data)
        st.mark("header-signed PUT")
        signed = rate("header-signed PUT", size)
        if r.getheader("ETag") != etag:
            raise AssertionError("header-signed PUT: ETag")
        st.need("aws-chunked PUT")
        if chunked != signed:
            raise AssertionError(f"K1/K2 launches differ: aws-chunked {chunked}, "
                                 f"header-signed {signed}")
        _settle(es.drives)
        for key in ("chunked", "signed"):
            _check_sampled_digests(paths, es, "iamb", key, device)
            if user.request("GET", f"/iamb/{key}")[1] != data:
                raise AssertionError(f"GET {key}: bytes differ")
        st.mark("gets")
        # (b) a presigned SigV4 GET and a SigV2 presigned GET.
        r, got = user.raw("GET", sigv4.presign_url("GET", "/iamb/chunked", user.host, creds))
        st.mark("presigned SigV4 GET")
        expect("presigned SigV4 GET", r, b"", 200)
        if got != data:
            raise AssertionError("presigned SigV4 GET: bytes differ")
        rate("presigned SigV4 GET", size)
        r, got = user.raw("GET", sigv2.presign_url("GET", "/iamb/chunked", "smokeuser",
                                                   "smokeuser-secret", int(time.time()) + 600))
        st.mark("presigned SigV2 GET")
        expect("presigned SigV2 GET", r, b"", 200)
        if got != data:
            raise AssertionError("presigned SigV2 GET: bytes differ")
        rate("presigned SigV2 GET", size)
        # (c) STS AssumeRole, then a PUT and a GET with the session token;
        # without it, InvalidToken.
        r, doc = user.request("POST", "/", b"Action=AssumeRole&DurationSeconds=900"
                              b"&Version=2011-06-15")
        ak, sk, token = _sts_creds(doc)
        sts = _Client(srv.url, ak, sk, token)
        clients.append(sts)
        small = rng.bytes(16 << 20)
        st.mark("sts start")
        sts.request("PUT", "/iamb/sts", small)
        st.mark("STS PUT")
        rate("STS PUT", len(small))
        if sts.request("GET", "/iamb/sts")[1] != small:
            raise AssertionError("STS GET: bytes differ")
        st.mark("STS GET")
        rate("STS GET", len(small))
        bare = _Client(srv.url, ak, sk)
        clients.append(bare)
        r, out = bare.request("GET", "/iamb/sts", check=False)
        expect("GET without the session token", r, out, 400, "InvalidToken")
        # (d) a user-policy Deny and a bucket-policy Deny refuse before any
        # kernel; an anonymous GET the bucket policy allows.
        denied = _Client(srv.url, "denieduser", "denieduser-secret")
        clients.append(denied)
        refused("user-policy Deny", denied, "/iamb/x")
        public = rng.bytes(1 << 20)
        root.request("PUT", "/iamb/public/obj", public)
        root.request("PUT", "/iamb", IAM_BUCKET_POLICY.encode(), query={"policy": ""})
        refused("bucket-policy Deny (root)", root, "/iamb/frozen/x")
        r, got = root.raw("GET", "/iamb/public/obj")
        expect("anonymous GET", r, b"", 200)
        if got != public:
            raise AssertionError("anonymous GET: bytes differ")
        r, out = root.raw("GET", "/iamb/signed")
        expect("anonymous GET outside the policy", r, out, 403, "AccessDenied")
        # (e) object lock: a COMPLIANCE version outlives its DELETE by id; a
        # GOVERNANCE one deletes with the bypass header.
        until = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + 86400))
        root.request("PUT", "/iamlock", headers={"x-amz-bucket-object-lock-enabled": "true"})
        locked = rng.bytes(4 << 20)
        vids = {}
        for mode in ("COMPLIANCE", "GOVERNANCE"):
            r, _ = root.request("PUT", f"/iamlock/{mode.lower()}", locked, headers={
                "x-amz-object-lock-mode": mode,
                "x-amz-object-lock-retain-until-date": until})
            vids[mode] = r.getheader("x-amz-version-id")
        r, out = root.request("DELETE", "/iamlock/compliance", check=False,
                              query={"versionId": vids["COMPLIANCE"]},
                              headers={"x-amz-bypass-governance-retention": "true"})
        expect("DELETE of the COMPLIANCE version", r, out, 403, "AccessDenied")
        if root.request("GET", "/iamlock/compliance",
                        query={"versionId": vids["COMPLIANCE"]})[1] != locked:
            raise AssertionError("the COMPLIANCE version does not read back")
        r, out = root.request("DELETE", "/iamlock/governance", check=False,
                              query={"versionId": vids["GOVERNANCE"]})
        expect("DELETE of the GOVERNANCE version", r, out, 403, "AccessDenied")
        root.request("DELETE", "/iamlock/governance", query={"versionId": vids["GOVERNANCE"]},
                     headers={"x-amz-bypass-governance-retention": "true"})
        r, out = root.request("GET", "/iamlock/governance", check=False,
                              query={"versionId": vids["GOVERNANCE"]})
        expect("GET of the deleted GOVERNANCE version", r, out, 404)
        # (f) a tampered chunk in the middle of an aws-chunked overwrite.
        hdrs, body = sigv4.sign_chunked("PUT", "/iamb/chunked", {}, {}, user.host, creds,
                                        rng.bytes(1 << 20), chunk)
        body = bytearray(body)
        mid = body.index(b"\r\n", (1 << 20) // 2) + 100
        body[mid] ^= 1
        st.mark("tamper start")
        r, out = user.raw("PUT", "/iamb/chunked", bytes(body), hdrs)
        st.mark("tampered PUT")
        expect("tampered aws-chunked PUT", r, out, 403, "SignatureDoesNotMatch")
        r, got = user.request("GET", "/iamb/chunked")
        if got != data or r.getheader("ETag") != etag:
            raise AssertionError("the key changed after a tampered aws-chunked PUT")
        st.mark("end")
    finally:
        for cl in clients:
            cl.close()
        _close_server(srv)
        shutil.rmtree(work, ignore_errors=True)
    print(f"  IAM store load ({len(fresh.users)} users, {len(fresh.policies)} policies; "
          f"one argon2id derivation): {load_ms:.3f} ms on the host")
    for line in lines:
        print(f"  {line} on {card}")
    print("  (c) STS session token enforced (InvalidToken without it); (d) user-policy "
          "and bucket-policy Deny refused with K1/K2 launches 0, anonymous GET allowed "
          "by the bucket policy byte-equal; (e) COMPLIANCE version kept, GOVERNANCE "
          "deleted with the bypass header; (f) tampered chunk: SignatureDoesNotMatch, "
          "key unchanged")
    total = {k: st.at[-1][1][k] - st.at[0][1][k] for k in st.at[0][1]}
    print(f"  launches in the phase: {total}")


FD_OBJECTS = 128                # phase 15: warp-mix objects through the pool and one server
FD_BIG = 256 << 20              # ... the big object through the pool
FD_HOT = 16 << 20               # ... the hot object, fetched FD_HOT_GETS times
FD_HOT_GETS = 8
FD_KILL_PUTS = 64               # ... small PUTs in flight across the SIGKILL of worker 1


def _fd_view(samples, backend: str) -> dict:
    """One worker's scrape, reduced to what phase 15 reads: its requests,
    K1 and K2 launches (labels as OBS_K1 / OBS_K2), ring submits and
    served by op, ring fallbacks by reason."""
    k = _by_label(samples, "minio_tpu_kernel_launches_total", "kernel", backend=backend)
    return {"requests": sum(_by_label(samples, "minio_tpu_frontdoor_requests_total",
                                      "worker").values()),
            "k1": sum(k.get(lbl, 0) for lbl in OBS_K1),
            "k2": sum(k.get(lbl, 0) for lbl in OBS_K2),
            "submits": _by_label(samples, "minio_tpu_frontdoor_ring_submits_total", "op"),
            "served": _by_label(samples, "minio_tpu_frontdoor_ring_served_total", "op"),
            "fallbacks": _by_label(samples, "minio_tpu_frontdoor_ring_fallbacks_total",
                                   "reason")}


def _fd_delta(a: dict, b: dict) -> dict:
    out = {}
    for key, v in b.items():
        if isinstance(v, dict):
            d = {k: int(x - a[key].get(k, 0)) for k, x in v.items()
                 if x - a[key].get(k, 0)}
            out[key] = d
        else:
            out[key] = int(v - a[key])
    return out


class _Workers:
    """One keep-alive connection pinned to each worker of a pool (the
    router passes each new connection to the next worker), for its scrape
    and for requests that must reach a given worker."""

    def __init__(self, url: str, n: int, backend: str):
        self.backend = backend
        self.cl: dict[str, _Client] = {}
        for _ in range(8 * n):
            cl = _Client(url)
            r, _body = cl.request("GET", "/minio/health/live")
            w = r.getheader("X-Mtpu-Worker")
            if w in self.cl:
                cl.close()
            else:
                self.cl[w] = cl
            if len(self.cl) == n:
                break
        if len(self.cl) != n:
            raise AssertionError(f"front door: reached workers {sorted(self.cl)} of {n}")

    def views(self) -> dict:
        out = {}
        for w, cl in self.cl.items():
            _r, body = cl.request("GET", "/minio/v2/metrics/node")
            out[w] = _fd_view(parse_exposition(body.decode())[1], self.backend)
        return out

    def close(self) -> None:
        for cl in self.cl.values():
            cl.close()


def _fd_run(url: str, objects: dict, n_clients: int, verb: str) -> tuple[float, dict]:
    """PUT or GET (checked byte-equal with its ETag) every object through
    `n_clients` client threads; -> (seconds, answers per worker)."""
    pool = _Pool(url, n_clients)
    per: dict = {}

    def one(cl, kv):
        key, body = kv
        if verb == "PUT":
            r, _d = cl.request("PUT", key, body)
            if r.getheader("ETag") != _md5_etag(body):
                raise AssertionError(f"front door PUT {key}: ETag differs")
        else:
            r, data = cl.request("GET", key)
            if data != body or r.getheader("ETag") != _md5_etag(body):
                raise AssertionError(f"front door GET {key}: bytes or ETag differ")
        return r.getheader("X-Mtpu-Worker")

    try:
        t0 = time.perf_counter()
        for w in pool.run(one, objects.items()):
            per[w] = per.get(w, 0) + 1
        return time.perf_counter() - t0, per
    finally:
        pool.close()


def _drain_launch_logs(log_dir: str, n: int) -> dict:
    """Each worker's exact kernel launch counts (ops/kernels.py) over its
    life, from the line its drain logs; a worker killed before draining
    logs none."""
    import ast

    out = {}
    for i in range(n):
        try:
            text = open(os.path.join(log_dir, f"worker{i}.log"), encoding="utf-8").read()
        except OSError:
            continue
        for line in text.splitlines():
            if "drained; kernel launches" in line:
                out[i] = ast.literal_eval(line.split("kernel launches ", 1)[1])
    return out


def frontdoor_phase(seed: int, card: str, device: str = "cuda",
                    n_objects: int = FD_OBJECTS, n_clients: int = 64,
                    big_size: int = FD_BIG, hot_size: int = FD_HOT,
                    kill_puts: int = FD_KILL_PUTS, workers: int | None = None) -> dict:
    """Phase 15 (see the module's docstring): the multi-process front door
    and the QoS plane on config 1; -> the numbers it printed."""
    import signal

    import numpy as np

    from minio_tpu_torch.frontdoor.supervisor import Supervisor
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    n_workers = workers or min(4, os.cpu_count() or 1)
    backend = "gpu" if device == "cuda" else "cpu"
    rng = np.random.default_rng(seed + 15)
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                               n_objects)).astype(np.int64)
    objects = {f"/fd-{'ab'[i % 2]}/w{i:04d}": rng.bytes(int(n))
               for i, n in enumerate(sizes)}
    total = int(sizes.sum())
    gib = total / (1 << 30)
    env = {"MTPU_QOS": "1", "MTPU_QOS_WEIGHTS": f"{ACCESS}/fd-a=3,{ACCESS}/fd-b=1",
           "MTPU_HOTTIER": "1", "MTPU_HOTTIER_BYTES": str(64 << 20),
           "MTPU_HOTTIER_MAX_OBJECT": str(32 << 20), "MTPU_FRONTDOOR_DRAIN_S": "30"}
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-fd-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    spaths = [os.path.join(work, f"s{i:02d}") for i in range(12)]
    logs = tempfile.mkdtemp(prefix="mtpu-torch-fd-logs-")
    out: dict = {"workers": n_workers}
    print(f"  {n_workers} workers on {os.cpu_count()} CPUs; {n_objects} objects, {total} B "
          f"({total / (1 << 20):.1f} MiB), {n_clients} client threads, buckets fd-a and "
          f"fd-b (tenants {ACCESS}/fd-a and /fd-b, weights 3:1), MTPU_QOS=1")
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    sup = Supervisor(paths, f"127.0.0.1:{port}", n_workers, shared_lanes=True,
                     device=device, log_dir=logs, env=_child_env(env))
    pin = None
    from concurrent.futures import ThreadPoolExecutor

    # The one-process server of (a) boots beside the pool (it idles until
    # the pool's runs are done).
    sport = _free_port()
    boot = ThreadPoolExecutor(max_workers=1)
    child_f = boot.submit(_crash_child, spaths, sport, device, env)
    try:
        t0 = time.perf_counter()
        sup.start()
        sup.wait_workers()
        out["boot_s"] = time.perf_counter() - t0
        print(f"  pool up in {out['boot_s']:.3f} s (worker 0 first, then the rest)")
        root = _Client(url)
        for b in ("/fd-a", "/fd-b"):
            root.request("PUT", b)
        pin = _Workers(url, n_workers, backend)

        # (a) the warp mix through the pool, then through one server.
        v0 = pin.views()
        put_s, put_w = _fd_run(url, objects, n_clients, "PUT")
        get_s, get_w = _fd_run(url, objects, n_clients, "GET")
        v1 = pin.views()
        da = {w: _fd_delta(v0[w], v1[w]) for w in v0}
        per_worker = {w: put_w.get(w, 0) + get_w.get(w, 0) for w in pin.cl}
        out["pool"] = {"put": n_objects / put_s, "get": n_objects / get_s}
        print(f"  (a) pool of {n_workers} on {card}: PUT {n_objects / put_s:.3f} objects/s, "
              f"{gib / put_s:.6f} GiB/s ({put_s:.6f} s); GET {n_objects / get_s:.3f} "
              f"objects/s, {gib / get_s:.6f} GiB/s ({get_s:.6f} s); requests per worker "
              f"(X-Mtpu-Worker) {dict(sorted(per_worker.items()))}")
        for w in sorted(da):
            print(f"      worker {w}: K1 {da[w]['k1']}, K2 {da[w]['k2']} (scrape labels); "
                  f"ring submits {da[w]['submits']}, served {da[w]['served']}, "
                  f"fallbacks {da[w]['fallbacks']}")
        served = sum(da["0"]["served"].values())
        submits = sum(sum(d["submits"].values()) for d in da.values())
        fallbacks = sum(sum(d["fallbacks"].values()) for d in da.values())
        out["ring"] = {"submits": submits, "served": served, "fallbacks": fallbacks}
        print(f"      ring: {submits} submits, {served} served by worker 0, {fallbacks} "
              f"fallbacks; served / (served + fallbacks) "
              f"{served / max(1, served + fallbacks):.3f}")
        if any(per_worker[w] == 0 for w in per_worker):
            raise AssertionError(f"front door: a worker served no request {per_worker}")
        if served <= 0:
            raise AssertionError("front door: the ring served nothing in (a)")
        if da["0"]["k1"] <= 0 or da["0"]["k2"] <= 0 or da["0"]["served"].get("encode", 0) <= 0:
            raise AssertionError(f"front door: worker 0 launched no K1/K2 for ring work {da['0']}")
        # The SLO plane's mailboxes: any worker's answer merges every
        # worker's latest evaluation (a worker evaluates every 5 s).
        deadline = time.perf_counter() + 30
        while True:
            r, body = root.request("GET", "/minio/admin/v3/slo")
            local = json.loads(body)["nodes"]["local"]
            if (sorted(local["workers"]) == list(range(n_workers))
                    or time.perf_counter() > deadline):
                break
            time.sleep(0.5)
        merged = sorted(local["workers"])
        print(f"  (a) GET /minio/admin/v3/slo through worker {r.getheader('X-Mtpu-Worker')}: "
              f"the mailboxes of workers {merged} merged; burn fast/slow, breach "
              + "; ".join(f"{k} {s['windows']['fast']['burn']}/{s['windows']['slow']['burn']}"
                          f", {s['breach']}" for k, s in sorted(local["slos"].items())))
        if merged != list(range(n_workers)) or len(local["slos"]) != 4:
            raise AssertionError(f"front door: the slo answer merged workers {merged} of "
                                 f"{n_workers}")
        out["slo_workers"] = merged

        child = child_f.result()
        surl = f"http://127.0.0.1:{sport}"
        scl = _Client(surl)
        for b in ("/fd-a", "/fd-b"):
            scl.request("PUT", b)
        s0 = _fd_view(parse_exposition(scl.request(
            "GET", "/minio/v2/metrics/node")[1].decode())[1], backend)
        sput_s, _w = _fd_run(surl, objects, n_clients, "PUT")
        sget_s, _w = _fd_run(surl, objects, n_clients, "GET")
        s1 = _fd_view(parse_exposition(scl.request(
            "GET", "/minio/v2/metrics/node")[1].decode())[1], backend)
        scl.close()
        child.kill()
        child.wait(timeout=30)
        for p in spaths:
            shutil.rmtree(p, ignore_errors=True)
        ds = _fd_delta(s0, s1)
        out["single"] = {"put": n_objects / sput_s, "get": n_objects / sget_s}
        print(f"  (a) one server process on {card}: PUT {n_objects / sput_s:.3f} objects/s, "
              f"{gib / sput_s:.6f} GiB/s ({sput_s:.6f} s); GET {n_objects / sget_s:.3f} "
              f"objects/s, {gib / sget_s:.6f} GiB/s ({sget_s:.6f} s); K1 {ds['k1']}, K2 "
              f"{ds['k2']}; pool/one PUT {sput_s / put_s:.3f}x, GET {sget_s / get_s:.3f}x")

        # (b) one big object through the pool: its 1 MiB blocks do not fit
        # a slot, so the worker that takes it encodes in its own context.
        big = rng.bytes(big_size)
        v0 = pin.views()
        t0 = time.perf_counter()
        r, _d = root.request("PUT", "/fd-a/big", big)
        bput = time.perf_counter() - t0
        bw = r.getheader("X-Mtpu-Worker")
        t0 = time.perf_counter()
        r, data = root.request("GET", "/fd-a/big")
        bget = time.perf_counter() - t0
        if data != big or r.getheader("ETag") != _md5_etag(big):
            raise AssertionError("front door: the big GET differs")
        v1 = pin.views()
        db = {w: _fd_delta(v0[w], v1[w]) for w in v0}
        out["big"] = {"put_s": bput, "get_s": bget}
        print(f"  (b) {big_size >> 20} MiB through worker {bw}: PUT {bput:.6f} s "
              f"({big_size / (1 << 30) / bput:.6f} GiB/s), GET {bget:.6f} s "
              f"({big_size / (1 << 30) / bget:.6f} GiB/s); K1/K2 by worker "
              f"{ {w: (d['k1'], d['k2']) for w, d in sorted(db.items())} }")
        if db[bw]["k1"] <= 0:
            raise AssertionError(f"front door: worker {bw} encoded the big object without K1")
        objects["/fd-a/big"] = big

        # (c) the hot tier lives in worker 0; siblings probe it over
        # OP_HOTGET, whose answer must fit a slot's response area (256 KiB
        # of a 1 MiB slot): a sibling's full GET of the object falls back
        # as oversize, its Range GETs ride the ring.
        hot = rng.bytes(hot_size)
        root.request("PUT", "/fd-b/hot", hot)
        objects["/fd-b/hot"] = hot
        sibs = [w for w in sorted(pin.cl) if w != "0"] or ["0"]
        span = 200 << 10
        fetches = [("0", None), ("0", None), (sibs[0], None)] + [
            (sibs[i % len(sibs)], (i * (hot_size - span) // (FD_HOT_GETS - 4), span))
            for i in range(FD_HOT_GETS - 3)]
        v0 = pin.views()
        t0 = time.perf_counter()
        for i, (w, rg) in enumerate(fetches):
            hdr = {} if rg is None else {"Range": f"bytes={rg[0]}-{rg[0] + rg[1] - 1}"}
            r, data = pin.cl[w].request("GET", "/fd-b/hot", headers=hdr)
            want = hot if rg is None else hot[rg[0]:rg[0] + rg[1]]
            if data != want or r.getheader("ETag") != _md5_etag(hot):
                raise AssertionError(f"front door: hot GET {i} differs")
            if i == 1:
                # Worker 0's two GETs made the key hot: wait for its admission.
                deadline = time.perf_counter() + 20
                while time.perf_counter() < deadline:
                    _r, body = pin.cl["0"].request("GET", "/minio/v2/metrics/node")
                    fams = parse_exposition(body.decode())[1]
                    if sum(_by_label(fams, "minio_tpu_hottier_admits_total", "").values()):
                        break
                    time.sleep(0.05)
        hot_s = time.perf_counter() - t0
        v1 = pin.views()
        dc = {w: _fd_delta(v0[w], v1[w]) for w in v0}
        hits = dc["0"]["served"].get("hotget", 0)
        out["hot_hits"] = hits
        print(f"  (c) {hot_size >> 20} MiB fetched {FD_HOT_GETS} times in {hot_s:.6f} s: by "
              f"worker 0 whole twice, by worker {sibs[0]} whole, then {FD_HOT_GETS - 3} "
              f"Range GETs of {span >> 10} KiB by workers {[w for w, rg in fetches if rg]}; "
              f"OP_HOTGET served {hits}, fallbacks "
              f"{ {w: d['fallbacks'] for w, d in sorted(dc.items()) if d['fallbacks']} }")
        if hits < 1:
            raise AssertionError("front door: no OP_HOTGET hit served a sibling")
        ring_end = pin.views()
        pin.close()
        pin = None
        root.close()

        # (d) SIGKILL of worker 1 with small PUTs in flight.
        from minio_tpu_torch.frontdoor import supervisor as fd_sup

        respawns = fd_sup._RESPAWNS.labels(worker="1").value
        old_pid = sup.pid(1)
        ksizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                                    kill_puts)).astype(np.int64)
        kobjs = {f"/fd-b/k{i:03d}": rng.bytes(int(n)) for i, n in enumerate(ksizes)}
        acked: dict = {}
        import threading

        mu = threading.Lock()
        started = threading.Semaphore(0)

        def put(item):
            key, body = item
            for _ in range(5):   # a PUT cut by the kill is retried, as clients do
                cl = _Client(url)
                try:
                    started.release()
                    r, _d = cl.request("PUT", key, body, check=False)
                    if r.status == 200:
                        with mu:
                            acked[key] = body
                        return
                except (OSError, http.client.HTTPException):
                    pass
                finally:
                    cl.close()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=kill_puts) as ex:
            futs = [ex.submit(put, kv) for kv in kobjs.items()]
            for _ in range(kill_puts // 2):
                started.acquire()
            sup.kill_worker(1, signal.SIGKILL)
            for f in futs:
                f.result()
        deadline = time.perf_counter() + 120
        while (sup.pid(1) in (None, old_pid) or len(sup.alive()) < n_workers
               or len(sup.router.workers_connected()) < n_workers):
            if time.perf_counter() > deadline:
                raise AssertionError("front door: the pool never returned to "
                                     f"{n_workers} workers")
            time.sleep(0.1)
        back_s = time.perf_counter() - t0
        got = fd_sup._RESPAWNS.labels(worker="1").value - respawns
        lost = [k for k, b in acked.items() if _fd_get(url, k) != b]
        out["kill"] = {"acked": len(acked), "lost": len(lost), "respawns": got,
                       "back_s": back_s}
        print(f"  (d) worker 1 SIGKILLed with {kill_puts} PUTs in flight: {len(acked)} "
              f"acknowledged, {len(lost)} of them lost; respawns_total {got:.0f}; "
              f"{n_workers} workers again {back_s:.3f} s after the first PUT")
        if lost or got != 1 or len(acked) < kill_puts // 2:
            raise AssertionError(f"front door: lost {lost}, respawns {got}, acked "
                                 f"{len(acked)} of {kill_puts}")
        objects.update(acked)

        # (e) SIGTERM drain, then one server over the drives.
        t0 = time.perf_counter()
        sup.drain(timeout=30)
        drain_s = time.perf_counter() - t0
        rcs = {i: p.returncode for i, p in sup.procs.items()}
        segs = {os.path.basename(p): sorted(n for n in os.listdir(
            os.path.join(p, ".mtpu.sys", "wal")) if n.endswith(".wal")) for p in paths}
        exact = _drain_launch_logs(logs, n_workers)
        print(f"  (e) drained in {drain_s:.3f} s, exit codes {rcs}; WAL segments on "
              f"d00: {segs['d00']}; exact launches at drain by worker {exact}")
        want = [f"journal.w{i}.wal" for i in range(n_workers)]
        if any(rc != 0 for rc in rcs.values()):
            raise AssertionError(f"front door: a worker did not drain cleanly {rcs}")
        if any(not set(want) <= set(v) for v in segs.values()):
            raise AssertionError(f"front door: WAL segments {segs}")
        if device == "cuda" and (0 not in exact or exact[0]["gf2_matmul"] <= 0
                                 or exact[0]["mxsum_digest"] <= 0):
            raise AssertionError(f"front door: worker 0's K1/K2 launches {exact}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
        try:
            read_s, _w = _fd_run(srv.url, objects, n_clients, "GET")
            es = srv.obj.pools[0].sets[0]
            for key in ("/fd-a/big", "/fd-b/hot",
                        max((k for k in objects if k.startswith("/fd-b/k")),
                            key=lambda k: len(objects[k]))):
                _b, bucket, name = key.split("/", 2)
                _check_sampled_digests(paths, es, bucket, name, device)
        finally:
            _close_server(srv)
        counts = kernels.launches()
        print(f"  (e) one server read all {len(objects)} keys back in "
              f"{time.perf_counter() - t0:.3f} s ({read_s:.3f} s of GETs; K2 "
              f"{counts['mxsum_digest']}); sampled shard digests and parity equal the "
              f"plain versions")
        if counts["mxsum_digest"] <= 0:
            raise AssertionError("front door: the read-back launched no K2")
        out["ring_end"] = {w: v["fallbacks"] for w, v in ring_end.items()}
        return out
    finally:
        if pin is not None:
            pin.close()
        boot.shutdown(wait=True)   # the child has booted, or failed to
        if child_f.exception() is None and child_f.result().poll() is None:
            child_f.result().kill()
            child_f.result().wait(timeout=30)
        if sup.alive():
            sup.drain(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(logs, ignore_errors=True)


CL_NODES, CL_DRIVES = 4, 4       # phase 16: 4 node processes x 4 drives, one 16-drive set
CL_BIG = 256 << 20              # ... the object PUT through node 1, GET through node 3
CL_OBJECTS, CL_CLIENTS = 256, 32   # ... the warp mix across the 4 nodes
CL_CONTEND = 8                  # ... concurrent PUTs of one key
CL_DOWN_PUT = 16 << 20          # ... the PUT while node 4 is down


def _free_port_pair() -> int:
    """A port p with p and p + 1000 (its RPC fabric's default) free."""
    import socket

    for _ in range(200):
        p = _free_port()
        if p + 1000 > 65535:
            continue
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", p + 1000))
        except OSError:
            continue
        finally:
            s.close()
        return p
    raise AssertionError("no free port pair for a cluster node")


class _Node:
    """One node of phase 16: `python -m minio_tpu_torch.s3.server` over the
    cluster's URL endpoints, its output kept (a reader thread) for its
    "serving S3" and "drained" lines."""

    def __init__(self, endpoints: list[str], port: int, device: str, env: dict):
        import threading

        self.port = port
        self.url = f"http://127.0.0.1:{port}"
        self.name = f"127.0.0.1:{port}"
        self.lines: list[str] = []
        self.serving = threading.Event()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.s3.server", *endpoints,
             "--address", f"127.0.0.1:{port}", "--device", device,
             "--scan-interval", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)

        def read():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip("\n"))
                if "serving S3" in line:
                    self.serving.set()

        self._reader = threading.Thread(target=read, daemon=True, name="smoke-node-log")
        self._reader.start()

    def wait_serving(self, deadline: float) -> None:
        while not self.serving.wait(0.1):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.proc.kill()
                raise AssertionError(f"node {self.name} did not serve:\n"
                                     + "\n".join(self.lines[-40:]))

    def scrape(self, backend: str) -> dict:
        """{"k1", "k2", "k1_rec"}: this node's K1/K2 launches by label."""
        cl = _Client(self.url)
        try:
            _r, body = cl.request("GET", "/minio/v2/metrics/node")
        finally:
            cl.close()
        k = _by_label(parse_exposition(body.decode())[1],
                      "minio_tpu_kernel_launches_total", "kernel", backend=backend)
        return {"k1": sum(k.get(lbl, 0) for lbl in OBS_K1),
                "k2": sum(k.get(lbl, 0) for lbl in OBS_K2),
                "k1_rec": sum(k.get(lbl, 0) for lbl in
                              ("reconstruct", "reconstruct_digests", "reconstruct_weights",
                               "dp_reconstruct"))}

    def term(self) -> None:
        import signal

        self.proc.send_signal(signal.SIGTERM)

    def drain(self, timeout: float = 60.0) -> dict:
        """After term(): -> its exact kernel launch counts (the drain line)."""
        import ast

        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise AssertionError(f"node {self.name} did not drain in {timeout} s")
        self._reader.join(10)
        if rc != 0:
            raise AssertionError(f"node {self.name} exited {rc} on SIGTERM:\n"
                                 + "\n".join(self.lines[-40:]))
        for line in self.lines:
            if "drained; kernel launches" in line:
                return ast.literal_eval(line.split("kernel launches ", 1)[1])
        raise AssertionError(f"node {self.name} logged no drain line")

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(30)
        self._reader.join(10)


def _cluster_diag(nodes) -> None:
    """After a failure: each live node's fabric and drive-health counters
    and the end of its output."""
    fams = ("minio_tpu_rpc_errors_total", "minio_tpu_rpc_offline_total",
            "minio_tpu_rpc_retry_shed_total", "minio_tpu_peer_breaker_transitions_total",
            "minio_tpu_drive_state", "minio_tpu_drive_timeouts_total",
            "minio_tpu_admission_shed_total", "minio_tpu_hung_workers_total")
    for n in nodes:
        print(f"  node {n.name} (exit {n.proc.poll()}):")
        if n.proc.poll() is None:
            try:
                cl = _Client(n.url)
                _r, body = cl.request("GET", "/minio/v2/metrics/node")
                cl.close()
                for name, lbl, v in parse_exposition(body.decode())[1]:
                    if name in fams and v:
                        print(f"    {name} {lbl} {v}")
            except Exception as e:  # noqa: BLE001 - a diagnosis only
                print(f"    scrape failed: {e}")
        for line in n.lines[-15:]:
            print(f"    | {line}")


def _cluster_views(nodes, backend: str) -> list[dict]:
    return [n.scrape(backend) for n in nodes]


def _views_delta(a: list[dict], b: list[dict]) -> list[dict]:
    return [{k: int(y[k] - x[k]) for k in y} for x, y in zip(a, b)]


def _cluster_pick_key(bucket: str, prefix: str, down: range) -> str:
    """A key whose shards on the drives of `down` (the slots of node 4)
    include a data shard, so reading it with node 4 gone reconstructs."""
    from minio_tpu_torch.erasure.metadata import hash_order

    for i in range(1000):
        key = f"{prefix}{i}"
        dist = hash_order(f"{bucket}/{key}", K12 + M12)
        if any(dist[s] <= K12 for s in down):
            return key
    raise AssertionError("no key with a data shard on node 4")


def _cluster_shards(roots: list[str], bucket: str, key: str) -> dict:
    """{slot: bytes} of every drive's part.1 of `key`."""
    out = {}
    for slot, root in enumerate(roots):
        hits = glob.glob(os.path.join(root, bucket, key, "*", "part.1"))
        if hits:
            with open(hits[0], "rb") as f:
                out[slot] = f.read()
    return out


def _cluster_check_shards(shards: dict, bucket: str, key: str, size: int,
                          device: str) -> None:
    """The first block's chunk of every shard: its digest equal to K2's
    plain version, and the 4 parity chunks equal to K1's plain version
    over the 12 data chunks (slot s holds shard hash_order(bucket/key)[s])."""
    import io as _io

    import numpy as np
    import torch

    from minio_tpu_torch.erasure.metadata import hash_order
    from minio_tpu_torch.ops import bitrot, rs
    from minio_tpu_torch.storage.fileinfo import ErasureInfo

    ei = ErasureInfo(data_blocks=K12, parity_blocks=M12, block_size=1 << 20)
    dist = hash_order(f"{bucket}/{key}", K12 + M12)
    chunks = {}
    for slot, raw in shards.items():
        digest, chunk = bitrot.BitrotReader(_io.BytesIO(raw), ei.shard_file_size(size),
                                            ei.shard_size(), "mxsum256").read_record(0)
        if digest != _plain_digest("mxsum256", chunk, device):
            raise AssertionError(f"{key}: slot {slot}'s first digest differs from "
                                 "K2's plain version")
        chunks[dist[slot]] = chunk
    x = torch.from_numpy(np.stack([np.frombuffer(chunks[j + 1], dtype=np.uint8)
                                   for j in range(K12)]))[None].to(device)
    parity = rs.gf2_matmul_plain(x, rs.device_encode_weights(K12, M12, torch.device(device)),
                                 M12)[0].cpu()
    for j in range(M12):
        if parity[j].numpy().tobytes() != chunks[K12 + j + 1]:
            raise AssertionError(f"{key}: parity shard {K12 + j + 1} differs from K1's "
                                 "plain version")


def cluster_phase(seed: int, card: str, records: list[dict] | None, device: str = "cuda",
                  big_size: int = CL_BIG, n_objects: int = CL_OBJECTS,
                  n_clients: int = CL_CLIENTS, down_put: int = CL_DOWN_PUT) -> dict:
    """Phase 16 (see the module's docstring): four port nodes serving one
    16-drive set at EC 12+4; -> the numbers it printed."""
    import threading

    import numpy as np

    from minio_tpu_torch.dist.dsync import DRWMutex, RemoteLocker
    from minio_tpu_torch.dist.rpc import RestClient

    backend = "gpu" if device == "cuda" else "cpu"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 16)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-cl-", dir=shm)
    ports = []
    while len(ports) < CL_NODES:
        p = _free_port_pair()
        if p not in ports:
            ports.append(p)
    roots = [os.path.join(work, f"n{i + 1}", f"d{j + 1}")
             for i in range(CL_NODES) for j in range(CL_DRIVES)]
    endpoints = [f"http://127.0.0.1:{ports[i]}{work}/n{i + 1}/d{{1...{CL_DRIVES}}}"
                 for i in range(CL_NODES)]
    env = _child_env({"MTPU_BOOT_TIMEOUT": "120"})
    out: dict = {}
    nodes: list[_Node] = []
    try:
        # (a) boot: all four at once (the kernels are built: each node
        # loads the library, its own CUDA context).
        t0 = time.perf_counter()
        nodes = [_Node(endpoints, p, device, env) for p in ports]
        deadline = time.monotonic() + 180
        for n in nodes:
            n.wait_serving(deadline)
        out["boot_s"] = time.perf_counter() - t0
        print(f"  (a) {CL_NODES} nodes x {CL_DRIVES} drives serving one "
              f"{K12}+{M12} set after {out['boot_s']:.3f} s (bootstrap, format, "
              f"quorum reads), nodes {[n.name for n in nodes]}")
        print("  " + nodes[0].lines[-1])
        cls = [_Client(n.url) for n in nodes]
        for b in ("cl-big", "cl-mix", "cl-lock"):
            cls[0].request("PUT", f"/{b}")
        # (b) one big object: PUT through node 1, GET through node 3.
        node4_slots = range(CL_DRIVES * 3, CL_DRIVES * 4)
        key = _cluster_pick_key("cl-big", "big", node4_slots)
        data = rng.bytes(big_size)
        v0 = _cluster_views(nodes, backend)
        t0 = time.perf_counter()
        r, _b = cls[0].request("PUT", f"/cl-big/{key}", data)
        out["put_s"] = time.perf_counter() - t0
        if r.getheader("ETag") != _md5_etag(data):
            raise AssertionError("phase 16 PUT: ETag is not the md5")
        v1 = _cluster_views(nodes, backend)
        t0 = time.perf_counter()
        r, got = cls[2].request("GET", f"/cl-big/{key}")
        out["get_s"] = time.perf_counter() - t0
        v2 = _cluster_views(nodes, backend)
        if got != data or r.getheader("ETag") != _md5_etag(data):
            raise AssertionError("phase 16 GET through node 3: bytes or ETag differ")
        put_d, get_d = _views_delta(v0, v1), _views_delta(v1, v2)
        gib = big_size / (1 << 30)
        print(f"  (b) {big_size >> 20} MiB PUT via node 1 {out['put_s']:.6f} s "
              f"({gib / out['put_s']:.3f} GiB/s), GET via node 3 {out['get_s']:.6f} s "
              f"({gib / out['get_s']:.3f} GiB/s) on {card}")
        print(f"      K1/K2 launches per node, PUT: "
              f"{[(d['k1'], d['k2']) for d in put_d]}; GET: "
              f"{[(d['k1'], d['k2']) for d in get_d]}")
        if device == "cuda" and (put_d[0]["k1"] < 1 or put_d[0]["k2"] < 1
                                 or get_d[2]["k2"] < 1):
            raise AssertionError("phase 16: K1/K2 did not launch in the node that "
                                 "took the request")
        shards = _cluster_shards(roots, "cl-big", key)
        if sorted(shards) != list(range(CL_NODES * CL_DRIVES)):
            raise AssertionError(f"phase 16: shard files on slots {sorted(shards)}, "
                                 "not all 16")
        _cluster_check_shards(shards, "cl-big", key, big_size, device)
        print("      all 16 drives hold a shard; sampled digests and parity equal "
              "the plain versions")
        # (c) the warp mix across the nodes, read back through another node.
        sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                                   n_objects)).astype(np.int64)
        objs = [(f"/cl-mix/w{i:04d}", rng.bytes(int(n))) for i, n in enumerate(sizes)]
        local = threading.local()
        opened: list = []
        mu = threading.Lock()

        def client(i):
            cs = getattr(local, "cs", None)
            if cs is None:
                cs = local.cs = [_Client(n.url) for n in nodes]
                with mu:
                    opened.extend(cs)
            return cs[i % CL_NODES]

        def put(it):
            i, (k, body) = it
            r, _d = client(i).request("PUT", k, body)
            if r.getheader("ETag") != _md5_etag(body):
                raise AssertionError(f"phase 16 PUT {k}: ETag differs")

        def get(it):
            i, (k, body) = it
            r, d = client(i + 1).request("GET", k)
            if d != body or r.getheader("ETag") != _md5_etag(body):
                raise AssertionError(f"phase 16 GET {k}: bytes or ETag differ")

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(n_clients, thread_name_prefix="smoke-client") as ex:
            t0 = time.perf_counter()
            list(ex.map(put, enumerate(objs)))
            out["mix_put"] = n_objects / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            list(ex.map(get, enumerate(objs)))
            out["mix_get"] = n_objects / (time.perf_counter() - t0)
        for c in opened:
            c.close()
        print(f"  (c) warp mix, {n_objects} objects of 1-512 KiB "
              f"({int(sizes.sum()) / (1 << 20):.1f} MiB), {n_clients} clients over "
              f"{CL_NODES} nodes, each read back through another node: PUT "
              f"{out['mix_put']:.3f} objects/s, GET {out['mix_get']:.3f} objects/s "
              f"on {card}")
        # (d) contention: a lock held from here over the lock plane, listed
        # by top/locks, holds back a PUT; then 8 PUTs of one key race.
        lock_clients = [RestClient("127.0.0.1", p + 1000, SECRET, timeout=10.0)
                        for p in ports]
        mx = DRWMutex(["cl-lock/hot"], [RemoteLocker(c) for c in lock_clients])
        try:
            if not mx.get_lock(timeout=10.0):
                raise AssertionError("phase 16: no dsync quorum for the smoke's lock")
            _r, doc = cls[1].request("GET", "/minio/admin/v3/top/locks")
            if "cl-lock/hot" not in json.loads(doc)["locks"]:
                raise AssertionError("phase 16: top/locks does not list a held lock")
            held = {}

            def blocked_put():
                c = _Client(nodes[0].url)
                try:
                    t = time.perf_counter()
                    c.request("PUT", "/cl-lock/hot", b"first")
                    held["s"] = time.perf_counter() - t
                finally:
                    c.close()

            th = threading.Thread(target=blocked_put, daemon=True)
            th.start()
            th.join(1.0)
            if "s" in held:
                raise AssertionError("phase 16: a PUT went through a held lock")
        finally:
            mx.unlock()
            for c in lock_clients:
                c.close()
        th.join(60)
        if "s" not in held:
            raise AssertionError("phase 16: the PUT behind the lock never finished")
        bodies = [rng.bytes(4 << 20) for _ in range(CL_CONTEND)]

        def race(i):
            c = _Client(nodes[i % CL_NODES].url)
            try:
                c.request("PUT", "/cl-lock/hot", bodies[i])
            finally:
                c.close()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(CL_CONTEND) as ex:
            list(ex.map(race, range(CL_CONTEND)))
        race_s = time.perf_counter() - t0
        finals = set()
        for c in cls:
            _r, d = c.request("GET", "/cl-lock/hot")
            finals.add(hashlib.md5(d).hexdigest())
        winners = {hashlib.md5(b).hexdigest() for b in bodies}
        if len(finals) != 1 or not finals <= winners:
            raise AssertionError("phase 16: the contended key is not one body whole")
        print(f"  (d) top/locks on node 2 listed the smoke's dsync lock; a PUT "
              f"waited {held['s']:.3f} s behind it; {CL_CONTEND} PUTs of one key "
              f"through {CL_NODES} nodes in {race_s:.3f} s left one body whole")
        # (e) node 4 lost and back.
        before = {s: shards[s] for s in node4_slots}
        nodes[3].kill()
        for root in roots[CL_DRIVES * 3:]:
            shutil.rmtree(os.path.join(root, "cl-big", key), ignore_errors=True)
        t0 = time.perf_counter()
        r, got = cls[0].request("GET", f"/cl-big/{key}")
        out["degraded_get_s"] = time.perf_counter() - t0
        if got != data:
            raise AssertionError("phase 16: degraded GET with node 4 killed differs")
        down_data = rng.bytes(down_put)
        t0 = time.perf_counter()
        r, _b = cls[0].request("PUT", "/cl-big/while-down", down_data)
        out["down_put_s"] = time.perf_counter() - t0
        if r.getheader("ETag") != _md5_etag(down_data):
            raise AssertionError("phase 16: the PUT with node 4 down has the wrong ETag")
        t0 = time.perf_counter()
        _r, scrape = cls[0].request("GET", "/minio/v2/metrics/cluster")
        scrape_s = time.perf_counter() - t0
        errs = _by_label(parse_exposition(scrape.decode())[1],
                         "minio_tpu_peer_scrape_errors_total", "peer")
        if not errs.get(nodes[3].name) or scrape_s > 2.0 + 3.0:
            raise AssertionError(f"phase 16: cluster scrape with node 4 down: "
                                 f"{scrape_s:.3f} s, peer errors {errs}")
        print(f"  (e) node 4 SIGKILLed: GET via node 1 {out['degraded_get_s']:.6f} s "
              f"byte-equal; {down_put >> 20} MiB PUT at quorum {out['down_put_s']:.6f} s; "
              f"node 1's cluster scrape {scrape_s:.3f} s with peer scrape errors {errs}")
        t0 = time.perf_counter()
        nodes[3] = _Node(endpoints, ports[3], device, env)
        nodes[3].wait_serving(time.monotonic() + 120)
        out["restart_s"] = time.perf_counter() - t0
        cl4 = _Client(nodes[3].url)
        cls[3].close()
        cls[3] = cl4
        t0 = time.perf_counter()
        cl4.request("POST", "/minio/admin/v3/heal/cl-big", b"")
        out["heal_s"] = time.perf_counter() - t0
        after = _cluster_shards(roots, "cl-big", key)
        if any(after.get(s) != before[s] for s in node4_slots):
            raise AssertionError("phase 16: node 4's healed shard files differ from "
                                 "their copies")
        if len(_cluster_shards(roots, "cl-big", "while-down")) != CL_NODES * CL_DRIVES:
            raise AssertionError("phase 16: heal did not bring the PUT node 4 missed")
        _r, got = cl4.request("GET", "/cl-big/while-down")
        if got != down_data:
            raise AssertionError("phase 16: node 4 reads the healed object wrong")
        print(f"  (e) node 4 restarted in {out['restart_s']:.3f} s; heal via node 4 "
              f"{out['heal_s']:.3f} s: its shard files equal the copies taken before "
              f"the kill, and it holds the {down_put >> 20} MiB object it missed")
        for c in cls:
            c.close()
        # (f) drain. A node's scrape labels K1 by entry point, and the GET
        # path's reconstruct (the codec's decode, in both packages) under
        # none: node 1's exact K1 count at its drain less its labeled K1
        # is the reconstructs of its degraded GET, the only one it served.
        v_end = _cluster_views(nodes, backend)
        t0 = time.perf_counter()
        for n in nodes:
            n.term()
        drained = [n.drain() for n in nodes]
        out["drain_s"] = time.perf_counter() - t0
        totals = {k: sum(d.get(k, 0) for d in drained) for k in drained[0]}
        out["node1_reconstruct_k1"] = drained[0]["gf2_matmul"] - int(v_end[0]["k1"])
        print(f"  (f) SIGTERM: every node exited 0 in {out['drain_s']:.3f} s; exact "
              f"launches per node {drained} (node 4's restarted process)")
        if device == "cuda":
            print(f"      node 1's labeled K1 {int(v_end[0]['k1'])}: its degraded GET "
                  f"launched K1 reconstruct {out['node1_reconstruct_k1']} times")
        if device == "cuda" and out["node1_reconstruct_k1"] < 1:
            raise AssertionError("phase 16: no K1 reconstruct in node 1 with node 4 down")
        if records is not None:
            for r0 in [r for r in records if r["path"] == "multipart"
                       and r["name"] in (f"gf2_matmul encode 12+4 [16,12,{S12}]->4",
                                         f"mxsum_digest PUT 12+4 [256,{S12}]")]:
                r1 = dict(r0, name=r0["name"] + " (phase 16 cluster)", path="cluster")
                records.append(r1)
            if sum(r["path"] == "cluster" for r in records) != 2:
                raise AssertionError("phase 16: K1 and K2 records of EC 12+4 not found")
            _fill_launches(records, "cluster", totals)
        out["launches"] = totals
    except BaseException:
        _cluster_diag(nodes)
        raise
    finally:
        for n in nodes:
            if n.proc.poll() is None:
                n.kill()
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 16: {out['phase_s']:.1f} s on {card}")
    return out


class _Sink:
    """A local HTTP listener that keeps the JSON body of every POST (the
    phase's event webhook and audit webhook)."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        docs: list = []

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                docs.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.docs = docs
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def wait(self, pred, timeout: float) -> bool:
        end = time.monotonic() + timeout
        while not pred(self.docs):
            if time.monotonic() > end:
                return False
            time.sleep(0.05)
        return True

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


class _RidClient(_Client):
    """_Client that keeps the x-amz-request-id of every answer."""

    def __init__(self, url: str, rids: list):
        super().__init__(url)
        self._rids = rids

    def send(self, *a, **kw):
        r = super().send(*a, **kw)
        self._rids.append(r.getheader("x-amz-request-id"))
        return r


def background_phase(seed: int, card: str, device: str = "cuda", synth: int = BG_SYNTH,
                     mix: int = BG_MIX, tier_size: int = BG_TIER_SIZE,
                     deep_size: int = BG_DEEP_SIZE) -> None:
    """Phase 17 (see the module's docstring): the background plane on
    config 1's set, the scanner driven cycle by cycle through scan_once."""
    import numpy as np

    from minio_tpu_torch.ops import kernels, mxsum
    from minio_tpu_torch.s3.server import build_server
    from minio_tpu_torch.scanner import scanner as scanmod
    from minio_tpu_torch.scanner import tiers as tiermod
    from minio_tpu_torch.scanner.usage import DataUsageCache
    from minio_tpu_torch.utils.synthbucket import make_synthetic_bucket, synthetic_key

    rng = np.random.default_rng(seed + 17)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-bg-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    events, audit = _Sink(), _Sink()
    prev_qdir = os.environ.get("MTPU_EVENT_QUEUE_DIR")
    os.environ["MTPU_EVENT_QUEUE_DIR"] = os.path.join(work, "events")
    st = _Stages()
    lines = []
    rids: list = []
    srv = pool = None
    real_digest = mxsum.digest
    try:
        srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
        # The scanner the CLI starts (heal_objects on), its loop not
        # started: each cycle below is one scan_once.
        srv.start_scanner(loop=False)
        sc = srv.scanner
        root = _RidClient(srv.url, rids)
        es = srv.obj.pools[0].sets[0]
        # The event and audit webhooks; the scanner's pacing off (delay 0:
        # no sleep of 10x each page's time), so a cycle's seconds are its
        # crawl's own.
        root.request("PUT", "/minio/admin/v3/config-kv", json.dumps({
            "notify_webhook": {"enable": "on", "endpoint": events.url},
            "audit_webhook": {"enable": "on", "endpoint": audit.url},
            "scanner": {"delay": "0"}}).encode())
        cold = os.path.join(work, "cold")
        root.request("PUT", "/minio/admin/v3/tier", json.dumps(
            {"kind": "fs", "name": "COLD", "dir": cold}).encode())
        for b in ("bgsynth", "bgmix", "bgtier", "bgdeep"):
            root.request("PUT", f"/{b}")
        root.request("PUT", "/bgsynth", NOTIFY_ILM, query={"notification": ""})
        t0 = time.perf_counter()
        make_synthetic_bucket(es.drives, "bgsynth", synth)
        build_s = time.perf_counter() - t0
        sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10), mix)).astype(np.int64)
        mixed = {f"w/{i:03d}": rng.bytes(int(n)) for i, n in enumerate(sizes)}
        pool = _Pool(srv.url, 16)

        def put_mix(c, kv):
            r, _body = c.request("PUT", f"/bgmix/{kv[0]}", kv[1])
            rids.append(r.getheader("x-amz-request-id"))

        pool.run(put_mix, mixed.items())
        print(f"  {synth} synthetic keys in {build_s:.3f} s, {mix} warp-mix objects "
              f"({int(sizes.sum())} B) by 16 clients; drives on {shm or 'the tmp dir'}")

        # (a) one cycle over everything: usage equal to what was written.
        # The synthetic keys were written beside the server: the tracker is
        # told, as a write through it would have marked the bucket.
        srv.update_tracker.mark("bgsynth")
        kernels.reset_launches()
        st.mark("start")
        usage = sc.scan_once()
        st.mark("cycle")
        sec, d = st.delta("cycle")
        n_obj = synth + mix
        lines.append(f"cycle 1 (usage) {sec:.6f} s ({n_obj / sec:.3f} objects scanned/s; "
                     f"K1/K2 {d['gf2_matmul']}/{d['mxsum_digest']})")
        _r, doc = root.request("GET", "/minio/admin/v3/datausageinfo")
        info = json.loads(doc)
        want = {"bgsynth": (synth, synth), "bgmix": (mix, int(sizes.sum()))}
        for b, (count, size) in want.items():
            got = info["bucketsUsage"].get(b, {})
            if (got.get("objectsCount"), got.get("objectsTotalSize")) != (count, size):
                raise AssertionError(f"datausageinfo {b}: {got}, want {count} objects "
                                     f"of {size} B")
        if info["objectsCount"] != n_obj or usage.cycles != 1:
            raise AssertionError(f"datausageinfo counts {info['objectsCount']} objects "
                                 f"(want {n_obj}), cycle {usage.cycles}")

        # (b) an Expiration rule on one prefix: the next cycle expires
        # exactly its 1,000 keys, each an ILM event at the webhook.
        root.request("PUT", "/bgsynth", BG_EXPIRE_RULE, query={"lifecycle": ""})
        due = [synthetic_key(i) for i in range(synth) if synthetic_key(i).startswith(
            BG_EXPIRE_PREFIX)]
        st.mark("rule")
        sc.scan_once()
        st.mark("expiry")
        sec, d = st.delta("expiry")
        lines.append(f"cycle 2 (expiry of {len(due)} keys) {sec:.6f} s "
                     f"({len(due) / sec:.3f} expired keys/s; K1/K2 "
                     f"{d['gf2_matmul']}/{d['mxsum_digest']})")
        # The rule's prefix lies in one 1,000-key directory: every key of
        # that directory outside the prefix stays.
        home = BG_EXPIRE_PREFIX.split("/")[0] + "/"
        _r, doc = root.request("GET", "/bgsynth", query={
            "list-type": "2", "prefix": home, "max-keys": "1000"})
        left = [k for k, _e, _s in _list_page(doc)[0]]
        want_left = [synthetic_key(i) for i in range(synth) if synthetic_key(i).startswith(
            home) and not synthetic_key(i).startswith(BG_EXPIRE_PREFIX)]
        if left != want_left:
            raise AssertionError(f"{home} holds {len(left)} keys after expiry, want "
                                 f"{len(want_left)}: the rule's {len(due)} gone")

        def ilm(docs):
            return [x for x in docs if x["Records"][0]["userIdentity"]["principalId"]
                    == "minio_tpu:ilm"]

        t0 = time.perf_counter()
        if not events.wait(lambda docs: len(ilm(docs)) >= len(due), 120):
            raise AssertionError(f"the webhook holds {len(ilm(events.docs))} ILM events, "
                                 f"want {len(due)}")
        got = ilm(events.docs)
        if (sorted(x["Key"] for x in got) != sorted(f"bgsynth/{k}" for k in due)
                or {x["EventName"] for x in got} != {"s3:ObjectRemoved:Delete"}):
            raise AssertionError("the ILM events are not one s3:ObjectRemoved:Delete "
                                 "per expired key")
        lines.append(f"{len(got)} ILM events delivered, the last "
                     f"{time.perf_counter() - t0:.3f} s after the cycle")
        root.request("DELETE", "/bgsynth", query={"lifecycle": ""})

        # (c) two objects under a Transition rule, the cycle at now + 2
        # days: their data moves to the FS tier (a GET's K2, no K1).
        big = {f"t{i}": rng.bytes(tier_size) for i in range(BG_TIER)}
        st.mark("tier put start")
        for k, v in big.items():
            root.request("PUT", f"/bgtier/{k}", v)
        st.mark("tier put")
        _s, put_d = st.delta("tier put")
        for k in big:
            root.request("GET", f"/bgtier/{k}")
        st.mark("tier get")
        _s, get_d = st.delta("tier get")
        root.request("PUT", "/bgtier", BG_TIER_RULE, query={"lifecycle": ""})
        st.mark("rule 2")
        sc.scan_once(now=time.time() + 2 * 86400)
        st.mark("transition")
        sec, d = st.delta("transition")
        nbytes = tier_size * len(big)
        lines.append(f"transition of {len(big)} x {tier_size} B {sec:.6f} s "
                     f"({nbytes / (1 << 30) / sec:.6f} GiB/s; K1/K2 "
                     f"{d['gf2_matmul']}/{d['mxsum_digest']}; a GET of them "
                     f"{get_d['gf2_matmul']}/{get_d['mxsum_digest']})")
        if d["gf2_matmul"] or d["mxsum_digest"] != get_d["mxsum_digest"] \
                or not d["mxsum_digest"]:
            raise AssertionError(f"the transition launched {d}, want K2 as a GET of "
                                 f"the objects ({get_d}) and no K1")
        for k, v in big.items():
            info = es.latest_fileinfo("bgtier", k)
            if info.metadata.get(tiermod.TRANSITION_TIER) != "COLD" or info.data_dir:
                raise AssertionError(f"bgtier/{k} was not transitioned")
            if any(glob.glob(os.path.join(p, "bgtier", k, "*", "part.*")) for p in paths):
                raise AssertionError(f"bgtier/{k}: shard files left on the drives")
        st.mark("read start")
        first = next(iter(big))
        _r, got_b = root.request("GET", f"/bgtier/{first}")
        _r2, part = root.request("GET", f"/bgtier/{first}",
                                 headers={"Range": "bytes=1000000-2999999"})
        st.mark("read-through")
        sec, d = st.delta("read-through")
        if got_b != big[first] or part != big[first][1000000:3000000]:
            raise AssertionError("the read-through is not byte-equal")
        if d["gf2_matmul"] or d["mxsum_digest"]:
            raise AssertionError(f"the read-through launched {d}")
        lines.append(f"read-through GET of {tier_size} B + a 2 MB Range {sec:.6f} s "
                     f"({(tier_size + 2000000) / (1 << 30) / sec:.6f} GiB/s; no kernel)")
        st.mark("restore start")
        r, body = root.request("POST", f"/bgtier/{first}", b"", query={"restore": ""})
        st.mark("restore")
        sec, d = st.delta("restore")
        if r.status != 202:
            raise AssertionError(f"POST ?restore answered {r.status} {body[:200]!r}")
        lines.append(f"restore of {tier_size} B {sec:.6f} s "
                     f"({tier_size / (1 << 30) / sec:.6f} GiB/s; K1/K2 "
                     f"{d['gf2_matmul']}/{d['mxsum_digest']}; a PUT of the same size "
                     f"{put_d['gf2_matmul'] // len(big)}/{put_d['mxsum_digest'] // len(big)})")
        if (d["gf2_matmul"], d["mxsum_digest"]) != (put_d["gf2_matmul"] // len(big),
                                                    put_d["mxsum_digest"] // len(big)):
            raise AssertionError(f"the restore launched {d}, want a PUT's")
        if root.request("GET", f"/bgtier/{first}")[1] != big[first]:
            raise AssertionError("the restored object does not read back byte-equal")
        if os.path.exists(os.path.join(cold, "bgtier", first, "null")):
            raise AssertionError("the restore left the tier copy")
        _settle(es.drives)
        _check_sampled_digests(paths, es, "bgtier", first, device)

        # (d) heal bitrotscan=on: a byte flipped in a shard of a 64 MiB
        # object; the synthetic bucket is dropped first (its 19,000 inline
        # keys hold no shard to verify), then a deep cycle.
        root.request("PUT", "/minio/admin/v3/config-kv",
                     json.dumps({"heal": {"bitrotscan": "on"}}).encode())
        deep = rng.bytes(deep_size)
        root.request("PUT", "/bgdeep/obj", deep)
        _settle(es.drives)
        for p in paths:
            shutil.rmtree(os.path.join(p, "bgsynth"), ignore_errors=True)
        files = _shard_files(paths, "bgdeep", "obj")
        victim = sorted(files)[5]
        good = open(files[victim], "rb").read()
        flipped = bytearray(good)
        flipped[len(flipped) // 3] ^= 0x01
        with open(files[victim], "wb") as f:
            f.write(flipped)
        # The tracker walks the buckets written since its last cycle: every
        # real bucket, as a write to each would mark it.
        for b in ("bgmix", "bgtier", "bgdeep"):
            srv.update_tracker.mark(b)
        expect_rows = 0
        for b, keys in (("bgmix", mixed), ("bgtier", big), ("bgdeep", {"obj": deep})):
            for k in keys:
                fi = es.latest_fileinfo(b, k)
                if fi.data_dir:
                    expect_rows += es.n * -(-fi.size // es.block_size)
        rows = [0, 0]

        def counting(chunks, lens):
            rows[0] += int(chunks.shape[0])
            rows[1] += int(lens.sum())
            return real_digest(chunks, lens)

        mxsum.digest = counting
        # The deep cycle comes every HEAL_EVERY_N_CYCLES-th cycle, counted
        # from the persisted usage document: persist a count one short of
        # it and reload, as a restarted server would.
        persisted = DataUsageCache.load(srv.obj)
        persisted.cycles = scanmod.HEAL_EVERY_N_CYCLES * 2 - 1
        persisted.save(srv.obj)
        sc.usage = DataUsageCache.load(srv.obj)
        st.mark("deep start")
        usage = sc.scan_once()
        st.mark("deep")
        mxsum.digest = real_digest
        sec, d = st.delta("deep")
        lines.append(f"deep cycle {usage.cycles} {sec:.6f} s ({rows[1] / (1 << 30) / sec:.6f} "
                     f"GiB/s verified, {rows[0]} chunks; K1/K2 {d['gf2_matmul']}/"
                     f"{d['mxsum_digest']})")
        if usage.cycles % scanmod.HEAL_EVERY_N_CYCLES:
            raise AssertionError(f"cycle {usage.cycles} is not a deep one")
        _settle(es.drives)
        if open(files[victim], "rb").read() != good:
            raise AssertionError("the deep cycle did not rebuild the flipped shard")
        if rows[0] < expect_rows:
            raise AssertionError(f"K2 digested {rows[0]} chunks, want every block of "
                                 f"every real object: {expect_rows}")
        if not d["gf2_matmul"]:
            raise AssertionError("the deep cycle's heal launched no K1")
        if root.request("GET", "/bgdeep/obj")[1] != deep:
            raise AssertionError("the healed object does not read back byte-equal")

        # (e) every request's audit entry, under its answer's request id.
        want_ids = set(filter(None, rids))
        if not audit.wait(lambda docs: want_ids <= {x.get("requestID") for x in docs}, 60):
            have = {x.get("requestID") for x in audit.docs}
            raise AssertionError(f"{len(want_ids - have)} of {len(want_ids)} requests "
                                 "have no audit entry")
        lines.append(f"{len(want_ids)} requests, each with its audit entry "
                     f"({len(audit.docs)} entries)")
        for line in lines:
            print(f"  {line} on {card}")
    finally:
        mxsum.digest = real_digest
        if pool is not None:
            pool.close()
        if srv is not None:
            _close_server(srv)
        events.close()
        audit.close()
        if prev_qdir is None:
            os.environ.pop("MTPU_EVENT_QUEUE_DIR", None)
        else:
            os.environ["MTPU_EVENT_QUEUE_DIR"] = prev_qdir
        shutil.rmtree(work, ignore_errors=True)


CH_STORM_S = 30.0               # phase 18: seconds of the mixed workload under the storm,
CH_CLIENTS = 16                 # ... its client threads (warp mix of 1-512 KiB),
CH_BIG = 4                      # ... and the objects whose GETs go degraded,
CH_BIG_SIZE = 64 << 20          # ... each of 64 MiB
CH_P99_S, CH_ERR = 12.0, 0.5    # ... the storm window's SLO bounds (the JAX soak's)


def chaos_phase(seed: int, card: str, device: str = "cuda", storm_s: float = CH_STORM_S,
                clients: int = CH_CLIENTS, n_big: int = CH_BIG,
                big_size: int = CH_BIG_SIZE) -> dict:
    """Phase 18 (see the module's docstring): the SLO plane and the
    composed chaos plane on config 1 behind the server's CLI; -> the
    numbers it printed."""
    import random
    import threading

    import numpy as np

    from minio_tpu_torch import chaos
    from minio_tpu_torch.chaos import invariants, schedule
    from minio_tpu_torch.chaos.ledger import WriteLedger, digest
    from minio_tpu_torch.chaos.workload import MixedWorkload, S3Client
    from minio_tpu_torch.erasure.metadata import hash_order
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server

    backend = "gpu" if device == "cuda" else "cpu"
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-chaos-", dir=shm)
    paths = [os.path.join(work, f"d{i:02d}") for i in range(12)]
    bucket = "chaos"
    out: dict = {}
    t_phase = time.perf_counter()
    node = _Node(paths, _free_port(), device, _child_env({
        "MTPU_CHAOS_DRIVE_WRAP": "1", "MTPU_FAULT_INJECTION": "1",
        "MTPU_CHAOS_SEED": str(seed), "MTPU_SLO_SAMPLE_S": "1"}))
    try:
        node.wait_serving(time.monotonic() + 120)
        boot_s = time.perf_counter() - t_phase
        cl = S3Client(node.url, ACCESS, SECRET, timeout=120)
        if cl.put(f"/{bucket}").status_code != 200:
            raise AssertionError("chaos: bucket not made")

        # The big objects, acknowledged before the storm.
        lgr = WriteLedger(path=os.path.join(work, "ledger.jsonl"))
        rng = np.random.default_rng(seed + 18)
        bigs = {f"big{i}": rng.bytes(big_size) for i in range(n_big)}
        for key, body in bigs.items():
            e = lgr.intent("put", key, digest(body), len(body))
            r = cl.put(f"/{bucket}/{key}", data=body)
            if r.status_code != 200:
                raise AssertionError(f"chaos: PUT {key}: {r.status_code} {r.content[:300]!r}")
            lgr.ack(e, r.headers.get("ETag", ""))

        # The storm, from the seed: a hang on the shard reads of the drive
        # holding a data shard of the most big objects, create_file errors
        # on two others, a trickling read stream on a fourth; each cleared
        # before the storm ends.
        srng = random.Random(chaos.subseed(seed, "drive-schedule"))
        held = [sum(hash_order(f"{bucket}/{k}", 12)[i] <= 8 for k in bigs)
                for i in range(12)]
        hang = srng.choice([i for i in range(12) if held[i] == max(held)])
        rest = [i for i in range(12) if i != hang]
        srng.shuffle(rest)
        err1, err2, slow = rest[:3]
        prog = schedule.ChaosProgram(seed)
        prog.add(2.0, schedule.DRIVE_HANG, paths[hang], method="read_file_stream")
        prog.add(3.0, schedule.DRIVE_DELAY, paths[err1], method="create_file", error="faulty")
        prog.add(3.0, schedule.DRIVE_DELAY, paths[err2], method="create_file", error="faulty")
        prog.add(4.0, schedule.DRIVE_SLOW, paths[slow], chunkDelay=0.02)
        prog.add(storm_s * 0.6, schedule.DRIVE_CLEAR, paths[hang])
        prog.add(storm_s * 0.7, schedule.DRIVE_CLEAR, paths[err1])
        prog.add(storm_s * 0.7, schedule.DRIVE_CLEAR, paths[err2])
        prog.add(storm_s * 0.8, schedule.DRIVE_CLEAR, paths[slow])
        admin = S3Client(node.url, ACCESS, SECRET, timeout=30)

        def fault(doc):
            r = admin.post("/minio/admin/v3/faults", data=json.dumps(doc).encode())
            if r.status_code != 200:
                raise AssertionError(f"chaos: fault {doc}: {r.status_code} {r.content[:300]!r}")

        def drive_fault(ev):
            doc = {"op": "drive", "endpoint": ev.target, "method": ev.params["method"]}
            if "error" in ev.params:
                doc["error"] = ev.params["error"]
            else:
                doc["delay"] = "hang"
            fault(doc)

        sched = schedule.ChaosScheduler(prog, {
            schedule.DRIVE_HANG: drive_fault, schedule.DRIVE_DELAY: drive_fault,
            schedule.DRIVE_SLOW: lambda ev: fault({
                "op": "drive_slow", "endpoint": ev.target,
                "chunkDelay": ev.params["chunkDelay"]}),
            schedule.DRIVE_CLEAR: lambda ev: fault({"op": "drive_clear",
                                                   "endpoint": ev.target})})
        print(f"  program (seed {seed}): hang read_file_stream on d{hang:02d} (a data "
              f"shard of {held[hang]} of the {n_big} big objects), create_file errors on "
              f"d{err1:02d} and d{err2:02d}, a 20 ms trickle on d{slow:02d}; "
              f"{len(prog.schedule())} events over {prog.duration():.1f} s")

        # The degraded GETs: the big objects read while the hang holds.
        big_gets: list[tuple[str, int, float, bool]] = []

        def read_bigs():
            time.sleep(2.5)
            gcl = S3Client(node.url, ACCESS, SECRET, timeout=120)
            while time.perf_counter() - t_storm < storm_s * 0.55:
                for key, body in bigs.items():
                    t0 = time.perf_counter()
                    r = gcl.get(f"/{bucket}/{key}")
                    big_gets.append((key, r.status_code, time.perf_counter() - t0,
                                     r.status_code == 200 and r.content == body))
            gcl.close()

        sizes = tuple(int(s) for s in np.unique(np.geomspace(1 << 10, 512 << 10, 40)
                                               .astype(np.int64)))
        fleet = MixedWorkload(lambda: S3Client(node.url, ACCESS, SECRET, timeout=60),
                              lgr, bucket, seed=seed, workers=clients, sizes=sizes,
                              mp_size=5 << 20, op_timeout=60.0)
        reader = threading.Thread(target=read_bigs, name="smoke-chaos-bigs")
        t_storm = time.perf_counter()
        sched.start()
        reader.start()
        try:
            fleet.run_for(storm_s)
        finally:
            sched.stop()
            sched.join(60.0)
            reader.join(300)
        storm_wall = time.perf_counter() - t_storm
        ops = fleet.stats.total_ops()
        out["storm"] = {"s": storm_wall, "ops": ops, "ops_s": ops / storm_wall,
                        "acked": lgr.acked_count(), "codes": fleet.stats.codes}
        print(f"  storm on {card}: {storm_wall:.3f} s, {clients} clients, {ops} ops "
              f"({ops / storm_wall:.3f} ops/s; {dict(sorted(fleet.stats.ops.items()))}), "
              f"errors {dict(sorted(fleet.stats.errors.items()))}, statuses "
              f"{dict(sorted(fleet.stats.codes.items()))}; ledger {lgr.describe()}; "
              f"p99 {fleet.stats.p99():.3f} s")
        bad_big = [g for g in big_gets if not g[3]]
        print(f"  degraded GETs of the big objects under the hang: {len(big_gets)}, "
              f"{sum(g[2] for g in big_gets) / max(1, len(big_gets)):.3f} s each on "
              f"average, {sum(g[1] == 200 for g in big_gets)} answered 200, "
              f"{len(bad_big)} not byte-equal")
        if sched.errors() or sched.applied() != prog.schedule():
            raise AssertionError(f"chaos: the program was not applied as previewed: "
                                 f"{sched.errors()}")
        if not big_gets or bad_big:
            raise AssertionError(f"chaos: the big objects' GETs under the hang {big_gets}")
        if fleet.stats.violations:
            raise AssertionError(f"chaos: in-storm read violations "
                                 f"{fleet.stats.violations[:5]} (seed {seed})")
        if lgr.acked_count() < 50 + n_big:
            raise AssertionError(f"chaos: the storm acknowledged too little {lgr.describe()}")

        # Converge: faults cleared, every drive back, then the invariants.
        t0 = time.perf_counter()
        r = admin.post("/minio/admin/v3/faults", data=b'{"op": "clear_all"}')
        if r.status_code != 200:
            raise AssertionError(f"chaos: clear_all {r.status_code}")

        def info():
            r = admin.get("/minio/admin/v3/info")
            return json.loads(r.content) if r.status_code == 200 else {}

        heal_s = []

        def deep_heal():
            t1 = time.perf_counter()
            r = S3Client(node.url, ACCESS, SECRET, timeout=600).post(
                f"/minio/admin/v3/heal/{bucket}",
                data=json.dumps({"scanMode": "deep"}).encode())
            heal_s.append(time.perf_counter() - t1)
            if r.status_code != 200:
                raise AssertionError(f"chaos: deep heal {r.status_code} {r.content[:300]!r}")
            return [i for i in json.loads(r.content)["items"] if i.get("object")]

        def get_via(c):
            def get_fn(key):
                r = c.get(f"/{bucket}/{key}")
                return r.status_code, (r.content if r.status_code == 200 else b"")
            return get_fn

        healed = invariants.check_heal_convergence(info, deep_heal, want_drives=12,
                                                   seed=seed, timeout=120)
        converge_s = time.perf_counter() - t0
        acked_rep = invariants.check_acknowledged_writes(get_via(cl), lgr, seed=seed)
        lost = sum("lost" in f or "HTTP" in f for f in acked_rep.failures)
        torn = len(acked_rep.failures) - lost
        agree = invariants.check_cross_node_agreement(
            [get_via(cl), get_via(S3Client(node.url, ACCESS, SECRET, timeout=120))],
            lgr, seed=seed)
        window_s = time.perf_counter() - t_storm
        r = cl.get("/minio/admin/v3/slo/history", query={"seconds": str(window_s + 5)})
        if r.status_code != 200:
            raise AssertionError(f"chaos: slo/history {r.status_code} {r.content[:300]!r}")
        window = invariants.window_from_history(json.loads(r.content)["history"], window_s)
        slo_rep = invariants.check_slos(window, seed=seed, p99_bound=CH_P99_S,
                                        error_rate_bound=CH_ERR)
        fam = "minio_tpu_s3_requests_latency_seconds"
        p99 = {api: invariants.histogram_quantile(window, fam, 0.99, {"api": api})
               for api in ("PutObject", "GetObject")}
        total = invariants.counter_sum(window, "minio_tpu_s3_requests_total")
        errs = invariants.counter_sum(window, "minio_tpu_s3_requests_5xx_errors_total")
        r = cl.get("/minio/admin/v3/slo")
        doc = json.loads(r.content) if r.status_code == 200 else {}
        (state,) = (doc.get("nodes") or {"": {}}).values()
        burns = {name: (s["windows"]["fast"]["burn"], s["windows"]["slow"]["burn"],
                        s["breach"]) for name, s in (state.get("slos") or {}).items()}
        out.update({"lost": lost, "torn": torn, "heal_s": heal_s[0] if heal_s else None,
                    "converge_s": converge_s, "burns": burns, "p99": p99,
                    "err_rate": errs / max(1.0, total)})
        print(f"  converged in {converge_s:.3f} s (deep heal {heal_s[0] if heal_s else 0:.3f} s"
              f" over {healed.checked - 1} objects); {healed.summary()}")
        print(f"  acknowledged writes: {lgr.acked_count()} acked, {lost} lost, {torn} torn; "
              f"{acked_rep.summary()}; {agree.summary()}")
        print(f"  SLO window of the server's ring ({window_s:.1f} s): {total:.0f} requests, "
              f"5xx {errs:.0f} ({errs / max(1.0, total):.4f}), p99 PUT "
              f"{p99['PutObject']:.3f} s, GET {p99['GetObject']:.3f} s; "
              f"{slo_rep.summary()}")
        print(f"  GET /minio/admin/v3/slo on {card}: burn (fast, slow, breach) "
              + "; ".join(f"{k} {v[0]}, {v[1]}, {v[2]}" for k, v in sorted(burns.items()))
              + f"; any breach: {any(v[2] for v in burns.values())}")
        for rep in (healed, acked_rep, agree, slo_rep):
            rep.assert_ok()
        if set(burns) != {"put_latency_p99", "get_latency_p99", "s3_error_ratio",
                          "tenant_latency_p99"} or doc.get("errors"):
            raise AssertionError(f"chaos: the slo answer {doc}")

        # The launches: labeled by the scrape, exact at the drain.
        labeled = node.scrape(backend)
        scrape = invariants.parse_exposition(cl.get("/minio/v2/metrics/node").content.decode())
        hedged = (invariants.counter_sum(scrape, "minio_tpu_hedged_reads_total"),
                  invariants.counter_sum(scrape, "minio_tpu_hedged_reads_won_total"))
        cl.close()
        admin.close()
        node.term()
        exact = node.drain()
        print(f"  launches of the server over the phase (fresh process; exact at drain): "
              f"K1 {exact['gf2_matmul']}, K2 {exact['mxsum_digest']}; labeled K1 "
              f"{labeled['k1']} (reconstructs {labeled['k1_rec']}), K2 {labeled['k2']}; "
              f"unlabeled K1 (degraded GET decodes) {exact['gf2_matmul'] - labeled['k1']}; "
              f"hedged reads {hedged[0]:.0f}, won {hedged[1]:.0f}")
        out["launches"] = {"k1": exact["gf2_matmul"], "k2": exact["mxsum_digest"],
                           "k1_degraded": exact["gf2_matmul"] - labeled["k1"]}
        if device == "cuda" and (exact["gf2_matmul"] <= 0 or exact["mxsum_digest"] <= 0
                                 or exact["gf2_matmul"] <= labeled["k1"]):
            raise AssertionError(f"chaos: K1/K2 launches {exact}, labeled {labeled}: the "
                                 "storm's PUTs, verify and degraded GETs must launch them")

        # Sampled shard digests and parity against the plain versions.
        kernels.reset_launches()
        srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
        try:
            es = srv.obj.pools[0].sets[0]
            for key in bigs:
                _check_sampled_digests(paths, es, bucket, key, device)
            # Warp-mix keys written once (one data directory), past the
            # inline size.
            once = {}
            for e in lgr.entries():
                once[e.key] = once.get(e.key, 0) + 1
            small = [k for k, st in sorted(lgr.expected().items())
                     if k not in bigs and once[k] == 1 and st.must_exist
                     and st.settled.op == "put" and st.settled.size > 256 << 10][:2]
            for key in small:
                _check_sampled_digests(paths, es, bucket, key, device)
        finally:
            _close_server(srv)
        counts = kernels.launches()
        out["s"] = time.perf_counter() - t_phase
        print(f"  sampled shard digests and parity of {n_big} big and {len(small)} small "
              f"objects equal the plain versions (K1 {counts['gf2_matmul']}, K2 "
              f"{counts['mxsum_digest']} in the check); boot {boot_s:.3f} s; phase "
              f"{out['s']:.1f} s on {card}")
        return out
    finally:
        if node.proc.poll() is None:
            node.kill()
        shutil.rmtree(work, ignore_errors=True)


def _fd_get(url: str, key: str) -> bytes | None:
    cl = _Client(url)
    try:
        r, data = cl.request("GET", key, check=False)
        return data if r.status == 200 else None
    finally:
        cl.close()


def _list_objects_for(free_bytes: int, elapsed_s: float) -> tuple[int, str]:
    """LIST_OBJECTS, halved (down to 1/32 of it) until its journals fit in
    `free_bytes` and the phase's estimated time fits what is left of
    SMOKE_BUDGET_S after `elapsed_s`, but for time not below
    LIST_MIN_OBJECTS unless the estimate passes SMOKE_LIMIT_S;
    -> (count, the reason for a cut)."""
    n, why = LIST_OBJECTS, ""
    while n > LIST_OBJECTS // 32:
        end_s = elapsed_s + LIST_FIXED_S + n * LIST_S_PER_OBJECT
        if n * LIST_BYTES_PER_OBJECT > free_bytes:
            why = f"{free_bytes} B free on the drives' filesystem"
        elif end_s > SMOKE_LIMIT_S or (end_s > SMOKE_BUDGET_S and n > LIST_MIN_OBJECTS):
            limit = SMOKE_BUDGET_S if n > LIST_MIN_OBJECTS else SMOKE_LIMIT_S
            why = (f"{elapsed_s:.0f} s spent, {LIST_S_PER_OBJECT * 1e3:.1f} ms per "
                   f"object, the script kept under {limit:.0f} s")
        else:
            break
        n //= 2
    return n, why


def _rss_bytes() -> int:
    """This process's resident set now (/proc/self/statm), in bytes."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _list_page(doc: bytes):
    """A ListObjects answer -> ([(key, etag, size)], [prefixes],
    truncated, next marker or continuation token)."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(doc)
    keys = [(c.find(S3_NS + "Key").text, c.find(S3_NS + "ETag").text.strip('"'),
             int(c.find(S3_NS + "Size").text)) for c in root.iter(S3_NS + "Contents")]
    prefixes = [c.find(S3_NS + "Prefix").text for c in root.iter(S3_NS + "CommonPrefixes")]
    nxt = root.find(S3_NS + "NextContinuationToken")
    if nxt is None:
        nxt = root.find(S3_NS + "NextMarker")
    return (keys, prefixes, root.find(S3_NS + "IsTruncated").text == "true",
            "" if nxt is None else nxt.text)


def _delete_doc(keys) -> bytes:
    return ("<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>" for k in keys)
            + "</Delete>").encode()


def listing_phase(seed: int, card: str, mp: _Kept | None, elapsed_s: float,
                  n_objects: int | None = None, device: str = "cuda",
                  clients: int = 64) -> None:
    """Listing and the bucket calls (phase 9) on config 1's deployment: one
    12-drive set at EC 8+4, 1 MiB blocks, mxsum256, behind the port's S3
    server over HTTP with SigV4, its drives on /dev/shm. A bucket of
    LIST_OBJECTS synthetic objects (the JAX package's listing-scale
    layout, 200 prefixes of 1000; halved by _list_objects_for to fit) and
    LIST_REAL real ones PUT through the server; the whole bucket walked
    with ListObjectsV2 pages of LIST_PAGE: every name once, in order, the
    real objects' ETag and Size as PUT; a delimiter listing in pages, a v1
    listing resumed from a marker in the middle, ListBuckets; every 50th
    real object read back; the real objects deleted in one DeleteObjects,
    their prefix then empty; DeleteBucket on the big bucket answers
    BucketNotEmpty; a small bucket emptied and deleted, then absent from
    ListBuckets; and on phase 6's pools (`mp`), one ListObjectsV2 naming
    the multipart object once across the 4 pools. The server runs with
    enable_mrf=False, as every phase's but the heal phase's does."""
    import numpy as np

    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3.server import build_server
    from minio_tpu_torch.utils.synthbucket import (make_synthetic_bucket,
                                                   synthetic_key)

    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    work = tempfile.mkdtemp(prefix="mtpu-torch-list-", dir=shm)
    free = shutil.disk_usage(work).free
    if n_objects is None:
        n_syn, why = _list_objects_for(free, elapsed_s)
    else:
        n_syn, why = n_objects, "asked for"
    print(f"  drives on {shm or tempfile.gettempdir()} ({free} B free); {n_syn} "
          f"synthetic objects + {LIST_REAL} real" +
          (f" (cut from {LIST_OBJECTS}: {why})" if n_syn != LIST_OBJECTS else ""))
    paths = [os.path.join(work, f"d{i}") for i in range(12)]
    srv = build_server(paths, ACCESS, SECRET, device=device, enable_mrf=False).start()
    layer = srv.obj
    pool = _Pool(srv.url, clients)
    cl = _Client(srv.url)
    rng = np.random.default_rng(seed + 7)
    sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(512 << 10),
                               LIST_REAL)).astype(np.int64)
    real = {f"real/{i:04d}": rng.bytes(int(n)) for i, n in enumerate(sizes)}
    stats = {}
    try:
        es = layer.pools[0].sets[0]
        print(f"  server {srv.url}: EC {es.n - es.parity}+{es.parity}, block "
              f"{es.block_size} B, bitrot {es.bitrot_algorithm}")
        kernels.reset_launches()
        cl.request("PUT", "/big")
        t0 = time.perf_counter()
        make_synthetic_bucket(es.drives, "big", n_syn)
        stats["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool.run(lambda c, kv: c.request("PUT", f"/big/{kv[0]}", kv[1]), real.items())
        stats["put_s"] = time.perf_counter() - t0
        after_put = kernels.launches()

        # The whole bucket through ListObjectsV2, checked page by page
        # against the expected names (the client holds one page).
        expected = iter([synthetic_key(i) for i in range(n_syn)] + sorted(real))
        mc = layer.metacache
        hits0, misses0 = mc.hits, mc.misses
        rss0 = rss_peak = _rss_bytes()
        page_ms, token, listed, seen_real = [], "", 0, {}
        t_walk = time.perf_counter()
        while True:
            q = {"list-type": "2", "max-keys": str(LIST_PAGE)}
            if token:
                q["continuation-token"] = token
            t0 = time.perf_counter()
            _r, doc = cl.request("GET", "/big", query=q)
            page_ms.append((time.perf_counter() - t0) * 1e3)
            rss_peak = max(rss_peak, _rss_bytes())
            keys, _p, truncated, token = _list_page(doc)
            for key, etag, size in keys:
                want = next(expected, None)
                if key != want:
                    raise AssertionError(f"listing: {key!r} where {want!r} belongs")
                if key in real:
                    seen_real[key] = (etag, size)
            listed += len(keys)
            if not truncated:
                break
            if len(keys) != LIST_PAGE:
                raise AssertionError(f"a truncated page of {len(keys)} keys")
        stats["walk_s"] = time.perf_counter() - t_walk
        stats["rss_mb"] = (rss_peak - rss0) / (1 << 20)
        stats["hits"], stats["misses"] = mc.hits - hits0, mc.misses - misses0
        if next(expected, None) is not None or listed != n_syn + LIST_REAL:
            raise AssertionError(f"listing: {listed} names, {n_syn + LIST_REAL} expected")
        bad = [k for k, v in real.items()
               if seen_real[k] != (hashlib.md5(v).hexdigest(), len(v))]
        if bad:
            raise AssertionError(f"listing: ETag or Size of {bad[:3]} differ from the PUT")
        print(f"  ListObjectsV2: {listed} names in {len(page_ms)} pages, once each, "
              "in order; the real objects' ETag and Size as PUT")

        # CommonPrefixes in pages of 50, then v1 from a marker mid-bucket.
        prefixes, marker = [], ""
        while True:
            q = {"list-type": "2", "delimiter": "/", "max-keys": "50"}
            if marker:
                q["continuation-token"] = marker
            keys, pfx, truncated, marker = _list_page(cl.request("GET", "/big", query=q)[1])
            if keys:
                raise AssertionError(f"delimiter listing: keys {keys[:3]} at the top level")
            prefixes += pfx
            if not truncated:
                break
        want = [f"p{p:03d}/" for p in range(-(-n_syn // 1000))] + ["real/"]
        if prefixes != want:
            raise AssertionError(f"delimiter listing: {len(prefixes)} prefixes, "
                                 f"{len(want)} expected")
        mid = n_syn // 2
        keys, _p, truncated, nxt = _list_page(cl.request(
            "GET", "/big", query={"marker": synthetic_key(mid), "max-keys": "1000"})[1])
        want = [synthetic_key(i) for i in range(mid + 1, mid + 1001)]
        if [k for k, _e, _s in keys] != want or not truncated or nxt != want[-1]:
            raise AssertionError("v1 listing from a marker")
        doc = cl.request("GET", "/")[1]
        if b"<Name>big</Name>" not in doc:
            raise AssertionError("ListBuckets: big missing")
        print(f"  delimiter listing: {len(prefixes)} CommonPrefixes in pages of 50; "
              f"v1 from marker {synthetic_key(mid)}: the next 1000; ListBuckets: ok")

        # Read back every 50th real object named in the listing.
        def get_ok(c, key):
            r, data = c.request("GET", f"/big/{key}")
            if data != real[key] or r.getheader("ETag") != _md5_etag(data):
                raise AssertionError(f"GET {key}: bytes or ETag differ")

        before_get = kernels.launches()
        pool.run(get_ok, sorted(seen_real)[::50])
        after_get = kernels.launches()

        # The real objects in one DeleteObjects (S3's 1000-key cap).
        t0 = time.perf_counter()
        doc = cl.request("POST", "/big", _delete_doc(sorted(real)),
                         query={"delete": ""})[1]
        stats["delete_s"] = time.perf_counter() - t0
        if doc.count(b"<Deleted>") != LIST_REAL or b"<Error>" in doc:
            raise AssertionError(f"DeleteObjects: {doc[:300]!r}")
        keys, pfx, truncated, _n = _list_page(cl.request(
            "GET", "/big", query={"list-type": "2", "prefix": "real/"})[1])
        if keys or pfx or truncated:
            raise AssertionError(f"real/ not empty after DeleteObjects: {keys[:3]}")
        r, doc = cl.request("DELETE", "/big", check=False)
        if r.status != 409 or b"<Code>BucketNotEmpty</Code>" not in doc:
            raise AssertionError(f"DeleteBucket on a full bucket: {r.status} {doc[:200]!r}")
        cl.request("PUT", "/small")
        for i in range(3):
            cl.request("PUT", f"/small/k{i}", real[f"real/{i:04d}"])
        cl.request("POST", "/small", _delete_doc([f"k{i}" for i in range(3)]),
                   query={"delete": ""})
        r, _doc = cl.request("DELETE", "/small")
        doc = cl.request("GET", "/")[1]
        if r.status != 204 or b"<Name>small</Name>" in doc or b"<Name>big</Name>" not in doc:
            raise AssertionError("the emptied bucket is not deleted, or ListBuckets lists it")
        print(f"  DeleteObjects of {LIST_REAL} keys in one POST; real/ then empty; "
              "DeleteBucket: BucketNotEmpty on big, 204 on the emptied one, which "
              "ListBuckets then omits")
        end = kernels.launches()
    finally:
        pool.close()
        cl.close()
        _close_server(srv)
        t0 = time.perf_counter()
        rms = [subprocess.Popen(["rm", "-rf", p]) for p in paths]
        for p in rms:
            p.wait()
        shutil.rmtree(work, ignore_errors=True)
        stats["cleanup_s"] = time.perf_counter() - t0

    for stage, at in (("PUT", after_put), ("GET", after_get)):
        for name in MXSUM_KERNELS:
            if at[name] <= 0:
                raise AssertionError(f"{name} did not launch by the listing phase's {stage}s")
    if after_get["mxsum_digest"] <= before_get["mxsum_digest"]:
        raise AssertionError("K2 did not launch for the GETs' verify")

    if mp is not None:
        c = _Client(mp.url)
        try:
            keys, pfx, truncated, _n = _list_page(c.request(
                "GET", f"/{mp.bucket}", query={"list-type": "2"})[1])
        finally:
            c.close()
        if keys != [(mp.key, keys[0][1] if keys else "", mp.size)] or pfx or truncated:
            raise AssertionError(f"4-pool listing: {keys}")
        print(f"  4 pools x 16 drives: ListObjectsV2 names {mp.key} once "
              f"({mp.size} B, ETag {keys[0][1]})")

    cont = sorted(page_ms[1:]) or [0.0]
    p99 = cont[min(len(cont) - 1, int(round(0.99 * (len(cont) - 1))))]
    print(f"  launches listing phase: " + ", ".join(
        f"{n} {end[n]}" for n in kernels.KERNELS))
    print(f"  listing {n_syn} + {LIST_REAL} objects on {card}: build "
          f"{stats['build_s']:.6f} s, {LIST_REAL} PUTs {stats['put_s']:.6f} s; page 1 "
          f"(walk + synchronous render) {page_ms[0]:.3f} ms, continuation pages "
          f"median {statistics.median(cont):.3f} ms, p99 {p99:.3f} ms; "
          f"{listed / stats['walk_s']:.1f} objects/s listed over the full walk "
          f"({stats['walk_s']:.6f} s, {len(page_ms)} pages); metacache hits "
          f"{stats['hits']}, misses {stats['misses']}; RSS peak over the walk "
          f"+{stats['rss_mb']:.1f} MiB (sampled after each page); DeleteObjects {LIST_REAL / stats['delete_s']:.1f} keys/s "
          f"({stats['delete_s']:.6f} s); removal of the drives {stats['cleanup_s']:.3f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from minio_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: minio_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build+load: {time.perf_counter() - t0:.3f} s")
    kernel = ""
    for line in kernels.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {kernel}: {line.strip()}")
    print("obs phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; the admin plane "
          "and the scrapes):")
    obs_phase(args.seed, card)
    print(f"kernel phase (EC 8+4, 1 MiB blocks; begun at "
          f"{time.perf_counter() - t_start:.1f} s):")
    records = kernel_phase(args.seed)
    print("S3 phase:")
    s3_phase(args.seed, card, records)
    print(f"plane phase (EC 8+4, 1 MiB blocks; the plane on, then off; begun at "
          f"{time.perf_counter() - t_start:.1f} s):")
    rates = {True: [], False: []}
    for i, on in enumerate(PLANE_RUNS):
        rates[on].append(plane_phase(args.seed, card, records if i == 0 else None,
                                     PLANE_OBJECTS, plane_on=on))
    for stage in ("put", "get", "degraded_get"):
        on, off = ([r[stage] for r in rates[v]] for v in (True, False))
        print(f"  {stage} objects/s on {card}: plane on "
              f"{', '.join(f'{x:.3f}' for x in on)}; plane off "
              f"{', '.join(f'{x:.3f}' for x in off)}; on/off "
              f"{sum(on) / sum(off):.3f}")
    print("hot-tier phase (MTPU_HOTTIER=1):")
    hot_tier_phase(args.seed, card, records, HOT_WORKING_SET)
    print(f"multipart phase (4 pools x 16 drives, EC 12+4, 1 MiB blocks; begun at "
          f"{time.perf_counter() - t_start:.1f} s):")
    mp = multipart_phase(args.seed, card, records, keep=True)
    try:
        print("versioning phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; "
              "UploadPartCopy on the 4 pools, EC 12+4):")
        versioning_phase(args.seed, card, mp)
        print(f"heal phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; MRF and the "
              f"auto-healer on; begun at {time.perf_counter() - t_start:.1f} s):")
        heal_phase(args.seed, card, records)
        print(f"bitrot phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; every "
              f"algorithm of the JAX registry; begun at {time.perf_counter() - t_start:.1f} s):")
        bitrot_phase(args.seed, card, records)
        print(f"metadata plane and drive resilience phase (EC 8+4, 1 MiB blocks, "
              f"drives on /dev/shm; the metadata plane, MRF and the auto-healer on; "
              f"begun at {time.perf_counter() - t_start:.1f} s):")
        meta_phase(args.seed, card, records)
        print(f"data at rest phase (EC 8+4 and, by storageclass, 10+2, 1 MiB blocks, "
              f"drives on /dev/shm; sealed config, SSE-S3, SSE-C, SSE-KMS, S2; begun at "
              f"{time.perf_counter() - t_start:.1f} s):")
        atrest_phase(args.seed, card, records)
        print(f"identity and access phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; "
              f"an IAM user, aws-chunked, presigned, SigV2, STS, policies, object lock; "
              f"begun at {time.perf_counter() - t_start:.1f} s):")
        iam_phase(args.seed, card)
        print(f"late device profile (the admin route on an old process; begun at "
              f"{time.perf_counter() - t_start:.1f} s):")
        late_profile_check(args.seed, card)
        print(f"front door phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; a pool of "
              f"workers, shared lanes, the QoS plane; begun at "
              f"{time.perf_counter() - t_start:.1f} s):")
        frontdoor_phase(args.seed, card)
        print(f"cluster phase (4 node processes x 4 drives on /dev/shm, one 16-drive "
              f"set, EC 12+4, 1 MiB blocks; bootstrap, the storage, lock and peer "
              f"planes; begun at {time.perf_counter() - t_start:.1f} s):")
        cluster_phase(args.seed, card, records)
        print(f"background plane phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; the "
              f"scanner, ILM expiry and tiers, deep heal, events and audit; begun at "
              f"{time.perf_counter() - t_start:.1f} s):")
        background_phase(args.seed, card)
        print(f"SLO and chaos phase (EC 8+4, 1 MiB blocks, drives on /dev/shm; the "
              f"server's CLI with the drive wrap and fault injection, a seeded drive "
              f"storm under a mixed workload; begun at "
              f"{time.perf_counter() - t_start:.1f} s):")
        chaos_phase(args.seed, card)
        print(f"listing phase (EC 8+4, 1 MiB blocks; drives on /dev/shm; begun at "
              f"{time.perf_counter() - t_start:.1f} s):")
        listing_phase(args.seed, card, mp, time.perf_counter() - t_start)
    finally:
        mp.close()
    for r in records:
        del r["kernel"], r["path"]
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
