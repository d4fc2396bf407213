"""ILM lifecycle parity: minio_tpu_torch/scanner/lifecycle.py against the
JAX package's minio_tpu/scanner/lifecycle.py.

Seeded rule sets (prefix and tag filters, Expiration by days and date,
ExpiredObjectDeleteMarker, NoncurrentVersionExpiration,
AbortIncompleteMultipartUpload, Transition, disabled rules) are rendered
as XML, parsed by both packages and evaluated by both over seeded
versions, tags and times; the rules, every action, the transition tier
and the multipart expiry must be equal. The documents the JAX package
refuses must be refused by the port too. Tolerance: exact.
"""

import dataclasses
import datetime

import numpy as np
import pytest

from minio_tpu.scanner import lifecycle as jlc
from minio_tpu_torch.scanner import lifecycle as tlc

DAY = 86400.0
NOW = 1_760_000_000.0
PREFIXES = ["", "logs/", "logs/2023/", "tmp/", "a"]
TAGS = [{}, {"class": "cold"}, {"class": "hot"}, {"class": "cold", "team": "x"}]
KEYS = ["logs/2023/a.txt", "logs/b", "tmp/x", "a", "abc/def", "z"]


def _rule_xml(rng, i: int) -> str:
    parts = [f"<ID>r{i}</ID>",
             f"<Status>{'Disabled' if rng.random() < 0.15 else 'Enabled'}</Status>"]
    prefix = PREFIXES[rng.integers(len(PREFIXES))]
    tags = TAGS[rng.integers(len(TAGS))]
    shape = rng.integers(3)
    if shape == 0:
        parts.append(f"<Prefix>{prefix}</Prefix>")
    elif shape == 1 and not tags:
        parts.append(f"<Filter><Prefix>{prefix}</Prefix></Filter>")
    else:
        tag_xml = "".join(f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>"
                          for k, v in tags.items())
        parts.append(f"<Filter><And><Prefix>{prefix}</Prefix>{tag_xml}</And></Filter>")
    actions = []
    if rng.random() < 0.5:
        if rng.random() < 0.3:
            d = datetime.datetime.fromtimestamp(
                NOW + float(rng.integers(-5, 5)) * DAY, datetime.timezone.utc)
            actions.append(f"<Expiration><Date>{d.strftime('%Y-%m-%dT00:00:00Z')}"
                           "</Date></Expiration>")
        elif rng.random() < 0.3:
            actions.append("<Expiration><ExpiredObjectDeleteMarker>true"
                           "</ExpiredObjectDeleteMarker></Expiration>")
        else:
            actions.append(f"<Expiration><Days>{rng.integers(1, 30)}</Days></Expiration>")
    if rng.random() < 0.4:
        actions.append("<NoncurrentVersionExpiration><NoncurrentDays>"
                       f"{rng.integers(1, 30)}</NoncurrentDays></NoncurrentVersionExpiration>")
    if rng.random() < 0.3:
        actions.append("<AbortIncompleteMultipartUpload><DaysAfterInitiation>"
                       f"{rng.integers(1, 10)}</DaysAfterInitiation>"
                       "</AbortIncompleteMultipartUpload>")
    if rng.random() < 0.4:
        actions.append(f"<Transition><Days>{rng.integers(1, 30)}</Days>"
                       f"<StorageClass>{'COLD' if rng.random() < 0.5 else 'WARM'}"
                       "</StorageClass></Transition>")
    if not actions:
        actions.append("<Expiration><Days>7</Days></Expiration>")
    return "<Rule>" + "".join(parts + actions) + "</Rule>"


def _doc(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    ns = ' xmlns="http://s3.amazonaws.com/doc/2006-03-01/"' if seed % 2 else ""
    rules = "".join(_rule_xml(rng, i) for i in range(int(rng.integers(1, 6))))
    return f"<LifecycleConfiguration{ns}>{rules}</LifecycleConfiguration>".encode()


@pytest.mark.parametrize("seed", range(24))
def test_parse_and_eval_match_jax(seed):
    raw = _doc(seed)
    jl, tl = jlc.parse_lifecycle_xml(raw), tlc.parse_lifecycle_xml(raw)
    assert [dataclasses.asdict(r) for r in tl.rules] == \
        [dataclasses.asdict(r) for r in jl.rules]
    assert tl.has_active_rules == jl.has_active_rules
    rng = np.random.default_rng(1000 + seed)
    for _ in range(200):
        key = KEYS[rng.integers(len(KEYS))]
        mod_time = NOW - float(rng.integers(0, 40)) * DAY - float(rng.random()) * DAY
        kw = dict(is_latest=bool(rng.random() < 0.6),
                  delete_marker=bool(rng.random() < 0.2),
                  num_versions=int(rng.integers(1, 4)),
                  successor_mod_time=(mod_time + float(rng.integers(0, 20)) * DAY
                                      if rng.random() < 0.5 else 0.0),
                  tags=TAGS[rng.integers(len(TAGS))] or None,
                  transitioned=bool(rng.random() < 0.2),
                  now=NOW)
        assert tl.eval(key, mod_time, **kw) == jl.eval(key, mod_time, **kw), (key, kw)
        tags = kw["tags"]
        assert (tl.transition_tier(key, mod_time, tags, now=NOW)
                == jl.transition_tier(key, mod_time, tags, now=NOW))
        initiated = NOW - float(rng.integers(0, 12)) * DAY
        assert tl.mpu_expired(initiated, NOW) == jl.mpu_expired(initiated, NOW)


BAD_DOCS = [
    b"<LifecycleConfiguration><Rule>",                       # malformed
    b"<LifecycleConfiguration></LifecycleConfiguration>",    # no rules
    b"<LifecycleConfiguration><Rule><ID>x</ID><Status>Enabled</Status>"
    b"<Prefix>a</Prefix></Rule></LifecycleConfiguration>",   # no action
    b"<LifecycleConfiguration><Rule><Expiration><Days>x</Days></Expiration>"
    b"</Rule></LifecycleConfiguration>",                     # bad number
    b"<LifecycleConfiguration><Rule><Expiration><Date>not-a-date</Date>"
    b"</Expiration></Rule></LifecycleConfiguration>",        # bad date
    b"not xml at all",
]


@pytest.mark.parametrize("raw", BAD_DOCS, ids=range(len(BAD_DOCS)))
def test_bad_documents_refused_as_in_jax(raw):
    with pytest.raises(ValueError):
        jlc.parse_lifecycle_xml(raw)
    with pytest.raises(ValueError):
        tlc.parse_lifecycle_xml(raw)


def test_constants_match_jax():
    for name in ("NONE", "DELETE", "DELETE_VERSION", "DELETE_MARKER", "TRANSITION",
                 "ABORT_MPU"):
        assert getattr(tlc, name) == getattr(jlc, name)
