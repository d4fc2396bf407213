"""S3 XML documents (the subset of minio_tpu/s3/xmlutil.py the port sends:
the error document, the listing, version-listing and bucket documents,
the multipart, copy, tagging and versioning documents and the STS answer,
byte for byte the JAX package's; reference cmd/api-response.go)."""

from __future__ import annotations

import datetime
import urllib.parse
import xml.etree.ElementTree as ET

from minio_tpu_torch.s3.errors import S3Error

S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, tz=datetime.timezone.utc
    ).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _doc(root_tag: str) -> ET.Element:
    return ET.Element(root_tag, xmlns=S3_NS)


def render(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root)


def error_xml(code: str, message: str, resource: str, request_id: str) -> bytes:
    root = ET.Element("Error")
    _el(root, "Code", code)
    _el(root, "Message", message)
    _el(root, "Resource", resource)
    _el(root, "RequestId", request_id)
    _el(root, "HostId", "minio-tpu")
    return render(root)


def list_buckets_xml(buckets, owner="minio-tpu") -> bytes:
    root = _doc("ListAllMyBucketsResult")
    o = _el(root, "Owner")
    _el(o, "ID", owner)
    _el(o, "DisplayName", owner)
    bs = _el(root, "Buckets")
    for b in buckets:
        be = _el(bs, "Bucket")
        _el(be, "Name", b.name)
        _el(be, "CreationDate", _iso(b.created))
    return render(root)


def _object_entry(parent, o, tag="Contents"):
    c = _el(parent, tag)
    _el(c, "Key", o.name)
    _el(c, "LastModified", _iso(o.mod_time))
    _el(c, "ETag", f'"{o.etag}"')
    _el(c, "Size", o.size)
    _el(c, "StorageClass", o.storage_class)
    return c


def _entries(root, res) -> None:
    for o in res.objects:
        _object_entry(root, o)
    for p in res.prefixes:
        cp = _el(root, "CommonPrefixes")
        _el(cp, "Prefix", p)


def list_objects_v1_xml(bucket, prefix, marker, delimiter, max_keys, res) -> bytes:
    root = _doc("ListBucketResult")
    _el(root, "Name", bucket)
    _el(root, "Prefix", prefix)
    _el(root, "Marker", marker)
    _el(root, "MaxKeys", max_keys)
    if delimiter:
        _el(root, "Delimiter", delimiter)
    _el(root, "IsTruncated", "true" if res.is_truncated else "false")
    if res.is_truncated and res.next_marker:
        _el(root, "NextMarker", res.next_marker)
    _entries(root, res)
    return render(root)


def list_objects_v2_xml(bucket, prefix, token, start_after, delimiter,
                        max_keys, res) -> bytes:
    root = _doc("ListBucketResult")
    _el(root, "Name", bucket)
    _el(root, "Prefix", prefix)
    _el(root, "MaxKeys", max_keys)
    if delimiter:
        _el(root, "Delimiter", delimiter)
    _el(root, "KeyCount", len(res.objects) + len(res.prefixes))
    _el(root, "IsTruncated", "true" if res.is_truncated else "false")
    if token:
        _el(root, "ContinuationToken", token)
    if start_after:
        _el(root, "StartAfter", start_after)
    if res.is_truncated and res.next_marker:
        _el(root, "NextContinuationToken", res.next_marker)
    _entries(root, res)
    return render(root)


def list_versions_xml(bucket, prefix, res) -> bytes:
    root = _doc("ListVersionsResult")
    _el(root, "Name", bucket)
    _el(root, "Prefix", prefix)
    _el(root, "IsTruncated", "true" if res.is_truncated else "false")
    if res.is_truncated:
        _el(root, "NextKeyMarker", res.next_marker)
        _el(root, "NextVersionIdMarker", res.next_version_id_marker)
    for o in res.objects:
        v = _el(root, "DeleteMarker" if o.delete_marker else "Version")
        _el(v, "Key", o.name)
        _el(v, "VersionId", o.version_id or "null")
        _el(v, "IsLatest", "true" if o.is_latest else "false")
        _el(v, "LastModified", _iso(o.mod_time))
        if not o.delete_marker:
            _el(v, "ETag", f'"{o.etag}"')
            _el(v, "Size", o.size)
            _el(v, "StorageClass", o.storage_class)
    for p in res.prefixes:
        cp = _el(root, "CommonPrefixes")
        _el(cp, "Prefix", p)
    return render(root)


def delete_result_xml(deleted, errors) -> bytes:
    root = _doc("DeleteResult")
    for d in deleted:
        e = _el(root, "Deleted")
        _el(e, "Key", d.object_name)
        if d.version_id:
            _el(e, "VersionId", d.version_id)
        if d.delete_marker:
            _el(e, "DeleteMarker", "true")
            _el(e, "DeleteMarkerVersionId", d.delete_marker_version_id)
    for key, code, msg in errors:
        e = _el(root, "Error")
        _el(e, "Key", key)
        _el(e, "Code", code)
        _el(e, "Message", msg)
    return render(root)


def parse_delete_xml(body: bytes) -> tuple[list[tuple[str, str]], bool]:
    """DeleteObjects body -> ([(key, version_id)], quiet)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise S3Error("MalformedXML") from None
    out = []
    quiet = False
    for child in root:
        local = child.tag.rsplit("}", 1)[-1]
        if local == "Quiet":
            quiet = (child.text or "").strip().lower() == "true"
        elif local == "Object":
            key = vid = ""
            for c in child:
                l2 = c.tag.rsplit("}", 1)[-1]
                if l2 == "Key":
                    key = c.text or ""
                elif l2 == "VersionId":
                    vid = c.text or ""
            if key:
                out.append((key, vid))
    return out, quiet


def copy_object_xml(etag: str, mod_time: float) -> bytes:
    """CopyObject's and UploadPartCopy's answer."""
    root = _doc("CopyObjectResult")
    _el(root, "ETag", f'"{etag}"')
    _el(root, "LastModified", _iso(mod_time))
    return render(root)


def tagging_xml(tags: str) -> bytes:
    """tags: the url-encoded k=v&k2=v2 form objects store them in."""
    root = _doc("Tagging")
    ts = _el(root, "TagSet")
    for k, v in urllib.parse.parse_qsl(tags):
        t = _el(ts, "Tag")
        _el(t, "Key", k)
        _el(t, "Value", v)
    return render(root)


def parse_tagging_xml(body: bytes) -> str:
    """PutObjectTagging body -> the url-encoded form."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise S3Error("MalformedXML") from None
    pairs = []
    tagset = root.find(f"{{{S3_NS}}}TagSet")
    if tagset is None:
        tagset = root.find("TagSet")
    for tag in (tagset if tagset is not None else []):
        key = val = None
        for child in tag:
            local = child.tag.rsplit("}", 1)[-1]
            if local == "Key":
                key = child.text or ""
            elif local == "Value":
                val = child.text or ""
        if key is not None:
            pairs.append((key, val or ""))
    return urllib.parse.urlencode(pairs)


def versioning_xml(status: str) -> bytes:
    root = _doc("VersioningConfiguration")
    if status:
        _el(root, "Status", status)
    return render(root)


def parse_versioning_xml(body: bytes) -> str:
    """PutBucketVersioning body -> "Enabled" or "Suspended"; ValueError
    for anything else."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise ValueError("malformed XML") from None
    status = root.findtext("{*}Status") or root.findtext("Status") or ""
    if status not in ("Enabled", "Suspended"):
        raise ValueError(f"bad versioning status {status!r}")
    return status


def initiate_multipart_xml(bucket: str, key: str, upload_id: str) -> bytes:
    root = _doc("InitiateMultipartUploadResult")
    _el(root, "Bucket", bucket)
    _el(root, "Key", key)
    _el(root, "UploadId", upload_id)
    return render(root)


def complete_multipart_xml(location: str, bucket: str, key: str, etag: str) -> bytes:
    root = _doc("CompleteMultipartUploadResult")
    _el(root, "Location", location)
    _el(root, "Bucket", bucket)
    _el(root, "Key", key)
    _el(root, "ETag", f'"{etag}"')
    return render(root)


def parse_complete_multipart_xml(body: bytes) -> list[tuple[int, str]]:
    """CompleteMultipartUpload body -> [(part_number, etag)]."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise S3Error("MalformedXML") from None
    parts = []
    for child in root:
        if child.tag.rsplit("}", 1)[-1] != "Part":
            continue
        num = etag = None
        for c in child:
            local = c.tag.rsplit("}", 1)[-1]
            if local == "PartNumber":
                try:
                    num = int(c.text)
                except (TypeError, ValueError):
                    raise S3Error("MalformedXML") from None
            elif local == "ETag":
                etag = (c.text or "").strip('"')
        if num is not None and etag is not None:
            parts.append((num, etag))
    return parts


def list_parts_xml(bucket, key, upload_id, parts) -> bytes:
    root = _doc("ListPartsResult")
    _el(root, "Bucket", bucket)
    _el(root, "Key", key)
    _el(root, "UploadId", upload_id)
    _el(root, "IsTruncated", "false")
    for p in parts:
        e = _el(root, "Part")
        _el(e, "PartNumber", p.part_number)
        _el(e, "ETag", f'"{p.etag}"')
        _el(e, "Size", p.size)
        if p.last_modified:
            _el(e, "LastModified", _iso(p.last_modified))
    return render(root)


def list_uploads_xml(bucket, uploads) -> bytes:
    root = _doc("ListMultipartUploadsResult")
    _el(root, "Bucket", bucket)
    _el(root, "IsTruncated", "false")
    for u in uploads:
        e = _el(root, "Upload")
        _el(e, "Key", u.object)
        _el(e, "UploadId", u.upload_id)
        _el(e, "Initiated", _iso(u.initiated))
    return render(root)


def sts_assume_role_xml(access_key: str, secret_key: str, session_token: str,
                        expiry_iso: str, request_id: str, action: str = "AssumeRole",
                        subject: str = "") -> bytes:
    """The STS answer of AssumeRole and its federated variants
    (cmd/sts-handlers.go response types)."""
    root = ET.Element(f"{action}Response", xmlns="https://sts.amazonaws.com/doc/2011-06-15/")
    result = _el(root, f"{action}Result")
    creds = _el(result, "Credentials")
    _el(creds, "AccessKeyId", access_key)
    _el(creds, "SecretAccessKey", secret_key)
    _el(creds, "SessionToken", session_token)
    _el(creds, "Expiration", expiry_iso)
    if subject and action == "AssumeRoleWithWebIdentity":
        _el(result, "SubjectFromWebIdentityToken", subject)
    _el(_el(root, "ResponseMetadata"), "RequestId", request_id)
    return render(root)
