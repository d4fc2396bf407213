"""S3 XML documents (the subset of minio_tpu/s3/xmlutil.py the port sends:
the error document and the multipart documents, byte for byte the JAX
package's; reference cmd/api-response.go)."""

from __future__ import annotations

import datetime
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
