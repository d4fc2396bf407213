"""S3 XML documents (the subset of minio_tpu/s3/xmlutil.py this slice sends:
the error document; reference cmd/api-response.go)."""

from __future__ import annotations

import xml.etree.ElementTree as ET


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


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
