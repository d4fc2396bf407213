"""Bucket configuration documents (versioning; the other fields are kept)."""
