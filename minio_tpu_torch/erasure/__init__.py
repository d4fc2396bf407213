"""Erasure-set object engine: codec staging, quorum metadata, PUT/GET/heal."""
