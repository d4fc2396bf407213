"""Drive layer: the per-object journal and the local-directory drive."""
