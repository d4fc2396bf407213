"""Host-side helpers with no device code (errors, geometry math, codecs)."""
