"""Columnar table storage and the read-only Storage over it."""
