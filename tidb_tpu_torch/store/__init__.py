"""Columnar table storage read by the coprocessor."""
