"""Columnar table storage (epochs, deltas, compaction) and the in-memory
transactional Storage over it."""
