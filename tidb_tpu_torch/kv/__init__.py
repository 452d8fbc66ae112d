from .memdb import MemDB, Mutation, TOMBSTONE
from .tso import TimestampOracle

__all__ = ["MemDB", "Mutation", "TOMBSTONE", "TimestampOracle"]
