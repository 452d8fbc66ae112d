"""MySQL wire protocol server (port of `tidb_tpu/server/`)."""

from .server import Server

__all__ = ["Server"]
