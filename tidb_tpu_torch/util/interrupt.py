"""Per-statement interrupt plane (KILL QUERY / KILL CONNECTION).

The reference kills running statements by flipping a kill flag the
executors poll between batches (reference: server/server.go:548 Kill ->
sessVars.Killed; executor checkpoints via Next loops). Here the flag is
a threading.Event installed for the duration of a statement; the engine
checks it between plan nodes and the coprocessor client between tiles —
granular enough that long scans and joins die promptly, while a single
in-flight device dispatch (one tile kernel) runs to completion.
"""

from __future__ import annotations

import threading
from typing import Optional


class QueryInterrupted(Exception):
    """errno 1317 ER_QUERY_INTERRUPTED."""

    def __init__(self) -> None:
        super().__init__("Query execution was interrupted")


_local = threading.local()


def install(flag: Optional[threading.Event]) -> None:
    _local.flag = flag


def current() -> Optional[threading.Event]:
    return getattr(_local, "flag", None)


def check() -> None:
    flag = getattr(_local, "flag", None)
    if flag is not None and flag.is_set():
        raise QueryInterrupted()
