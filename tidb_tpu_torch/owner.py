"""Owner election: who runs DDL jobs.

Port of `tidb_tpu/owner.py`, with its two managers:

* MockOwnerManager — single process: always the owner (in-memory stores
  use this).
* FileLockOwnerManager — processes sharing one durable directory: POSIX
  flock on <dir>/<key>.owner.lock. The kernel releases the lock when the
  holder dies, so ownership fails over without a lease.

`owner_manager(path, key)` chooses between them as the reference does.
A socket follower campaigns through the leader instead
(`rpc/remote.RemoteOwnerManager`).
"""

from __future__ import annotations

import os
import threading
from typing import Optional


class MockOwnerManager:
    """Single-process owner: campaigns always succeed (reference:
    owner/mock.go:35 mockManager)."""

    def __init__(self, key: str = "ddl") -> None:
        self.key = key
        self._lock = threading.RLock()  # serialize same-process workers
        self._owner_thread: Optional[int] = None
        self._depth = 0

    def campaign(self, timeout_s: float = 10.0) -> bool:
        if not self._lock.acquire(timeout=timeout_s):
            return False
        self._owner_thread = threading.get_ident()
        self._depth += 1
        return True

    def try_campaign(self) -> bool:
        if not self._lock.acquire(blocking=False):
            return False
        self._owner_thread = threading.get_ident()
        self._depth += 1
        return True

    def resign(self) -> None:
        try:
            self._depth -= 1
            if self._depth <= 0:
                self._owner_thread = None
                self._depth = 0
            self._lock.release()
        except RuntimeError:
            pass

    def is_owner(self) -> bool:
        """Is the CALLING thread the current owner (reference:
        mockManager.IsOwner)."""
        return self._owner_thread == threading.get_ident()

    def close(self) -> None:
        pass

    def __enter__(self):
        if not self.campaign():
            raise TimeoutError(f"could not become {self.key} owner")
        return self

    def __exit__(self, *exc) -> None:
        self.resign()


class FileLockOwnerManager:
    """flock-based owner for processes sharing a durable directory.

    Crash-safe: the OS drops the flock with the process, so ownership
    fails over without a TTL dance (reference analog: etcd lease expiry
    at owner/manager.go:124)."""

    def __init__(self, dir_path: str, key: str = "ddl") -> None:
        self.key = key
        self.path = os.path.join(dir_path, f"{key}.owner.lock")
        self._fd: Optional[int] = None
        self._thread_lock = threading.RLock()

    def _open(self) -> int:
        if self._fd is None:
            self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        return self._fd

    def try_campaign(self) -> bool:
        import fcntl

        if not self._thread_lock.acquire(blocking=False):
            return False
        try:
            fcntl.flock(self._open(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            os.truncate(self._fd, 0)
            os.pwrite(self._fd, str(os.getpid()).encode(), 0)
            return True
        except OSError:
            self._thread_lock.release()
            return False

    def campaign(self, timeout_s: float = 10.0) -> bool:
        import time

        deadline = time.monotonic() + timeout_s
        while True:
            if self.try_campaign():
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def resign(self) -> None:
        import fcntl

        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            except OSError:
                pass
        try:
            self._thread_lock.release()
        except RuntimeError:
            pass

    def owner_pid(self) -> Optional[int]:
        try:
            with open(self.path) as f:
                return int(f.read().strip() or 0) or None
        except (OSError, ValueError):
            return None

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    def __enter__(self):
        if not self.campaign():
            raise TimeoutError(f"could not become {self.key} owner")
        return self

    def __exit__(self, *exc) -> None:
        self.resign()


def owner_manager(path: Optional[str], key: str = "ddl"):
    """The deployment-appropriate manager (reference: tests take the
    mock, real clusters take etcd — main.go wires by store type)."""
    if path is None:
        return MockOwnerManager(key)
    return FileLockOwnerManager(path, key)


__all__ = ["MockOwnerManager", "FileLockOwnerManager", "owner_manager"]
