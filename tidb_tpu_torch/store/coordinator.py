"""Shared-directory multi-process coordination.

Port of `tidb_tpu/store/coordinator.py`. The reference runs many
stateless tidb-servers against a shared TiKV cluster: schema changes
propagate by lease (reference: domain/domain.go:352 Reload loop),
transactions from a server holding a superseded schema abort at commit
(domain/schema_validator.go), and a connection on one server can be
killed from another (server/server.go:548 Kill + tests/globalkilltest,
32-bit conn ids carrying the server id).

Here the multi-server shape is N processes sharing one durable
directory:

* one shared WAL, appended under an flock'd critical section (the
  percolator lock/write RECORDS carry the concurrency safety; the flock
  only serializes file appends and conflict checks against a fresh
  view);
* every process tails the WAL (`Storage.refresh`) before statements and
  inside every mutation section, folding other processes' commits into
  its own columnar epochs and reloading the catalog when the meta plane
  moved, with the schema fence aborting stale in-flight transactions;
* timestamps come from ONE shared allocator (`kv/tso.py SharedTSO`), so
  snapshot isolation is STRICT across processes;
* a `procs/` registry + `kill/` mailbox implement cross-process KILL:
  global connection ids embed the server id (the reference's
  globalconn layout), and each server's kill-mailbox thread polls it.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time
from typing import Optional

# size of the procs/ node-slot table (node ids feed global connection
# ids and the kill mailbox; timestamps come from the ONE SharedTSO
# allocator in kv/tso.py, not from per-node slicing)
TSO_NODE_SLICES = 32


class SharedDirCoordinator:
    """flock'd mutation sections + process/kill registry for N processes
    sharing one durable store directory."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.join(path, "procs"), exist_ok=True)
        os.makedirs(os.path.join(path, "kill"), exist_ok=True)
        self._lock_file = open(os.path.join(path, "store.lock"), "a+b")
        self._tlock = threading.RLock()  # in-process serialization
        self._depth = 0
        self.node_id = self._claim_node_id()

    # ---- node identity ----------------------------------------------------
    def _claim_node_id(self) -> int:
        """Smallest free slot in procs/ (flock'd probe): the slot file
        stays flock'd by this process for its lifetime, so a crashed
        process frees its slot automatically."""
        self._slots = []
        for nid in range(TSO_NODE_SLICES):
            f = open(os.path.join(self.path, "procs", f"node{nid}.lock"),
                     "a+b")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                f.close()
                continue
            self._slots.append(f)  # hold for process lifetime
            return nid
        raise RuntimeError("no free node slots in shared store dir")

    def register_server(self, port: int, status_port: Optional[int]
                        ) -> None:
        info = {"pid": os.getpid(), "port": port,
                "status_port": status_port, "started": time.time()}
        p = os.path.join(self.path, "procs", f"node{self.node_id}.json")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, p)

    def servers(self) -> dict[int, dict]:
        out = {}
        for name in os.listdir(os.path.join(self.path, "procs")):
            if not (name.startswith("node") and name.endswith(".json")):
                continue
            nid = int(name[4:-5])
            try:
                with open(os.path.join(self.path, "procs", name)) as f:
                    out[nid] = json.load(f)
            except (OSError, ValueError):
                continue
        return out

    # ---- mutation critical section ---------------------------------------
    def acquire(self) -> None:
        self._tlock.acquire()
        self._depth += 1
        if self._depth == 1:
            fcntl.flock(self._lock_file, fcntl.LOCK_EX)

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            fcntl.flock(self._lock_file, fcntl.LOCK_UN)
        self._tlock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def close(self) -> None:
        """Release the node slot and the section's file (a closed
        storage frees its slot at once instead of at process exit)."""
        for f in [*self._slots, self._lock_file]:
            try:
                f.close()
            except OSError:
                pass
        self._slots = []

    # ---- cross-process kill mailbox ---------------------------------------
    @staticmethod
    def global_conn_id(node_id: int, local_id: int) -> int:
        """serverID:local layout of the reference's global connection ids
        (reference: tests/globalkilltest, util/globalconn)."""
        return (node_id << 24) | (local_id & 0xFFFFFF)

    @staticmethod
    def split_conn_id(conn_id: int) -> tuple[int, int]:
        return conn_id >> 24, conn_id & 0xFFFFFF

    def post_kill(self, conn_id: int, query_only: bool) -> None:
        nid, local = self.split_conn_id(conn_id)
        name = f"{nid}_{local}_{'q' if query_only else 'c'}_{time.time()}"
        p = os.path.join(self.path, "kill", name)
        with open(p + ".tmp", "w") as f:
            f.write(str(conn_id))
        os.replace(p + ".tmp", p)

    def poll_kills(self, node_id: Optional[int] = None
                   ) -> list[tuple[int, bool]]:
        """(local_conn_id, query_only) requests addressed to `node_id`
        (default: this node); consumed on read. The RPC tier polls on
        behalf of socket followers, so the target node is a parameter."""
        target = self.node_id if node_id is None else node_id
        out = []
        d = os.path.join(self.path, "kill")
        for name in os.listdir(d):
            parts = name.split("_")
            if len(parts) < 3 or name.endswith(".tmp"):
                continue
            try:
                nid, local = int(parts[0]), int(parts[1])
            except ValueError:
                continue
            if nid != target:
                continue
            out.append((local, parts[2] == "q"))
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass
        return out
