"""Socket RPC tier for the multi-process plane.

Port of `tidb_tpu/rpc/`. The shared-directory deployment is the fast
local mode; this package carries the same coordination services — TSO
allocation, WAL append/tail, the KILL mailbox — over a length-prefixed
frame protocol on TCP or unix sockets, so a second server can join a
cluster WITHOUT sharing a disk.

Layers (as in the reference):

* frame.py  — wire format: u32 length-prefixed frames carrying a
  tagged binary encoding (None/bool/int/float/bytes/str/list/dict).
* errors.py — the typed error surface (CodedError subclasses, so
  exhaustion and lease loss reach MySQL clients with real errnos).
* server.py — CoordRPCServer: embedded in the store-owning process,
  granting leases on the SAME flocks the shared-dir mode uses.
* client.py — RpcClient: per-request Backoffer (BO_RPC), timeouts,
  reconnect, heartbeat, circuit breaker, failpoint sites at each edge.
* remote.py — the follower's adapters (RemoteKV, RemoteCoordinator,
  RemoteOwnerManager) that plug the client into the storage.
* diag.py   — per-server diagnostics endpoints + the cluster_* fan-out.
* apply.py  — the follower's apply engine: the continuous mirror fold
  and the closed timestamp advertised on every heartbeat.
* replica.py — the follower read tier: the router (`try_route`), the
  serving side (`serve_replica_read`), the row codec and the settings.
* failover.py — the follower's leader-loss watcher: the deterministic
  election and the fenced in-place promotion it drives.
* netfault.py — the network fault plane (`net/*` failpoints) hooked
  into frame.py's send/recv.

* ranged.py — range-sharded write leadership: the range directory
  (table, grants, terms, the split journal), per-range leaders with
  their own WALs and closed timestamps, the RangeServer's `range_*`
  percolator handlers behind a fencing gate, online splits, the
  heat-driven auto-split actuator, and the RangePlane a Storage arms.

Unlike the reference, the serving loops here survive only the errors
they are meant to survive: the port's own RPC, KV, transaction and
coded errors, and socket errors (`errors.SURVIVABLE`). Any other
exception — a torch or CUDA error among them — is kept on the listener
or engine that hit it and re-raised by its `close()`; the peer sees only
a dropped connection, that is, a transport error.
"""
