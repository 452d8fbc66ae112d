"""The write path's crash sites, the port held to the reference.

For each of the eight failpoint sites of the KV, 2PC and storage planes,
a child process of each package runs the same script on a durable store
(`sync_log="commit"`) holding a HASH-partitioned table: routed INSERTs of
two rows each (two partitions, so two regions a commit), printing
`ACK=<i>` after each acknowledged statement and `DONE` at its end, armed
with `TIDB_TPU_FAILPOINTS=<site>=exit(9)@K` (each package parses the
variable at import). Each test asserts that both children died at the
site (exit code 9, no `DONE`), then reopens both stores: every
acknowledged row is back, the two packages' stores are equal partition
by partition (epochs, dictionaries, deltas, handles), and the next INSERT
gets a handle above every handle of every partition.

`storage/mid-checkpoint` runs its INSERTs and then `checkpoint()`, which
dies after two of the four partitions' epoch files are written.
`kv/wal-torn-append` lives only in the pure-Python engine: its children
turn the C++ engine off by patching the module attribute each package's
`_make_engine` reads.

The strings written after the first close are the ones the first rows
wrote: after a reopen each partition holds its own copy of the
dictionaries (its epoch file's), and both packages reject a new string
routed to a partition other than the first
(`test_torch_partition.py::test_new_string_after_reopen`).
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

from test_torch_partition import part_stores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {
    "port": (Storage, lambda st: Session(st, device="cpu")),
    "ref": (RefStorage, RefSession),
}
TABLE = ("create table t (k int, v int, s varchar(8)) "
         "partition by hash(k) partitions 4")
BASE_ROWS = 8
N_INSERTS = 30

CHILD = """
import sys
pkg, path, site, epilogue = sys.argv[1:5]
if pkg == "port":
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store import storage as S
    new_session = lambda st: Session(st, device="cpu")
    if site == "kv/wal-torn-append":
        S.native_available = lambda: False
else:
    from tidb_tpu.kv import native as N
    from tidb_tpu.session import Session as new_session
    from tidb_tpu.store import storage as S
    if site == "kv/wal-torn-append":
        N.native_available = lambda: False
st = S.Storage(path, sync_log="commit")
if site == "kv/wal-torn-append":
    assert type(st.kv.kv).__name__ == "PyOrderedKV"
s = new_session(st)
for i in range({n}):
    k = {base} + 2 * i
    s.execute(f"insert into t values ({{k}}, {{k * 7}}, 'b{{i % 8}}'), "
              f"({{k + 1}}, {{k * 7 + 1}}, 'b{{(i + 3) % 8}}')")
    print(f"ACK={{i}}", flush=True)
if epilogue == "checkpoint":
    st.checkpoint()
print("DONE", flush=True)
""".format(n=N_INSERTS, base=BASE_ROWS)

# (site, K, epilogue): the K-th hit of the site kills the child. An
# INSERT here is one commit of two keys in two regions: ~4 WAL records
# a key, one group fsync, one pass through each 2PC site
SITES = [
    ("kv/group-fsync", 17, ""),
    ("kv/wal-torn-append", 40, ""),
    ("storage/mid-checkpoint", 2, "checkpoint"),
    ("storage/before-fold", 12, ""),
    ("twopc/before-prewrite", 12, ""),
    ("twopc/after-prewrite", 12, ""),
    ("twopc/before-commit-primary", 12, ""),
    ("twopc/after-primary-commit", 12, ""),
]


def _prepare(path: str, name: str) -> None:
    """The table and its first rows, closed cleanly."""
    StorageCls, new_session = SIDES[name]
    st = StorageCls(path, sync_log="commit")
    s = new_session(st)
    s.execute(TABLE)
    s.execute("insert into t values " + ", ".join(
        f"({k}, {k * 7}, 'b{k}')" for k in range(BASE_ROWS)))
    st.close()


def _child(path: str, name: str, site: str, k: int, epilogue: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               TIDB_TPU_FAILPOINTS=f"{site}=exit(9)@{k}")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, name, path, site, epilogue],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    lines = proc.stdout.splitlines()
    acked = [int(ln[4:]) for ln in lines if ln.startswith("ACK=")]
    return proc.returncode, "DONE" in lines, acked, proc.stderr


@pytest.mark.parametrize("site,k,epilogue", SITES,
                         ids=[s for s, _, _ in SITES])
def test_child_killed_at_site_loses_no_acked_commit(tmp_path, site, k,
                                                    epilogue):
    opened = {}
    acks = {}
    for name in SIDES:
        path = str(tmp_path / name)
        _prepare(path, name)
        rc, done, acked, err = _child(path, name, site, k, epilogue)
        assert rc == 9 and not done, (name, rc, err[-2000:])
        acks[name] = acked
        StorageCls, new_session = SIDES[name]
        st = StorageCls(path, sync_log="commit")
        opened[name] = (st, new_session(st))
    # the two children died at the same hit
    assert acks["port"] == acks["ref"]
    acked = acks["port"]
    if epilogue == "checkpoint":
        assert len(acked) == N_INSERTS
    else:
        assert 0 < len(acked) < N_INSERTS
    try:
        stores = {n: part_stores(st) for n, (st, _) in opened.items()}
        assert stores["port"] == stores["ref"]
        want = set(range(BASE_ROWS))
        for i in acked:
            want |= {BASE_ROWS + 2 * i, BASE_ROWS + 2 * i + 1}
        for name, (st, s) in opened.items():
            got = {r[0] for r in s.execute("select k from t").rows}
            assert want <= got, name
            # at most the commit the kill interrupted comes back too
            assert len(got - want) <= 2, name
        new = []
        for name, (st, s) in opened.items():
            part = st.catalog.table("test", "t").partition
            before = [st.table_store(d.id) for d in part.defs]
            top = max(max([int(h) for h in ps.epoch.handles]
                          + [h for _, h, _ in ps.deltas] + [0])
                      for ps in before)
            s.execute("insert into t values (1001, 1, 'b1'), "
                      "(1002, 2, 'b2')")
            rows = [(h, row) for ps in before for _, h, row in ps.deltas
                    if h > top]
            assert len(rows) == 2, name
            new.append(sorted(h for h, _ in rows))
        assert new[0] == new[1]
        assert part_stores(opened["port"][0]) == \
            part_stores(opened["ref"][0])
    finally:
        for st, _ in opened.values():
            st.close()
