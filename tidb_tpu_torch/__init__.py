"""TiTPU on PyTorch and CUDA.

A port of `tidb_tpu` to one NVIDIA Hopper card. It keeps the JAX package's
module paths and function names so that every function here has a
findable counterpart, and it imports nothing of `tidb_tpu`: what it needs
from host-only modules is copied in. Entry points:

* `session.Session(device=None).execute(sql)` / `.query(sql)`: SQL text,
  parsed (`sql/`), planned as the reference plans it (`plan/`), run by the
  root executor (`executor/engine.py`) over the transactional
  `store.storage.Storage` (`kv/`: percolator 2PC over an ordered KV,
  durable with a path; `store/table_store.py`: column epochs, deltas,
  compaction), with DML, transactions, the point fast path
  (`plan/fastpath.py`), online DDL (`ddl/ddl.py`), the schema surface
  (SHOW, `catalog/infoschema.py`, views, sequences), partitioned tables,
  the function registry (`copr/funcs.py`), the clock and user locks,
  accounts, grants and roles checked per statement
  (`session/privileges.py`), and the statement plane: the plan cache,
  bindings (`session/bindinfo.py`), LOAD DATA and INTO OUTFILE, statement
  digests and the slow log, TRACE and EXPLAIN ANALYZE over the
  coprocessor's dispatch stages (`obs.py`), @@max_execution_time;
* `server.Server(storage)`: the MySQL wire protocol over it;
* `copr.client.CopClient(device).execute(dag, snap)` for a single-table
  pushdown request (`plan.dag.CopDAG`);
* `copr.fragment.execute_fragment(cop, frag, snaps)` for a fragment
  request (`plan.fragment.FragmentDAG`).

Where the reference's gates send a request to its host tier, the port's
host tier answers it too (`copr/host_exec.py`, the fragment's host
interpreter), with the reference's engine tag. `errors.NotInSlice` marks
what is not ported yet: SHOW PROCESSLIST, PROFILES, PROFILE and METRICS,
the obs-backed information_schema tables but `statements_summary` and
`slow_query`, `metrics_schema`.
"""

from .errors import NotInSlice

__all__ = ["NotInSlice", "resolve_device"]


def __getattr__(name):
    # lazy: importing the package (the analysis CLI, the config loader)
    # must not import torch; `resolve_device` loads it at first use
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
