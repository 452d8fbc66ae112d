"""Every coprocessor request of the 22 TPC-H queries, through the port.

TPC-H (SF0.01, seed 42, all eight tables) is loaded into one reference
`Session`. Each query runs there; `unittest.mock` wraps the reference's
`CopClient.execute` and `copr.fragment.execute_fragment` to capture every
coprocessor call the statement makes (request, snapshots, answer). Each
call then crosses over with `tidb_tpu_torch.convert` and runs through the
port on the CPU. None may raise `NotInSlice`: every one of them runs on a
device path of the reference, and so on the port's.

Tolerance: exact, engine tag included. Partial aggregation rows are
compared sorted (the order of groups is not part of the contract); row
results column by column in the order returned, chunk for chunk (TopN:
one chunk per tile).

Q19 is left out of the SQL census: its reference run alone takes about
50 s on a CPU, most of this file's 60 s budget. Its two coprocessor calls
are bare scans (of lineitem and of part); `test_q19_scans` builds them by
hand as the reference planner cuts them and holds the port to the
reference on the same snapshots.
"""

from unittest import mock

import numpy as np
import pytest

from tidb_tpu.bench.tpch_data import load_tpch
from tidb_tpu.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu.copr import client as JC
from tidb_tpu.copr import fragment as JF
from tidb_tpu.plan.dag import CopDAG, DAGScan
from tidb_tpu.session import Session
from tidb_tpu_torch import NotInSlice
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.copr.fragment import execute_fragment

SF, SEED = 0.01, 42
QUERIES = sorted((q for q in TPCH_QUERIES if q != "q19"),
                 key=lambda q: int(q[1:]))
# coprocessor calls per query (the reference planner's cut at SF0.01)
N_CALLS = {"q1": 1, "q2": 2, "q3": 1, "q4": 1, "q5": 1, "q6": 1, "q7": 1,
           "q8": 1, "q9": 4, "q10": 1, "q11": 2, "q12": 1, "q13": 2,
           "q14": 1, "q15": 3, "q16": 1, "q17": 2, "q18": 2, "q20": 3,
           "q21": 3, "q22": 3}
# Q19's scans: (table, scan offsets), as the reference planner cuts them
Q19_SCANS = [("lineitem", [1, 4, 5, 6, 13, 14]), ("part", [0, 3, 5, 6])]


@pytest.fixture(scope="module")
def session():
    s = Session()
    load_tpch(s, sf=SF, seed=SEED)
    return s


_CALLS: dict = {}


def _calls(session, q):
    """[(kind, request, snapshot(s), reference result)] per coprocessor
    call of TPC-H query q, captured once."""
    if q not in _CALLS:
        calls = []
        run_dag, run_frag = JC.CopClient.execute, JF.execute_fragment

        def dag_call(self, dag, snap):
            r = run_dag(self, dag, snap)
            calls.append(("dag", dag, snap, r))
            return r

        def frag_call(cop, frag, snaps):
            r = run_frag(cop, frag, snaps)
            calls.append(("frag", frag, snaps, r))
            return r

        with mock.patch.object(JC.CopClient, "execute", dag_call), \
                mock.patch.object(JF, "execute_fragment", frag_call):
            session.query(TPCH_QUERIES[q])
        _CALLS[q] = calls
    return _CALLS[q]


def _port(kind, req, snaps):
    cop = CopClient("cpu")
    try:
        if kind == "dag":
            return cop.execute(request_from_reference(req),
                               snapshot_from_reference(snaps))
        return execute_fragment(cop, request_from_reference(req),
                                {tid: snapshot_from_reference(s)
                                 for tid, s in snaps.items()})
    except NotInSlice as e:
        pytest.fail(f"NotInSlice({e.reason!r})")


def _assert_same(got, ref):
    assert got.engine == ref.engine
    assert got.is_partial_agg == ref.is_partial_agg
    if ref.is_partial_agg:
        assert TR.partial_rows(got.chunks) == TR.partial_rows(ref.chunks)
        return
    assert len(got.chunks) == len(ref.chunks)
    cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
    assert len(cols) == len(want)
    for a, b in zip(cols, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("q", QUERIES)
def test_every_coprocessor_call_matches_reference(session, q):
    calls = _calls(session, q)
    assert len(calls) == N_CALLS[q]
    for kind, req, snaps, ref in calls:
        # every call of the 22 queries runs on a device path of the
        # reference
        assert ref.engine.startswith("device"), (q, ref.engine)
        _assert_same(_port(kind, req, snaps), ref)


def test_q19_scans(session):
    # Q18 and Q17 read every table Q19's scans read: take their snapshots
    snaps = {}
    for q in ("q17", "q18"):
        for kind, req, s, _ in _calls(session, q):
            for snap in ([s] if kind == "dag" else s.values()):
                snaps[snap.table.name] = snap
    for name, offs in Q19_SCANS:
        snap = snaps[name]
        dag = CopDAG(scan=DAGScan(snap.table.id, offs),
                     output_types=[snap.table.columns[o].ftype
                                   for o in offs])
        ref = JC.CopClient().execute(dag, snap)
        assert ref.engine == "device"
        got = _port("dag", dag, snap)
        _assert_same(got, ref)
        assert got.chunks[0].num_rows == snap.epoch.num_rows


def test_census_of_tags(session):
    # 37 calls of 21 queries (+ Q19's two scans = 39), every one on the
    # reference's device paths, the new ones of this slice among them
    tags: dict = {}
    for q in QUERIES:
        for _, _, _, ref in _calls(session, q):
            tags[ref.engine] = tags.get(ref.engine, 0) + 1
    assert sum(tags.values()) == sum(N_CALLS.values()) == 37
    assert tags["device[agg+semi]"] == 1 and tags["device[rows+semi]"] == 2
    assert tags["device"] == 15
