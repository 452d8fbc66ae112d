"""The statement plane of the port, held to the reference statement for
statement: the plan cache, bindings, statement digests and the slow log,
spans and TRACE, EXPLAIN ANALYZE with the coprocessor's dispatch stages,
the metrics registry, and @@max_execution_time.

Statements run through `Twin`s (tests/test_torch_functions.py): one
`Session` of each package (the port's with `device="cpu"`) over its own
store, the same statements in the same order, outcomes (rows, or the
error's class, errno and message), warnings and engine tags equal after
every statement. EXPLAIN ANALYZE and TRACE go through `timeless`, which
drops their time columns and the spans of a first compile (JAX compiles
at a program's first call; the port on the CPU compiles nothing); on top
of that the stage NAMES of each EXPLAIN ANALYZE row are compared without
`compile`. Compared besides: plan text, SHOW BINDINGS rows (times
excluded), @@last_plan_from_binding, plan-cache hit, miss and eviction
counts and the cache's keys, statements_summary digests, texts and
counts, slow-log digests and stage names, the two `normalize`s over
seeded statements. The cases are twins of tests/test_bindinfo.py, the
plan-cache cases of tests/test_fast_path.py, tests/test_observability.py
(but its status-port case), the registry, span-cap, trace-ring, slow-log
and stage-sum cases of tests/test_trace.py, and
tests/test_compat.py::test_max_execution_time_enforced. Tolerance: exact,
with times excluded.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from test_torch_functions import Twin, cells
from tidb_tpu import obs as ref_obs
from tidb_tpu.obs import StatementsSummary as RefSummary
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch import obs
from tidb_tpu_torch.obs import StatementsSummary
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

_TIMED = {"time_ms", "stages", "start_ms", "duration_ms"}
_COMPILE_SPANS = ("xla.compile", "cuda.compile")


def _stage_names(cell: str) -> set:
    """'staging:0.2ms kernel:1.5ms' -> {'staging', 'kernel'} (no
    compile)."""
    return {p.partition(":")[0] for p in (cell or "").split()} - {"compile"}


def _parse_stages(s: str) -> dict:
    out = {}
    for part in (s or "").split():
        k, _, v = part.partition(":")
        out[k] = float(v.removesuffix("ms")) / 1e3
    return out


def timeless(rs) -> tuple:
    """A result without its time columns and first-compile spans; an
    EXPLAIN ANALYZE row keeps the NAMES of its stages."""
    cols = rs.column_names
    keep = [i for i, c in enumerate(cols) if c not in _TIMED]
    si = cols.index("stages") if "stages" in cols else None
    rows = []
    for r in rs.rows:
        if isinstance(r[0], str) and \
                r[0].strip().split(" ")[0] in _COMPILE_SPANS:
            continue
        row = [r[i] for i in keep]
        if si is not None:
            row.append(sorted(_stage_names(r[si])))
        rows.append(tuple(row))
    return [cols[i] for i in keep], cells(rows)


def both_timeless(tk: Twin, sql: str):
    """Run a timed statement on both sides; their timeless results must
    be equal. Returns the port's ResultSet."""
    got = [s.execute(sql) for s in tk.sessions]
    assert timeless(got[0]) == timeless(got[1]), sql
    assert tk.port.last_engines == tk.ref.last_engines, sql
    return got[0]


def _explain(tk, sql):
    return "\n".join(r[0] for r in tk.must_query("explain " + sql))


# ==================== bindings (tests/test_bindinfo.py) ====================

@pytest.fixture()
def bk():
    t = Twin()
    t.must_exec("create table bt (a int primary key, b int, key kb (b))")
    t.must_exec("insert into bt values " +
                ",".join(f"({i},{i % 7})" for i in range(200)))
    t.must_exec("create table ct (a int primary key, c int)")
    t.must_exec("insert into ct values " +
                ",".join(f"({i},{i})" for i in range(50)))
    return t


def _lpfb(tk) -> int:
    return tk.must_query("select @@last_plan_from_binding")[0][0]


def test_session_binding_injects_hints(bk):
    base = _explain(bk, "select * from bt where b = 3")
    bk.must_exec(
        "create binding for select * from bt where b = 3 "
        "using select /*+ IGNORE_INDEX(bt, kb) */ * from bt where b = 3")
    bound = _explain(bk, "select * from bt where b = 3")
    assert bound != base, (base, bound)
    assert len(bk.must_query("select * from bt where b = 3")) == 29
    assert _lpfb(bk) == 1
    bk.must_query("select * from bt where b = 5")
    assert _lpfb(bk) == 1
    bk.must_query("select a from bt where b = 3 and a > 1")
    assert _lpfb(bk) == 0


def _bindings(bk, sql: str) -> list:
    """SHOW BINDINGS rows of both, equal but for the two time columns."""
    got = [[r[:4] + r[6:] for r in s.execute(sql).rows]
           for s in bk.sessions]
    assert got[0] == got[1]
    return got[0]


def test_show_and_drop_binding(bk):
    bk.must_exec(
        "create binding for select * from bt where b = 1 "
        "using select /*+ USE_INDEX(bt, kb) */ * from bt where b = 1")
    rows = _bindings(bk, "show bindings")
    assert len(rows) == 1
    orig, bind_sql, db, status = rows[0][:4]
    assert "?" in orig and "bt" in orig
    assert "USE_INDEX" in bind_sql
    assert db == "test" and status == "enabled"
    bk.must_exec("drop binding for select * from bt where b = 99")
    assert _bindings(bk, "show bindings") == []


def test_global_binding_persists_and_crosses_sessions(bk):
    bk.must_exec(
        "create global binding for select * from bt where b = 2 "
        "using select /*+ USE_INDEX(bt, kb) */ * from bt where b = 2")
    assert len(_bindings(bk, "show global bindings")) == 1
    sib = bk.sibling()
    sib.must_query("select * from bt where b = 2")
    assert _lpfb(sib) == 1
    bk.must_exec("drop global binding for select * from bt where b = 2")
    assert _bindings(bk, "show global bindings") == []


def test_global_binding_rides_the_meta_keyspace(tmp_path):
    """A GLOBAL binding persists through put_meta/get_meta: a reopened
    store still applies it, in both packages."""
    stores = {"port": (Storage, lambda st: Session(st, device="cpu")),
              "ref": (RefStorage, RefSession)}
    got = {}
    for name, (Store, new_session) in stores.items():
        path = str(tmp_path / name)
        st = Store(path)
        s = new_session(st)
        s.execute("create table bt (a int primary key, b int, key kb (b))")
        s.execute("insert into bt values (1, 2), (2, 2), (3, 4)")
        s.execute("create global binding for select * from bt where b = 2 "
                  "using select /*+ IGNORE_INDEX(bt, kb) */ * from bt "
                  "where b = 2")
        st.close()
        st = Store(path)
        s = new_session(st)
        rows = s.query("select * from bt where b = 2")
        got[name] = (rows, s.query("select @@last_plan_from_binding"),
                     [r[:4] for r in s.query("show global bindings")])
        st.close()
    assert got["port"] == got["ref"]
    assert got["port"][1] == [(1,)]


def test_mismatched_using_statement_rejected(bk):
    with pytest.raises(Exception):
        bk.must_exec(
            "create binding for select * from bt where b = 1 "
            "using select /*+ USE_INDEX(bt, kb) */ * from ct")


def test_baselines_toggle(bk):
    bk.must_exec(
        "create binding for select * from bt where b = 4 "
        "using select /*+ USE_INDEX(bt, kb) */ * from bt where b = 4")
    bk.must_exec("set tidb_use_plan_baselines = 0")
    bk.must_query("select * from bt where b = 4")
    assert _lpfb(bk) == 0
    bk.must_exec("set tidb_use_plan_baselines = 1")
    bk.must_query("select * from bt where b = 4")
    assert _lpfb(bk) == 1


def test_binding_leading_join_order(bk):
    sql = "select count(*) from bt, ct where bt.a = ct.a"
    base = _explain(bk, sql)
    bk.must_exec(
        f"create binding for {sql} using "
        f"select /*+ LEADING(ct, bt) */ count(*) "
        f"from bt, ct where bt.a = ct.a")
    bound = _explain(bk, sql)
    assert bound != base, (base, bound)
    assert bk.must_query(sql) == [(50,)]
    assert _lpfb(bk) == 1


def _prepared(tk, sql: str, params: list):
    """PREPARE + EXECUTE on both; equal rows and engines."""
    sids = [s.prepare(sql) for s in tk.sessions]
    assert sids[0][1] == sids[1][1]
    got = [s.execute_prepared(sid, params)
           for s, (sid, _) in zip(tk.sessions, sids)]
    assert cells(got[0].rows) == cells(got[1].rows)
    assert tk.port.last_engines == tk.ref.last_engines
    return got[0].rows


def test_prepared_explain_does_not_reuse_stale_raw_sql(bk):
    bk.must_exec(
        "create binding for select * from bt where b = 1 "
        "using select /*+ IGNORE_INDEX(bt, kb) */ * from bt where b = 1")
    bk.must_query("explain select * from bt where b = 1")
    assert _prepared(bk, "select a from ct where a = ?", [1]) == [(1,)]
    assert _lpfb(bk) == 0


def test_binding_matches_prepared_statements(bk):
    bk.must_exec(
        "create binding for select * from bt where b = 1 "
        "using select /*+ IGNORE_INDEX(bt, kb) */ * from bt where b = 1")
    assert len(_prepared(bk, "select * from bt where b = ?", [6])) == 28
    assert _lpfb(bk) == 1


# ==================== the plan cache (tests/test_fast_path.py) =============

def _counts(tk) -> tuple:
    return tk.both(lambda s: (s.storage.obs.plan_cache_hits.get(),
                              s.storage.obs.plan_cache_misses.get(),
                              s.storage.obs.plan_cache_evictions.get()))


def test_plan_cache_lru_move_to_back_and_evict():
    tk = Twin()
    tk.must_exec("create table l (id bigint primary key, v bigint)")
    for i in range(6):
        tk.must_exec(f"insert into l values ({i}, {i})")
    tk.must_exec("set tidb_plan_cache_size = 3")
    e0 = _counts(tk)[2]
    for i in range(3):
        tk.must_query(f"select v from l where id = {i}")
    tk.must_query("select v from l where id = 0")
    assert tk.both(lambda s: s.last_plan_from_cache)
    tk.must_query("select v from l where id = 3")
    keys = tk.both(lambda s: list(s._plan_cache))
    assert any("id = 0" in k for k in keys), keys
    assert not any("id = 1" in k for k in keys), keys
    assert _counts(tk)[2] > e0


def test_plan_cache_counters_and_metrics_names():
    tk = Twin()
    tk.must_exec("create table m (id bigint primary key, v bigint)")
    tk.must_exec("insert into m values (1, 1)")
    h0, m0, _ = _counts(tk)
    for _ in range(4):
        tk.must_query("select v from m where id = 1")
    h1, m1, _ = _counts(tk)
    assert m1 - m0 >= 1
    assert h1 - h0 == 3
    text = tk.port.storage.obs.render()
    for fam in ("tidb_plan_cache_hits_total",
                "tidb_plan_cache_misses_total",
                "tidb_plan_cache_evictions_total",
                "tidb_group_commit_batch_size"):
        assert fam in text, fam


def test_prepared_statement_fast_path_and_cache():
    tk = Twin()
    tk.must_exec("create table ps (id bigint primary key, v bigint)")
    tk.must_exec("insert into ps values (7, 70)")
    sids = [s.prepare("select v from ps where id = ?")[0]
            for s in tk.sessions]
    h0 = _counts(tk)[0]
    for _ in range(3):
        got = [s.execute_prepared(sid, [7]).rows
               for s, sid in zip(tk.sessions, sids)]
        assert got == [[(70,)], [(70,)]]
        assert tk.both(lambda s: list(s.last_engines)) == ["point"]
    assert _counts(tk)[0] - h0 == 2
    assert tk.both(lambda s: [k for k in s._plan_cache
                              if k.startswith("#stmt")])


def test_explain_analyze_shows_point_and_cache():
    tk = Twin()
    tk.must_exec("create table ea (id bigint primary key, v bigint)")
    tk.must_exec("insert into ea values (5, 50)")
    for _ in range(2):
        rows = both_timeless(
            tk, "explain analyze select v from ea where id = 5").rows
        assert rows[0][3] == "point", rows
        assert "Point_Get" in rows[0][0]
        assert "plan_cache:" in rows[0][4]
        assert rows[0][1] == 1
    assert rows[0][4] == "plan_cache:hit"
    rows = both_timeless(tk, "explain analyze select sum(v) from ea").rows
    assert all(r[3] != "point" for r in rows)


def test_seeded_point_reads_hit_the_cache_alike():
    """Seeded point SELECTs over a table: equal rows, equal hit and miss
    counts; a repeated key hits."""
    tk = Twin()
    tk.must_exec("create table o (k bigint primary key, v bigint)")
    tk.must_exec("insert into o values " +
                 ",".join(f"({i}, {i * 3})" for i in range(300)))
    keys = np.random.default_rng(14).integers(0, 40, size=200)
    before = _counts(tk)
    for k in keys:
        assert tk.must_query(f"select v from o where k = {int(k)}") == \
            [(int(k) * 3,)]
    after = _counts(tk)
    hits, misses = after[0] - before[0], after[1] - before[1]
    # every read is a lookup; each key's first read misses, and so does
    # the first after an auto-analyze (every 64 statements) moved the
    # statistics generation the entries are stamped with
    assert hits + misses == len(keys)
    assert len(set(keys.tolist())) <= misses < len(keys) // 2


# ==================== observability (tests/test_observability.py) ==========

def test_trace_statement():
    tk = Twin()
    tk.must_exec("create table t (a int primary key, b int)")
    tk.must_exec("insert into t values (1,1),(2,2)")
    rs = both_timeless(tk, "trace select sum(b) from t where a >= 1")
    ops = [r[0] for r in rs.rows]
    assert any("session.prepare" in o for o in ops)
    assert any("planner.optimize" in o for o in ops)
    assert any("executor.run" in o for o in ops)
    assert any("TableRead" in o for o in ops)
    exec_row = next(r for r in rs.rows if r[0].strip() == "executor.run")
    assert exec_row[2] > 0
    assert rs.rows[0][0] == "session.run"
    assert exec_row[0].startswith("  ")
    assert any("copr." in o for o in ops)


def test_trace_dml_and_inactive_spans():
    tk = Twin()
    tk.must_exec("create table td (a int primary key)")
    rs = both_timeless(tk, "trace insert into td values (1)")
    assert rs.rows[0][0] == "session.run"
    assert any("executor.dml" in r[0] for r in rs.rows)
    assert tk.must_query("select a from td") == [(1,)]
    with obs.span("nothing") as sp:
        assert sp is None


def test_trace_rejects_ddl():
    tk = Twin()
    with pytest.raises(Exception, match="TRACE supports SELECT"):
        tk.must_exec("trace create table x (a int)")


def test_statement_normalization():
    for n in (StatementsSummary.normalize, RefSummary.normalize):
        assert n("SELECT * FROM t WHERE a = 5 AND b = 'x'") == \
            "select * from t where a = ? and b = ?"
        assert n("select 1.5, 2e3") == "select ? , ?"
        assert n("select a from t where a=1") == \
            n("select a from t where a=  42")


def test_seeded_digests_equal_the_reference():
    """Seeded statements (literals of every lexical kind, keywords in
    mixed case, a text the lexer refuses): the same normalized text and
    the same sha256 digest in both packages."""
    rng = np.random.default_rng(14)
    kws = ["SELECT", "select", "Select"]
    sqls = ["select 'unterminated"]
    for _ in range(200):
        lit = [str(int(rng.integers(-10**9, 10**9))),
               f"{rng.standard_normal():.6f}", f"{rng.random():.3e}",
               "'" + "".join(rng.choice(list("abc xyz'"), 5)).replace(
                   "'", "''") + "'"][int(rng.integers(0, 4))]
        sqls.append(f"{kws[int(rng.integers(0, 3))]} a, b FROM t "
                    f"WHERE a = {lit} and b in ({lit}, 3) LIMIT 5")
    for sql in sqls:
        assert StatementsSummary.normalize(sql) == RefSummary.normalize(sql)
        assert StatementsSummary.digest(sql)[0] == _ref_digest(sql)


def _ref_digest(sql: str) -> str:
    import hashlib
    return hashlib.sha256(
        RefSummary.normalize(sql).encode()).hexdigest()[:32]


def _summary(tk, where: str) -> list:
    """statements_summary rows of both (digest, text, sample, counts,
    rows), equal."""
    got = [s.query("select digest, digest_text, query_sample_text, "
                   "exec_count, sum_errors, sum_result_rows from "
                   f"information_schema.statements_summary {where}")
           for s in tk.sessions]
    assert sorted(got[0]) == sorted(got[1])
    return got[0]


def test_statements_summary_memtable():
    tk = Twin()
    tk.must_exec("create table s (a int primary key)")
    tk.must_exec("insert into s values (1),(2),(3)")
    for i in range(1, 4):
        tk.must_query(f"select a from s where a = {i}")
    rows = _summary(tk, "where digest_text like 'select a from s%'")
    assert rows and rows[0][3] == 3 and rows[0][5] == 3
    with pytest.raises(Exception):
        tk.must_query("select nocol from s")
    rows = _summary(tk, "where digest_text like 'select nocol%'")
    assert [r[4] for r in rows] == [1]


def test_slow_query_memtable():
    tk = Twin()
    tk.must_exec("create table q (a int)")
    tk.must_exec("insert into q values (1)")
    tk.must_exec("set tidb_slow_log_threshold = 0")
    tk.must_query("select a from q")
    tk.must_exec("set tidb_slow_log_threshold = 100000")
    got = [s.query("select db, query, plan_digest from "
                   "information_schema.slow_query") for s in tk.sessions]
    assert got[0] == got[1]
    assert any("select a from q" in r[1] for r in got[0])


def test_trace_checks_privileges():
    tk = Twin()
    tk.must_exec("create table priv_t (a int)")
    tk.must_exec("insert into priv_t values (1)")
    tk.must_exec("create user 'limited'")
    tk.set("user", "limited")
    try:
        with pytest.raises(Exception, match="denied"):
            tk.must_exec("trace select a from priv_t")
    finally:
        tk.set("user", None)


def test_trace_usable_as_identifier():
    tk = Twin()
    tk.must_exec("create table trace (trace int)")
    tk.must_exec("insert into trace values (7)")
    assert tk.must_query("select trace from trace") == [(7,)]


def test_metrics_exposition_has_no_duplicate_families():
    tk = Twin()
    tk.must_exec("create table m (a int)")
    tk.must_exec("insert into m values (1)")
    tk.must_query("select a from m")
    text = tk.port.storage.obs.render() + obs.PROCESS_METRICS.render()
    families = [ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")]
    assert len(families) == len(set(families)), families
    # the statement families count alike in both packages
    assert tk.both(lambda s: (s.storage.obs.queries.get(type="Select"),
                              s.storage.obs.queries.get(type="Insert"),
                              s.storage.obs.commits.get())) == (1, 1, 1)


def test_batch_statements_not_digested():
    tk = Twin()
    tk.must_exec("create table bt (a int)")
    tk.must_exec("insert into bt values (1); insert into bt values (2)")
    entries = tk.both(lambda s: sorted(
        e["sample_text"] for e in s.storage.obs.statements.snapshot()))
    assert all("[stmt" not in e for e in entries)


def test_per_server_isolation():
    s1 = Session(Storage(), device="cpu")
    s2 = Session(Storage(), device="cpu")
    s1.execute("create table i1 (a int)")
    s1.execute("insert into i1 values (1)")
    for _ in range(5):
        s1.execute("select a from i1")
    assert s1.storage.obs.queries.get(type="Select") >= 5
    assert s2.storage.obs.queries.get(type="Select") == 0
    assert s1.storage.obs.statements.snapshot()
    assert not s2.storage.obs.statements.snapshot()


def test_digest_eviction_cap():
    ss, rs = StatementsSummary(), RefSummary()
    for i in range(StatementsSummary.MAX_DIGESTS + 50):
        for x in (ss, rs):
            x.record(f"select {'x' * (i % 7)}{i} from t{i}", "d", 0.001)
    assert len(ss.snapshot()) <= StatementsSummary.MAX_DIGESTS
    assert sorted(e["digest"] for e in ss.snapshot()) == \
        sorted(e["digest"] for e in rs.snapshot())


# ==================== tracing and stages (tests/test_trace.py) =============

Q6 = ("select sum(l_extendedprice * l_discount) from lineitem "
      "where l_quantity < 24 and l_discount >= 1 and l_discount <= 6")


def _q6_twin() -> Twin:
    tk = Twin()
    tk.must_exec("create table lineitem (l_orderkey int primary key, "
                 "l_quantity int, l_extendedprice int, l_discount int)")
    rows = ",".join(f"({i},{i % 50},{100 + i},{i % 10})"
                    for i in range(1, 201))
    tk.must_exec(f"insert into lineitem values {rows}")
    return tk


def test_trace_q6_dispatch_stages():
    tk = _q6_twin()
    tk.must_query(Q6)  # warm
    rs = both_timeless(tk, "trace " + Q6)
    ops = [r[0].strip() for r in rs.rows]
    assert any(o.startswith("copr.staging") for o in ops)
    assert any(o.startswith("device.dispatch") for o in ops)
    assert any(o.startswith("device.fetch") for o in ops)
    assert any(o.startswith("planner.optimize") for o in ops)
    root = rs.rows[0]
    assert root[0] == "session.run"
    for r in rs.rows:
        if r[1] is not None and r[2] is not None:
            assert r[1] + r[2] <= root[2] + 1.0


def test_trace_stage_sum_matches_explain_analyze_wall():
    tk = _q6_twin()
    tk.must_query(Q6)  # warm
    rs = both_timeless(tk, "explain analyze " + Q6)
    assert rs.column_names == ["plan", "actRows", "time_ms", "engine",
                               "stages", "mesh", "wait_profile"]
    root = rs.rows[0]
    leaf = next(r for r in rs.rows if "TableRead" in r[0])
    assert "device" in leaf[3]
    stages = _parse_stages(leaf[4])
    for want in ("staging", "kernel", "device_get"):
        assert want in stages, (want, stages)
    assert "compile" not in stages
    wall_s = root[2] / 1e3
    total = sum(stages.values())
    assert total <= wall_s * 1.10 + 1e-3
    assert total >= wall_s * 0.10
    assert (leaf[5], leaf[6]) == ("", "")


def test_trace_span_cap_bounds_the_tree():
    tk = _q6_twin()
    tk.must_query(Q6)  # warm: no first-compile span in the count
    tk.must_exec("set tidb_trace_span_cap = 4")
    rs = both_timeless(tk, "trace " + Q6)
    span_rows = [r for r in rs.rows if r[1] is not None]
    assert len(span_rows) <= 4
    assert "dropped at cap" in rs.rows[0][0]


def test_trace_kept_in_the_storage_ring():
    tk = _q6_twin()
    tk.set("conn_id", 42)
    both_timeless(tk, "trace " + Q6)
    for s in tk.sessions:
        tr = s.storage.obs.trace_for(42)
        assert tr is not None and tr["spans"][0][0] == "session.run"
        assert s.storage.obs.trace_for(99999) is None


def test_tracing_disabled_allocates_no_spans(monkeypatch):
    tk = _q6_twin()
    tk.must_query(Q6)
    made: list[str] = []
    orig = obs.Span.__init__

    def counting(self, name, start):
        made.append(name)
        orig(self, name, start)

    monkeypatch.setattr(obs.Span, "__init__", counting)
    tk.port.query(Q6)
    assert made == []
    tk.port.query("trace " + Q6)
    assert made


def test_slow_log_carries_digest_and_stages():
    tk = _q6_twin()
    tk.must_exec("set tidb_slow_log_threshold = 0")
    tk.must_query(Q6)
    tk.must_exec("set tidb_slow_log_threshold = 100000")
    got = []
    for s in tk.sessions:
        rs = s.execute("show slow queries")
        assert rs.column_names == ["Time", "DB", "Duration_ms", "Query",
                                   "Plan_digest", "Stages", "Mem_max",
                                   "Spill_count", "Wait_profile"]
        ent = next(r for r in rs.rows if "l_extendedprice" in r[3])
        assert len(ent[4]) == 32
        digests = {r[0] for r in s.query(
            "select digest from information_schema.statements_summary")}
        assert ent[4] in digests
        stages = _stage_names(ent[5])
        assert "kernel" in stages and "staging" in stages
        raw = s.storage.obs.slow_queries()
        e = next(e for e in raw if "l_extendedprice" in e["sql"])
        assert e["plan_digest"] == ent[4] and "kernel" in e["stages"]
        rows = s.query(
            "select plan_digest, stages from information_schema.slow_query "
            "where query like '%l_extendedprice%'")
        assert rows and rows[0][0] == ent[4]
        got.append((ent[1], ent[3], ent[4], stages, ent[6:]))
    assert got[0] == got[1]


def test_every_metric_family_has_tidb_prefix():
    tk = _q6_twin()
    tk.must_query(Q6)
    for reg in (tk.port.storage.obs.metrics, obs.PROCESS_METRICS):
        for fam in reg.families():
            assert fam.startswith("tidb_"), fam
        for line in reg.render().splitlines():
            if line and not line.startswith("#"):
                assert line.startswith("tidb_"), line
    # every statement family of the port is a family of the reference
    ref = set(tk.ref.storage.obs.metrics.families())
    assert set(tk.port.storage.obs.metrics.families()) <= ref


def test_histogram_text_format_order_and_labels():
    tk = _q6_twin()
    tk.must_query(Q6)
    text = tk.port.storage.obs.render() + obs.PROCESS_METRICS.render()
    lines = text.splitlines()
    hist_fams = [ln.split()[2] for ln in lines
                 if ln.startswith("# TYPE") and ln.endswith("histogram")]
    assert "tidb_dispatch_stage_duration_seconds" in hist_fams
    for fam in hist_fams:
        fam_lines = [ln for ln in lines
                     if ln.startswith(fam) and not ln.startswith("#")]
        assert fam_lines, fam
        i = 0
        while i < len(fam_lines):
            assert fam_lines[i].startswith(fam + "_bucket{le="), \
                fam_lines[i]
            prev = -1.0
            while "+Inf" not in fam_lines[i]:
                le = float(fam_lines[i].split('le="')[1].split('"')[0])
                assert le > prev
                prev = le
                i += 1
            inf_count = int(fam_lines[i].split()[-1])
            i += 1
            assert fam_lines[i].startswith(fam + "_sum")
            i += 1
            assert fam_lines[i].startswith(fam + "_count")
            assert int(fam_lines[i].split()[-1]) == inf_count
            i += 1


def test_registry_exposition_equals_the_reference():
    """The same observations through both packages' registries render
    the same exposition text."""
    rng = np.random.default_rng(14)
    texts = []
    for mod in (obs, ref_obs):
        r = mod.Registry()
        c = r.counter("tidb_c_total", "a counter")
        g = r.gauge("tidb_g", "a gauge")
        h = r.histogram("tidb_h_seconds", "a histogram")
        hb = r.histogram("tidb_hb", "custom buckets", buckets=(1, 2, 4))
        for v in rng.random(50):
            c.inc(float(v), kind="a" if v < 0.5 else "b")
            g.set(float(v) * 1e9, device="0")
            h.observe(float(v) / 100, stage="kernel")
            hb.observe(float(v) * 5)
        texts.append(r.render())
        rng = np.random.default_rng(14)
    assert texts[0] == texts[1]


def test_sub_millisecond_buckets_exist():
    b = obs.Histogram.BUCKETS
    assert b == ref_obs.Histogram.BUCKETS
    assert b[0] <= 1e-5 and 0.0001 in b and 0.0005 in b
    h = obs.Histogram("tidb_x", "")
    h.observe(0.00005)
    h.observe(0.0005)
    counts, _, total = h.snapshot()
    assert total == 2 and counts[b.index(0.00005)] == 1


def test_duplicate_registration_type_mismatch_raises():
    r = obs.Registry()
    r.counter("tidb_thing_total")
    with pytest.raises(TypeError):
        r.histogram("tidb_thing_total")
    with pytest.raises(TypeError):
        r.gauge("tidb_thing_total")
    assert r.counter("tidb_thing_total") is r.counter("tidb_thing_total")


def test_gauge_exposition_and_dup_guard():
    r = obs.Registry()
    g = r.gauge("tidb_gauge_thing", "a gauge")
    g.set(3.0, device="0")
    g.inc(2.0, device="0")
    g.dec(1.0, device="0")
    g.set(7.5)
    text = r.render()
    assert "# TYPE tidb_gauge_thing gauge" in text
    assert 'tidb_gauge_thing{device="0"} 4' in text
    assert "tidb_gauge_thing 7.5" in text
    with pytest.raises(TypeError):
        r.counter("tidb_gauge_thing")
    assert r.gauge("tidb_gauge_thing") is g


def test_stages_are_exclusive_and_compile_never_shows_on_the_cpu():
    """Nested stages add up to at most the outer wall; on the CPU no
    statement records `compile` (no CUDA library is built or loaded)."""
    rec = obs.StageRecorder()
    obs.install_stage_recorder(rec)
    try:
        t0 = time.perf_counter()
        with obs.stage("staging"):
            with obs.stage("transfer"):
                time.sleep(0.01)
            time.sleep(0.005)
        wall = time.perf_counter() - t0
    finally:
        obs.install_stage_recorder(None)
    assert rec.totals["transfer"] >= 0.01
    assert sum(rec.totals.values()) <= wall
    tk = _q6_twin()
    for _ in range(2):
        tk.port.query(Q6)
        assert "compile" not in tk.port.last_stages
        assert {"prepare", "staging", "kernel", "device_get"} <= \
            set(tk.port.last_stages)


# ==================== @@max_execution_time (tests/test_compat.py) =========

def test_max_execution_time_enforced():
    tk = Twin()
    tk.must_exec("CREATE TABLE met (id INT PRIMARY KEY)")
    tk.must_exec("INSERT INTO met VALUES (1)")
    tk.must_exec("SET max_execution_time = 80")
    for s in tk.sessions:
        t0 = time.monotonic()
        with pytest.raises(Exception) as exc:
            s.query("SELECT SLEEP(30)")
        assert time.monotonic() - t0 < 10, "deadline did not fire promptly"
        assert exc.value.errno == 3024
        assert "maximum statement execution time" in str(exc.value)
    assert tk.must_query("SELECT id FROM met") == [(1,)]
    tk.must_exec("INSERT INTO met VALUES (2)")  # DML exempt
    tk.must_exec("SET max_execution_time = 0")
    assert tk.must_query("SELECT SLEEP(0.01)") == [(0,)]
