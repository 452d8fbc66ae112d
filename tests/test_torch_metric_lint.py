"""The metric-hygiene lint of the port (`obs.lint_metrics`,
`obs._lint_exposition`, `obs_inspect.lint_rules`, `metrics_schema.lint`),
held to the reference's.

Twins of every case of tests/test_metric_lint.py: each runs over each
package's registries (the port's live ones after an exercised store on
`device="cpu"`), and the lint findings are compared. The live registries
pass clean in both, with the port's families the reference's less
`metrics_schema.UNPORTED_FAMILIES` (none since the mesh plane's port).
The default device-label cap follows the live mesh width, at least 8,
in both.
"""

from __future__ import annotations

import pytest

import tidb_tpu.obs as ref_obs
import tidb_tpu.obs_inspect as ref_inspect
from tidb_tpu.catalog import metrics_schema as RefMS
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch import obs, obs_inspect
from tidb_tpu_torch.catalog import metrics_schema as MS
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

PORT = {"obs": obs, "inspect": obs_inspect, "ms": MS, "Storage": Storage,
        "Session": lambda st: Session(st, device="cpu")}
REF = {"obs": ref_obs, "inspect": ref_inspect, "ms": RefMS,
       "Storage": RefStorage, "Session": RefSession}


def both(fn):
    """fn(package) for the port and the reference; equal outcomes."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _exercised_storage(pkg):
    st = pkg["Storage"]()
    st.obs.topsql.configure(enabled=True)
    st.obs.waitprofile.configure(enabled=True)
    st.history.configure(enabled=True)
    s = pkg["Session"](st)
    s.execute("create table lint_t (a int primary key, b varchar(8))")
    s.execute("insert into lint_t values (1,'x'),(2,'y')")
    s.execute("select count(*), max(a) from lint_t where a >= 1")
    s.execute("set tidb_slow_log_threshold = 0")
    s.execute("select b from lint_t")
    s.execute("set tidb_slow_log_threshold = 100000")
    s.execute("select * from information_schema.inspection_result")
    st.obs.events.record("breaker_trip", detail="lint")
    st.metrics_history.sample_now()
    return st


def test_live_registries_pass_lint():
    def run(pkg):
        st = _exercised_storage(pkg)
        o = pkg["obs"]
        findings = o.lint_metrics([st.obs.metrics, o.PROCESS_METRICS])
        fams = set(st.obs.metrics.families()) | \
            set(o.PROCESS_METRICS.families())
        st.close()
        return findings, fams

    (got, fams), (want, ref_fams) = run(PORT), run(REF)
    assert got == want == []
    assert fams == ref_fams - MS.UNPORTED_FAMILIES


def test_lint_flags_missing_help():
    def run(pkg):
        reg = pkg["obs"].Registry()
        reg.counter("tidb_helpless_total", "")
        return pkg["obs"].lint_metrics([reg])

    assert any("missing help" in f for f in both(run))


def test_lint_flags_bad_prefix_and_case():
    def run(pkg):
        reg = pkg["obs"].Registry()
        reg.counter("queries_total", "no prefix")
        reg.gauge("tidb_BadCase", "case")
        return pkg["obs"].lint_metrics([reg])

    assert sum("tidb_[a-z0-9_]+" in f for f in both(run)) == 2


def test_lint_flags_cross_registry_duplicate():
    def run(pkg):
        a, b = pkg["obs"].Registry(), pkg["obs"].Registry()
        a.counter("tidb_dup_total", "one")
        b.counter("tidb_dup_total", "two")
        return pkg["obs"].lint_metrics([a, b])

    assert any("more than one" in f for f in both(run))


def test_lint_flags_malformed_exposition():
    bad = (
        "# HELP tidb_x_total fine\n"
        "# TYPE tidb_x_total counter\n"
        'tidb_x_total{l="v"} not_a_number\n'
        "tidb_orphan_total 3\n"
    )
    findings = both(lambda pkg: pkg["obs"]._lint_exposition(bad))
    assert any("non-numeric" in f for f in findings)
    assert any("orphan" in f and "TYPE" in f for f in findings)


@pytest.mark.parametrize("text", [
    "# HELP tidb_a gauge without type\ntidb_a 1\n",
    "# TYPE tidb_b counter\ntidb_b 2\n",
    "# HELP tidb_c x\n# TYPE tidb_c summery\ntidb_c 1\n",
    "# HELP tidb_d x\n# TYPE tidb_d counter\n# TYPE tidb_d counter\n",
    '# HELP tidb_e x\n# TYPE tidb_e histogram\n'
    'tidb_e_bucket{le="1"} 5\ntidb_e_bucket{le="2"} 3\n'
    'tidb_e_bucket{le="+Inf"} 5\ntidb_e_sum 1\ntidb_e_count 5\n',
    "# HELP tidb_f x\n# TYPE tidb_f gauge\ntidb_f{bad label} 1\n",
    "# HELP \n"])
def test_exposition_findings_equal_the_reference(text):
    both(lambda pkg: pkg["obs"]._lint_exposition(text))


def test_lint_accepts_histogram_exposition():
    def run(pkg):
        reg = pkg["obs"].Registry()
        h = reg.histogram("tidb_lat_seconds", "latency")
        for v in (0.0001, 0.01, 3.0):
            h.observe(v, stage="kernel")
            h.observe(v * 2, stage="staging")
        return pkg["obs"].lint_metrics([reg]), reg.render()

    findings, _ = both(run)
    assert findings == []


def test_lint_flags_unbounded_device_label_cardinality():
    def run(pkg):
        o = pkg["obs"]
        reg = o.Registry()
        g = reg.gauge("tidb_mesh_thing_bytes", "per-device thing")
        for i in range(9):
            g.set(float(i), device=f"TPU_{i}")
        out = [o.lint_metrics([reg], device_label_cap=8),
               o.lint_metrics([reg], device_label_cap=9)]
        c = reg.counter("tidb_mesh_shard_rows_total", "per-shard rows")
        for i in range(3):
            c.inc(shard=str(i))
        out += [o.lint_metrics([reg], device_label_cap=9),
                o.lint_metrics([reg], device_label_cap=2)]
        return out

    wide, ok, ok2, shards = both(run)
    assert any("cardinality" in f and "device" in f for f in wide)
    assert ok == [] and ok2 == []
    assert any("tidb_mesh_shard_rows_total" in f for f in shards)


def test_lint_default_cap_is_eight():
    """Without an explicit cap the port lints at 8 device labels, the
    reference's floor (its default follows the live mesh width): 8
    labels pass, 9 do not."""
    reg = obs.Registry()
    g = reg.gauge("tidb_mesh_dev_bytes", "per-device")
    for i in range(8):
        g.set(1.0, device=f"d{i}")
    assert not any("cardinality" in f for f in obs.lint_metrics([reg]))
    g.set(1.0, device="d8")
    assert any("cardinality" in f for f in obs.lint_metrics([reg]))


def test_inspection_rule_registry_lints_clean():
    assert len(obs_inspect.RULES) == len(ref_inspect.RULES) >= 10
    assert both(lambda pkg: pkg["inspect"].lint_rules()) == []


def test_inspection_rule_lint_flags_bad_metadata():
    def run(pkg):
        insp = pkg["inspect"]
        bad = {
            "Bad Name": insp.Rule("Bad Name", "warning", "r", lambda c: []),
            "no-ref": insp.Rule("no-ref", "warning", "", lambda c: []),
            "bad-sev": insp.Rule("bad-sev", "fatal", "r", lambda c: []),
        }
        errors = []
        for name, sev, ref in (("x", "warning", ""), ("x", "fatal", "ref"),
                               ("mesh-shard-skew", "warning", "ref")):
            with pytest.raises(ValueError) as exc:
                insp.rule(name, sev, ref)(lambda c: [])
            errors.append(str(exc.value))
        return insp.lint_rules(bad), errors

    findings, errors = both(run)
    assert any("kebab-case" in f for f in findings)
    assert any("missing reference" in f for f in findings)
    assert any("severity" in f for f in findings)
    assert len(errors) == 3


def test_metrics_schema_tables_map_to_live_families():
    def run(pkg):
        ms = pkg["ms"]
        st = _exercised_storage(pkg)
        ms.ensure_schema(st)
        clean = ms.lint(st)
        schema = st.catalog.schemas[ms.DB_NAME]
        tables = set(schema.tables)
        assert tables == set(ms.families(st))
        schema.tables["tidb_gone_total"] = next(iter(
            schema.tables.values()))
        dangling = ms.lint(st)
        st.close()
        return clean, tables, dangling

    (clean, tables, dangling), (rclean, rtables, rdangling) = \
        run(PORT), run(REF)
    assert clean == rclean == []
    assert tables == rtables - MS.UNPORTED_FAMILIES
    assert dangling == rdangling
    assert any("dangling" in f and "tidb_gone_total" in f for f in dangling)


def test_registry_type_conflict_still_raises():
    def run(pkg):
        reg = pkg["obs"].Registry()
        reg.counter("tidb_conflict_total", "c")
        with pytest.raises(TypeError) as exc:
            reg.gauge("tidb_conflict_total", "g")
        return str(exc.value)

    both(run)
