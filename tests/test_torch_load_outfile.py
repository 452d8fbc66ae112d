"""LOAD DATA INFILE and SELECT ... INTO OUTFILE on the port, held to the
reference statement for statement.

Every case of tests/test_load_outfile.py but the ADMIN CHECK ones (ported
with ADMIN CHECK itself) runs through a `FileTwin`: one `Session` of each
package (the port's with `device="cpu"`) over its own store and its own
directory, the same input files written into both. After every statement
the outcomes must be equal (rows, affected count, or the error's class,
errno and message with the side's directory masked), and so must every
physical store (partitions by name: epoch, dictionaries, deltas with
their commit timestamps ranked). The files INTO OUTFILE writes are
compared byte for byte. Beyond those: LOAD DATA routed into a
HASH-partitioned table, and a round trip of a table of seeded numpy
values (ints, decimals, doubles, strings with tabs, newlines and
backslashes, NULLs) through OUTFILE and LOAD DATA. Tolerance: none.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_functions import outcome
from test_torch_partition import part_stores
from tidb_tpu.session import Session as RefSession
from tidb_tpu_torch.session import Session


class FileTwin:
    """One session of each package, each with its own directory: `{d}`
    in a statement is the side's directory."""

    def __init__(self, tmp_path) -> None:
        self.dirs = {"port": tmp_path / "port", "ref": tmp_path / "ref"}
        for d in self.dirs.values():
            d.mkdir()
        self.sides = {"port": Session(device="cpu"), "ref": RefSession()}

    @property
    def port(self):
        return self.sides["port"]

    def write(self, name: str, text: str) -> None:
        for d in self.dirs.values():
            (d / name).write_text(text)

    def read_bytes(self, name: str) -> bytes:
        got = {k: (d / name).read_bytes() for k, d in self.dirs.items()}
        assert got["port"] == got["ref"], name
        return got["port"]

    def set(self, attr: str, value) -> None:
        for s in self.sides.values():
            setattr(s, attr, value)

    def set_var(self, name: str, sub=None) -> None:
        """Session variable `name` = the side's directory (or a directory
        under it); None removes it."""
        for k, s in self.sides.items():
            if sub is None:
                s.vars.pop(name, None)
            else:
                s.vars[name] = str(self.dirs[k] / sub)

    def execute(self, sql: str):
        out = {}
        for k, s in self.sides.items():
            d = str(self.dirs[k])
            try:
                res = ("ok", s.execute(sql.replace("{d}", d)))
            except Exception as e:  # the session error, compared below
                res = ("error", e)
            o = outcome(*res)
            if res[0] == "error":
                o = o[:3] + (o[3].replace(d, "{d}"),)
            out[k] = (res, o)
        assert out["port"][1] == out["ref"][1], sql
        assert part_stores(self.port.storage) == \
            part_stores(self.sides["ref"].storage), sql
        res = out["port"][0]
        if res[0] == "error":
            raise res[1]
        return res[1]

    must_exec = execute

    def must_query(self, sql: str) -> list:
        return self.execute(sql).rows

    def check(self, sql: str, expected: list) -> None:
        got = [tuple(str(v) if type(v).__name__ == "Decimal" else v
                     for v in r) for r in self.must_query(sql)]
        assert got == expected, sql


@pytest.fixture()
def tk(tmp_path):
    return FileTwin(tmp_path)


def test_load_data_basic_tsv(tk):
    tk.write("t.tsv", "1\talpha\t1.50\n2\tbeta\t2.25\n3\t\\N\t0.00\n")
    tk.must_exec("create table t (a int primary key, b varchar(20), "
                 "c decimal(6,2))")
    rs = tk.must_exec("load data infile '{d}/t.tsv' into table t")
    assert rs.affected == 3
    tk.check("select a, b from t order by a",
             [(1, "alpha"), (2, "beta"), (3, None)])


def test_load_data_local_rejected(tk):
    tk.write("t.tsv", "1\n")
    tk.must_exec("create table t (a int primary key)")
    with pytest.raises(Exception) as exc:
        tk.must_exec("load data local infile '{d}/t.tsv' into table t")
    assert "local" in str(exc.value).lower()
    assert getattr(exc.value, "errno", None) == 1235
    tk.check("select count(*) from t", [(0,)])


def test_load_data_local_opt_in(tk):
    tk.write("t.tsv", "1\talpha\n2\tbeta\n")
    tk.must_exec("create table t (a int primary key, b varchar(20))")
    tk.must_exec("set global local_infile = 1")
    rs = tk.must_exec("load data local infile '{d}/t.tsv' into table t")
    assert rs.affected == 2
    tk.check("select a, b from t order by a", [(1, "alpha"), (2, "beta")])
    tk.write("t2.tsv", "2\tBETA2\n3\tgamma\n")
    tk.must_exec("load data local infile '{d}/t2.tsv' into table t")
    tk.check("select a, b from t order by a",
             [(1, "alpha"), (2, "beta"), (3, "gamma")])
    tk.must_exec("load data local infile '{d}/t2.tsv' replace into table t")
    tk.check("select b from t where a = 2", [("BETA2",)])
    tk.must_exec("set global local_infile = 0")
    with pytest.raises(Exception) as exc:
        tk.must_exec("load data local infile '{d}/t.tsv' into table t")
    assert getattr(exc.value, "errno", None) == 1235


def test_load_data_local_user_needs_file_or_confinement(tk):
    tk.write("x.tsv", "1\n")
    tk.must_exec("create table t (a int primary key)")
    tk.must_exec("set global local_infile = 1")
    tk.must_exec("create user 'nobody'@'%'")
    tk.must_exec("grant insert on test.t to 'nobody'@'%'")
    tk.set("user", "nobody")
    with pytest.raises(Exception) as exc:
        tk.must_exec("load data local infile '{d}/x.tsv' into table t")
    assert getattr(exc.value, "errno", None) == 1227
    tk.set_var("secure_file_priv", ".")
    tk.set("user", None)
    tk.must_exec("load data local infile '{d}/x.tsv' into table t")
    tk.check("select a from t", [(1,)])


def test_load_data_local_respects_secure_file_priv(tk):
    for d in tk.dirs.values():
        (d / "allowed").mkdir()
    tk.write("outside.tsv", "1\n")
    tk.write("allowed/in.tsv", "2\n")
    tk.must_exec("create table t (a int primary key)")
    tk.must_exec("set global local_infile = 1")
    tk.set_var("secure_file_priv", "allowed")
    with pytest.raises(Exception) as exc:
        tk.must_exec("load data local infile '{d}/outside.tsv' into table t")
    assert getattr(exc.value, "errno", None) == 1290
    tk.must_exec("load data local infile '{d}/allowed/in.tsv' into table t")
    tk.check("select a from t", [(2,)])


def test_load_data_csv_enclosed_ignore_lines(tk):
    tk.write("t.csv", 'a,b\n1,"hello, world"\n2,"say ""hi"""\n3,plain\n')
    tk.must_exec("create table t (a int, b varchar(40))")
    tk.must_exec(
        "load data infile '{d}/t.csv' into table t fields terminated by ',' "
        "optionally enclosed by '\"' lines terminated by '\\n' "
        "ignore 1 lines")
    tk.check("select b from t order by a",
             [("hello, world",), ('say "hi"',), ("plain",)])


def test_load_data_column_list_and_defaults(tk):
    tk.write("t.txt", "10\tx\n20\ty\n")
    tk.must_exec("create table t (a int, b varchar(10), c int default 7)")
    tk.must_exec("load data infile '{d}/t.txt' into table t (a, b)")
    tk.check("select a, b, c from t order by a",
             [(10, "x", 7), (20, "y", 7)])


def test_load_data_duplicate_modes(tk):
    tk.write("dups.tsv", "1\tnew1\n9\tnine\n")
    tk.must_exec("create table t (a int primary key, b varchar(10))")
    tk.must_exec("insert into t values (1, 'old1')")
    with pytest.raises(Exception):
        tk.must_exec("load data infile '{d}/dups.tsv' into table t")
    tk.must_exec("load data infile '{d}/dups.tsv' ignore into table t")
    tk.check("select b from t order by a", [("old1",), ("nine",)])
    tk.must_exec("delete from t where a = 9")
    tk.must_exec("load data infile '{d}/dups.tsv' replace into table t")
    tk.check("select b from t order by a", [("new1",), ("nine",)])


def test_load_data_missing_file_errno(tk):
    tk.must_exec("create table t (a int)")
    with pytest.raises(Exception) as ei:
        tk.must_exec("load data infile '/nonexistent/x.csv' into table t")
    assert getattr(ei.value, "errno", None) == 1017


def test_outfile_roundtrip(tk):
    tk.must_exec("create table src (a int, b varchar(30), c decimal(8,2))")
    tk.must_exec("insert into src values (1,'plain',2.50), "
                 "(2,'tab\\the re',0.25), (3,NULL,10.00)")
    rs = tk.must_exec(
        "select a, b, c from src order by a into outfile '{d}/dump.tsv'")
    assert rs.affected == 3
    tk.read_bytes("dump.tsv")
    tk.must_exec("create table dst (a int, b varchar(30), c decimal(8,2))")
    tk.must_exec("load data infile '{d}/dump.tsv' into table dst")
    assert tk.must_query("select * from dst order by a") == \
        tk.must_query("select * from src order by a")


def test_outfile_csv_format_and_refuse_overwrite(tk):
    tk.must_exec("create table t (a int, b varchar(10))")
    tk.must_exec("insert into t values (1,'x'), (2,'y')")
    tk.must_exec("select * from t order by a into outfile '{d}/o.csv' "
                 "fields terminated by ',' enclosed by '\"'")
    assert tk.read_bytes("o.csv") == b'"1","x"\n"2","y"\n'
    with pytest.raises(Exception) as ei:
        tk.must_exec("select * from t into outfile '{d}/o.csv'")
    assert getattr(ei.value, "errno", None) == 1086


def test_file_priv_gates_load_and_outfile(tk):
    tk.write("x.tsv", "1\n")
    tk.must_exec("create table t (a int)")
    tk.must_exec("create user 'bob' identified by ''")
    tk.must_exec("grant select, insert on test.* to 'bob'")
    tk.set("user", "bob")
    with pytest.raises(Exception) as ei:
        tk.must_exec("load data infile '{d}/x.tsv' into table t")
    assert getattr(ei.value, "errno", None) == 1227
    with pytest.raises(Exception) as ei:
        tk.must_exec("select a from t into outfile '{d}/o.txt'")
    assert getattr(ei.value, "errno", None) == 1227
    tk.set("user", None)
    tk.must_exec("grant file on *.* to 'bob'")
    tk.set("user", "bob")
    assert tk.must_exec(
        "load data infile '{d}/x.tsv' into table t").affected == 1


def test_secure_file_priv_confines_paths(tk):
    for d in tk.dirs.values():
        (d / "allowed").mkdir()
    tk.write("allowed/in.tsv", "5\n")
    tk.write("outside.tsv", "6\n")
    tk.must_exec("create table t (a int)")
    tk.set_var("secure_file_priv", "allowed")
    tk.must_exec("load data infile '{d}/allowed/in.tsv' into table t")
    with pytest.raises(Exception) as ei:
        tk.must_exec("load data infile '{d}/outside.tsv' into table t")
    assert getattr(ei.value, "errno", None) == 1290


def test_load_bad_numeric_text_is_data_error(tk):
    tk.write("bad.tsv", "abc\n")
    tk.must_exec("create table t (a int)")
    with pytest.raises(Exception) as ei:
        tk.must_exec("load data infile '{d}/bad.tsv' into table t")
    assert getattr(ei.value, "errno", None) == 1292


def test_final_enclosed_empty_record_not_dropped(tk):
    tk.write("e.csv", '"a"\n""')
    tk.must_exec("create table t (s varchar(10))")
    tk.must_exec("load data infile '{d}/e.csv' into table t "
                 "fields terminated by ',' enclosed by '\"'")
    assert tk.must_query("select s from t order by s") == [("",), ("a",)]


def test_empty_terminators_rejected(tk):
    tk.write("x.tsv", "1\n")
    tk.must_exec("create table t (a int)")
    for clause in ("fields terminated by ''", "lines terminated by ''"):
        with pytest.raises(Exception):
            tk.must_exec(f"load data infile '{{d}}/x.tsv' into table t "
                         f"{clause}")


def test_union_into_outfile(tk):
    tk.must_exec("create table t (a int)")
    tk.must_exec("insert into t values (1), (2)")
    rs = tk.must_exec("select a from t union all select a + 10 from t "
                      "into outfile '{d}/u.txt'")
    assert rs.affected == 4
    assert sorted(tk.read_bytes("u.txt").decode().split()) == \
        ["1", "11", "12", "2"]


def test_load_empty_and_fractional_coercions(tk):
    tk.write("c.tsv", "1\t\t2.5\n2\t3.25\t-2.5\n")
    tk.must_exec("create table t (a int primary key, "
                 "d decimal(6,2) not null, i int)")
    tk.must_exec("load data infile '{d}/c.tsv' into table t")
    rows = tk.must_query("select d, i from t order by a")
    assert [(str(d), i) for d, i in rows] == [("0.00", 3), ("3.25", -3)]


# ==================== beyond the reference's cases ====================

def test_load_data_routes_into_hash_partitions(tk):
    """LOAD DATA into a HASH-partitioned table goes through INSERT's
    routing: every partition's store equals the reference's (the twin
    compares them after each statement), and a REPLACE reload moves no
    row across partitions."""
    rng = np.random.default_rng(14)
    keys = rng.permutation(5000)[:1200]
    vals = rng.integers(-10**6, 10**6, size=len(keys))
    tk.write("p.tsv", "".join(f"{k}\t{v}\tc{k % 13}\n"
                              for k, v in zip(keys, vals)))
    tk.must_exec("create table pt (k int primary key, v bigint, "
                 "s varchar(8)) partition by hash(k) partitions 4")
    assert tk.must_exec("load data infile '{d}/p.tsv' into table "
                        "pt").affected == len(keys)
    counts = tk.must_query(
        "select partition_name, table_rows from information_schema."
        "partitions where table_name = 'pt' order by partition_name")
    assert sum(c for _, c in counts) == len(keys)
    assert all(c > 0 for _, c in counts)
    tk.must_exec("load data infile '{d}/p.tsv' replace into table pt")
    assert tk.must_query("select count(*), sum(v) from pt") == \
        [(len(keys), int(vals.sum()))]


def _seeded_rows(rng, n: int) -> list[str]:
    words = ["a\tb", "line\nbreak", "back\\slash", "plain", "", "x,y"]
    rows = []
    for i in range(n):
        cells = [str(i),
                 "NULL" if i % 11 == 0 else str(int(rng.integers(-2**40,
                                                                 2**40))),
                 "NULL" if i % 7 == 0 else
                 f"{int(rng.integers(-10**7, 10**7)) / 100:.2f}",
                 "NULL" if i % 5 == 0 else
                 repr(float(rng.standard_normal()))]
        w = words[int(rng.integers(0, len(words)))]
        cells.append("NULL" if i % 9 == 0 else
                     "'" + w.replace("\\", "\\\\").replace("\t", "\\t")
                     .replace("\n", "\\n") + "'")
        rows.append("(" + ", ".join(cells) + ")")
    return rows


@pytest.mark.parametrize("fmt", [
    "", "fields terminated by ',' enclosed by '\"'",
    "fields terminated by '|' escaped by '' lines terminated by ';'"])
def test_seeded_outfile_bytes_and_reload(tk, fmt):
    """Seeded numpy values through INTO OUTFILE (byte-equal files) and
    back through LOAD DATA into an empty copy (equal stores, equal
    reads)."""
    rng = np.random.default_rng(7)
    ddl = ("(id int primary key, b bigint, d decimal(12,2), f double, "
           "s varchar(20))")
    tk.must_exec(f"create table src {ddl}")
    tk.must_exec(f"create table dst {ddl}")
    tk.must_exec("insert into src values " + ", ".join(_seeded_rows(rng,
                                                                    300)))
    tk.must_exec(f"select * from src order by id into outfile "
                 f"'{{d}}/s.txt' {fmt}")
    assert len(tk.read_bytes("s.txt")) > 0
    load = f"load data infile '{{d}}/s.txt' into table dst {fmt}"
    if "escaped by ''" in fmt:
        # without escapes a NULL is the text NULL: both packages refuse
        # it for an integer column alike
        with pytest.raises(Exception) as ei:
            tk.must_exec(load)
        assert getattr(ei.value, "errno", None) == 1292
        return
    tk.must_exec(load)
    assert tk.must_query("select * from dst order by id") == \
        tk.must_query("select * from src order by id")
