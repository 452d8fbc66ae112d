"""Full TPC-H schema + deterministic data generator (all 8 tables).

The reference treats the TPC-H corpus as its correctness baseline
(reference: cmd/explaintest/t/tpch.test) and ships a fake-data importer
(reference: cmd/importer/main.go). This module generates spec-shaped data
for every TPC-H table directly into the columnar store: value distributions,
vocabularies, referential integrity (l_suppkey drawn from the part's 4
partsupp suppliers via the spec formula) and date arithmetic follow the
TPC-H v3 specification closely enough that all 22 queries return non-empty,
discriminating results at small scale factors.

Everything is vectorized numpy; string columns are generated as
(vocabulary, codes) pairs that map 1:1 onto the store's dictionary
encoding, so even SF1 loads are fast.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from ..types.value import parse_date

if TYPE_CHECKING:
    from ..session import Session

# ---------------------------------------------------------------------------
# DDL (schema per TPC-H spec 1.4; types mapped to our MySQL-compatible set)
# ---------------------------------------------------------------------------

TPCH_DDL: dict[str, str] = {
    "region": """
create table region (
  r_regionkey bigint not null primary key,
  r_name char(25) not null,
  r_comment varchar(152) not null
)""",
    "nation": """
create table nation (
  n_nationkey bigint not null primary key,
  n_name char(25) not null,
  n_regionkey bigint not null,
  n_comment varchar(152) not null
)""",
    "part": """
create table part (
  p_partkey bigint not null primary key,
  p_name varchar(55) not null,
  p_mfgr char(25) not null,
  p_brand char(10) not null,
  p_type varchar(25) not null,
  p_size bigint not null,
  p_container char(10) not null,
  p_retailprice decimal(15,2) not null,
  p_comment varchar(23) not null
)""",
    "supplier": """
create table supplier (
  s_suppkey bigint not null primary key,
  s_name char(25) not null,
  s_address varchar(40) not null,
  s_nationkey bigint not null,
  s_phone char(15) not null,
  s_acctbal decimal(15,2) not null,
  s_comment varchar(101) not null
)""",
    "partsupp": """
create table partsupp (
  ps_partkey bigint not null,
  ps_suppkey bigint not null,
  ps_availqty bigint not null,
  ps_supplycost decimal(15,2) not null,
  ps_comment varchar(199) not null
)""",
    "customer": """
create table customer (
  c_custkey bigint not null primary key,
  c_name varchar(25) not null,
  c_address varchar(40) not null,
  c_nationkey bigint not null,
  c_phone char(15) not null,
  c_acctbal decimal(15,2) not null,
  c_mktsegment char(10) not null,
  c_comment varchar(117) not null
)""",
    "orders": """
create table orders (
  o_orderkey bigint not null primary key,
  o_custkey bigint not null,
  o_orderstatus char(1) not null,
  o_totalprice decimal(15,2) not null,
  o_orderdate date not null,
  o_orderpriority char(15) not null,
  o_clerk char(15) not null,
  o_shippriority bigint not null,
  o_comment varchar(79) not null
)""",
    "lineitem": """
create table lineitem (
  l_orderkey bigint not null,
  l_partkey bigint not null,
  l_suppkey bigint not null,
  l_linenumber bigint not null,
  l_quantity decimal(15,2) not null,
  l_extendedprice decimal(15,2) not null,
  l_discount decimal(15,2) not null,
  l_tax decimal(15,2) not null,
  l_returnflag char(1) not null,
  l_linestatus char(1) not null,
  l_shipdate date not null,
  l_commitdate date not null,
  l_receiptdate date not null,
  l_shipinstruct char(25) not null,
  l_shipmode char(10) not null,
  l_comment varchar(44) not null
)""",
}

TPCH_TABLES = list(TPCH_DDL)  # load order respects FK-ish dependencies

# ---------------------------------------------------------------------------
# vocabularies (TPC-H spec 4.2.2.13 / appendix grammar)
# ---------------------------------------------------------------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# (name, regionkey) — spec's fixed 25 nations
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_TYPES = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]

CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_CONTAINERS = [f"{a} {b}" for a in CONT_S1 for b in CONT_S2]

COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

_NOISE = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "final", "bold", "express", "regular", "pending", "silent", "even",
    "special", "unusual", "ruthless", "idle", "busy", "daring", "quiet",
    "packages", "deposits", "requests", "accounts", "instructions",
    "theodolites", "pinto beans", "foxes", "ideas", "platelets", "asymptotes",
    "sleep", "haggle", "nag", "wake", "cajole", "boost", "detect", "engage",
    "among", "across", "above", "beneath", "along",
]

CURRENT_DATE = "1995-06-17"  # spec's fixed "current date"


def _comment_vocab(rng: np.random.Generator, n: int, width: int,
                   pattern: Optional[tuple[str, str]] = None,
                   pattern_frac: float = 0.0) -> list[str]:
    """n pseudo-random comments; pattern_frac of them embed 'A...B'."""
    out = []
    n_pat = int(round(n * pattern_frac))
    for i in range(n):
        words = [_NOISE[j] for j in rng.integers(0, len(_NOISE), 6)]
        if pattern is not None and i < n_pat:
            a, b = pattern
            words[1], words[3] = a, b
        out.append(" ".join(words)[:width])
    return out


def _phones(rng: np.random.Generator, nationkeys: np.ndarray) -> list[str]:
    """'CC-NNN-NNN-NNNN' with country code nationkey+10 (spec 4.2.2.9)."""
    a = rng.integers(100, 1000, len(nationkeys))
    b = rng.integers(100, 1000, len(nationkeys))
    c = rng.integers(1000, 10000, len(nationkeys))
    return [f"{int(k) + 10}-{x}-{y}-{z}"
            for k, x, y, z in zip(nationkeys, a, b, c)]


def tpch_sizes(sf: float) -> dict[str, int]:
    return {
        "region": 5,
        "nation": 25,
        "part": max(20, int(200_000 * sf)),
        "supplier": max(4, int(10_000 * sf)),
        "customer": max(10, int(150_000 * sf)),
        "orders": max(30, int(1_500_000 * sf)),
        # lineitem row count is derived (1..7 lines per order)
    }


def generate_tpch(sf: float, seed: int = 42) -> dict[str, dict[str, object]]:
    """All 8 tables as {table: {column: ndarray | (vocab, codes)}}.

    Numeric columns are physically encoded (decimals scaled x100, dates as
    proleptic day numbers). String columns are (vocab: list[str],
    codes: int64 ndarray) pairs ready for dictionary encoding.
    """
    rng = np.random.default_rng(seed)
    sz = tpch_sizes(sf)
    n_part, n_supp = sz["part"], sz["supplier"]
    n_cust, n_ord = sz["customer"], sz["orders"]
    out: dict[str, dict[str, object]] = {}

    # ---- region / nation ----------------------------------------------------
    out["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": (REGIONS, np.arange(5, dtype=np.int64)),
        "r_comment": (_comment_vocab(rng, 5, 152), np.arange(5)),
    }
    out["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": ([n for n, _ in NATIONS], np.arange(25, dtype=np.int64)),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
        "n_comment": (_comment_vocab(rng, 25, 152), np.arange(25)),
    }

    # ---- part ---------------------------------------------------------------
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    # p_name: 5 distinct color words (spec 4.2.3); vectorized via code matrix
    name_codes = np.empty((n_part, 5), dtype=np.int64)
    for j in range(5):
        name_codes[:, j] = rng.integers(0, len(COLORS), n_part)
    colors = np.array(COLORS)
    p_names = [" ".join(row) for row in colors[name_codes]]
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    # spec 4.2.3: retailprice = (90000 + ((pk/10) mod 20001) + 100*(pk mod 1000))/100
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    out["part"] = {
        "p_partkey": pk,
        "p_name": _dedup(p_names),
        "p_mfgr": ([f"Manufacturer#{i}" for i in range(1, 6)], mfgr - 1),
        "p_brand": ([f"Brand#{m}{n}" for m in range(1, 6)
                     for n in range(1, 6)], (mfgr - 1) * 5 + (brand % 10 - 1)),
        "p_type": (P_TYPES, rng.integers(0, len(P_TYPES), n_part)),
        "p_size": rng.integers(1, 51, n_part, dtype=np.int64),
        "p_container": (P_CONTAINERS,
                        rng.integers(0, len(P_CONTAINERS), n_part)),
        "p_retailprice": retail,
        "p_comment": _vocab_codes(_comment_vocab(rng, 199, 23), rng, n_part),
    }

    # ---- supplier -----------------------------------------------------------
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    # every nation gets suppliers even at tiny SF (keeps Q7/Q11/Q20/Q21
    # non-degenerate); tail is uniform like the spec
    s_nation = np.where(sk <= 50, (sk - 1) % 25,
                        rng.integers(0, 25, n_supp, dtype=np.int64))
    # spec: 5/10000 suppliers embed "Customer ... Complaints", 5/10000
    # "Customer ... Recommends"; guarantee at least one of each at tiny SF
    s_comments = _comment_vocab(rng, n_supp, 101)
    n_special = max(1, n_supp * 5 // 10000)
    for i in range(n_special):
        s_comments[(i * 2) % n_supp] = \
            "carefully Customer silent Complaints sleep furiously"
        s_comments[(i * 2 + 1) % n_supp] = \
            "blithely Customer bold Recommends haggle slyly"
    out["supplier"] = {
        "s_suppkey": sk,
        "s_name": ([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
                   np.arange(n_supp, dtype=np.int64)),
        "s_address": _vocab_codes(_comment_vocab(rng, 211, 40), rng, n_supp),
        "s_nationkey": s_nation,
        "s_phone": _dedup(_phones(rng, s_nation)),
        "s_acctbal": rng.integers(-99999, 999999, n_supp, dtype=np.int64),
        "s_comment": _dedup(s_comments),
    }

    # ---- partsupp -----------------------------------------------------------
    # spec formula: for i in 0..3, suppkey = (pk + i*(S/4 + (pk-1)/S)) % S + 1
    S = n_supp
    ps_pk = np.repeat(pk, 4)
    i4 = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_sk = (ps_pk + i4 * (S // 4 + (ps_pk - 1) // S)) % S + 1
    n_ps = len(ps_pk)
    out["partsupp"] = {
        "ps_partkey": ps_pk,
        "ps_suppkey": ps_sk,
        "ps_availqty": rng.integers(1, 10000, n_ps, dtype=np.int64),
        "ps_supplycost": rng.integers(100, 100001, n_ps, dtype=np.int64),
        "ps_comment": _vocab_codes(_comment_vocab(rng, 331, 199), rng, n_ps),
    }

    # ---- customer -----------------------------------------------------------
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nation = np.where(ck <= 50, (ck - 1) % 25,
                        rng.integers(0, 25, n_cust, dtype=np.int64))
    out["customer"] = {
        "c_custkey": ck,
        "c_name": ([f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
                   np.arange(n_cust, dtype=np.int64)),
        "c_address": _vocab_codes(_comment_vocab(rng, 223, 40), rng, n_cust),
        "c_nationkey": c_nation,
        "c_phone": _dedup(_phones(rng, c_nation)),
        "c_acctbal": rng.integers(-99999, 999999, n_cust, dtype=np.int64),
        "c_mktsegment": (SEGMENTS, rng.integers(0, 5, n_cust)),
        "c_comment": _vocab_codes(_comment_vocab(rng, 401, 117), rng, n_cust),
    }

    # ---- orders -------------------------------------------------------------
    ok = np.arange(1, n_ord + 1, dtype=np.int64)
    # spec: only customers with custkey % 3 != 0 place orders
    cust_pool = ck[ck % 3 != 0]
    o_cust = cust_pool[rng.integers(0, len(cust_pool), n_ord)]
    d0, d1 = parse_date("1992-01-01"), parse_date("1998-08-02")
    o_date = rng.integers(d0, d1 + 1, n_ord, dtype=np.int64)
    o_comments = _comment_vocab(rng, 997, 79,
                                pattern=("special", "requests"),
                                pattern_frac=0.012)
    rng.shuffle(o_comments)
    out["orders"] = {
        "o_orderkey": ok,
        "o_custkey": o_cust,
        # o_orderstatus patched below from lineitem statuses
        "o_orderstatus": None,
        "o_totalprice": None,  # patched below
        "o_orderdate": o_date,
        "o_orderpriority": (PRIORITIES, rng.integers(0, 5, n_ord)),
        "o_clerk": ([f"Clerk#{i:09d}" for i in range(1, max(2, n_ord // 1000) + 1)],
                    rng.integers(0, max(1, n_ord // 1000), n_ord)),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _vocab_codes(o_comments, rng, n_ord),
    }

    # ---- lineitem -----------------------------------------------------------
    lines_per = rng.integers(1, 8, n_ord)
    # ~1% "jumbo" orders: 7 lines of near-max quantity, so Q18's
    # sum(l_quantity) > 300 predicate discriminates at every scale factor
    jumbo = rng.random(n_ord) < 0.01
    lines_per[jumbo] = 7
    l_ok = np.repeat(ok, lines_per)
    l_odate = np.repeat(o_date, lines_per)
    n_li = len(l_ok)
    l_ln = _line_numbers(lines_per)
    l_pk = rng.integers(1, n_part + 1, n_li, dtype=np.int64)
    # pick one of the part's 4 partsupp suppliers (keeps Q9/Q20 joins alive)
    li_i4 = rng.integers(0, 4, n_li, dtype=np.int64)
    l_sk = (l_pk + li_i4 * (S // 4 + (l_pk - 1) // S)) % S + 1
    qty = rng.integers(1, 51, n_li, dtype=np.int64)
    l_jumbo = np.repeat(jumbo, lines_per)
    qty[l_jumbo] = rng.integers(45, 51, int(l_jumbo.sum()))
    l_price = qty * retail[l_pk - 1]  # retailprice is scaled x100 already
    disc = rng.integers(0, 11, n_li, dtype=np.int64)
    tax = rng.integers(0, 9, n_li, dtype=np.int64)
    ship = l_odate + rng.integers(1, 122, n_li)
    commit = l_odate + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    cur = parse_date(CURRENT_DATE)
    rf = np.where(receipt <= cur, rng.integers(0, 2, n_li), 2)  # 0=R 1=A 2=N
    ls = (ship > cur).astype(np.int64)  # 0=F 1=O
    out["lineitem"] = {
        "l_orderkey": l_ok,
        "l_partkey": l_pk,
        "l_suppkey": l_sk,
        "l_linenumber": l_ln,
        "l_quantity": qty * 100,
        "l_extendedprice": l_price,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": (["R", "A", "N"], rf),
        "l_linestatus": (["F", "O"], ls),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": (SHIP_INSTRUCT,
                           rng.integers(0, len(SHIP_INSTRUCT), n_li)),
        "l_shipmode": (SHIP_MODES, rng.integers(0, len(SHIP_MODES), n_li)),
        "l_comment": _vocab_codes(_comment_vocab(rng, 1499, 44), rng, n_li),
    }

    # o_orderstatus: F if all lines F, O if all O, else P (spec 4.2.3)
    sums = np.zeros(n_ord + 1, dtype=np.int64)
    counts = np.zeros(n_ord + 1, dtype=np.int64)
    np.add.at(sums, l_ok, ls)
    np.add.at(counts, l_ok, 1)
    status = np.full(n_ord, 2, dtype=np.int64)  # 2=P
    status[sums[1:] == 0] = 0  # F
    status[sums[1:] == counts[1:]] = 1  # O
    out["orders"]["o_orderstatus"] = (["F", "O", "P"], status)
    # o_totalprice = sum(extendedprice*(1+tax)*(1-discount)) over lines,
    # computed in scaled-integer space then rounded back to cents
    line_total = l_price * (100 + tax) * (100 - disc) // 10000
    totals = np.zeros(n_ord + 1, dtype=np.int64)
    np.add.at(totals, l_ok, line_total)
    out["orders"]["o_totalprice"] = totals[1:]

    return out


def _line_numbers(lines_per: np.ndarray) -> np.ndarray:
    total = int(lines_per.sum())
    ln = np.arange(total, dtype=np.int64)
    starts = np.cumsum(lines_per) - lines_per
    return ln - np.repeat(starts, lines_per) + 1


def _dedup(strings: list[str]) -> tuple[list[str], np.ndarray]:
    """(vocab, codes) for a list that may contain duplicates."""
    vocab: list[str] = []
    index: dict[str, int] = {}
    codes = np.empty(len(strings), dtype=np.int64)
    for i, s in enumerate(strings):
        c = index.get(s)
        if c is None:
            c = len(vocab)
            vocab.append(s)
            index[s] = c
        codes[i] = c
    return vocab, codes


def _vocab_codes(vocab: list[str], rng: np.random.Generator,
                 n: int) -> tuple[list[str], np.ndarray]:
    return vocab, rng.integers(0, len(vocab), n, dtype=np.int64)


# ---------------------------------------------------------------------------
# loading into the engine
# ---------------------------------------------------------------------------

def load_table(session: "Session", name: str,
               data: dict[str, object]) -> None:
    """Create `name` from TPCH_DDL and bulk-load generated arrays."""
    session.execute(f"drop table if exists {name}")
    session.execute(TPCH_DDL[name])
    info = session.catalog.table(session.current_db, name)
    store = session.storage.table_store(info.id)
    store.bulk_load(_physical_columns(info, store, data))


def _physical_columns(info, store, data: dict[str, object]) -> list:
    """Generated arrays in the store's physical encoding: string columns
    as codes of the store's dictionaries."""
    cols = []
    for c in info.columns:
        v = data[c.name]
        if isinstance(v, tuple):
            vocab, codes = v
            d = store.dictionaries[c.offset]
            remap = np.array([d.encode(s) for s in vocab], dtype=np.int64)
            cols.append(remap[codes])
        else:
            cols.append(np.asarray(v))
    return cols


def route_partitions(part, keys: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> np.ndarray:
    """The index into `part.defs` of each row's partition: what
    `PartitionInfo.route` gives row by row, in numpy. HASH takes the
    floor modulo of the key (Python's `%`, which `np.mod` computes for
    integers, negative keys too); RANGE the first partition whose bound
    is above the key; a NULL key (`valid` False) partition 0. Raises
    ValueError, as `route` does, for a key above the last RANGE bound."""
    keys = np.asarray(keys, dtype=np.int64)
    if part.kind == "hash":
        idx = np.mod(keys, len(part.defs))
    else:
        bounds = np.array([d.less_than for d in part.defs
                           if d.less_than is not None], dtype=np.int64)
        idx = np.searchsorted(bounds, keys, side="right")
        if part.defs[-1].less_than is not None:
            over = idx == len(part.defs)
            if valid is not None:
                over &= valid
            if over.any():
                v = int(keys[np.argmax(over)])
                raise ValueError(f"Table has no partition for value {v}")
    if valid is not None:
        idx = np.where(valid, idx, 0)
    return idx


def load_table_partitioned(session: "Session", name: str,
                           data: dict[str, object],
                           partition_by: str) -> list[int]:
    """Create `name` from TPCH_DDL with `partition_by` appended (e.g.
    "partition by hash(l_orderkey) partitions 4") and bulk-load the
    generated arrays: each row routed by `route_partitions` into its
    partition's store, one bulk load per partition. Handles come from
    the table's allocator (the first partition's store) in blocks, one
    block per partition, so they are unique across the table and the
    allocator covers them all. Returns the rows per partition."""
    session.execute(f"drop table if exists {name}")
    session.execute(TPCH_DDL[name].rstrip() + " " + partition_by)
    info = session.catalog.table(session.current_db, name)
    part = info.partition
    first = session.storage.table_store(part.defs[0].id)
    cols = _physical_columns(info, first, data)
    pidx = route_partitions(part, cols[part.col_offset])
    base = first._next_handle
    counts = []
    for k, d in enumerate(part.defs):
        rows = np.flatnonzero(pidx == k)
        if len(rows):
            store = session.storage.table_store(d.id)
            store._next_handle = base
            store.bulk_load([np.take(c, rows) for c in cols])
        base += len(rows)
        counts.append(len(rows))
    first._next_handle = max(first._next_handle, base)
    return counts


def load_tpch(session: "Session", sf: float = 0.01, seed: int = 42,
              tables: Optional[list[str]] = None) -> dict[str, dict[str, object]]:
    """Generate + load the whole TPC-H database; returns the raw arrays
    (useful for loading the same data into an oracle engine)."""
    data = generate_tpch(sf, seed)
    for name in tables or TPCH_TABLES:
        load_table(session, name, data[name])
    return data
