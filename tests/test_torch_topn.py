"""TopN consumers of the fragment executor: the port vs the JAX reference.

(a) topnpack's int32 functions (`pair_digits`, `digit_sort_keys`,
    `avg_sort_keys`, `composite_score`) against the reference's on the same
    inputs, every output int32, and the reference's 512-case AVG ordering
    property run through the port;
(b) hcagg's pieces (`segment_bounds`, `seg_sum_pairs`, `_suffix_min`,
    `candidate_blocks_sound`, `sort_by_keys`) against the reference's;
(c) a fact/dimension corpus (copied from tests/test_topn_device.py): the
    join TopN row fragments, the fused join+agg+TopN ("fat") fragments and
    their AVG variants are captured from a reference session and run
    through the port, whole-epoch and in 2,048-row tiles on both clients;
(d)-(g) the gates: the fused cut's boundary tie (`fat-boundary`, on
    FAT_QUERIES[2] without its tie-breaking key), an
    unpackable TopN key set (row-bitmask mode), the non-fused hc TopN
    (`MAX_DIGIT_PAIRS = 0` in both packages) and the sorted body's
    `group-overflow`;
(h) the corpus's single-table TopN requests (the reference's SCAN_QUERIES:
    mixed directions, NULL ordering, ties at the cut) through
    `CopClient.execute`, whole-epoch and in 2,048-row tiles.

All inputs are made from seeds with numpy. Tolerance: exact, engine tag
included; row fragments compare column by column in the order returned,
aggregations as sorted partial-layout rows. Where the reference concedes
to its host interpreter, so does the port: the same rows, tagged
`host(fragment:<reason>)`.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import client as JC
from tidb_tpu.copr import fragment as JF
from tidb_tpu.copr import hcagg as JH
from tidb_tpu.copr import topnpack as JT
from tidb_tpu.plan.fragment import FragmentDAG as RefFragmentDAG
from tidb_tpu.session import Session
from tidb_tpu.types.value import Decimal
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr import fragment as PF
from tidb_tpu_torch.copr import hcagg as PH
from tidb_tpu_torch.copr import topnpack as PT
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.plan.fragment import FragmentDAG


def _same_i32(got, want):
    """Port tensors vs reference arrays: int32 and equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


# ---- (a) topnpack --------------------------------------------------------------

def _pair_inputs(seed, n=4000):
    """Two pair stacks in the sumexact layout: three limbs at shift 0 and
    two at shift 5 (split across digits), hi small, lo below 2^25, signed
    top limbs."""
    rng = np.random.default_rng(seed)
    out = []
    for shift, L in ((0, 3), (5, 2)):
        p = np.zeros((L, 2, n), np.int32)
        p[:, 0] = rng.integers(0, 3, (L, n))
        p[:, 1] = rng.integers(-(1 << 24), 1 << 25, (L, n))
        p[L - 1, 0] = rng.integers(-3, 3, n)
        out.append((shift, p))
    return out


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_pair_digits_and_digit_sort_keys_match_reference(seed, desc):
    contribs = _pair_inputs(seed)
    want = JT.pair_digits([(s, jnp.asarray(p)) for s, p in contribs])
    got = PT.pair_digits([(s, torch.from_numpy(p)) for s, p in contribs])
    _same_i32(got, want)
    _same_i32(PT.digit_sort_keys(got, desc), JT.digit_sort_keys(want, desc))


def _avg_cases():
    """The reference's AVG property inputs (tests/test_topn_device.py)."""
    rng = np.random.default_rng(11)
    n = 512
    sums = rng.integers(-(10 ** 13), 10 ** 13, n)
    cnts = rng.integers(1, (1 << 18) - 1, n)
    cnts[:16] = rng.integers(1, 5, 16)
    sums[:16] = rng.integers(-8, 8, 16)
    sums[0], cnts[0], sums[1], cnts[1] = 6, 4, 3, 2
    sums[2] = sums[3] = 0
    nulls = np.zeros(n, bool)
    nulls[4:7] = True
    L = 6
    pairs = np.zeros((L, 2, n), np.int32)
    x = sums.copy()
    for i in range(L):
        pairs[i, 1] = (x & 0xFFF) if i < L - 1 else x
        x >>= 12
    return sums, cnts, nulls, pairs


@pytest.mark.parametrize("desc", [False, True])
def test_avg_sort_keys_match_reference_and_host_order(desc):
    sums, cnts, nulls, pairs = _avg_cases()
    digs = PT.pair_digits([(0, torch.from_numpy(pairs))])
    keys = PT.avg_sort_keys(digs, torch.from_numpy(cnts.astype(np.int32)),
                            torch.from_numpy(nulls), desc)
    jdigs = JT.pair_digits([(0, jnp.asarray(pairs))])
    _same_i32(keys, JT.avg_sort_keys(
        jdigs, jnp.asarray(cnts.astype(np.int32)), jnp.asarray(nulls), desc))
    # the property: the lexicographic rank of the key rows is the rank of
    # the host's rounded AVG (NULL first-ASC / last-DESC)
    kmat = np.stack([k.numpy() for k in keys], axis=1)
    _, dev_rank = np.unique(kmat, axis=0, return_inverse=True)
    host_keys = []
    for i in range(len(sums)):
        if nulls[i]:
            host_keys.append((1, 0) if desc else (-1, 0))
            continue
        q = Decimal(int(sums[i]), 0).div(
            Decimal.from_int(int(cnts[i]))).unscaled
        host_keys.append((0, -q if desc else q))
    uniq = sorted(set(host_keys))
    host_rank = np.array([uniq.index(hk) for hk in host_keys])
    assert np.array_equal(dev_rank.reshape(-1), host_rank)


def test_composite_score_matches_reference():
    rng = np.random.default_rng(5)
    n = 3000
    ranks = rng.permutation(11).astype(np.int32)
    specs = [
        {"expr": 0, "desc": True, "kind": "int", "lo": -50, "hi": 99,
         "card": 151},
        {"expr": 1, "desc": False, "kind": "rank", "card": 12},
        {"expr": 2, "desc": False, "kind": "int", "lo": 0, "hi": 6,
         "card": 8},
        {"expr": 1, "desc": True, "kind": "rank", "card": 12},
    ]
    vals = [rng.integers(-60, 110, n), rng.integers(0, 11, n),
            rng.integers(0, 7, n)]
    valids = [rng.random(n) > 0.1 for _ in vals]
    ref_cols = [(jnp.asarray(v.astype(np.int32)), jnp.asarray(m))
                for v, m in zip(vals, valids)]
    port_cols = [(torch.from_numpy(v.astype(np.int32)), torch.from_numpy(m))
                 for v, m in zip(vals, valids)]
    want = JT.composite_score(
        specs, ref_cols, {("topn_rank", 1): jnp.asarray(ranks),
                          ("topn_rank", 3): jnp.asarray(ranks)},
        lambda e, cols, prepared: cols[e])
    got = PT.composite_score(
        specs, port_cols, {("topn_rank", 1): torch.from_numpy(ranks),
                           ("topn_rank", 3): torch.from_numpy(ranks)},
        lambda e, cols, prepared: cols[e])
    _same_i32([got], [want])


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_topk_desc_breaks_ties_by_the_lower_row(dtype):
    rng = np.random.default_rng(8)
    score = rng.integers(-3, 4, 5000).astype(dtype)
    if dtype == "float32":
        score[::7] = -np.inf
    got = PT.topk_desc(torch.from_numpy(score), 300).numpy()
    want = np.lexsort((np.arange(len(score)), -score))[:300]
    assert np.array_equal(got, want)


# ---- (b) hcagg -------------------------------------------------------------------

def _sorted_runs(seed, n, n_keys=2):
    rng = np.random.default_rng(seed)
    keys = [np.sort(rng.integers(0, n // 20, n)).astype(np.int32)]
    for _ in range(n_keys - 1):
        keys.append(rng.integers(0, 3, n).astype(np.int32))
    order = np.lexsort(keys[::-1])
    keys = [k[order] for k in keys]
    valid = np.ones(n, bool)
    valid[-37:] = False
    return keys, valid


def test_segment_bounds_and_seg_sum_pairs_match_reference():
    n = 10_007  # not a multiple of the 4,096-row prefix block
    keys, valid = _sorted_runs(3, n)
    j_start, j_end = JH.segment_bounds([jnp.asarray(k) for k in keys],
                                       jnp.asarray(valid))
    p_start, p_end = PH.segment_bounds([torch.from_numpy(k) for k in keys],
                                       torch.from_numpy(valid))
    assert np.array_equal(p_start.numpy(), np.asarray(j_start))
    _same_i32([p_end], [j_end])
    rng = np.random.default_rng(4)
    iota = np.arange(n, dtype=np.int32)
    for limb in (rng.integers(0, 4096, n), rng.integers(-2048, 2048, n)):
        limb = limb.astype(np.int32)
        want = JH.seg_sum_pairs(jnp.asarray(limb), jnp.asarray(iota), j_end)
        got = PH.seg_sum_pairs(torch.from_numpy(limb),
                               torch.from_numpy(iota), p_end)
        _same_i32(got, want)


def test_suffix_min_matches_reference():
    s = np.random.default_rng(6).integers(0, 10_000, 5001).astype(np.int32)
    _same_i32([PH._suffix_min(torch.from_numpy(s))],
              [JH._suffix_min(jnp.asarray(s))])


@pytest.mark.parametrize("case", range(6))
def test_candidate_blocks_sound_matches_reference(case):
    rng = np.random.default_rng(case)
    picked = rng.random(64) < 0.9
    score = np.sort(rng.integers(0, 6, 64).astype(np.float32))[::-1]
    if case % 2:
        picked[:] = True  # exhausted buffers: the score gap decides
    k, blocks = [(5, 1), (5, 1), (3, 2), (20, 2), (63, 1), (64, 4)][case]
    assert PH.candidate_blocks_sound(picked, score, k, blocks) == \
        JH.candidate_blocks_sound(picked, score, k, blocks)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_sort_by_keys_sorts_as_reference(n_keys):
    rng = np.random.default_rng(n_keys)
    n = 9000
    keys = [rng.integers(-5, 40, n).astype(np.int32) for _ in range(n_keys)]
    keys[0][::11] = PH._I32_MAX
    vals = rng.integers(0, 4096, n).astype(np.int32)
    j_sk, j_perm = JH.sort_by_keys([jnp.asarray(k) for k in keys])
    p_sk, p_perm = PH.sort_by_keys([torch.from_numpy(k) for k in keys])
    _same_i32(p_sk, j_sk)
    # rows of one segment may come in another order: the segment sums
    # that follow from each permutation are the same
    valid = np.asarray(j_sk[0]) != PH._I32_MAX
    j_start, j_end = JH.segment_bounds(j_sk, jnp.asarray(valid))
    p_start, p_end = PH.segment_bounds(p_sk, torch.from_numpy(valid))
    iota = np.arange(n, dtype=np.int32)
    want = JH.seg_sum_pairs(jnp.asarray(vals)[j_perm], jnp.asarray(iota),
                            j_end)
    got = PH.seg_sum_pairs(torch.from_numpy(vals)[p_perm],
                           torch.from_numpy(iota), p_end)
    starts = np.asarray(j_start)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy()[starts], np.asarray(w)[starts])


# ---- (c)-(g) the corpus ------------------------------------------------------------

N_FACT = 12_000
N_DIM = 3_000

SCAN_QUERIES = [
    # mixed directions, NULLs in b (first in ASC, last in DESC), ties
    "select k, b, c from f where c > -40 "
    "order by b desc, c, k desc limit 9",
    "select k, b, c from f where c > -40 "
    "order by b, c desc limit 6",
    # LIMIT beyond the survivor count
    "select k, b, c from f where c > 93 order by b desc, c limit 50",
    # tie-heavy keys: the cut resolves by row order
    "select k, b from f order by b desc limit 11",
]

JOIN_QUERIES = [
    "select k, x, b from f, dim where fg = dg "
    "order by x desc, b, k limit 7",
    # dictionary string key: order-preserving rank table on the device
    "select k, s, c from f, dim where fg = dg "
    "order by s, k desc limit 8",
    "select k, x, c from f, dim where fg = dg and c > 94 "
    "order by x, c desc, k limit 40",
]

FAT_QUERIES = [
    "select dg, x, sum(v) from f, dim where fg = dg "
    "group by dg, x order by sum(v) desc, x limit 5",
    "select dg, x, sum(v) from f, dim where fg = dg "
    "group by dg, x order by sum(v), dg desc limit 6",
    # coarse values force sum ties at the boundary (fat-boundary)
    "select dg, sum(w) from f, dim where fg = dg "
    "group by dg order by sum(w) desc, dg limit 7",
]

AVG_FAT_QUERIES = [
    "select dg, x, avg(v) a from f, dim where fg = dg "
    "group by dg, x order by a desc, dg limit 6",
    "select dg, x, avg(v) a from f, dim where fg = dg "
    "group by dg, x order by a, dg desc limit 7",
    "select dg, x, avg(w) a, sum(v) s from f, dim where fg = dg "
    "group by dg, x order by a desc, s, dg limit 5",
]

CORPUS = JOIN_QUERIES + FAT_QUERIES + AVG_FAT_QUERIES
# the reference's engine per corpus query (whole-epoch and tiled alike):
# AVG_FAT_QUERIES[2]'s coarse averages tie at the candidate buffer's
# score boundary, which the reference concedes to its host interpreter
CORPUS_ENGINES = ["device[topn]"] * 3 + ["device[fat]"] * 5 + \
    ["host(fragment:hc-boundary)"]
# FAT_QUERIES[2] without its dg tie-break: the 0/1 sums tie across the
# cut, so the fused cut's boundary check refuses it
FAT_TIE = ("select dg, sum(w) from f, dim where fg = dg "
           "group by dg order by sum(w) desc limit 7")
# k spans 12,000 codes, fg 3,000 and c 150: 5.4e9 > 2^31, no int32 pack
UNPACKABLE = ("select k, fg, c from f, dim where fg = dg "
              "order by k, fg, c desc limit 5")
# (dg, b): 3,001 x 9 codes exceed the dense space; fg (for dg) and b are
# probe columns but not run-ordered, so the sorted body sorts by both
SORTED_HAVING = ("select dg, b, sum(v) from f, dim where fg = dg "
                 "group by dg, b having sum(v) > -100000")


def _bulk(session, name, ddl, cols, valids=None):
    session.execute(ddl)
    info = session.catalog.table("test", name)
    store = session.storage.table_store(info.id)
    store.bulk_load(cols, valids)
    return store


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    base = Session(cop=JC.CopClient())
    k = np.arange(N_FACT, dtype=np.int64)
    fg = rng.integers(0, N_DIM, N_FACT)
    b = rng.integers(0, 7, N_FACT)
    b_valid = rng.random(N_FACT) > 0.12
    c = rng.integers(-50, 100, N_FACT)
    v = rng.integers(-30, 30, N_FACT)
    w = rng.integers(0, 2, N_FACT)  # coarse: many equal sums
    _bulk(base, "f",
          "create table f (k bigint primary key, fg int, b int, "
          "c int, v int, w int)",
          [k, fg, b, c, v, w], [None, None, b_valid, None, None, None])
    dg = np.arange(N_DIM, dtype=np.int64)
    x = rng.integers(0, 40, N_DIM)
    base.execute("create table dim (dg bigint primary key, x int, "
                 "s varchar(16))")
    dinfo = base.catalog.table("test", "dim")
    dstore = base.storage.table_store(dinfo.id)
    d = dstore.dictionaries[2]
    svals = np.array([d.encode(f"name-{i % 11:02d}") for i in range(N_DIM)],
                     dtype=np.int64)
    dstore.bulk_load([dg, x, svals])
    return base


_CAPTURED: dict = {}


def _capture(corpus, sql):
    """(fragment, snapshots, reference result) of the statement's one
    fragment call."""
    if sql not in _CAPTURED:
        calls = []
        run = JF.execute_fragment

        def frag_call(cop, frag, snaps):
            r = run(cop, frag, snaps)
            calls.append((frag, snaps, r))
            return r

        with mock.patch.object(JF, "execute_fragment", frag_call):
            corpus.query(sql)
        assert len(calls) == 1, sql
        _CAPTURED[sql] = calls[0]
    return _CAPTURED[sql]


def _port(frag, snaps, cop=None):
    return PF.execute_fragment(
        cop or CopClient("cpu"), request_from_reference(frag),
        {tid: snapshot_from_reference(s) for tid, s in snaps.items()})


def _assert_same(frag, snaps, ref, cop=None):
    """The port gives the reference's chunks and tag (on a device path or
    the host interpreter's)."""
    got = _port(frag, snaps, cop)
    assert got.engine == ref.engine
    if frag.agg is None:
        assert len(got.chunks) == len(ref.chunks)
        cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
        assert len(cols) == len(want) and len(want[0])
        for a, b in zip(cols, want):
            assert np.array_equal(a, b)
    else:
        rows = TR.partial_rows(got.chunks)
        assert rows and rows == TR.partial_rows(ref.chunks)


@pytest.mark.parametrize("tiled", [False, True], ids=["epoch", "tiled"])
@pytest.mark.parametrize("qi", range(len(CORPUS)))
def test_corpus_matches_reference(corpus, qi, tiled):
    frag, snaps, ref = _capture(corpus, CORPUS[qi])
    assert ref.engine == CORPUS_ENGINES[qi]
    kind = "topn" if qi < len(JOIN_QUERIES) else "fat"
    cop = CopClient("cpu")
    if tiled:
        # the fact table's 12,000 rows stream as 6 tiles (TopN: one chunk
        # per tile; the hc modes stage the whole epoch)
        ref_cop = JC.CopClient()
        ref_cop.TILE_ROWS = cop.TILE_ROWS = 2048
        ref = JF.execute_fragment(ref_cop, frag, snaps)
        if kind == "topn":
            assert len(ref.chunks) == 6
    _assert_same(frag, snaps, ref, cop)


def test_fat_boundary_tie_concedes_as_reference(corpus):
    # coarse 0/1 sums tie at the 7th/8th group: the reference's host
    # reason is fat-boundary, and so is the port's, with the host
    # interpreter's rows
    frag, snaps, ref = _capture(corpus, FAT_TIE)
    assert ref.engine == "host(fragment:fat-boundary)"
    _assert_same(frag, snaps, ref)


def test_unpackable_topn_stays_in_row_mode(corpus):
    frag, snaps, ref = _capture(corpus, UNPACKABLE)
    assert frag.topn is not None and ref.engine == "device[rows]"
    _assert_same(frag, snaps, ref)


@pytest.mark.parametrize("sql", [FAT_QUERIES[0], FAT_QUERIES[1],
                                 AVG_FAT_QUERIES[0]])
def test_unfused_hc_topn_matches_reference(corpus, sql):
    # no digit pairs admitted: the fused cut is off, and the candidate
    # buffer (4k rows) goes to the host as it is
    frag, snaps, _ = _capture(corpus, sql)
    with mock.patch.object(JT, "MAX_DIGIT_PAIRS", 0), \
            mock.patch.object(PT, "MAX_DIGIT_PAIRS", 0):
        ref = JF.execute_fragment(JC.CopClient(), frag, snaps)
        assert ref.engine == "device[hc]"
        _assert_same(frag, snaps, ref)


def test_sorted_body_group_overflow_matches_reference(corpus):
    # the ~10,000 (dg, b) groups exhaust a 256-group HAVING buffer
    frag, snaps, ref = _capture(corpus, SORTED_HAVING)
    assert ref.engine == "device[hc]"
    _assert_same(frag, snaps, ref)
    with mock.patch.object(RefFragmentDAG, "HAVING_CAP", 256):
        ref = JF.execute_fragment(JC.CopClient(), frag, snaps)
    assert ref.engine == "host(fragment:group-overflow)"
    with mock.patch.object(FragmentDAG, "HAVING_CAP", 256):
        _assert_same(frag, snaps, ref)


# ---- (h) single-table TopN requests (CopClient.execute) ------------------------

_CAPTURED_DAGS: dict = {}


def _capture_dag(corpus, sql):
    """(CopDAG, snapshot, reference result) of the statement's one
    single-table request."""
    if sql not in _CAPTURED_DAGS:
        calls = []
        run = JC.CopClient.execute

        def dag_call(self, dag, snap):
            r = run(self, dag, snap)
            calls.append((dag, snap, r))
            return r

        with mock.patch.object(JC.CopClient, "execute", dag_call):
            corpus.query(sql)
        assert len(calls) == 1, sql
        _CAPTURED_DAGS[sql] = calls[0]
    return _CAPTURED_DAGS[sql]


@pytest.mark.parametrize("tiled", [False, True], ids=["epoch", "tiled"])
@pytest.mark.parametrize("qi", range(len(SCAN_QUERIES)))
def test_scan_topn_matches_reference(corpus, qi, tiled):
    dag, snap, ref = _capture_dag(corpus, SCAN_QUERIES[qi])
    assert dag.topn is not None
    cop = CopClient("cpu")
    if tiled:
        # 12,000 rows in 2,048-row tiles: one candidate chunk per tile
        ref_cop = JC.CopClient()
        ref_cop.TILE_ROWS = cop.TILE_ROWS = 2048
        ref = ref_cop.execute(dag, snap)
        assert len(ref.chunks) == 6
    assert ref.engine == "device"
    got = cop.execute(request_from_reference(dag),
                      snapshot_from_reference(snap))
    assert got.engine == ref.engine and not got.is_partial_agg
    assert len(got.chunks) == len(ref.chunks)
    cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
    assert len(cols) == len(want) and len(want[0])
    for a, b in zip(cols, want):
        assert np.array_equal(a, b)
