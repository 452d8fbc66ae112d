"""The port's exchange tier against the reference's: parallel/exchange.py's
routing and hash on the same seeded inputs, and the two exchanges inside
fragments (the distributed hc GROUP BY and the partitioned join, before
and after DML), on 8 `cpu` shard slots against the reference's 8 virtual
CPU devices (tests/conftest.py).

Counterparts of tests/test_exchange.py: `route_rows` delivers the same
received arrays, validity and overflow flag slot by slot as the
reference's `shard_map` over 8 devices (the overflow case of
tests/test_exchange.py:51 included); `mix_hash` gives the same int32
values (wrapping arithmetic); Q3 through the group exchange and Q12, Q3,
Q5 through a partitioned orders build give the rows and engine tags of
the reference's `DistCopClient`. Tolerance: none.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from torch_mesh_pairs import CPU8, explain, q, tpch_pair
from tidb_tpu.parallel import DistCopClient as RDist
from tidb_tpu.parallel import make_mesh as rmake
from tidb_tpu.parallel.dist import shard_map as rshard_map
from tidb_tpu.parallel.exchange import capacity_for as rcap
from tidb_tpu.parallel.exchange import mix_hash as rmix
from tidb_tpu.parallel.exchange import route_cols as rroute_cols
from tidb_tpu.parallel.exchange import route_rows as rroute
from tidb_tpu_torch.parallel import DistCopClient, make_mesh
from tidb_tpu_torch.parallel.dist import AXIS, P, shard_map
from tidb_tpu_torch.parallel.exchange import (
    abs32,
    capacity_for,
    mix_hash,
    route_cols,
    route_rows,
)
from tidb_tpu_torch.session import Session

N_DEV = 8


def _ref_route(dest, vals, cap):
    """The reference's route_rows over 8 devices: per device the received
    values, validity and the replicated overflow."""
    mesh = rmake()

    def kern(d, v):
        recv, rv, ov = rroute(d, [v], "shard", N_DEV, cap)
        return {"vals": recv[0].reshape(1, -1),
                "valid": rv.reshape(1, -1), "ov": ov}

    sh = NamedSharding(mesh, JP("shard"))
    f = jax.jit(rshard_map(
        kern, mesh=mesh, in_specs=(JP("shard"), JP("shard")),
        out_specs={"vals": JP("shard", None), "valid": JP("shard", None),
                   "ov": JP()}))
    out = jax.device_get(f(jax.device_put(jnp.asarray(dest), sh),
                           jax.device_put(jnp.asarray(vals), sh)))
    return (np.asarray(out["vals"]), np.asarray(out["valid"]),
            int(out["ov"]))


def _port_route(dest, vals, cap):
    def kern(d, v):
        recv, rv, ov = route_rows(d, [v], AXIS, N_DEV, cap)
        return {"vals": recv[0][None], "valid": rv[None], "ov": ov}

    f = shard_map(kern, make_mesh(CPU8), in_specs=(P(AXIS), P(AXIS)),
                  out_specs={"vals": P(AXIS), "valid": P(AXIS), "ov": P()})
    out = f(torch.as_tensor(dest), torch.as_tensor(vals))
    return (out["vals"].numpy(), out["valid"].numpy(), int(out["ov"]))


@pytest.mark.parametrize("seed,m_total,cap", [
    (1, 2048, None), (2, 4096, None), (3, 2048, 16), (4, 1024, 40)])
def test_route_rows_equals_reference(seed, m_total, cap):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2**31, 2**31 - 1, m_total, dtype=np.int64) \
        .astype(np.int32)
    dest = rng.integers(0, N_DEV, m_total).astype(np.int32)
    if cap is None:
        cap = capacity_for(m_total // N_DEV, N_DEV)
        assert cap == rcap(m_total // N_DEV, N_DEV)
    got = _port_route(dest, vals, cap)
    want = _ref_route(dest, vals, cap)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]
    if got[2] == 0:
        for d in range(N_DEV):
            recv = np.sort(got[0][d][got[1][d]])
            assert np.array_equal(recv, np.sort(vals[dest == d])), d


def test_route_rows_detects_overflow():
    """tests/test_exchange.py:51: every row bound for slot 0 past a
    16-row capacity is an overflow on every slot, never a truncation."""
    dest = np.zeros(2048, dtype=np.int32)
    got = _port_route(dest, dest, 16)
    want = _ref_route(dest, dest, 16)
    assert got[2] == want[2] > 0
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_route_cols_equals_reference():
    rng = np.random.default_rng(11)
    m = 1024
    d0 = rng.integers(-1000, 1000, m).astype(np.int32)
    v0 = rng.random(m) < 0.9
    mask = rng.random(m) < 0.7
    dest = rng.integers(0, N_DEV, m).astype(np.int32)
    cap = capacity_for(m // N_DEV, N_DEV)

    def pk(d, a, av, mk):
        cols, nm, ov = route_cols(d, [(a, av)], mk, AXIS, N_DEV, cap)
        return {"a": cols[0][0], "av": cols[0][1], "m": nm, "ov": ov}

    f = shard_map(pk, make_mesh(CPU8), in_specs=(P(AXIS),) * 4,
                  out_specs={"a": P(AXIS), "av": P(AXIS), "m": P(AXIS),
                             "ov": P()})
    got = f(*(torch.as_tensor(x) for x in (dest, d0, v0, mask)))
    mesh = rmake()

    def rk(d, a, av, mk):
        cols, nm, ov = rroute_cols(d, [(a, av)], mk, "shard", N_DEV, cap)
        return {"a": cols[0][0], "av": cols[0][1], "m": nm, "ov": ov}

    sh = NamedSharding(mesh, JP("shard"))
    rf = jax.jit(rshard_map(
        rk, mesh=mesh, in_specs=(JP("shard"),) * 4,
        out_specs={"a": JP("shard"), "av": JP("shard"), "m": JP("shard"),
                   "ov": JP()}))
    want = jax.device_get(rf(*(jax.device_put(jnp.asarray(x), sh)
                               for x in (dest, d0, v0, mask))))
    for k in ("a", "av", "m"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert int(got["ov"]) == int(want["ov"]) == 0


def test_mix_hash_equals_reference():
    rng = np.random.default_rng(5)
    k1 = np.concatenate([
        np.array([0, 1, -1, 2**31 - 1, -2**31], dtype=np.int64),
        rng.integers(-2**31, 2**31 - 1, 4091)]).astype(np.int32)
    k2 = rng.integers(-2**31, 2**31 - 1, 4096).astype(np.int32)
    for keys in ([k1], [k1, k2]):
        got = mix_hash([torch.as_tensor(k) for k in keys]).numpy()
        want = np.asarray(rmix([jnp.asarray(k) for k in keys]))
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert np.array_equal(
            (abs32(torch.as_tensor(got)) % N_DEV).numpy(),
            np.asarray(jnp.abs(jnp.asarray(want)) % N_DEV))
    h = mix_hash([torch.arange(4096, dtype=torch.int32)]).numpy()
    counts = np.bincount(np.abs(h.astype(np.int64)) % N_DEV,
                         minlength=N_DEV)
    assert counts.min() > 4096 // N_DEV // 2


@pytest.fixture(scope="module")
def corpus():
    """SF0.01 seed 13: orders = 15,000, an l_orderkey space past 8,192."""
    ref, port = tpch_pair(0.01, 13)
    return ref.single, port.single


def _dist(pair, threshold=None):
    r, p = pair
    rc, pc = RDist(rmake()), DistCopClient(make_mesh(CPU8))
    if threshold is not None:
        rc.partition_join_threshold = threshold
        pc.partition_join_threshold = threshold
    return (type(r)(r.storage, cop=rc),
            Session(p.storage, cop=pc, device="cpu"))


def test_distributed_hc_groupby(corpus):
    """Q3's full l_orderkey group space shards through the group
    exchange: rows and tags equal the reference's."""
    from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
    rd, pd = _dist(corpus)
    sql = TPCH_QUERIES["q3"]
    assert q(pd, sql) == q(rd, sql) == q(corpus[1], sql)
    eng = explain(pd, sql)
    assert eng == explain(rd, sql)
    assert {e for e, _ in eng} & {"device[fat]", "device[hc]"}


def test_partitioned_join(corpus):
    """The orders build (15,000 rows past a 1,000-row threshold) shards by
    key, probe rows route over the slots; Q12, Q3, Q5 exact."""
    from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
    rd, pd = _dist(corpus, 1000)
    for qn, want in (("q12", {"device[agg]"}),
                     ("q3", {"device[hc]", "device[fat]"}),
                     ("q5", {"device[agg]"})):
        sql = TPCH_QUERIES[qn]
        assert q(pd, sql) == q(rd, sql) == q(corpus[1], sql), qn
        eng = explain(pd, sql)
        assert eng == explain(rd, sql), qn
        assert {e for e, _ in eng} & want, qn
        assert [k for k in pd.cop._col_cache if "partb" in str(k)]


def test_partitioned_join_with_dml_visibility(corpus):
    """Deleted build rows stay invisible through the exchange: inside an
    open transaction, the meshed session and a plain session sharing its
    transaction answer alike, on both packages."""
    from tidb_tpu.session import Session as RSession
    from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
    rd, pd = _dist(corpus, 1000)
    sql = TPCH_QUERIES["q12"]
    outs = []
    for s, S, kw in ((rd, RSession, {}), (pd, Session, {"device": "cpu"})):
        s.execute("BEGIN")
        s.execute("DELETE FROM orders WHERE o_orderkey < 2000")
        single = S(s.storage, **kw)
        single.txn = s.txn
        single.in_explicit_txn = True
        got, want = q(s, sql), q(single, sql)
        single.txn = None
        single.in_explicit_txn = False
        s.execute("ROLLBACK")
        outs.append((got, want))
    assert outs[1][0] == outs[1][1] == outs[0][0] == outs[0][1]
    assert q(pd, sql) == q(corpus[1], sql)
