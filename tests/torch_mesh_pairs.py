"""Reference and port sessions over the same seeded data, single and meshed.

The reference's mesh runs on the 8 virtual CPU devices `tests/conftest.py`
forces; the port's on 8 `cpu` shard slots (`MeshPlane(devices=[cpu] * 8)`).
Each side's data comes from its own package's seeded generators, whose
arrays are equal (tests/test_torch_mesh.py holds them so).
"""

from __future__ import annotations

import re

import torch

CPU8 = [torch.device("cpu")] * 8

# a device name of either package's per-device telemetry
_DEVICE = re.compile(r"TFRT_CPU_\d+|cpu/\d+")


def mask_devices(v):
    """Device names -> '<dev>' inside rows, dicts and strings."""
    if isinstance(v, str):
        return _DEVICE.sub("<dev>", v)
    if isinstance(v, (list, tuple)):
        return type(v)(mask_devices(x) for x in v)
    if isinstance(v, dict):
        return {mask_devices(k): mask_devices(x) for k, x in v.items()}
    return v


def ref_plane(**kw):
    from tidb_tpu.copr import mesh as RM
    cfg = dict(enabled=True, shard_threshold_rows=512)
    cfg.update(kw)
    return RM.MeshPlane(RM.MeshConfig(**cfg))


def port_plane(**kw):
    from tidb_tpu_torch.copr import mesh as PM
    cfg = dict(enabled=True, shard_threshold_rows=512)
    cfg.update(kw)
    return PM.MeshPlane(PM.MeshConfig(**cfg), devices=CPU8)


class Side:
    """One package's single-device and meshed sessions over one storage."""

    def __init__(self, pkg: str, single, plane) -> None:
        self.pkg = pkg
        self.single = single
        self.plane = plane
        self.mesh = self.session(plane)

    def session(self, plane):
        S = type(self.single)
        kw = {} if self.pkg == "ref" else {"device": "cpu"}
        return S(self.single.storage, cop=plane.client_for(
            self.single.storage), **kw)


def ref_single():
    from tidb_tpu.copr.client import CopClient
    from tidb_tpu.session import Session
    return Session(cop=CopClient())


def port_single():
    from tidb_tpu_torch.copr.client import CopClient
    from tidb_tpu_torch.session import Session
    return Session(cop=CopClient("cpu"), device="cpu")


def lineitem_pair(n_rows: int, **plane_kw) -> tuple[Side, Side]:
    """lineitem of `n_rows` (bench/tpch.py, seed 42) on both packages."""
    from tidb_tpu.bench import tpch as RT
    from tidb_tpu_torch.bench import tpch as PT
    r, p = ref_single(), port_single()
    RT.load_lineitem(r, n_rows)
    PT.load_lineitem(p, n_rows)
    return Side("ref", r, ref_plane(**plane_kw)), \
        Side("port", p, port_plane(**plane_kw))


def tpch_pair(sf: float, seed: int, **plane_kw) -> tuple[Side, Side]:
    """All eight TPC-H tables (bench/tpch_data.py) on both packages."""
    from tidb_tpu.bench import tpch_data as RD
    from tidb_tpu_torch.bench import tpch_data as PD
    r, p = ref_single(), port_single()
    for D, s in ((RD, r), (PD, p)):
        data = D.generate_tpch(sf, seed)
        for t in D.TPCH_DDL:
            D.load_table(s, t, data[t])
    return Side("ref", r, ref_plane(**plane_kw)), \
        Side("port", p, port_plane(**plane_kw))


def cells(rows) -> list:
    """Rows of either package in one exact form (a Decimal as (unscaled,
    scale), a float as its hex form: `tpch_requests.sql_cells`)."""
    from tidb_tpu_torch.bench.tpch_requests import sql_cells
    return sql_cells(rows)


def q(session, sql) -> list:
    """A statement's rows in the form of `cells`."""
    return cells(session.query(sql))


def explain(session, sql) -> list:
    """(engine, mesh cell) of every engine-tagged EXPLAIN ANALYZE row."""
    rows = session.execute("EXPLAIN ANALYZE " + sql).rows
    return [(r[3], r[5]) for r in rows if r[3]]


def stages(session, sql) -> str:
    rows = session.execute("EXPLAIN ANALYZE " + sql).rows
    return " ".join(str(r[4]) for r in rows if r[4])
