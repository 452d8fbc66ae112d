"""Mesh plane: process-wide mesh of shard slots + placement-aware coprocessor.

Port of `tidb_tpu/copr/mesh.py`. The multi-chip data plane: the sharded
client (parallel/dist.py) exists, and this module decides when to use it.

* **MeshPlane**: one per process. Owns the 1-D mesh of shard slots
  (`parallel.dist.Mesh`; `devices=` names the slot devices, and a device
  may repeat: `[torch.device("cuda:0")] * 8` is an 8-slot mesh on one
  card), the placement policy, and the per-storage shared clients.
  Configured from the server's `[mesh]` TOML section or the
  `TIDB_TPU_MESH*` env knobs for embedded use. The process plane's
  default slot list is the first card, so unless `axis-size` asks for
  more than one slot (and always without a card) it is inactive and
  `client_for` hands out the plain `CopClient`, as the reference does on
  one TPU.

* **Placement policy**, per TABLE EPOCH, decided once per plan node
  (executor/engine.py opens `placement_scope` around every dispatch):
  - epochs with >= `shard-threshold-rows` rows shard on the row axis;
  - smaller epochs run the unchanged single-device path;
  - join build sides REPLICATE (broadcast exchange) unless bigger than
    `replicate-threshold-bytes` or the row threshold, in which case they
    shard by key and probe rows route over the mesh (hash-partition
    exchange, parallel/exchange.py), as TiDB's MPP election
    (planner/core/fragment.go:45).

* **Persistent sharded residency**: staged columns are PLACED at
  creation (client._place_cols) and the placed tensors are what the
  epoch caches hold, so a sharded epoch stays resident across queries
  and sessions. DML that folds a new epoch frees the old epoch's tensors
  eagerly (Storage.add_epoch_listener).

* **Exact single-device path**: `mesh.enabled = false`, fewer than two
  slots, a session on another device, or a below-threshold table
  all take the single-device path: `client_for` hands out a plain
  CopClient when the plane is inactive, and MeshCopClient in `single`
  mode dispatches every hook to the base implementations.

Results equal the single-device path's: the sharded programs produce the
same exact limb partials and merge them with int32 collectives.

What differs from the reference: the slots run on ONE physical device
(a slot list over several raises NotInSlice), so `axis-size = 0` (the
reference's "every device") is one slot and an inactive plane, and
`axis-size = k` is k slots on the first card where the reference takes
its first k devices; the routed-bytes count (`MESH_RESHARD_BYTES`,
`routed_bytes`, the `mesh` column's `routed=`) is the reference's: every
probe column and the mask of a fragment that routes, at dispatch. The
port's hc exchange routes only the columns its aggregation reads (see
parallel/dist.py), so for an hc fragment that count is more than its
exchange moves; `parallel.dist.routed_payload_bytes()` totals what the
port's exchanges are handed. A "compile" in the flight recorder is
the first dispatch of a program signature (PyTorch builds no program);
the per-device ledger keeps one row per SLOT (`<device>/<slot>`), with a
sharded tensor's bytes split over the slots, a replicated one's counted
in full on each and a single-device one's on slot 0, as the reference
counts its devices; and the memory watermark compares each PHYSICAL
device's unique tensor bytes with its capacity (`torch.cuda.mem_get_info`
on a card, none on the CPU, where the watermark is off as in the
reference).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..errors import NotInSlice
from ..parallel.dist import (
    AXIS,
    DistCopClient,
    P,
    _collective_merge,
    make_mesh,
    physical,
    placement_of,
    shard_map,
)
from ..util import failpoint
from .client import CopClient, _dag_key, _obj_nbytes, widen32
from .eval import selection_mask


@dataclass
class MeshConfig:
    """The `[mesh]` knobs (config.py MeshSection mirrors this)."""

    enabled: bool = True
    # slots in the mesh; 0 = the slot list as given (the process
    # plane's: one slot on the first card)
    axis_size: int = 0
    # epochs with at least this many rows shard on the row axis
    shard_threshold_rows: int = 1 << 20
    # join build sides larger than this stop replicating and shard by
    # key (probe rows then route over the exchange)
    replicate_threshold_bytes: int = 64 << 20
    # ---- flight recorder (per-shard skew / memory / build telemetry) ----
    # warn (session warning + mesh_skew event) when a sharded dispatch's
    # max/mean shard-row ratio reaches this; 0 disables the warning
    skew_warn_ratio: float = 4.0
    # emit a mesh_hbm_watermark event when one device's live tensor
    # bytes cross this fraction of its capacity
    hbm_watermark_fraction: float = 0.85
    # per-device capacity override in bytes; 0 = ask the device
    # (torch.cuda.mem_get_info; unknown on the CPU = disabled)
    hbm_bytes: int = 0
    # per-dispatch shard-accounting ring: digests kept per client
    shard_ring_cap: int = 256


def epoch_nbytes(epoch) -> int:
    """Host bytes of one columnar epoch (columns + validity lanes)."""
    n = 0
    for data, valid in zip(epoch.columns, epoch.valids):
        n += int(data.nbytes)
        if valid is not None:
            n += int(valid.nbytes)
    return n


# ==================== flight recorder ====================

def _plan_digest(kind: str, identity) -> str:
    """Stable per-logical-program digest: the plan identity WITHOUT the
    shape bucket or placement mode, the key the recompile-storm detector
    groups by."""
    return hashlib.sha256(
        (str(kind) + "|" + str(identity)).encode()).hexdigest()[:16]


def _stat_pair(in_rows, out_rows) -> torch.Tensor:
    """int32[1, 2] per-shard (input rows, post-filter survivors); the
    P(AXIS) out-spec concatenates the slots into [n_slots, 2]."""
    dev = in_rows.device
    return torch.stack([
        torch.as_tensor(in_rows, dtype=torch.int32, device=dev),
        torch.as_tensor(out_rows, dtype=torch.int32, device=dev)])[None]


def _rows_partial_total(p: torch.Tensor) -> torch.Tensor:
    """Total of a 1-limb 'rows' agg partial (int32[1, 2, segments], value
    = hi*4096 + lo per segment): the shard's post-filter survivor count,
    read off the partials the program already computes."""
    return p[:, 0, :].sum() * 4096 + p[:, 1, :].sum()


def _bits_shard_counts(bits, shards: int) -> np.ndarray:
    """Per-shard popcount of a concatenated packed row bitmask: each
    slot's equal slice of the packed bytes IS its survivor set."""
    b = np.asarray(bits).view(np.uint8)
    per = len(b) // max(shards, 1)
    return np.asarray([int(np.unpackbits(b[i * per:(i + 1) * per]).sum())
                       for i in range(shards)], dtype=np.int64)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class MeshFlightRecorder:
    """Per-client mesh dispatch telemetry: a bounded ring of per-shard
    accounting keyed by plan digest, program-build counts and durations
    with a recompile-storm detector, and the skew detector feeding
    EXPLAIN ANALYZE / Top SQL / the slow log / tidb_events.

    Hot-path contract: the dispatch side only APPENDS (kind, digest,
    stats, routed bytes, operator) tuples to a thread-local list: no
    lock, no fetch. collect() (called by the engine after each
    dispatching plan node, after the statement's own fetch) reads the
    tiny [n_slots, 2] stats, computes skew, and folds everything into
    the ring. The single-device CopClient never touches any of this. No
    background thread: rings are bounded OrderedDicts trimmed at
    insert."""

    STORM_COMPILES = 3   # same signature built this often = a storm
    COMPILE_CAP = 256    # signatures kept in the compile ring
    WARN_INTERVAL_S = 10.0  # per-digest skew-warning throttle

    def __init__(self, plane: "MeshPlane") -> None:
        self.plane = plane
        # the owning storage's Observability (events sink); set by
        # MeshPlane.client_for, None for bare test clients
        self.obs = None
        self._lock = threading.Lock()
        self._ring: "OrderedDict[str, dict]" = OrderedDict()
        self._compiles: "OrderedDict[str, dict]" = OrderedDict()
        self._tls = threading.local()

    # ---- dispatch side (hot path) ---------------------------------------
    def note_pending(self, kind: str, digest: str, stats,
                     routed: int = 0, op: Optional[str] = None) -> None:
        pend = getattr(self._tls, "pending", None)
        if pend is None:
            pend = self._tls.pending = []
        if len(pend) < 128:  # bound a pathological dispatch loop
            pend.append((kind, digest, stats, int(routed), op))

    # ---- collection (after the statement's own fetch) -------------------
    def collect(self) -> Optional[dict]:
        pend = getattr(self._tls, "pending", None)
        if not pend:
            return None
        self._tls.pending = []
        cap = max(int(self.plane.cfg.shard_ring_cap), 1)
        thr = float(self.plane.cfg.skew_warn_ratio)
        note_in = note_rows = None
        max_skew = 0.0
        routed_total = 0
        shards = 0
        now = time.time()
        for kind, digest, stats, routed, op in pend:
            inp = rows = None
            if isinstance(stats, dict) and "bits" in stats:
                rows = _bits_shard_counts(_host(stats["bits"]),
                                          int(stats["shards"]))
            else:
                a = _host(stats)
                inp = a[:, 0].astype(np.int64)
                rows = a[:, 1].astype(np.int64)
                if (rows < 0).any():
                    rows = None  # survivors unobservable (hc path)
            basis = rows if rows is not None and rows.sum() > 0 else inp
            skew = 1.0
            share = 0.0
            if basis is not None and len(basis) and basis.sum() > 0:
                total = float(basis.sum())
                skew = float(basis.max()) / (total / len(basis))
                share = float(basis.max()) / total
            fp = failpoint.inject("mesh/skew")
            if fp:
                skew = float(fp) if isinstance(fp, (int, float)) and \
                    not isinstance(fp, bool) else 1000.0
            # shard count from the observed arrays: a dispatch whose
            # filter matches zero rows is still an n-way dispatch
            n = len(rows) if rows is not None else (
                len(inp) if inp is not None else 0)
            shards = max(shards, n)
            max_skew = max(max_skew, skew)
            routed_total += routed
            if rows is not None:
                note_rows = rows if note_rows is None else note_rows + rows
            if inp is not None:
                note_in = inp if note_in is None else note_in + inp
            # ---- ring update (keyed by plan digest) ----
            last_rows = [int(x) for x in (
                rows if rows is not None else
                (inp if inp is not None else []))]
            warn = False
            with self._lock:
                ent = self._ring.get(digest)
                if ent is None:
                    while len(self._ring) >= cap:
                        self._ring.popitem(last=False)
                    ent = self._ring[digest] = {
                        "digest": digest, "kind": kind, "op": op or "",
                        "dispatches": 0, "shards": n, "last_rows": [],
                        "last_skew": 1.0, "max_skew": 1.0,
                        "skew_hits": [],
                        "in_rows": 0, "out_rows": 0, "routed_bytes": 0,
                        "last_seen": 0.0, "last_warn": 0.0}
                else:
                    self._ring.move_to_end(digest)
                ent["dispatches"] += 1
                ent["shards"] = n
                if op:
                    ent["op"] = op
                if last_rows:
                    ent["last_rows"] = last_rows
                if rows is not None:
                    ent["out_rows"] += int(rows.sum())
                if inp is not None:
                    ent["in_rows"] += int(inp.sum())
                ent["last_skew"] = round(skew, 4)
                ent["max_skew"] = max(ent["max_skew"], round(skew, 4))
                if thr > 0 and skew >= thr:
                    # (timestamp, skew) per dispatch that crossed the
                    # warn ratio, bounded: the inspection rule's
                    # "sustained AND current" evidence
                    hits = ent.setdefault("skew_hits", [])
                    hits.append((now, round(skew, 4)))
                    del hits[:-32]
                ent["routed_bytes"] += routed
                ent["last_seen"] = now
                if thr > 0 and skew >= thr and \
                        now - ent["last_warn"] >= self.WARN_INTERVAL_S:
                    ent["last_warn"] = now
                    warn = True
            obs.MESH_SKEW_RATIO.set(skew)
            srec = obs.active_stage_recorder()
            if srec is not None and n > 1:
                srec.note_mesh(op or kind, share, skew)
            if warn:
                obs.MESH_SKEW_WARNINGS.inc()
                detail = (f"{kind} dispatch {digest}: max/mean shard "
                          f"rows {skew:.2f} >= mesh.skew-warn-ratio "
                          f"{thr:g}; rows={last_rows}")
                o = self.obs
                if o is not None:
                    o.events.record("mesh_skew", detail=detail,
                                    severity="warn")
                w = getattr(self._tls, "warnings", None)
                if w is None:
                    w = self._tls.warnings = []
                if len(w) < 16:
                    w.append("mesh skew: " + detail)
        if shards == 0:
            return None
        return {"shards": shards,
                "in": None if note_in is None
                else [int(x) for x in note_in],
                "rows": None if note_rows is None
                else [int(x) for x in note_rows],
                "skew": max_skew, "routed": routed_total}

    def drain_warnings(self) -> tuple:
        w = getattr(self._tls, "warnings", None)
        if not w:
            return ()
        self._tls.warnings = []
        return tuple(w)

    def discard_pending(self) -> None:
        """Drop this thread's queued per-shard stats without folding
        them: a failed statement's dispatches must not leak into the
        next statement's first collect()."""
        if getattr(self._tls, "pending", None):
            self._tls.pending = []

    # ---- program-build observability -------------------------------------
    def note_compile(self, kind: str, signature: str, seconds: float,
                     full_key=None) -> None:
        obs.MESH_COMPILES.inc(kind=str(kind))
        obs.MESH_COMPILE_SECONDS.inc(float(seconds))
        storm = None
        with self._lock:
            ent = self._compiles.get(signature)
            if ent is None:
                while len(self._compiles) >= self.COMPILE_CAP:
                    self._compiles.popitem(last=False)
                ent = self._compiles[signature] = {
                    "signature": signature, "kind": str(kind),
                    "count": 0, "total_s": 0.0, "last_s": 0.0,
                    "storm": False, "last_key": ""}
            else:
                self._compiles.move_to_end(signature)
            ent["count"] += 1
            ent["total_s"] = round(ent["total_s"] + float(seconds), 6)
            ent["last_s"] = round(float(seconds), 6)
            if full_key is not None:
                ent["last_key"] = str(full_key)[:200]
            if ent["count"] >= self.STORM_COMPILES and not ent["storm"]:
                ent["storm"] = True
                storm = dict(ent)
        if storm is not None:
            obs.MESH_RECOMPILE_STORMS.inc()
            o = self.obs
            if o is not None:
                o.events.record(
                    "mesh_compile_storm",
                    detail=(f"kernel signature {storm['signature']} "
                            f"({storm['kind']}) compiled "
                            f"{storm['count']}x — bucket/placement-mode "
                            f"churn re-enters compile; last key "
                            f"{storm['last_key']}"),
                    severity="warn")

    # ---- read side -------------------------------------------------------
    def table_rows(self) -> list[list]:
        """information_schema.tidb_mesh_shards rows, newest first."""
        with self._lock:
            ents = [dict(e) for e in self._ring.values()]
        rows = []
        for e in reversed(ents):
            rows.append([
                e["digest"], e["kind"], e["op"], e["dispatches"],
                e["shards"],
                ",".join(str(x) for x in e["last_rows"])[:256],
                e["last_skew"], e["max_skew"], e["in_rows"],
                e["out_rows"], e["routed_bytes"],
                time.strftime("%Y-%m-%d %H:%M:%S",
                              time.localtime(e["last_seen"]))])
        return rows

    def snapshot(self) -> dict:
        """The /debug/mesh payload half owned by this recorder."""
        with self._lock:
            return {
                "dispatches": [dict(e) for e in self._ring.values()],
                "compiles": [dict(e) for e in self._compiles.values()],
            }


class _FirstCallCompile:
    """Times a program signature's first dispatch; `on_first` receives
    the wall seconds (the feed for build counts, durations and
    recompile-storm detection). Later calls delegate straight through."""

    __slots__ = ("fn", "done", "on_first")

    def __init__(self, fn, on_first) -> None:
        self.fn = fn
        self.done = False
        self.on_first = on_first

    def __call__(self, *args):
        if self.done:
            return self.fn(*args)
        self.done = True
        t0 = time.perf_counter()
        r = self.fn(*args)
        self.on_first(time.perf_counter() - t0)
        return r


class MeshPlane:
    """Process-wide mesh owner: the mesh of shard slots, the placement
    policy, shared per-storage clients, and the per-slot telemetry the
    gauges read."""

    AXIS = AXIS

    def __init__(self, cfg: Optional[MeshConfig] = None,
                 devices=None) -> None:
        self.cfg = cfg or MeshConfig()
        self._devices = devices  # explicit slot device list
        self._mesh = None
        # RLock: client_for constructs clients (which read .mesh) under
        # the same lock
        self._lock = threading.RLock()
        # storage -> shared MeshCopClient (weak: a collected Storage
        # releases its device tensors with it)
        self._clients: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        # physical devices currently above the watermark (edge-triggered
        # mesh_hbm_watermark events)
        self._above_watermark: set[str] = set()

    # ---- mesh lifecycle -----------------------------------------------------
    @property
    def mesh_built(self) -> bool:
        return self._mesh is not None

    @property
    def mesh(self):
        """The 1-D mesh of shard slots; lazy until the first active
        client asks. `axis_size` cuts the slot list as in the reference;
        a list of one device (the process plane's default: the first
        card) gives `axis_size` slots on it, so `axis-size = 8` on one
        card is an 8-slot mesh. Slots on more than one physical device
        raise NotInSlice: request constants live on slot 0's device and
        a sharded epoch would be copied to every card on each dispatch,
        so that path waits for a host with several cards (ROADMAP)."""
        with self._lock:
            if self._mesh is None:
                devs = list(make_mesh(self._devices).devices)
                if len({physical(d) for d in devs}) > 1:
                    raise NotInSlice(
                        "mesh slots on more than one physical device: "
                        + ", ".join(sorted({str(d) for d in devs})))
                k = self.cfg.axis_size
                if k > 0 and devs:
                    devs = devs * k if len(devs) == 1 else devs[:k]
                self._mesh = make_mesh(devs)
            return self._mesh

    @property
    def n_devices(self) -> int:
        return int(self.mesh.size)

    @property
    def device_type(self) -> Optional[str]:
        """The slots' device type ('cuda', 'cpu'), None without slots."""
        devs = self.mesh.devices
        return devs[0].type if devs else None

    @property
    def device(self):
        """The one physical device the slots run on, None without slots."""
        devs = self.mesh.devices
        return physical(devs[0]) if devs else None

    @property
    def active(self) -> bool:
        """Enabled AND more than one slot. A disabled plane never builds
        its mesh."""
        if not self.cfg.enabled:
            return False
        return self.n_devices > 1

    # ---- placement policy ---------------------------------------------------
    def placement_for(self, snap) -> str:
        """'shard' | 'single' for one table snapshot. Per-EPOCH
        deterministic (row count is fixed per epoch id), so staged cache
        keys never see both placements for one epoch."""
        if not self.active:
            return "single"
        if snap.epoch.num_rows >= self.cfg.shard_threshold_rows:
            return "shard"
        return "single"

    # ---- shared clients -----------------------------------------------------
    def client_for(self, storage) -> "MeshCopClient":
        """The storage's shared mesh client: every session of a storage
        uses ONE client, so sharded epochs persist across queries AND
        connections, and a folded epoch is evicted eagerly."""
        with self._lock:
            c = self._clients.get(storage)
            if c is None:
                c = MeshCopClient(self)
                self._clients[storage] = c
        # the flight recorder's event sink
        if c.recorder.obs is None:
            c.recorder.obs = getattr(storage, "obs", None)
        # the keyspace heat recorder: scans account per-range traffic
        if c.heat is None:
            c.heat = getattr(storage, "heat", None)
        # module-level storage -> client registry: the diag/infoschema
        # read side (client_of) resolves through it, whichever plane
        # built the client (latest client wins)
        _STORAGE_CLIENTS[storage] = c
        # outside the plane lock: the listener hook takes storage-side
        # structures only
        if hasattr(storage, "add_epoch_listener"):
            storage.add_epoch_listener(c.on_epoch_replaced)
        # DROP / TRUNCATE free the client's tensors (forget_table)
        if hasattr(storage, "add_cache_client"):
            storage.add_cache_client(c)
        return c

    def clients(self) -> list:
        with self._lock:
            return list(self._clients.values())

    # ---- telemetry ----------------------------------------------------------
    def device_bytes(self) -> dict[str, int]:
        """Live bytes per slot across this plane's clients (sharded epochs
        count their shard; replicated builds a full copy per slot). The
        per-client walk is memoized per cache generation
        (MeshCopClient.telemetry). Crossing the memory watermark is
        detected here (edge-triggered events)."""
        return self._totals()[0]

    def physical_bytes(self) -> dict[str, int]:
        """Unique live tensor bytes per physical device across this
        plane's clients (what the watermark compares with capacity)."""
        return self._totals()[1]

    def _totals(self) -> tuple:
        per: dict[str, int] = {}
        phys: dict[str, int] = {}
        if self.mesh_built:
            for name in self._mesh.slot_names():
                per[name] = 0
        for c in self.clients():
            t = c.telemetry()
            for dev, b in t["per_device"].items():
                per[dev] = per.get(dev, 0) + b
            for dev, b in t["physical"].items():
                phys[dev] = phys.get(dev, 0) + b
        self._check_watermark(phys)
        return per, phys

    def device_capacity_bytes(self, device=None) -> int:
        """One physical device's capacity for the watermark check:
        mesh.hbm-bytes when set, else the card's total memory (unknown on
        the CPU = 0 = watermark disabled)."""
        if self.cfg.hbm_bytes > 0:
            return int(self.cfg.hbm_bytes)
        if not self.mesh_built or device is None:
            return 0
        d = torch.device(device)
        if d.type != "cuda":
            return 0
        return int(torch.cuda.mem_get_info(d)[1])

    def _check_watermark(self, phys: dict[str, int]) -> None:
        for dev, b in phys.items():
            cap = self.device_capacity_bytes(dev)
            if cap <= 0:
                continue
            thr = cap * float(self.cfg.hbm_watermark_fraction)
            if b >= thr:
                if dev in self._above_watermark:
                    continue
                self._above_watermark.add(dev)
                obs.MESH_HBM_WATERMARK.inc(device=dev)
                detail = (f"device {dev}: {b} live buffer bytes >= "
                          f"{self.cfg.hbm_watermark_fraction:.0%} of "
                          f"{cap}-byte capacity")
                for c in self.clients():
                    o = getattr(c.recorder, "obs", None)
                    if o is not None:
                        o.events.record("mesh_hbm_watermark",
                                        detail=detail, severity="warn")
            else:
                self._above_watermark.discard(dev)

    def status(self) -> dict:
        """The /status `mesh` section (and the diag fan-out payload)."""
        out = {
            "enabled": self.cfg.enabled,
            "built": self.mesh_built,
            "devices": self.n_devices if self.mesh_built else 0,
            "shard_threshold_rows": self.cfg.shard_threshold_rows,
            "replicate_threshold_bytes":
                self.cfg.replicate_threshold_bytes,
            "skew_warn_ratio": self.cfg.skew_warn_ratio,
            "hbm_watermark_fraction": self.cfg.hbm_watermark_fraction,
        }
        if self.mesh_built:
            out["device_buffer_bytes"] = self.device_bytes()
            out["device_peak_bytes"] = self.device_peak_bytes()
            out["reshard_bytes_total"] = obs.MESH_RESHARD_BYTES.get()
        return out

    def device_peak_bytes(self) -> dict[str, int]:
        """High-water live bytes per slot across this plane's clients
        (tracked at every telemetry recompute)."""
        peak: dict[str, int] = {}
        for c in self.clients():
            for dev, b in c.telemetry()["peak"].items():
                peak[dev] = max(peak.get(dev, 0), b)
        return peak


def _walk_arrays(o):
    """Yield the tensors nested in cache values (tuples/dicts/tensors)."""
    if isinstance(o, (tuple, list)):
        for x in o:
            yield from _walk_arrays(x)
    elif isinstance(o, dict):
        for x in o.values():
            yield from _walk_arrays(x)
    elif isinstance(o, torch.Tensor):
        yield o


def _cached_arrays(client):
    """UNIQUE tensors resident in a client's caches, by identity: one
    replicated build tensor sits under two keys (its staging key and its
    'repc' re-placement key), and counting it twice would double every
    broadcast build."""
    with client._lock:
        vals = list(client._col_cache.values()) \
            + list(client._mask_cache.values())
    seen: set = set()
    for arr in _walk_arrays(vals):
        if id(arr) not in seen:
            seen.add(id(arr))
            yield arr


def _slot_bytes(arr, names: list[str]) -> dict[str, int]:
    """One tensor's bytes per slot: a sharded tensor's row chunks, a
    replicated one in full on every slot, a single-device one on slot
    0."""
    b = int(arr.nbytes)
    pl = placement_of(arr)
    if pl == "shard":
        share = b // max(len(names), 1)
        return {n: share for n in names}
    if pl == "rep":
        return {n: b for n in names}
    return {names[0]: b} if names else {}


def _classify_key(key) -> tuple:
    """(epoch_id or None, provenance kind) for one staging-cache key, the
    ledger's classification of WHAT pins the bytes: 'epoch' (staged scan
    columns and masks), 'replica' (broadcast join builds), 'perm' (join
    permutation tables and semi bitmaps), 'partition' (key-partitioned
    builds), 'aligned' (epoch-aligned join columns), 'rankaux' (streamseg
    metadata)."""
    if key and key[0] == "tile":
        return int(key[1]), "epoch"
    k1 = key[1] if len(key) > 1 else None
    if isinstance(k1, str):
        kind = {"perm": "perm", "perm-rep": "perm",
                "partb": "partition", "aligned": "aligned",
                "repc": "replica", "repv": "replica",
                "repvis": "replica", "rankaux": "rankaux",
                "semibm": "perm", "semibm-rep": "perm"}.get(k1, k1)
        return (int(key[0]) if isinstance(key[0], int) else None), kind
    if key and key[-1] == "rep":
        return int(key[0]), "replica"
    if key and isinstance(key[0], int):
        return int(key[0]), "epoch"
    return None, "other"


class MeshCopClient(DistCopClient):
    """Placement-aware coprocessor client over a MeshPlane.

    Every dispatch runs under a thread-local placement mode set by
    `placement_scope` (engine.py opens it per plan node from the probe
    snapshot). In `shard` mode the DistCopClient machinery applies:
    row-sharded staging, slot programs, collective merges, the broadcast
    or partition join election. In `single` mode every hook dispatches to
    the base CopClient implementation, so a small table behaves EXACTLY
    as on one device (same programs, same cache keys, same engine
    tags)."""

    def __init__(self, plane: MeshPlane) -> None:
        super().__init__(plane.mesh)
        self.plane = plane
        self._part_thr_rows = DistCopClient.partition_join_threshold
        # per-shard dispatch accounting, build observability, skew
        # detection (one per client = per storage)
        self.recorder = MeshFlightRecorder(plane)
        # program signatures already dispatched (mode, kind, ident, shape)
        self._programs: set = set()
        # (col version, mask version) -> telemetry dict; per-slot live
        # byte high-water marks (guarded by self._lock)
        self._telemetry_memo: Optional[tuple] = None
        self._device_peak: dict[str, int] = {}

    # ---- placement state ----------------------------------------------------
    def _mode(self) -> str:
        return getattr(self._tls, "mode", None) or "single"

    def _sharded(self) -> bool:
        return self._mode() == "shard"

    @contextmanager
    def _mode_scope(self, mode: str):
        prev = getattr(self._tls, "mode", None)
        self._tls.mode = mode
        try:
            yield
        finally:
            self._tls.mode = prev

    def placement_scope(self, snap):
        return self._mode_scope(self.plane.placement_for(snap))

    def execute(self, dag, snap):
        # direct callers (no engine scope): decide placement here
        if getattr(self._tls, "mode", None) is None:
            with self.placement_scope(snap):
                return super().execute(dag, snap)
        return super().execute(dag, snap)

    # ---- storage integration ------------------------------------------------
    def on_epoch_replaced(self, store) -> None:
        """Eager invalidation on an epoch fold (bulk load, compaction,
        DDL rewrite): free the superseded epoch's tensors NOW instead of
        on the next dispatch."""
        self._evict_stale(store.table.id, store.epoch.epoch_id)

    # ---- engine tags --------------------------------------------------------
    def _device_engine(self) -> str:
        return f"device@mesh{self._n}" if self._sharded() else "device"

    def _frag_engine(self, mode: str) -> str:
        if self._sharded():
            return f"device[{mode}]@mesh{self._n}"
        return f"device[{mode}]"

    # ---- mode-dispatched hooks ----------------------------------------------
    def _kernel(self, kind: str, ident, build, *shape):
        fn = build()
        full = (self._mode(), kind, ident()) + tuple(shape)
        with self._lock:
            first = full not in self._programs
            if first:
                self._programs.add(full)
        if not first:
            return fn
        # the signature EXCLUDES the shape bucket and placement mode, so
        # bucket/mode churn lands on one signature (the recompile-storm
        # detector's grouping)
        rec = self.recorder
        sig = _plan_digest(kind, full[2])
        short = (full[0], kind) + tuple(shape)
        return _FirstCallCompile(
            fn, lambda dt: rec.note_compile(kind, sig, dt, short))

    def _bucket_size(self, n: int) -> int:
        if self._sharded():
            return DistCopClient._bucket_size(self, n)
        return CopClient._bucket_size(self, n)

    def _place_cols(self, data, valid):
        if self._sharded():
            return DistCopClient._place_cols(self, data, valid)
        return CopClient._place_cols(self, data, valid)

    def _place_mask(self, mask):
        if self._sharded():
            return DistCopClient._place_mask(self, mask)
        return CopClient._place_mask(self, mask)

    def _with_shard_stats(self, fn, kind: str, digest: str):
        """Split a stats-augmented slot program's (result, stats) pair:
        the result flows back to the unchanged base machinery; the tiny
        [n_slots, 2] stats queue on the recorder's thread-local list and
        are read at take_mesh_note() time, after the statement's own
        fetch."""
        rec = self.recorder

        def kern(*args):
            out, stats = fn(*args)
            rec.note_pending(kind, digest, stats, op=obs.active_operator())
            return out

        return kern

    def _build_agg_kernel(self, dag, prepared, cards, segments):
        if not self._sharded():
            return CopClient._build_agg_kernel(
                self, dag, prepared, cards, segments)
        # per-shard stats: input rows from the visibility mask, survivors
        # read off the 'rows' partial, both BEFORE the collective merge
        body = self._agg_kernel_body(dag, prepared, cards, segments)
        sched = prepared["__agg_sched__"]

        def sharded(cols, row_mask):
            out = body(cols, row_mask)
            stats = _stat_pair(row_mask.sum(),
                               _rows_partial_total(out["rows"]))
            return _collective_merge(out, sched), stats

        prog = shard_map(sharded, self.mesh, in_specs=(P(AXIS), P(AXIS)),
                         out_specs=(P(), P(AXIS)))
        return self._with_shard_stats(
            prog, "agg", _plan_digest("agg", _dag_key(dag)))

    def _build_topn_kernel(self, dag, prepared):
        if not self._sharded():
            return CopClient._build_topn_kernel(self, dag, prepared)
        raw = self._topn_body(dag, prepared)
        sel = dag.selection

        def body(cols, row_mask):
            out = raw(cols, row_mask)
            m = row_mask if sel is None else selection_mask(
                sel.conditions, widen32(list(cols)), prepared, row_mask)
            return out, _stat_pair(row_mask.sum(), m.sum())

        prog = shard_map(body, self.mesh, in_specs=(P(AXIS), P(AXIS)),
                         out_specs=(P(None, AXIS), P(AXIS)))
        return self._with_shard_stats(
            prog, "topn", _plan_digest("topn", _dag_key(dag)))

    def _build_rowmask_kernel(self, dag, prepared):
        if not self._sharded():
            return CopClient._build_rowmask_kernel(self, dag, prepared)
        raw = self._rowmask_body(dag, prepared)
        sel = dag.selection

        def body(cols, row_mask):
            packed = raw(cols, row_mask)
            m = row_mask if sel is None else selection_mask(
                sel.conditions, widen32(list(cols)), prepared, row_mask)
            return packed, _stat_pair(row_mask.sum(), m.sum())

        prog = shard_map(body, self.mesh, in_specs=(P(AXIS), P(AXIS)),
                         out_specs=(P(AXIS), P(AXIS)))
        return self._with_shard_stats(
            prog, "rows", _plan_digest("rows", _dag_key(dag)))

    def _frag_jit(self, kernel, mode, prepared):
        if not self._sharded():
            return CopClient._frag_jit(self, kernel, mode, prepared)
        from .fragment import _frag_key
        rec = self.recorder
        routed = prepared.get("__part_join__") is not None or mode == "hc"
        kind = "frag-" + mode
        digest = _plan_digest(kind, _frag_key(prepared["__frag__"]))
        build_specs = self._build_in_specs(prepared)
        in_specs = (P(AXIS), P(AXIS), build_specs)
        if mode == "agg":
            sched = prepared["__agg_sched__"]

            def merged(pcols, pvis, builds):
                out = kernel(pcols, pvis, builds)
                stats = _stat_pair(pvis.sum(),
                                   _rows_partial_total(out["rows"]))
                return _collective_merge(out, sched), stats

            fn = shard_map(merged, self.mesh, in_specs, (P(), P(AXIS)))
        elif mode in ("hc", "topn"):
            # survivors are not observable outside the candidate cut, so
            # only input balance is recorded (-1 = unknown survivors)
            specs = DistCopClient._hc_out_specs(prepared) \
                if mode == "hc" else P(None, AXIS)

            def cand_body(pcols, pvis, builds):
                res = kernel(pcols, pvis, builds)
                return res, _stat_pair(pvis.sum(), torch.tensor(-1))

            fn = shard_map(cand_body, self.mesh, in_specs,
                           (specs, P(AXIS)))
        else:
            # rows mode: each slot's slice of the packed bitmask
            # popcounts to its survivors at collect time. Rows fragments
            # never route (the partitioned-join election is agg/hc-only)
            inner = DistCopClient._frag_jit(self, kernel, mode, prepared)
            n = self._n

            def row_kern(pcols, pvis, builds, *rest):
                out = inner(pcols, pvis, builds, *rest)
                rec.note_pending(kind, digest,
                                 {"bits": out["bits"], "shards": n},
                                 op=obs.active_operator())
                return out

            return row_kern

        def kern(pcols, pvis, builds, *rest):
            nbytes = 0
            if routed:
                # rows cross the slots inside the program (all_to_all):
                # account the probe payload at dispatch, as the
                # reference does (every probe column and the mask, what
                # its exchanges route; dist.routed_payload_bytes() has
                # what the port's exchanges are handed)
                nbytes = _obj_nbytes(pcols) + _obj_nbytes([pvis])
                obs.MESH_RESHARD_BYTES.inc(nbytes)
            out, stats = fn(pcols, pvis, builds, *rest)
            rec.note_pending(kind, digest, stats, routed=nbytes,
                             op=obs.active_operator())
            return out

        return kern

    # ---- flight-recorder surface (engine and session hooks) ---------------
    def take_mesh_note(self):
        return self.recorder.collect()

    def drain_mesh_warnings(self) -> tuple:
        return self.recorder.drain_warnings()

    def discard_mesh_pending(self) -> None:
        self.recorder.discard_pending()

    def telemetry(self) -> dict:
        """Per-slot live bytes and the provenance ledger in ONE cached-
        tensor walk, memoized per cache generation (the _VersionedDict
        mutation counters); also advances the per-slot peak marks and
        sums the unique bytes per physical device (the watermark's
        input)."""
        with self._lock:
            gen = (self._col_cache.version, self._mask_cache.version)
            memo = self._telemetry_memo
            if memo is not None and memo[0] == gen:
                return memo[1]
            items = list(self._col_cache.items()) + \
                list(self._mask_cache.items())
            epoch_tables = {eid: tid
                            for tid, eid in self._live_epochs.items()}
        names = self.mesh.slot_names()
        per: dict[str, int] = {}
        phys: dict[str, int] = {}
        entries: dict[tuple, list] = {}
        seen: set = set()
        storages: set = set()
        for key, val in items:
            eid, kind = _classify_key(key)
            for arr in _walk_arrays(val):
                if id(arr) in seen:
                    continue  # dedupe rep aliases (see _cached_arrays)
                seen.add(id(arr))
                for dev, b in _slot_bytes(arr, names).items():
                    per[dev] = per.get(dev, 0) + b
                    e = entries.setdefault((dev, eid, kind), [0, 0])
                    e[0] += 1
                    e[1] += b
                st = arr.untyped_storage()
                sk = (str(arr.device), st.data_ptr())
                if sk not in storages:
                    storages.add(sk)
                    phys[sk[0]] = phys.get(sk[0], 0) + st.nbytes()
        rows = [{"device": d, "epoch": eid, "kind": k,
                 "arrays": a, "bytes": b}
                for (d, eid, k), (a, b) in sorted(
                    entries.items(),
                    key=lambda kv: (kv[0][0], str(kv[0][1]), kv[0][2]))]
        with self._lock:
            for dev, b in per.items():
                if b > self._device_peak.get(dev, 0):
                    self._device_peak[dev] = b
            result = {"per_device": per, "entries": rows,
                      "peak": dict(self._device_peak),
                      "physical": phys,
                      "epoch_tables": epoch_tables}
            self._telemetry_memo = (gen, result)
        return result

    def _stage_build_table(self, facade, snap):
        if self._sharded():
            return DistCopClient._stage_build_table(self, facade, snap)
        return CopClient._stage_build_table(self, facade, snap)

    def _place_build_array(self, arr, key=None):
        if self._sharded():
            return DistCopClient._place_build_array(self, arr, key)
        return CopClient._place_build_array(self, arr, key)

    def _hc_exchange_fn(self, frag, prepared):
        if self._sharded():
            return DistCopClient._hc_exchange_fn(self, frag, prepared)
        return None

    def _join_exchange_fn(self, frag, prepared, spans):
        if self._sharded():
            return DistCopClient._join_exchange_fn(
                self, frag, prepared, spans)
        return None

    def _stage_partitioned_build(self, t, snap, lo, span, j):
        # partitioned builds are only elected in shard mode
        return DistCopClient._stage_partitioned_build(
            self, t, snap, lo, span, j)

    # ---- join build election ------------------------------------------------
    @property
    def partition_join_threshold(self):
        return self._part_thr_rows if self._sharded() else None

    @partition_join_threshold.setter
    def partition_join_threshold(self, v) -> None:
        self._part_thr_rows = v

    def _partition_build(self, snap) -> bool:
        if not self._sharded():
            return False
        if CopClient._partition_build(self, snap):
            return True
        return epoch_nbytes(snap.epoch) > \
            self.plane.cfg.replicate_threshold_bytes

    @property
    def frag_axis(self):
        return AXIS if self._sharded() else None

    @property
    def hc_exchange_blocks(self) -> int:
        return self._n if self._sharded() else 1


# ==================== process-wide plane ====================

_PLANE: Optional[MeshPlane] = None
_PLANE_LOCK = threading.Lock()

# storage -> latest shared mesh client, whichever plane built it (weak:
# dies with the storage); the diag/infoschema read side resolves here
_STORAGE_CLIENTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _env_config() -> MeshConfig:
    """Embedded-use defaults: the `TIDB_TPU_MESH*` env knobs (server
    processes override through config.seed_mesh from [mesh])."""
    cfg = MeshConfig()
    v = os.environ.get("TIDB_TPU_MESH")
    if v is not None:
        cfg.enabled = v not in ("0", "false", "off", "")
    for env, attr in (("TIDB_TPU_MESH_DEVICES", "axis_size"),
                      ("TIDB_TPU_MESH_SHARD_ROWS", "shard_threshold_rows"),
                      ("TIDB_TPU_MESH_REPLICATE_BYTES",
                       "replicate_threshold_bytes"),
                      ("TIDB_TPU_MESH_HBM_BYTES", "hbm_bytes"),
                      ("TIDB_TPU_MESH_RING_CAP", "shard_ring_cap")):
        raw = os.environ.get(env)
        if raw:
            try:
                setattr(cfg, attr, int(raw))
            except ValueError:
                pass
    for env, attr in (("TIDB_TPU_MESH_SKEW_RATIO", "skew_warn_ratio"),
                      ("TIDB_TPU_MESH_HBM_FRACTION",
                       "hbm_watermark_fraction")):
        raw = os.environ.get(env)
        if raw:
            try:
                setattr(cfg, attr, float(raw))
            except ValueError:
                pass
    return cfg


def get_plane() -> MeshPlane:
    global _PLANE
    with _PLANE_LOCK:
        if _PLANE is None:
            _PLANE = MeshPlane(_env_config())
        return _PLANE


def configure(enabled: Optional[bool] = None,
              axis_size: Optional[int] = None,
              shard_threshold_rows: Optional[int] = None,
              replicate_threshold_bytes: Optional[int] = None,
              skew_warn_ratio: Optional[float] = None,
              hbm_watermark_fraction: Optional[float] = None,
              hbm_bytes: Optional[int] = None,
              shard_ring_cap: Optional[int] = None) -> MeshPlane:
    """Replace the process plane (server startup / tests). Existing
    sessions keep their clients; NEW sessions see the new policy."""
    global _PLANE
    cfg = _env_config()
    if enabled is not None:
        cfg.enabled = enabled
    if axis_size is not None:
        cfg.axis_size = axis_size
    if shard_threshold_rows is not None:
        cfg.shard_threshold_rows = shard_threshold_rows
    if replicate_threshold_bytes is not None:
        cfg.replicate_threshold_bytes = replicate_threshold_bytes
    if skew_warn_ratio is not None:
        cfg.skew_warn_ratio = skew_warn_ratio
    if hbm_watermark_fraction is not None:
        cfg.hbm_watermark_fraction = hbm_watermark_fraction
    if hbm_bytes is not None:
        cfg.hbm_bytes = hbm_bytes
    if shard_ring_cap is not None:
        cfg.shard_ring_cap = shard_ring_cap
    with _PLANE_LOCK:
        _PLANE = MeshPlane(cfg)
        return _PLANE


def client_for(storage, device=None) -> CopClient:
    """Default coprocessor client for a session over `storage` on
    `device` (None: the card): the storage's shared mesh client when the
    plane is active and its slots run on the session's device, else a
    fresh single-device CopClient of the session's device."""
    plane = get_plane()
    if not plane.active or \
            physical(resolve_device(device)) != plane.device:
        c = CopClient(device)
        c.heat = getattr(storage, "heat", None)
        return c
    return plane.client_for(storage)


def status() -> dict:
    """The /status `mesh` section; never builds a mesh as a side effect."""
    with _PLANE_LOCK:
        plane = _PLANE
    if plane is None:
        return {"enabled": _env_config().enabled, "built": False,
                "devices": 0}
    return plane.status()


def client_of(storage) -> Optional["MeshCopClient"]:
    """The storage's EXISTING mesh client, or None: never creates one and
    never builds a mesh."""
    return _STORAGE_CLIENTS.get(storage)


def shard_rows(storage) -> list[list]:
    """information_schema.tidb_mesh_shards rows for one storage (empty
    while the storage has no mesh client)."""
    c = client_of(storage)
    return c.recorder.table_rows() if c is not None else []


def storage_rows(storage) -> list[list]:
    """information_schema.tidb_mesh_storage rows: the per-slot provenance
    ledger, one row per (slot, table/epoch, kind) entry plus one
    '(device)' total row per slot carrying live AND peak bytes."""
    c = client_of(storage)
    if c is None:
        return []
    t = c.telemetry()
    names: dict = {}
    for eid, tid in t["epoch_tables"].items():
        store = getattr(storage, "tables", {}).get(tid)
        if store is not None:
            names[eid] = store.table.name
    rows: list[list] = []
    for e in t["entries"]:
        rows.append([e["device"], names.get(e["epoch"]), e["epoch"],
                     e["kind"], e["arrays"], e["bytes"], None])
    for dev in sorted(t["per_device"]):
        rows.append([dev, "(device)", None, "total", None,
                     t["per_device"][dev], t["peak"].get(dev, 0)])
    return rows


def debug_payload() -> dict:
    """The /debug/mesh JSON: plane status + every client's dispatch ring,
    build ring and ledger. Never builds a mesh."""
    out: dict = {"status": status(), "dispatches": [], "compiles": [],
                 "storage": []}
    with _PLANE_LOCK:
        plane = _PLANE
    if plane is None:
        return out
    for c in plane.clients():
        snap = c.recorder.snapshot()
        out["dispatches"].extend(snap["dispatches"])
        out["compiles"].extend(snap["compiles"])
        if plane.mesh_built:
            t = c.telemetry()
            out["storage"].append({
                "per_device": t["per_device"], "peak": t["peak"],
                "entries": t["entries"]})
    return out


def placement_report(client: CopClient) -> dict:
    """Per-slot placement of a client's resident tensors: bytes per slot,
    tensor counts by placement, and an example shard spec."""
    names = client.mesh.slot_names() if hasattr(client, "mesh") \
        else [str(client.device)]
    per: dict[str, int] = {}
    n_sharded = n_replicated = n_single = 0
    shard_spec = None
    for arr in _cached_arrays(client):
        for dev, b in _slot_bytes(arr, names).items():
            per[dev] = per.get(dev, 0) + b
        pl = placement_of(arr)
        if pl == "shard":
            n_sharded += 1
            if shard_spec is None:
                shard_spec = str(P(AXIS))
        elif pl == "rep":
            n_replicated += 1
        else:
            n_single += 1
    return {"device_bytes": per, "sharded_arrays": n_sharded,
            "replicated_arrays": n_replicated,
            "single_arrays": n_single, "shard_spec": shard_spec}


# ---- per-slot gauge probe (run before every /metrics scrape and
# metrics-history sample) ------------------------------------------------

def _mesh_telemetry_probe() -> None:
    with _PLANE_LOCK:
        plane = _PLANE
    if plane is None or not plane.mesh_built:
        return
    obs.MESH_DEVICES.set(plane.n_devices)
    for dev, b in plane.device_bytes().items():
        obs.DEVICE_BUFFER_BYTES.set(b, device=dev)


obs.register_gauge_probe(_mesh_telemetry_probe)


__all__ = ["MeshConfig", "MeshPlane", "MeshCopClient",
           "MeshFlightRecorder", "epoch_nbytes", "get_plane",
           "configure", "client_for", "client_of", "status",
           "placement_report", "shard_rows", "storage_rows",
           "debug_payload"]
