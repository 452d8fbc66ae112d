"""Distributed coprocessor execution over a mesh of shard slots.

Port of `tidb_tpu/parallel/dist.py`. The multi-chip tier of the design
(SURVEY.md §7): where the reference fans coprocessor tasks out to TiKV
regions and runs MPP exchanges between TiFlash nodes (reference:
store/tikv/coprocessor.go:248 buildCopTasks; store/tikv/mpp.go:372;
planner/core/fragment.go), the framework shards the column epoch over a
1-D mesh and lets collectives do the exchange:

* scan fan-out  -> row-axis sharding of the padded column arrays;
* partial aggregation -> per-shard exact limb partials;
* final merge -> psum / pmin / pmax over the mesh axis, all in native
  int32: the limb partials are exact under addition (sumexact.py).

The reference's mesh is a `jax.sharding.Mesh` of devices and its
programs are `shard_map`s. Here the mesh is a list of shard SLOTS, each a
`torch.device`; a device may repeat (`[cuda:0] * 8` is an 8-slot mesh on
one card, `[cpu] * 8` the counterpart of the reference tests' 8 virtual
CPU devices). `shard_map` returns a slot program that the lockstep
runner executes: one thread per slot (the mesh's, started at its first
dispatch and joined by `Mesh.close()`), each on its slot's device,
meeting the others at every collective:

* `psum` / `pmin` / `pmax` reduce in slot order 0..n-1 and hand every
  slot the result on its own device (`_collective_merge` reduces all of
  a partial's keys in one collective);
* `all_to_all` hands slot d the concatenation over sources s of
  send[s][d], for a list of arrays at once.

The slots take turns on a baton (`_Run`): one slot thread runs at a time,
up to its next collective, so their launches never contend for the
interpreter lock or the driver.
* `P(AXIS)` inputs are row chunks of the placed tensor (views when the
  slots share a device, `.to(slot)` copies when they do not); `P()`
  inputs are replicated. Outputs concatenate along the spec's axis or
  take slot 0's replicated value.

An error in any slot aborts the dispatch (every waiting slot wakes and
stops); the dispatch ends every slot thread and re-raises the first
slot's error. Nothing retries on one device.

What stays as in the reference: the bucket rule (`lcm(256, 8 n)`), the
broadcast accounting into `MESH_RESHARD_BYTES`, the four fragment modes
of `_frag_jit`, the partitioned build (key-interleaved over the slots)
and the two exchanges (parallel/exchange.py).
"""

from __future__ import annotations

import queue
import threading
import weakref
from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np

from .. import obs
from ..copr.client import CopClient

AXIS = "shard"


# ==================== mesh and partition specs ====================

class P(tuple):
    """Partition spec (the reference's `jax.sharding.PartitionSpec`): one
    entry per array dimension, AXIS where the mesh axis splits it, None
    elsewhere. P() is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    @property
    def split_dim(self) -> Optional[int]:
        for i, p in enumerate(self):
            if p == AXIS:
                return i
        return None

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


class Mesh:
    """1-D mesh of shard slots over the `shard` axis. `devices[i]` is the
    torch.device that slot i runs on; a device may repeat. The mesh owns
    the slot threads its programs run on (`_SlotPool`, started at the
    first dispatch); `close()` joins them, and so does the mesh's
    collection."""

    axis_names = (AXIS,)

    def __init__(self, devices: Sequence) -> None:
        import torch
        self.devices = [torch.device(d) for d in devices]
        self._pool: Optional[_SlotPool] = None
        self._pool_lock = threading.Lock()

    def run_slots(self, work) -> None:
        """Run `work(i)` once per slot, each on its slot's thread, and
        return when every slot has finished. Dispatches on one mesh take
        turns: two interleaved on the slot threads would meet at each
        other's collectives. A dispatch whose slot failed ends the slot
        threads before it returns; the next one starts new ones."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = _SlotPool(len(self.devices))
                weakref.finalize(self, self._pool.close)
            pool = self._pool
            ok = pool.run(work)
            if not ok:
                pool.close()
                self._pool = None

    def close(self) -> None:
        """End the slot threads (a later dispatch starts new ones)."""
        with self._pool_lock:
            if self._pool is not None:
                self._pool.close()
                self._pool = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def slot_names(self) -> list[str]:
        """One name per slot, `<device>/<slot>` (8 distinct names on an
        8-slot mesh over one device)."""
        return [f"{d}/{i}" for i, d in enumerate(self.devices)]


def default_devices() -> list:
    """The process plane's default slot list: the first card (none
    without one). Slots on several cards are refused (`physical`), so the
    process plane never spans cards; an `axis-size` above 1 makes its
    mesh, that many slots on this one card."""
    import torch
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", 0)]


def physical(device):
    """The physical device a slot runs on (`cuda` without an index is
    the current card)."""
    import torch
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the given slot devices (or every visible card)."""
    return Mesh(list(devices) if devices is not None else default_devices())


# ==================== the lockstep slot runner ====================

_slot = threading.local()
# exchange payload handed to route_rows by every finished dispatch
_ROUTED = [0]
_ROUTED_LOCK = threading.Lock()


class _SlotPool:
    """One daemon thread per slot, each taking its slot's work from its
    own queue; a dispatch hands every slot one callable and waits until
    all have run."""

    def __init__(self, n: int) -> None:
        self._jobs = [queue.SimpleQueue() for _ in range(n)]
        self._threads = [threading.Thread(target=self._loop, args=(i,),
                                          name=f"titpu-slot-{i}",
                                          daemon=True)
                         for i in range(n)]
        for t in self._threads:
            t.start()

    def _loop(self, i: int) -> None:
        jobs = self._jobs[i]
        while True:
            job = jobs.get()
            if job is None:
                return
            job(i)

    def run(self, work) -> bool:
        """work(i) on every slot; -> whether every call returned True."""
        done = threading.Semaphore(0)
        oks: list = [False] * len(self._jobs)

        def job(i: int) -> None:
            try:
                oks[i] = work(i)
            finally:
                done.release()

        for q in self._jobs:
            q.put(job)
        for _ in self._jobs:
            done.acquire()
        return all(oks)

    def close(self) -> None:
        for q in self._jobs:
            q.put(None)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()


class _Run:
    """One dispatch's rendezvous. The slots take turns, a baton passing
    0 -> 1 -> ... -> n-1 -> 0: a slot runs until its next collective,
    deposits its operand on that collective's board and hands the baton
    on. When the baton comes back every slot has deposited, so the board
    is complete. One slot thread runs at a time: the slots' kernel
    launches never contend for the interpreter lock or the driver, and
    the device still overlaps their queued work."""

    def __init__(self, n: int) -> None:
        self.n = n
        self._go = [threading.Event() for _ in range(n)]
        self._boards: dict[int, list] = {}
        self._rounds = [0] * n
        self._aborted = False
        # payload bytes each slot handed to an exchange (note_routed)
        self.routed = [0] * n

    def begin(self, index: int) -> None:
        """Block slot `index` until its first turn (slot 0 goes first)."""
        if index == 0:
            return
        self._wait(index)

    def _wait(self, index: int) -> None:
        self._go[index].wait()
        self._go[index].clear()
        if self._aborted:
            raise threading.BrokenBarrierError

    def _pass(self, index: int) -> None:
        self._go[(index + 1) % self.n].set()

    def exchange(self, index: int, value) -> list:
        """Deposit `value` as slot `index`'s operand of its next
        collective and return all n operands of that collective."""
        k = self._rounds[index]
        self._rounds[index] = k + 1
        board = self._boards.setdefault(k, [None] * self.n)
        board[index] = value
        self._pass(index)
        self._wait(index)
        if index == self.n - 1:
            del self._boards[k]  # the last slot to read it
        return board

    def end(self, index: int) -> None:
        """Slot `index` returned: the next slot takes its turn."""
        self._pass(index)

    def abort(self) -> None:
        """A slot failed: every waiting slot wakes and stops."""
        self._aborted = True
        for e in self._go:
            e.set()


def _ctx(axis: str):
    if axis != AXIS:
        raise ValueError(f"unknown mesh axis {axis!r}")
    ctx = getattr(_slot, "ctx", None)
    if ctx is None:
        raise RuntimeError("mesh collective outside a slot program")
    return ctx


def axis_index(axis: str) -> int:
    """This slot's index on the mesh axis."""
    return _ctx(axis)[1]


def note_routed(nbytes: int, axis: str) -> None:
    """Account `nbytes` of exchange payload sent by this slot; the
    dispatch adds its slots' total to `routed_payload_bytes()`."""
    run, i = _ctx(axis)
    run.routed[i] += int(nbytes)


def routed_payload_bytes() -> int:
    """Exchange payload bytes this process's dispatches have handed to
    `route_rows` (values, validity and row masks, over every slot) since
    it started. The flight recorder's `routed_bytes` counts the
    reference's probe payload instead (copr/mesh.py)."""
    with _ROUTED_LOCK:
        return _ROUTED[0]


def _add(a, b):
    return a + b


def _reduce_ops(ops: dict, axis: str) -> dict:
    """One collective over a dict of operands: key -> (tensor, op), each
    reduced over the slots in slot order 0..n-1 by `op`; every slot
    receives the results on its own device."""
    run, i = _ctx(axis)
    vals = run.exchange(i, {k: x for k, (x, _) in ops.items()})
    out = {}
    for k, (x, op) in ops.items():
        acc = vals[0][k].to(x.device)
        for v in vals[1:]:
            acc = op(acc, v[k].to(x.device))
        out[k] = acc
    return out


def psum(x, axis: str):
    """Sum over the slots, in slot order 0..n-1; every slot receives it."""
    return _reduce_ops({0: (x, _add)}, axis)[0]


def pmin(x, axis: str):
    import torch
    return _reduce_ops({0: (x, torch.minimum)}, axis)[0]


def pmax(x, axis: str):
    import torch
    return _reduce_ops({0: (x, torch.maximum)}, axis)[0]


def all_to_all(xs: list, axis: str) -> list:
    """One collective over a list of arrays: each x is [n, ...] per slot,
    row d bound for slot d; -> per x an [n, ...] array whose row s is what
    slot s sent here (split and concat both on axis 0)."""
    import torch
    run, i = _ctx(axis)
    sends = run.exchange(i, xs)
    return [torch.stack([s[j][i].to(x.device) for s in sends])
            for j, x in enumerate(xs)]


def _is_tensor(x) -> bool:
    import torch
    return isinstance(x, torch.Tensor)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree) if _is_tensor(tree) else tree


def _split_for_slot(spec, tree, i: int, n: int, device):
    """The slot-i view of an argument tree under a spec prefix."""
    if isinstance(spec, P):
        dim = spec.split_dim

        def leaf(t):
            if dim is not None:
                rows = t.shape[dim]
                if rows % n:
                    raise ValueError(
                        f"dimension {dim} of size {rows} does not split "
                        f"into {n} shard slots")
                c = rows // n
                t = t.narrow(dim, i * c, c)
            return t.to(device)

        return _map_leaves(tree, leaf)
    if isinstance(spec, dict):
        return {k: _split_for_slot(spec[k], v, i, n, device)
                for k, v in tree.items()}
    return type(tree)(_split_for_slot(s, v, i, n, device)
                      for s, v in zip(spec, tree))


def _gather(spec, outs: list, device):
    """Per-slot output trees -> one tree under an out-spec prefix."""
    import torch
    if isinstance(spec, P):
        dim = spec.split_dim
        first = outs[0]
        if isinstance(first, dict):
            return {k: _gather(spec, [o[k] for o in outs], device)
                    for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(_gather(spec, [o[j] for o in outs], device)
                               for j in range(len(first)))
        if not _is_tensor(first):
            return first
        if dim is None:
            return first.to(device)
        return torch.cat([o.to(device) for o in outs], dim=dim)
    if isinstance(spec, dict):
        return {k: _gather(spec[k], [o[k] for o in outs], device)
                for k in outs[0]}
    return type(outs[0])(_gather(s, [o[j] for o in outs], device)
                         for j, s in enumerate(spec))


def _device_scope(device):
    import torch
    if device.type == "cuda":
        return torch.cuda.device(device)
    return nullcontext()


class SlotProgram:
    """A slot program (the reference's `shard_map`): `fn` runs once per
    slot of `mesh` in lockstep, on the slot's row chunk of each P(AXIS)
    input. Calling it is one dispatch: it returns when every slot has
    run the program on the mesh's slot threads."""

    def __init__(self, fn, mesh: Mesh, in_specs, out_specs) -> None:
        self.fn = fn
        self.mesh = mesh
        self.in_specs = in_specs
        self.out_specs = out_specs

    def __call__(self, *args):
        devices = self.mesh.devices
        n = len(devices)
        per_slot = [_split_for_slot(tuple(self.in_specs), args, i, n, d)
                    for i, d in enumerate(devices)]
        run = _Run(n)
        outs: list = [None] * n
        errs: list = [None] * n

        def work(i: int) -> bool:
            _slot.ctx = (run, i)
            try:
                run.begin(i)
                with _device_scope(devices[i]):
                    outs[i] = self.fn(*per_slot[i])
                run.end(i)
                return True
            except Exception as e:  # the dispatch re-raises it below
                errs[i] = e
                run.abort()
                return False
            finally:
                _slot.ctx = None

        self.mesh.run_slots(work)
        first = next((e for e in errs if e is not None and not isinstance(
            e, threading.BrokenBarrierError)), None)
        if first is None:
            first = next((e for e in errs if e is not None), None)
        if first is not None:
            raise first
        with _ROUTED_LOCK:
            _ROUTED[0] += sum(run.routed)
        return _gather(self.out_specs, outs, devices[0])


def shard_map(fn, mesh: Mesh, in_specs, out_specs) -> SlotProgram:
    return SlotProgram(fn, mesh, in_specs, out_specs)


# ==================== placement ====================

def placement_of(t) -> str:
    """'shard' | 'rep' | 'single' for a tensor placed by a mesh client
    (the reference reads `arr.sharding`)."""
    return getattr(t, "_mesh_placement", None) or "single"


def _mark(t, placement: str):
    t._mesh_placement = placement
    return t


# ==================== the distributed client ====================

class DistCopClient(CopClient):
    """CopClient whose kernels run sharded over a mesh of shard slots.

    Row batches are padded to shape buckets that split into slots of a
    multiple of 8 rows; each slot reduces its row shard into the full
    dense segment space, then collectives over the mesh axis give the
    global partials. Scan inputs are placed row-sharded at creation and
    the placed tensors are what the caches hold; build tables replicate
    (broadcast exchange) unless partitioned by key."""

    def __init__(self, mesh: Mesh) -> None:
        super().__init__(mesh.devices[0])
        self.mesh = mesh
        self._n = mesh.size

    def _build_agg_kernel(self, dag, prepared, cards, segments):
        body = self._agg_kernel_body(dag, prepared, cards, segments)
        sched = prepared["__agg_sched__"]

        def sharded(cols, row_mask):
            return _collective_merge(body(cols, row_mask), sched)

        return shard_map(sharded, self.mesh, in_specs=(P(AXIS), P(AXIS)),
                         out_specs=P())

    def _bucket_size(self, n: int) -> int:
        """Round the shape bucket so the rows axis splits evenly AND each
        shard is a multiple of 8 rows: per-shard packbits pads to byte
        boundaries, and concatenating padded shard masks would shift
        every later shard's rows."""
        b = super()._bucket_size(n)
        lcm = int(np.lcm(256, 8 * self._n))
        return -(-b // lcm) * lcm

    # staging placement: scan columns and masks shard on the rows axis at
    # creation and the placed tensors are what the caches hold; build-
    # table staging (the TLS flag below) places REPLICATED instead
    def _scan_placement(self) -> str:
        return "rep" if getattr(self._tls, "place_build", False) \
            else "shard"

    def _note_broadcast(self, *arrays) -> None:
        """Replicating build arrays copies them to every other slot: the
        dominant reshard-traffic component, counted at placement."""
        if getattr(self._tls, "place_build", False):
            n = sum(int(getattr(a, "nbytes", 0)) for a in arrays)
            obs.MESH_RESHARD_BYTES.inc(n * max(self._n - 1, 1))

    def _place_cols(self, data, valid):
        build = getattr(self._tls, "place_build", False)
        with obs.stage("reshard" if build else "shard"):
            self._note_broadcast(data, valid)
            pl = self._scan_placement()
            return (_mark(self._place(data), pl),
                    _mark(self._place(valid), pl))

    def _place_mask(self, mask):
        build = getattr(self._tls, "place_build", False)
        with obs.stage("reshard" if build else "shard"):
            self._note_broadcast(mask)
            return _mark(self._place(mask), self._scan_placement())

    # hc GROUP BY shards via the group-partition exchange: joined rows
    # route by group-key hash so each slot owns whole groups, one
    # candidate block per slot
    @property
    def hc_exchange_blocks(self) -> int:
        return self._n

    frag_axis = AXIS
    # builds larger than this replicate no more: they shard by key and
    # probe rows route over the exchange (hash-partition vs broadcast,
    # reference: planner/core/fragment.go:45)
    partition_join_threshold = 1 << 21

    def _stage_partitioned_build(self, t, snap, lo, span, j):
        """Key-interleaved build arrays sharded over the mesh: slot d owns
        keys with (key-lo) % n == d, at local index (key-lo) // n.
        Interleaving (not contiguous ranges) spreads a key-SORTED probe
        (TPC-H lineitem is orderkey-ordered) uniformly over the slots.
        After routing, a probe row gathers its build row by direct local
        key index."""
        from ..copr.client import _narrow

        n_dev = self._n
        span_pad = -(-span // n_dev) * n_dev
        per_dev = span_pad // n_dev
        epoch = snap.epoch
        key_off = t.col_offsets[j.build_key_local]
        ck = (epoch.epoch_id, "partb", key_off, lo, span_pad,
              snap.visible_digest, tuple(t.col_offsets))
        with self._lock:
            hit = self._col_cache.get(ck)
            cacheable = self._live_epochs.get(t.table.id) == epoch.epoch_id
        if hit is not None:
            return hit
        keys = epoch.columns[key_off]
        kvalid = epoch.valids[key_off]
        sel = snap.base_visible.copy()
        if kvalid is not None:
            sel &= kvalid
        idx = np.nonzero(sel)[0]
        k = keys[idx].astype(np.int64) - lo
        pos = (k % n_dev) * per_dev + k // n_dev  # interleave bijection
        present = np.zeros(span_pad, dtype=bool)
        present[pos] = True
        bykey = []
        with obs.stage("shard"):
            for off in t.col_offsets:
                data = np.zeros(span_pad, dtype=_narrow(
                    epoch.columns[off][:0]).dtype)
                data[pos] = _narrow(epoch.columns[off][idx])
                v = epoch.valids[off]
                valid = present.copy()
                if v is not None:
                    valid[pos] = v[idx]
                bykey.append((_mark(self._place(data), "shard"),
                              _mark(self._place(valid), "shard")))
            build = {"bykey": bykey,
                     "present": _mark(self._place(present), "shard")}
        if cacheable:
            with self._lock:
                self._col_cache[ck] = build
        return build

    def _join_exchange_fn(self, frag, prepared, spans):
        import torch

        from ..copr.eval import eval_expr
        from . import exchange as EX

        part_ji = prepared["__part_join__"]
        j = frag.joins[part_ji]
        lo, span = spans[part_ji]
        n_dev = self._n

        def route(cols, mask):
            key_v, key_vl = eval_expr(j.probe_key, cols, prepared)
            k = key_v.to(torch.int32) - lo
            m = mask.shape[0]
            iota = torch.arange(m, dtype=torch.int32, device=mask.device)
            live = mask & key_vl & (k >= 0) & (k < span)
            # interleaved build ownership: key k lives on slot k % n.
            # Dead rows (padding / null / out-of-span keys) spread
            # round-robin so no bucket overflows on them
            dest = torch.where(live, k % n_dev, iota % n_dev)
            return EX.route_cols(dest, cols, mask, AXIS, n_dev,
                                 EX.capacity_for(m, n_dev))

        return route

    def _hc_exchange_fn(self, frag, prepared):
        import torch

        from ..copr.eval import eval_expr
        from . import exchange as EX

        from ..copr.fragment import _cols_of

        n_dev = self._n
        seg_keys = prepared["__hc_segkeys__"]
        nulls = prepared["__hc_nulls__"]
        group_by = frag.agg.group_by
        # the candidate aggregation after the exchange reads only the
        # group keys' and the aggregate arguments' columns: only those
        # cross the slots (the reference routes every column; the rows
        # and results are the same, the exchange's buffers smaller)
        used: set = {0}  # a constant's length and device come from col 0
        for g in group_by:
            used |= _cols_of(g)
        for d in frag.agg.aggs:
            if d.arg is not None:
                used |= _cols_of(d.arg)
        used_idx = sorted(used)

        def route(cols, mask):
            # NULL-encoded segment keys (the encoding _hc_body uses)
            # decide the destination: every row of a group shares them
            keys = []
            for gi in seg_keys:
                v, vl = eval_expr(group_by[gi], cols, prepared)
                keys.append(torch.where(vl, v.to(torch.int32),
                                        nulls[gi]))
            m = mask.shape[0]
            # dead rows (bucket padding / filtered) spread round-robin:
            # they would otherwise hash to one bucket and overflow it
            iota = torch.arange(m, dtype=torch.int64, device=mask.device)
            dest = torch.where(mask, EX.abs32(EX.mix_hash(keys)) % n_dev,
                               iota % n_dev).to(torch.int32)
            sub, new_mask, overflow = EX.route_cols(
                dest, [cols[i] for i in used_idx], mask, AXIS, n_dev,
                EX.capacity_for(m, n_dev))
            routed: list = [None] * len(cols)
            for i, c in zip(used_idx, sub):
                routed[i] = c
            return routed, new_mask, overflow

        return route

    def _stage_key_suffix(self) -> tuple:
        # builds cache under a distinct placement namespace: one epoch
        # can be a sharded probe AND a replicated broadcast build
        return ("rep",) if getattr(self._tls, "place_build", False) else ()

    def _stage_build_table(self, facade, snap):
        # build columns place REPLICATED at creation under "rep"-suffixed
        # staging keys; the _replicated() re-placement below is then an
        # identity, and the repc keys keep the epoch-led eviction
        self._tls.place_build = True
        try:
            cols, vis, host_cols, host_mask = CopClient._stage_inputs(
                self, facade, snap, overlay=False)
        finally:
            self._tls.place_build = False
        b = vis.shape[0]
        eid = snap.epoch.epoch_id
        with self._lock:
            cacheable = self._live_epochs.get(facade.scan.table_id) == eid
        rep_cols = []
        for off, (d, v) in zip(facade.scan.col_offsets, cols):
            rep_cols.append((
                self._replicated((eid, "repc", off, b), d, cacheable),
                self._replicated((eid, "repv", off, b), v, cacheable)))
        vis = self._replicated((eid, "repvis", b, snap.visible_digest),
                               vis, cacheable)
        self._tls.frag_cacheable = cacheable
        return rep_cols, vis, host_cols, host_mask

    def _place_build_array(self, arr, key=None):
        # perm arrays are cached per epoch; replicate once under an
        # epoch-led key so _evict_stale reclaims the broadcast
        if key is None:
            return self._replicated(None, arr, False)
        return self._replicated(key, arr,
                                getattr(self._tls, "frag_cacheable", True))

    def _replicated(self, key, arr, cacheable: bool = True):
        """Broadcast once per epoch, then reuse. A snapshot on an already
        superseded epoch must not seed entries the one-shot eviction will
        never reclaim. An array already replicated is its own placement
        (no bytes move); otherwise the placed array is a new tensor
        object over the same storage, so the single-device original and
        its replica stay two ledger entries, as in the reference."""
        if key is not None:
            with self._lock:
                hit = self._col_cache.get(key)
            if hit is not None:
                return hit
        with obs.stage("reshard"):
            if placement_of(arr) == "rep":
                placed = arr
            else:
                placed = _mark(arr.detach(), "rep")
                # a real broadcast: every other slot receives a copy
                obs.MESH_RESHARD_BYTES.inc(
                    int(arr.nbytes) * max(self._n - 1, 1))
        if cacheable and key is not None:
            with self._lock:
                self._col_cache[key] = placed
        return placed

    def _frag_jit(self, kernel, mode, prepared):
        """The fragment body as a slot program: probe rows sharded,
        builds replicated (or key-partitioned); agg partials merge with
        native-int32 collectives, row bitmasks and TopN candidates
        concatenate along the rows axis."""
        build_specs = self._build_in_specs(prepared)
        in_specs = (P(AXIS), P(AXIS), build_specs)
        if mode == "agg":
            sched = prepared["__agg_sched__"]

            def merged(pcols, pvis, builds):
                return _collective_merge(kernel(pcols, pvis, builds), sched)

            return shard_map(merged, self.mesh, in_specs, P())
        if mode == "hc":
            return shard_map(kernel, self.mesh, in_specs,
                             self._hc_out_specs(prepared))
        if mode == "topn":
            # each shard ships its own top-n candidate rows, concatenated
            # along the k axis; the host Sort/Limit above merge exactly
            return shard_map(kernel, self.mesh, in_specs, P(None, AXIS))
        # row mode: per-shard packed bitmask; shards are 8-row multiples
        # so byte boundaries align and concatenation is the global mask
        return shard_map(kernel, self.mesh, in_specs, P(AXIS))

    @staticmethod
    def _hc_out_specs(prepared) -> dict:
        """Out-specs for the hc partial schema: per-slot candidate blocks
        concatenate (disjoint group partitions after the exchange);
        overflow is psum-replicated."""
        specs: dict = {"picked": P(AXIS), "score": P(AXIS),
                       "overflow": P()}
        for gi in range(len(prepared["__hc_nulls__"])):
            specs[f"gk{gi}"] = P(AXIS)
        for ai, s in enumerate(prepared["__hc_sched__"]):
            specs[f"cnt{ai}"] = P(None, None, AXIS)
            if s["kind"] in ("min", "max"):
                specs[f"mm{ai}"] = P(AXIS)
            for ti in range(len(s.get("terms", ()))):
                specs[f"s{ai}_{ti}"] = P(None, None, AXIS)
        return specs

    def _build_in_specs(self, prepared):
        """Per-build in-specs: broadcast builds replicate (P()), the
        partitioned build's key-ordered arrays shard by key."""
        part_ji = prepared.get("__part_join__")
        n_joins = prepared.get("__n_joins__", 0)
        if part_ji is None:
            return P()
        return [
            {"bykey": P(AXIS), "present": P(AXIS)} if ji == part_ji else P()
            for ji in range(n_joins)
        ] + [P()] * prepared.get("__n_semis__", 0)  # replicated bitmaps

    # ---- TopN: local top-k per shard, host merge ----------------------
    def _build_topn_kernel(self, dag, prepared):
        # per-shard candidate columns concatenate along the k axis; the
        # host Sort + Limit above merge exactly
        return shard_map(self._topn_body(dag, prepared), self.mesh,
                         in_specs=(P(AXIS), P(AXIS)),
                         out_specs=P(None, AXIS))

    def _build_rowmask_kernel(self, dag, prepared):
        return shard_map(self._rowmask_body(dag, prepared), self.mesh,
                         in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS))


def _collective_merge(out: dict, sched) -> dict:
    """Merge per-shard agg partials over the mesh axis, in one collective:
    pmin/pmax for min/max keys and HLL registers, psum for everything
    else (int32 limb partials and float block sums are both additive)."""
    import torch
    minmax_kind = {f"m{ai}": s["kind"] for ai, s in enumerate(sched)
                   if s["kind"] in ("min", "max")}
    hll_keys = {f"h{ai}" for ai, s in enumerate(sched)
                if s["kind"] == "hll"}
    ops = {}
    for key, val in out.items():
        kind = minmax_kind.get(key)
        if kind == "min":
            ops[key] = (val, torch.minimum)
        elif kind == "max" or key in hll_keys:
            # hll registers union across shards by elementwise max
            ops[key] = (val, torch.maximum)
        else:
            ops[key] = (val, _add)
    return _reduce_ops(ops, AXIS)


__all__ = ["AXIS", "DistCopClient", "Mesh", "P", "SlotProgram",
           "all_to_all", "axis_index", "default_devices",
           "make_mesh", "placement_of", "pmax", "pmin", "psum",
           "shard_map"]
