"""The port's network fault plane held to the reference's.

Twins of the three cases of tests/test_net_chaos.py that need no range
plane (the fault engine at the socket: the zero-work contract, the
delay/drop/dup/partition schedules, peer matching and asymmetric
partitions), each run over both packages' `rpc/netfault.py` and
`rpc/frame.py` through real socketpairs: the frames received, the
errors raised and the `WORK` pin compared. The five range cases of
that file (transfers across partition and heal cycles, the ledger held
until `txn_done`, the hold TTL, the successor's closed-ts floor, the
split's ledger handoff) run through `torch_twins`: the reference's case
on each package, its range tables, terms, caught errors, events and
range counters compared (the partition and heal cycles' counters, terms
and events are the host's timing, and left out).

Also here: the arming-change listeners that keep `netfault.ACTIVE`
(`util/failpoint.on_change`), and a routed replica read whose follower
is cut off by `net/partition`: it falls back typed
(`unreachable_fallback`) with the leader's exact answer on both
packages.
"""

from __future__ import annotations

import functools
import os
import socket
import sys
import threading
import time

import pytest

import tidb_tpu.rpc.client as ref_client
import tidb_tpu.rpc.frame as ref_frame
import tidb_tpu.rpc.netfault as ref_netfault
import tidb_tpu.util.failpoint as ref_fp
import tidb_tpu_torch.rpc.client as port_client
import tidb_tpu_torch.rpc.frame as port_frame
import tidb_tpu_torch.rpc.netfault as port_netfault
import tidb_tpu_torch.util.failpoint as port_fp
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.session import Session as PortSession
from tidb_tpu_torch.store.storage import Storage as PortStorage

REF = {"name": "ref", "nf": ref_netfault, "frame": ref_frame,
       "fp": ref_fp, "client": ref_client, "Storage": RefStorage,
       "Session": RefSession}
PORT = {"name": "port", "nf": port_netfault, "frame": port_frame,
        "fp": port_fp, "client": port_client,
        "Storage": functools.partial(PortStorage, device="cpu"),
        "Session": lambda st: PortSession(st, device="cpu")}
SIDES = [REF, PORT]


@pytest.fixture(autouse=True)
def _clean():
    for P in SIDES:
        P["nf"].reset()
    yield
    for P in SIDES:
        P["fp"].disable_all()
        P["nf"].reset()


def _pair():
    a, b = socket.socketpair()
    a.settimeout(2.0)
    b.settimeout(2.0)
    return a, b


def _both(fn):
    """fn(package) over the reference, then the port: equal outcomes."""
    want = fn(REF)
    got = fn(PORT)
    assert got == want
    return got


# ==================== the fault engine, at the socket ====================

def test_unarmed_frames_do_zero_fault_work():
    """The zero-work contract: with nothing armed the frame path reads
    netfault.ACTIVE and nothing else — the WORK pin stays flat."""
    def run(P):
        nf, send, recv = P["nf"], P["frame"].send_frame, \
            P["frame"].recv_frame
        a, b = _pair()
        try:
            assert nf.ACTIVE is False
            before = nf.WORK
            got = []
            for i in range(50):
                send(a, b"x%d" % i)
                got.append(recv(b))
            assert got == [b"x%d" % i for i in range(50)]
            assert nf.WORK == before
            return got
        finally:
            a.close()
            b.close()

    _both(run)


def test_delay_drop_dup_partition_schedules():
    def run(P):
        nf, send, recv = P["nf"], P["frame"].send_frame, \
            P["frame"].recv_frame
        a, b = _pair()
        out = []
        try:
            # delay: a fixed sleep on matching frames
            nf.arm("net/delay", ms=30)
            t0 = time.perf_counter()
            send(a, b"slow")
            assert recv(b) == b"slow"
            assert time.perf_counter() - t0 >= 0.03
            nf.heal("net/delay")

            # drop: deterministic — every 3rd frame vanishes (send side)
            nf.arm("net/drop", nth=3)
            got = []
            for i in range(6):
                send(a, b"d%d" % i)
            b.settimeout(0.2)
            with pytest.raises((socket.timeout, ConnectionError)):
                while True:
                    got.append(recv(b))
            assert got == [b"d0", b"d1", b"d3", b"d4"]  # d2, d5 dropped
            out.append(got)
            nf.heal("net/drop")

            # dup: every frame doubled; both copies arrive intact
            nf.arm("net/dup")
            send(a, b"twice")
            nf.heal("net/dup")
            b.settimeout(2.0)
            out.append([recv(b), recv(b)])
            assert out[-1] == [b"twice", b"twice"]

            # partition: the wire is cut typed, heal restores it
            nf.arm("net/partition")
            with pytest.raises(ConnectionResetError) as e:
                send(a, b"cut")
            out.append(str(e.value).split(":")[0])
            nf.heal("net/partition")
            send(a, b"healed")
            assert recv(b) == b"healed"
            assert nf.WORK > 0  # the armed path did count entries
            out.append(nf.WORK)
            return out
        finally:
            a.close()
            b.close()

    out = _both(run)
    assert out[2] == "net/partition"


def test_peer_matching_and_asymmetric_partition():
    """side+dir express asymmetric cuts: traffic TOWARD the named
    endpoint dies while the reverse direction still flows."""
    def run(P):
        nf, send, recv = P["nf"], P["frame"].send_frame, \
            P["frame"].recv_frame
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        cli = socket.create_connection(("127.0.0.1", port), timeout=2.0)
        acc, _ = srv.accept()
        cli.settimeout(2.0)
        acc.settimeout(2.0)
        try:
            # a rule naming some OTHER endpoint must not fire here
            nf.arm("net/partition", peer="127.0.0.1:1", side="peer")
            send(cli, b"pass")
            got = [recv(acc)]
            nf.heal("net/partition")

            # cut only frames SENT TOWARD the server's port: the
            # client's send dies, the server can still push toward the
            # client
            nf.arm("net/partition", peer=f"127.0.0.1:{port}",
                   side="peer", dir="send")
            with pytest.raises(ConnectionResetError):
                send(cli, b"toward-server")
            send(acc, b"from-server")  # acc's peer is the CLIENT
            got.append(recv(cli))
            # arming appends: a second rule extends the schedule
            nf.arm("net/partition", peer="127.0.0.1:2")
            got.append(len(P["fp"].inject("net/partition")))
            return got
        finally:
            cli.close()
            acc.close()
            srv.close()

    assert _both(run) == [b"pass", b"from-server", 2]


# ==================== the arming listeners ====================

def test_active_flag_follows_arming():
    """`ACTIVE` is recomputed by the failpoint registry's arming-change
    listener — set by any net/* enable, cleared by the last disable or
    by disable_all — never polled."""
    def run(P):
        nf, fp = P["nf"], P["fp"]
        seen = [nf.ACTIVE]
        fp.enable("net/delay", {"ms": 1})
        seen.append(nf.ACTIVE)
        fp.enable("net/drop", 3)
        fp.disable("net/delay")
        seen.append(nf.ACTIVE)
        fp.disable("net/drop")
        seen.append(nf.ACTIVE)
        fp.enable("net/dup", True)
        fp.enable("rpc/delay", 1)
        seen.append(nf.ACTIVE)
        fp.disable_all()
        seen.append(nf.ACTIVE)
        fp.enable("rpc/delay", 1)  # not a net fault
        seen.append(nf.ACTIVE)
        with pytest.raises(ValueError):
            nf.arm("net/bogus")
        return seen

    assert _both(run) == [False, True, True, False, True, False, False]


# ==================== a routed read across a cut ====================

def test_partitioned_follower_read_falls_back_typed(tmp_path,
                                                    monkeypatch):
    """A partition toward the serving follower's diag address cuts the
    routed read: the router falls back to the leader typed
    (`unreachable_fallback`, a Note) with the exact answer; healed, the
    read routes again."""
    monkeypatch.setenv("TIDB_TPU_REPLICA_APPLY_MS", "100")

    def run(P):
        d = tmp_path / P["name"]
        opts = P["client"].RpcOptions(
            connect_timeout_ms=500, request_timeout_ms=1000,
            backoff_budget_ms=1200, lock_budget_ms=8000, lease_ms=2000)
        leader = P["Storage"](str(d / "leader"), shared=True,
                              rpc_listen="127.0.0.1:0", rpc_options=opts)
        try:
            follower = P["Storage"](
                str(d / "f0"), remote=f"127.0.0.1:{leader.rpc_server.port}",
                rpc_options=opts)
            try:
                sl = P["Session"](leader)
                sl.execute("create table n (id bigint primary key, "
                           "v bigint)")
                sl.execute("insert into n values (1, 2), (2, 3)")
                deadline = time.monotonic() + 10
                while not any(m.get("serving")
                              for m in leader.rpc_server.members()
                              if m["role"] == "follower"):
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
                sl.execute("set tidb_replica_read = 'follower'")
                out = [sl.execute("select sum(v) from n").rows,
                       [e.split("@")[0] for e in sl.last_engines]]
                P["nf"].arm("net/partition",
                            peer=follower.diag_address, side="peer",
                            dir="send")
                try:
                    out.append(sl.execute("select sum(v) from n").rows)
                    out.append([e.split("@")[0] for e in sl.last_engines])
                    out.append([(w[0], w[2].split(":")[0])
                                for w in sl.warnings])
                finally:
                    P["nf"].heal()
                reads = leader.obs.replica_reads
                out.append({o: reads.get(outcome=o) for o in (
                    "served", "stale_fallback", "unreachable_fallback")})
                # healed: the breaker may still be open after the cut,
                # so the next reads route once it lets a probe through
                deadline = time.monotonic() + 15
                while reads.get(outcome="served") < 2.0:
                    assert time.monotonic() < deadline
                    assert sl.execute("select sum(v) from n").rows == \
                        [(5,)]
                    time.sleep(0.1)
                return out
            finally:
                follower.close()
        finally:
            leader.close()

    out = _both(run)
    assert out[:5] == [[(5,)], ["replica"], [(5,)], ["device"],
                       [("Note", "replica read fell back to the leader "
                                 "(unreachable_fallback)")]]
    assert out[5] == {"served": 1.0, "stale_fallback": 0.0,
                      "unreachable_fallback": 1.0}
    assert not [t for t in threading.enumerate()
                if t.is_alive() and t.name == "titpu-failover"]


# ---- the range plane under network faults (twins) --------------------------

sys.path.insert(0, os.path.dirname(__file__))

import torch_twins  # noqa: E402

_NC_REF, _NC_PORT = torch_twins.load("test_net_chaos.py")

# the partition and heal cycles run against the wall clock: how often
# leases lapse and leadership moves (the counters, the terms, the lease
# events) is the host's timing on either package; the range table, the
# caught errors and the case's own assertions are compared
_NC_TIMED = {"test_transfers_survive_partition_heal_cycles":
             ("metrics", "disk.terms", "events")}

for _name in ("test_transfers_survive_partition_heal_cycles",
              "test_cross_range_commit_holds_ledger_until_txn_done",
              "test_lost_txn_done_self_retires_after_hold_ttl",
              "test_leader_transfer_floors_successor_closed_ts",
              "test_split_hands_ledger_floor_to_children"):
    globals()[_name] = torch_twins.twin(_NC_REF, _NC_PORT, _name,
                                        exclude=_NC_TIMED.get(_name, ()))
