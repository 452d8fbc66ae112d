"""The port's range-sharded write leadership held to the reference's.

Twins of the 20 cases of tests/test_ranges.py (`torch_twins`): each case
runs on the reference, then on the port (`device="cpu"`), and the two
runs' range tables, terms, caught errors, hosted-range rows, events,
findings and range counters are compared (one case, whose transfer
count the host's timing decides, without the counters and the terms).
Two cases of the port's own: an error the range plane's lease loop does
not survive ends the loop, is kept, and is re-raised by
`RangeServer.close()` after its teardown, and through `RangePlane.close()`
by `Storage.close()` (the reference keeps the loop alive through every
exception). An autouse fixture fails a case that leaves a live
`titpu-*` thread behind.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(__file__))

import torch_twins  # noqa: E402

REF, PORT = torch_twins.load("test_ranges.py")


def _titpu_threads() -> set:
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("titpu-")}


@pytest.fixture(autouse=True)
def _no_leaked_threads():
    before = _titpu_threads()
    yield
    # the reference's connection threads end on their own after its
    # close; the port's close joins its own
    deadline = time.monotonic() + 15.0
    while _titpu_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
    left = _titpu_threads() - before
    assert not left, sorted(t.name for t in left)


# `range/lease-drop` stays armed until the case sees a transfer, so a
# slow host hands the range over more than once on either package: the
# transfer count and the term it ends at are the host's timing
_BOUNCES = {"test_lease_drop_failpoint_forces_transfer":
            ("metrics", "disk.terms")}

for _name in torch_twins.cases(REF):
    globals()[_name] = torch_twins.twin(REF, PORT, _name,
                                        exclude=_BOUNCES.get(_name, ()))


class _Foreign(Exception):
    """Stands for an error the range plane has no business surviving
    (a torch or CUDA error, a bug)."""


def test_foreign_error_in_lease_loop_is_reraised_by_close(tmp_path):
    from tidb_tpu_torch.kv.rangemeta import split_keyspace
    from tidb_tpu_torch.rpc import ranged

    srv = ranged.RangeServer(str(tmp_path), lease_ms=150,
                             specs=split_keyspace(2))
    calls = []
    orig = srv._lease_tick

    def tick():
        calls.append(1)
        if len(calls) == 2:
            raise _Foreign("boom")
        orig()

    srv._lease_tick = tick
    deadline = time.monotonic() + 10.0
    while srv._lease_thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    # the loop ended on the foreign error and did not tick again
    assert not srv._lease_thread.is_alive()
    assert len(calls) == 2
    assert isinstance(srv.error, _Foreign)
    with pytest.raises(_Foreign, match="boom"):
        srv.close()
    # the teardown ran before the re-raise: leadership released
    assert srv.hosted_ids() == []
    srv.close()  # a second close is a no-op


def test_foreign_error_in_range_plane_reraised_by_storage_close(tmp_path):
    from tidb_tpu_torch.store.storage import Storage

    st = Storage(str(tmp_path / "s"), device="cpu")
    st.arm_ranges(enabled=True, count=2, lease_ms=150)
    srv = st.ranges.server
    orig = srv._lease_tick
    fired = []

    def tick():
        if not fired:
            fired.append(1)
            raise _Foreign("lease loop")
        orig()

    srv._lease_tick = tick
    deadline = time.monotonic() + 10.0
    while srv._lease_thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not srv._lease_thread.is_alive()
    with pytest.raises(_Foreign, match="lease loop"):
        st.close()
    assert st.ranges is None
