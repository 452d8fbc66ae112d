"""The port's keyspace heat plane held to the reference's.

Twins of the 14 cases of tests/test_heatmap.py (`torch_twins`): each case
runs on the reference, then on the port (`device="cpu"`), and the two
runs' `tidb_hot_ranges` rows (read and write rows and bytes, the hot
ratio, the split advisory), findings, events and caught errors are
compared. The reference's cases patch `obs_heat`'s clock (`_Clock`,
`_recorder`); on each side that patches that side's own module, so
bucket rotation is deterministic on both. An autouse fixture fails a
case that leaves a live `titpu-*` thread behind.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(__file__))

import torch_twins  # noqa: E402

REF, PORT = torch_twins.load("test_heatmap.py")


def _titpu_threads() -> set:
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("titpu-")}


@pytest.fixture(autouse=True)
def _no_leaked_threads():
    before = _titpu_threads()
    yield
    deadline = time.monotonic() + 15.0
    while _titpu_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
    left = _titpu_threads() - before
    assert not left, sorted(t.name for t in left)


for _name in torch_twins.cases(REF):
    globals()[_name] = torch_twins.twin(REF, PORT, _name)
