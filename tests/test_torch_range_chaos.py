"""The port's range plane under kill -9, held to the reference's.

Twins of the 3 cases (4 collected) of tests/test_range_chaos.py
(`torch_twins`), `slow` as there: range-leader and coordinator child
processes of each package die by `os._exit(9)` at env-armed failpoints
or by SIGKILL, and the survivors' per-range elections, the acknowledged
commits, the all-or-nothing outcome of a crashed coordinator's
cross-range transaction and the fencing of a deposed term are asserted
on both packages, then compared: range tables, terms, caught errors and
range counters. The port's children import `tidb_tpu_torch` only.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import torch_twins  # noqa: E402

REF, PORT = torch_twins.load("test_range_chaos.py")

for _name in torch_twins.cases(REF):
    globals()[_name] = torch_twins.twin(REF, PORT, _name)
