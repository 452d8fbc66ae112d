"""Concurrency analysis plane: static rules + dynamic lock checking.

Two halves over one philosophy — the checker exists BEFORE more
threads and locks arrive, not after:

* static (engine.py + rules.py): an AST rule engine in the
  obs_inspect registry style (named, severity-graded,
  reference-linked rules; committed baseline so pre-existing findings
  burn down rather than block) run as `python -m
  tidb_tpu_torch.analysis` and as a tier-1 test
  (tests/test_torch_analysis.py).
* dynamic (lockcheck.py): opt-in instrumented locks
  (TIDB_TPU_LOCK_CHECK / [analysis] lock-check) feeding a global
  lock-order graph — cycle findings surface through the inspection
  plane (`lock-order-inversion`) and /debug/lockgraph.

Import-light by contract: nothing under tidb_tpu_torch/analysis/ may
import torch, jax or the executor/planner chain (the engine parses source
text, it never imports the code it checks).
"""

from .engine import (AnalysisFinding, RULES, SourceTree, check,
                     lint_rules, load_baseline, run, rule)
from . import lockcheck

__all__ = ["AnalysisFinding", "RULES", "SourceTree", "check",
           "lint_rules", "load_baseline", "run", "rule", "lockcheck"]
