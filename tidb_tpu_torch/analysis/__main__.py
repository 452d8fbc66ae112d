"""CLI: `python -m tidb_tpu_torch.analysis [--check|--baseline|--list]`.

Default: print every finding (baselined ones marked). `--check` is
the CI/tier-1 entry point — exit 0 iff no finding is missing from the
baseline (stale baseline entries are reported for removal but do not
fail; burning down is the point). `--baseline` rewrites baseline.txt
from the current findings, preserving reasons for keys that survive.
No torch, no jax, no device, no server import — this is safe in any
shell, CUDA or not.
"""

from __future__ import annotations

import argparse
import sys

from .engine import (BASELINE_PATH, RULES, SourceTree, check,
                     format_baseline_line, load_baseline, run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tidb_tpu_torch.analysis",
        description="static analysis of the TiTPU PyTorch port")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on any finding not in the "
                         "baseline (the CI / tier-1 mode)")
    ap.add_argument("--baseline", action="store_true",
                    help="rewrite analysis/baseline.txt from the "
                         "current findings")
    ap.add_argument("--list", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--rule", default=None,
                    help="run only the named rule")
    args = ap.parse_args(argv)

    from . import rules as _rules  # noqa: F401 — registers rules
    if args.list:
        for name, r in sorted(RULES.items()):
            print(f"{name:32s} {r.severity:8s} {r.reference}")
        return 0

    tree = SourceTree.load()
    rules = None
    if args.rule:
        if args.rule not in RULES:
            print(f"unknown rule {args.rule!r}; --list shows the "
                  f"registry", file=sys.stderr)
            return 2
        rules = {args.rule: RULES[args.rule]}

    if args.check:
        if rules is None:
            new, stale = check(tree)
        else:
            # single-rule gate: the ratchet applies to that rule's
            # findings against that rule's slice of the baseline
            baseline = {k: v for k, v in load_baseline().items()
                        if k[0] == args.rule}
            findings = run(tree, rules=rules)
            live = {f.key() for f in findings}
            new = [f for f in findings if f.key() not in baseline]
            stale = [k for k in baseline if k not in live]
        for f in new:
            print(f.render())
        for key in stale:
            print(f"stale baseline entry (finding no longer fires — "
                  f"remove the line): {' | '.join(key)}")
        if new:
            print(f"\n{len(new)} new finding(s) not in "
                  f"{BASELINE_PATH.name}; fix them or baseline with "
                  f"a reason", file=sys.stderr)
            return 1
        print(f"analysis clean: 0 new findings, "
              f"{len(load_baseline())} baselined, "
              f"{len(stale)} stale")
        return 0

    findings = run(tree, rules=rules)
    baseline = load_baseline()
    for f in findings:
        mark = "  [baselined]" if f.key() in baseline else ""
        print(f.render() + mark)
    if args.baseline:
        old = load_baseline()
        lines = [
            "# analysis baseline — findings that predate the rule (or",
            "# are deliberate); format: rule | path | item | reason.",
            "# New findings are NOT auto-admitted: python -m",
            "# tidb_tpu_torch.analysis --check fails until a finding is",
            "# fixed or a human adds it here with a reason.",
        ]
        for f in findings:
            reason = old.get(f.key(), "TODO: justify or fix")
            lines.append(format_baseline_line(f, reason))
        BASELINE_PATH.write_text("\n".join(lines) + "\n",
                                 encoding="utf-8")
        print(f"wrote {len(findings)} entries to {BASELINE_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
