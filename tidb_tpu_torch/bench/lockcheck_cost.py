"""What the lock-order checker costs a server process, armed against plain.

    python -m tidb_tpu_torch.bench.lockcheck_cost            # on the card, SF1
    python -m tidb_tpu_torch.bench.lockcheck_cost --device cpu --sf 0.05

Builds one durable store the way `chip_smoke.py`'s part h leaves it for
parts n and o (`sync_log="commit"`; sysbench's sbtest of 10,000 rows by
2,000-row INSERTs and 300 UPDATEs; lineitem, orders and customer
bulk-loaded; ANALYZE), then starts `python -m tidb_tpu_torch.server` over
it again and again, `[analysis] lock-check` on and off in the order
off, on, on, off, ... so neither mode always runs first. Each child is
timed from its start to its listening line, through a cold
`sum(k), count(*)` of sbtest and TPC-H Q6, 100 durable UPDATEs and a
SIGTERM to its exit. An armed child's `/debug/lockgraph` must show no
cycle and no blocking event. Prints one line a child, the medians of each
mode, the cost of one nested acquire in this process, plain and armed,
and the card's name and power limit (none with `--device cpu`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SB_ROWS = 10_000
SB_BATCH = 2_000
SB_UPDATES = 300
CHILD_UPDATES = 100
Q6 = ("select sum(l_extendedprice * l_discount) from lineitem where "
      "l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01' and "
      "l_discount between 0.05 and 0.07 and l_quantity < 24")


def _client_module():
    spec = importlib.util.spec_from_file_location(
        "lockcheck_cost_mysql_client",
        os.path.join(ROOT, "tests", "mysql_client.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_store(path: str, sf: float, device: str, seed: int) -> None:
    import numpy as np

    from ..session import Session
    from ..store.storage import Storage
    from . import tpch_data as TD

    st = Storage(path, sync_log="commit", device=device)
    try:
        s = Session(st, device=device)
        s.execute("create table sbtest (id bigint primary key, k bigint, "
                  "c char(120), pad char(60))")
        for lo in range(0, SB_ROWS, SB_BATCH):
            s.execute("insert into sbtest values " + ",".join(
                f"({i}, {i % 1000}, '{i:0120d}', '{i:060d}')"
                for i in range(lo, lo + SB_BATCH)))
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, SB_ROWS, SB_UPDATES):
            s.execute(f"update sbtest set k = k + 1 where id = {int(i)}")
        d = TD.generate_tpch(sf, seed)
        for name in ("lineitem", "orders", "customer"):
            TD.load_table(s, name, d[name])
        s.execute("analyze table sbtest, lineitem, orders, customer")
    finally:
        st.close()


def acquire_cost_us(n: int = 200_000) -> dict:
    """Microseconds per acquire and release of a lock taken while another
    is held (the store mutex's usual case), plain and instrumented, in
    this process."""
    import threading

    from ..analysis import lockcheck

    plain = (threading.Lock(), threading.Lock())
    lockcheck.enable()
    try:
        checked = (lockcheck.lock("lockcheck_cost.outer"),
                   lockcheck.lock("lockcheck_cost.inner"))
    finally:
        lockcheck.disable()
    out = {}
    for name, (outer, inner) in (("plain", plain), ("armed", checked)):
        with outer:
            t0 = time.perf_counter()
            for _ in range(n):
                with inner:
                    pass
            out[name] = (time.perf_counter() - t0) / n * 1e6
    lockcheck.reset()
    return out


def run_child(mc, path: str, tmp: str, armed: bool, device: str,
              rnd: int) -> dict:
    cfg = os.path.join(tmp, f"c{rnd}.toml")
    with open(cfg, "w") as f:
        f.write('host = "127.0.0.1"\n[analysis]\nlock-check = '
                f'{"true" if armed else "false"}\n')
    status = _free_port()
    cmd = [sys.executable, "-m", "tidb_tpu_torch.server", "--config", cfg,
           "--path", path, "-P", "0", "--status", str(status)]
    if device != "cuda":
        cmd += ["--device", device]
    out = {"armed": armed}
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             text=True)
    try:
        line = child.stdout.readline()
        if not line.startswith("tidb-tpu-server listening on 127.0.0.1:"):
            raise SystemExit(f"the child printed {line!r}")
        out["listen_s"] = time.perf_counter() - t0
        c = mc.MiniClient("127.0.0.1", int(line.rsplit(":", 1)[1]))
        t1 = time.perf_counter()
        c.query("select sum(k), count(*) from sbtest")
        out["sbtest_ms"] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        c.query(Q6)
        out["q6_ms"] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        for i in range(CHILD_UPDATES):
            c.execute(f"update sbtest set k = k + 1 where id = {i * 97}")
        out["updates_s"] = time.perf_counter() - t1
        c.close()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{status}/debug/lockgraph",
                timeout=60) as resp:
            g = json.loads(resp.read())
        if g["enabled"] is not armed or g["cycles"] or g["blocking"]:
            raise SystemExit(f"/debug/lockgraph: enabled {g['enabled']}, "
                             f"cycles {g['cycles']}, blocking "
                             f"{g['blocking']}")
        out["locks"] = len(g["locks"])
        out["nested_acquires"] = sum(e["count"] for e in g["edges"])
        t1 = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        if child.wait(timeout=120) != 0:
            raise SystemExit(f"the child exited {child.returncode}")
        out["stop_s"] = time.perf_counter() - t1
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
    out["total_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=8,
                    help="children in all (even: as many armed as plain)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {smi}")
    mc = _client_module()
    tmp = tempfile.mkdtemp(prefix="lockcheck-cost-")
    try:
        path = os.path.join(tmp, "db")
        t0 = time.perf_counter()
        build_store(path, args.sf, args.device, args.seed)
        print(f"store built in {time.perf_counter() - t0:.2f}s (SF{args.sf}, "
              f"sbtest {SB_ROWS} rows, {SB_UPDATES} UPDATEs)")
        # off, on, on, off, off, on, ...: neither mode always goes first
        order = [(i % 4) in (1, 2) for i in range(args.rounds)]
        runs = []
        for rnd, armed in enumerate(order):
            r = run_child(mc, path, tmp, armed, args.device, rnd)
            runs.append(r)
            print(f"child {rnd} {'armed' if armed else 'plain'}: "
                  + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                              else f"{k} {v}" for k, v in r.items()
                              if k != "armed"))
        keys = ("listen_s", "sbtest_ms", "q6_ms", "updates_s", "stop_s",
                "total_s")
        summary = {}
        for armed in (False, True):
            mine = [r for r in runs if r["armed"] is armed]
            summary["armed" if armed else "plain"] = {
                k: statistics.median(r[k] for r in mine) for k in keys}
        print("medians: " + json.dumps(summary))
        cost = acquire_cost_us()
        print(f"one nested acquire and release in this process: plain "
              f"{cost['plain']:.3f} us, armed {cost['armed']:.3f} us")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
