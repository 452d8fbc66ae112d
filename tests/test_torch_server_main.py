"""The port's server process against the reference's, as an operator
starts them.

`python -m tidb_tpu.server` (JAX on the CPU) and `python -m
tidb_tpu_torch.server --device cpu` run side by side as child processes,
each on its own durable directory, from the same TOML file and the same
flags: the same stdout lines (the listening line, the SIGHUP reload's
`config reloaded: [...]` line, `shutting down...`), the same wire answers
(DDL, DML, reads, SHOW PROCESSLIST, the sysvars the seeds set), flag
precedence (a flag beats the file, the file beats the default) and a
CLI-pinned reloadable knob that survives SIGHUP, `/status` on the
status port, and rc 0 after SIGTERM, each store reopening (in this
process) with every acknowledged row. Both reject a bad file with the
same `invalid configuration:` line and exit 1, and print the same
example config. The
port alone: without a card and without `--device cpu` it fails (no
listening line), and a knob of a plane not ported (the mesh) raises
`NotInSlice`. Every child is terminated and waited
for. Tolerance: none.
"""

from __future__ import annotations

import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from mysql_client import MiniClient
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"ref": ["tidb_tpu.server"],
           "port": ["tidb_tpu_torch.server", "--device", "cpu"]}

CONFIG = """
host = "127.0.0.1"
[log]
slow-threshold = 50
[performance]
token-limit = 5
topsql-enabled = false
[gc]
run-interval = "1s"
life-time = "10m0s"
"""
RELOADED = """
host = "127.0.0.1"
[log]
slow-threshold = 70
[performance]
token-limit = 6
topsql-enabled = true
[gc]
run-interval = "1s"
life-time = "20m"
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Child:
    """One server process; its stdout read line by line with a deadline."""

    def __init__(self, name: str, args: list, env=None) -> None:
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *MODULES[name], *args], cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.lines: list[str] = []
        self._sel = selectors.DefaultSelector()
        self._sel.register(self.proc.stdout, selectors.EVENT_READ)

    def readline(self, timeout: float = 60.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._sel.select(timeout=0.2):
                line = self.proc.stdout.readline()
                if not line:
                    break
                self.lines.append(line.rstrip("\n"))
                return self.lines[-1]
        raise AssertionError(
            f"{self.name}: no line within {timeout}s (rc "
            f"{self.proc.poll()}): {self.proc.stderr.read()[-2000:]}"
            if self.proc.poll() is not None else
            f"{self.name}: no line within {timeout}s")

    def listening_port(self) -> int:
        line = self.readline()
        assert line.startswith("tidb-tpu-server listening on 127.0.0.1:"), \
            line
        return int(line.rsplit(":", 1)[1])

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.lines += self.proc.stdout.read().splitlines()
        self._sel.close()
        self.proc.stdout.close()
        self.proc.stderr.close()
        return rc


def _masked(lines: list) -> list:
    return [ln.rsplit(":", 1)[0] if ln.startswith("tidb-tpu-server "
                                                   "listening") else ln
            for ln in lines]


def _status(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                timeout=30) as resp:
        return json.loads(resp.read())


STATEMENTS = [
    "create table t (a int primary key, b varchar(16), c decimal(8,2))",
    "insert into t values (1, 'x', 1.50), (2, 'y', 2.25), (3, NULL, 0)",
    "update t set c = c + 1 where a >= 2",
    "select a, b, c from t order by a",
    "select count(*), sum(c) from t where b is not null",
    "select @@tidb_slow_log_threshold, @@global.tidb_gc_run_interval",
    "select @@require_secure_transport, @@have_ssl",
]


def test_entry_points_side_by_side(tmp_path):
    cfg = tmp_path / "server.toml"
    cfg.write_text(CONFIG)
    children, got, statuses, status_ports = {}, {}, {}, {}
    try:
        for name in ("ref", "port"):
            status_ports[name] = status_port = _free_port()
            children[name] = Child(name, [
                "--config", str(cfg), "-P", "0", "--path",
                str(tmp_path / name), "--status", str(status_port),
                "--token-limit", "2", "--log-slow-threshold", "100"])
            sql_port = children[name].listening_port()
            c = MiniClient("127.0.0.1", sql_port)
            answers = []
            for sql in STATEMENTS:
                answers.append(c.query(sql) if sql.startswith("select")
                               else c.execute(sql))
            plist = c.query("show processlist")
            answers.append([r[:2] + r[3:] for r in plist])
            statuses[name] = _status(status_port)
            got[name] = answers
            c.close()
        assert got["port"] == got["ref"]
        # a flag beats the file: the slow threshold is the flag's 100
        assert got["port"][5] == [("100", "1s")]
        assert statuses["port"]["connections"] == \
            statuses["ref"]["connections"] == 1
        assert statuses["port"]["admission"] == \
            statuses["ref"]["admission"]
        assert set(statuses["port"]) == \
            set(statuses["ref"]) - {"mesh", "ranges"}
        # SIGHUP: the reloadable knobs the flags did not pin
        cfg.write_text(RELOADED)
        for child in children.values():
            child.proc.send_signal(signal.SIGHUP)
        reloaded = {n: ch.readline() for n, ch in children.items()}
        assert reloaded["port"] == reloaded["ref"] == (
            "config reloaded: ['gc.life_time', "
            "'performance.topsql_enabled']")
        for name in children:
            assert _status(status_ports[name])["top_sql"]["enabled"] is True
    finally:
        rcs = {n: ch.stop() for n, ch in children.items()}
    assert rcs == {"ref": 0, "port": 0}
    assert _masked(children["port"].lines) == \
        _masked(children["ref"].lines)
    assert children["port"].lines[-1] == "shutting down..."
    # each store reopens with every acknowledged row
    rows = []
    for S, new_session in ((RefStorage, RefSession),
                           (Storage, lambda st: Session(st, device="cpu"))):
        st = S(str(tmp_path / ("ref" if S is RefStorage else "port")))
        try:
            rows.append([tuple(map(str, r)) for r in
                         new_session(st).execute(STATEMENTS[3]).rows])
        finally:
            st.close()
    assert rows[0] == rows[1] and len(rows[1]) == 3


def test_invalid_configuration_exits_1(tmp_path):
    bad = tmp_path / "bad.toml"
    bad.write_text("prot = 4000\n")
    out = {}
    for name in ("ref", "port"):
        proc = subprocess.run(
            [sys.executable, "-m", *MODULES[name], "--config", str(bad)],
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=120)
        out[name] = (proc.returncode, proc.stdout, proc.stderr)
    assert out["port"] == out["ref"] == (
        1, "", "invalid configuration: unknown config key 'prot'\n")


def test_print_example_config_byte_equal():
    out = {}
    for name in ("ref", "port"):
        proc = subprocess.run(
            [sys.executable, "-m", *MODULES[name], "--print-example-config"],
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            capture_output=True, timeout=120)
        assert proc.returncode == 0
        out[name] = proc.stdout
    with open(os.path.join(REPO, "config.toml.example"), "rb") as f:
        assert out["port"] == out["ref"] == f.read()


@pytest.mark.parametrize("args,config,needle", [
    (["-P", "0"], None, "CUDA device requested"),
    (["-P", "0", "--device", "cpu", "--shared"],
     "[mesh]\naxis-size = 2\n", "NotInSlice"),
], ids=["no-card", "shared"])
def test_port_refuses_to_start(args, config, needle, tmp_path):
    """Without a card the default device fails the start (nothing moves
    to the CPU on its own); a shared sibling with the mesh knobs set (the
    multi-device plane, item 8) is not in this slice."""
    if config is not None:
        path = tmp_path / "c.toml"
        path.write_text(config)
        args = [*args, "--config", str(path), "--path",
                str(tmp_path / "db")]
    cmd = [sys.executable, "-m", "tidb_tpu_torch.server", *args]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "listening" not in proc.stdout
    assert needle in proc.stderr
