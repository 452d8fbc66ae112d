#!/usr/bin/env python3
"""Drive tidb_tpu_torch on one NVIDIA card, end to end.

    python3 chip_smoke.py            # TPC-H Q6 at SF10, Q1 at SF5, Q18 at SF1

Phases (any failure exits non-zero; no phase's failure is caught):

1. the card: `nvidia-smi` name and power limit, torch's device name;
   exits 1 at once when torch sees no CUDA device;
2. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, started together), with the build seconds;
3. each kernel against its plain PyTorch version on the card, exactly
   (the kernels sum integers below 2^24 in f32, so any order is exact):
   ragged shapes, then the shapes the main path gives it at SF10; times
   with CUDA events for the kernel, the plain version, one PyTorch
   library call computing the same function, and the bound from bytes
   moved / operations done over the H100's published peaks;
4. the main path through the port's entry points on the card: TPC-H Q6
   (SF10) and Q1 (SF5; at SF10 the reference's int64-accumulator gate,
   |bound| * rows >= 2^62, sends Q1's sum_charge to its host path) through
   `CopClient.execute`, and Q18's inner GROUP BY ... HAVING (SF1; at SF10
   its ~150k passing groups overflow the reference's 65,536-group HAVING
   buffer) through `execute_fragment`. Each result is checked exactly
   against its numpy oracle, the engine tags must be device, device and
   device[hc], and every kernel's launch counter must have risen; then the
   p50 wall time of 5 runs, each ending in torch.cuda.synchronize();
5. one JSON line of per-kernel numbers, the nvidia-smi line, and last the
   line {"ok": true, "device": {...}}.

Data comes from the port's seeded TPC-H generator (`--seed`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.copr import streamseg as SS
from tidb_tpu_torch.copr.client import CopClient, _bucket
from tidb_tpu_torch.copr.fragment import execute_fragment
from tidb_tpu_torch.copr.sumexact import limbs_of

# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _run_keys(rng, n: int, max_run: int):
    """Sorted key column of n rows in runs of 1..max_run rows (the first
    run is max_run long)."""
    lens = rng.integers(1, max_run + 1, 2 * n // (max_run + 1) + 16)
    lens[0] = max_run
    while lens.sum() < n:
        lens = np.concatenate([lens, rng.integers(1, max_run + 1, 16)])
    return np.repeat(np.arange(len(lens)), lens)[:n]


# (rows, longest run, K, pad rows past the flags): K = 1, 4, 8, the
# identity case (runs of 1), runs of the 4096-row gate maximum, rows past
# len(f), and sizes that are multiples of no block
RAGGED = ((1, 1, 1, 0), (4095, 7, 4, 0), (4097, 20, 8, 3),
          (100_003, 300, 4, 1021), (1_000_003, 4096, 8, 0),
          (777_777, 1, 4, 5))


def _kernel_phase(li10, seed: int, sf: str) -> dict:
    """streamseg.rank_sums against its plain version; timings at the
    main path's shapes at scale factor `sf`."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    for n, max_run, K, extra in RAGGED:
        name = f"n={n} runs<={max_run} K={K} pad={extra}"
        keys = _run_keys(rng, n, max_run)
        n_pad = n + extra
        meta = SS.rank_meta([keys])
        assert meta is not None, name
        vals = np.zeros((K, n_pad), np.float32)
        vals[:, :len(keys)] = rng.integers(-2048, 4096, (K, len(keys)))
        v = torch.as_tensor(vals, device=dev)
        f = torch.as_tensor(meta["f"], device=dev)
        got = _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"])
        want = SS.rank_sums_plain(v, f, meta["nd"], meta["nd_pad"])
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        print(f"  streamseg {name}: identity={meta['identity']} "
              f"nd={meta['nd']} exact={ok}")
        if not ok:
            raise SystemExit(f"streamseg kernel != plain at {name}")

    # the shapes Q18's inner block gives the kernel: K = 4 arrays
    # (row mask, count mask, two 12-bit limbs of l_quantity) over the
    # whole staged lineitem epoch, ranks = orders
    t0 = time.perf_counter()
    meta = SS.rank_meta([li10["l_orderkey"]])
    n0, nd, nd_pad = meta["n0"], meta["nd"], meta["nd_pad"]
    n_pad = _bucket(n0)
    qty = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    qty[:n0] = torch.as_tensor(li10["l_quantity"].astype(np.int32),
                               device=dev)
    live = torch.arange(n_pad, device=dev) < n0
    lo, hi = limbs_of(qty, 2)
    vals = torch.stack([live.float(), live.float(), lo.float(),
                        hi.float()]).contiguous()
    f = torch.as_tensor(meta["f"], device=dev)
    K = vals.shape[0]
    print(f"  {sf} shape: K={K} n0={n0} n_pad={n_pad} nd={nd} "
          f"maxd={meta['maxd']} (host setup {time.perf_counter()-t0:.1f}s)")
    got = _kernels.streamseg_rank_sums(vals, f, nd, nd_pad)
    want = SS.rank_sums_plain(vals, f, nd, nd_pad)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise SystemExit(f"streamseg kernel != plain at {sf} (max err {err})")
    rank64 = torch.cumsum(torch.cat([f, f.new_zeros(n_pad - n0)]), 0)
    ms = _cuda_ms(lambda: _kernels.streamseg_rank_sums(vals, f, nd, nd_pad),
                  20)
    plain_ms = _cuda_ms(lambda: SS.rank_sums_plain(vals, f, nd, nd_pad), 5)
    library_ms = _cuda_ms(lambda: torch.zeros(
        K, nd_pad, device=dev).index_add_(1, rank64, vals), 5)
    nbytes = vals.numel() * 4 + f.numel() * 4 + K * nd_pad * 4
    ops = vals.numel()  # one add per value
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    print(f"  streamseg {sf}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library index_add_ {library_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e9:.3f} GB), "
          f"exact=True")
    return {"name": "streamseg.rank_sums", "route": "cuda",
            "source": "tidb_tpu_torch/csrc/streamseg.cu",
            "replaces": "tidb_tpu/copr/streamseg.py:194",
            "launches": 0, "max_abs_err": err, "exact": True,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def _load(sf: float, seed: int, table_id: int):
    t0 = time.perf_counter()
    li = TD.generate_tpch(sf, seed)["lineitem"]
    table = TR.lineitem_table(table_id)
    snap = TR.load_table(table, li).snapshot()
    print(f"  generated + loaded lineitem SF{sf:g}: {len(li['l_orderkey'])}"
          f" rows in {time.perf_counter() - t0:.1f}s")
    return li, table, snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--sf", type=float, default=10.0,
                    help="scale factor of Q6 and of the kernel phase")
    ap.add_argument("--q1-sf", type=float, default=5.0)
    ap.add_argument("--q18-sf", type=float, default=1.0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1

    print("== 1. card")
    smi = _device_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  nvidia-smi: {smi}")
    print(f"  torch: {kind}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    print("== 2. build")
    t0 = time.perf_counter()
    logs = _kernels.build_all()
    print(f"  built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("== 3. kernels vs plain")
    li10, t10, snap10 = _load(args.sf, args.seed, 1)
    kern = _kernel_phase(li10, args.seed, f"SF{args.sf:g}")

    print("== 4. main path")
    li5, t5, snap5 = _load(args.q1_sf, args.seed, 2)
    li1, t1, snap1 = _load(args.q18_sf, args.seed, 3)
    cop = CopClient()
    queries = [
        ("Q6", f"SF{args.sf:g}", "device", len(li10["l_orderkey"]),
         lambda: cop.execute(TR.q6_dag(t10), snap10),
         lambda: TR.q6_oracle(li10)),
        ("Q1", f"SF{args.q1_sf:g}", "device", len(li5["l_orderkey"]),
         lambda: cop.execute(TR.q1_dag(t5), snap5),
         lambda: TR.q1_oracle(li5)),
        ("Q18-inner", f"SF{args.q18_sf:g}", "device[hc]",
         len(li1["l_orderkey"]),
         lambda: execute_fragment(cop, TR.q18_inner_frag(t1),
                                  {t1.id: snap1}),
         lambda: TR.q18_inner_oracle(li1)),
    ]
    # one checked run of each query, with the launch counters read around
    # exactly this run of the main path
    _kernels.reset_launches()
    firsts = []
    for name, sf, tag, n_in, run, oracle in queries:
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        firsts.append(time.perf_counter() - t0)
        rows = TR.partial_rows(r.chunks)
        if r.engine != tag:
            raise SystemExit(f"{name}: engine {r.engine!r}, want {tag!r}")
        if rows != oracle():
            raise SystemExit(f"{name}: result differs from the oracle")
    launches = dict(_kernels.LAUNCHES)
    for k, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {k} was not launched on the main path")
    print(f"  launches on the main path: {launches}")
    for (name, sf, tag, n_in, run, oracle), first in zip(queries, firsts):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            r = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        nrows = sum(c.num_rows for c in r.chunks)
        print(f"  {name} {sf}: engine={r.engine} rows_in={n_in} "
              f"result_rows={nrows} exact=True first_ms={first*1e3:.1f} "
              f"p50_ms={statistics.median(times)*1e3:.2f} "
              f"runs_ms={[round(t * 1e3, 2) for t in times]}")

    print("== 5. result")
    kern["launches"] = launches["streamseg.rank_sums"]
    print(json.dumps({"kernels": [kern]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
