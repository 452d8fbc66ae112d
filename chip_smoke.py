#!/usr/bin/env python3
"""Drive tidb_tpu_torch on one NVIDIA card, end to end.

    python3 chip_smoke.py     # TPC-H at SF10 (Q1 at SF2, Q18's blocks at SF1)

Phases (any failure exits non-zero; no phase's failure is caught):

1. the card: `nvidia-smi` name and power limit, torch's device name;
   exits 1 at once when torch sees no CUDA device;
2. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, started together, always, even where a library is
   up to date, so that ptxas's register and spill report is read on every
   run: a spill fails it), with the build seconds, and the streamseg
   kernel's persistent launch (blocks per SM x SMs);
3. each kernel against its plain PyTorch version on the card, exactly
   (the kernels sum integers below 2^24 in f32, so any order is exact):
   ragged shapes (each output handed a freed NaN-filled block first, so an
   element the kernel skips shows), then the shapes the main path gives
   it at SF10 and at Q18-inner's SF1; times with CUDA events for the
   kernel, the plain version and two PyTorch library calls computing the
   same function (`index_add_` and `segment_reduce`), and the bound from
   bytes moved / operations done over the H100's published peaks;
4. the main path through the port's entry points on the card, in parts
   a-p, each with the launch counters set to 0 just before it and read
   just after (every kernel must have launched in each of parts a-d):
   a. single-table requests: TPC-H Q6 (SF10) and Q1 (SF1, Q18's
      lineitem; SF2 before part q, SF5 before part p; at SF10 the
      reference's int64-accumulator gate, |bound| * rows >= 2^62, sends
      Q1's sum_charge to its host path) through
      `CopClient.execute`, and
      Q18's inner GROUP BY ... HAVING (SF1; at SF10 its ~150k passing
      groups overflow the reference's 65,536-group HAVING buffer) through
      `execute_fragment`;
   b. gather joins through `execute_fragment`: Q12, Q14 and Q5 (dense
      aggregation, SF10), Q17's outer block (rows, SF10), Q18's outer
      block (rows, SF1: every lineitem row) and `q18_join_having` (GROUP
      BY o_orderkey HAVING over lineitem joined to orders, SF1 for the same
      buffer reason as Q18-inner; it must launch streamseg itself), then
      the peak device memory;
   c. TopN consumers through `execute_fragment`, all at SF10: Q3 (the
      fused join+agg+TopN cut over the run-ordered l_orderkey; it must
      launch streamseg itself) and Q10 (the fused cut over the sorted-run
      body, c_custkey), both `device[fat]`; `join_topn` (`device[topn]`,
      each of the 15 probe tiles' top 100 rows, checked chunk by chunk);
      `cust_having` (`device[hc]`, the sorted-run body's HAVING over all
      ~60M rows), then the peak device memory and the time of
      `cust_having`'s top-65,536 candidate selection alone;
   d. semi-joins, rows and scan TopN, all at SF10: Q4 (`device[agg+semi]`,
      an EXISTS bitmap over lineitem's late rows), Q16 and Q20's partsupp
      block (`device[rows+semi]`: NOT IN, IN; 8M partsupp rows),
      `semi_having` (`device[hc+semi]`: Q18-inner over the 1-URGENT
      orders' lineitems; it must launch streamseg itself) through
      `execute_fragment`; Q21's `lineitem l3` selection, Q13's bare orders
      scan, `row_proj` (a projection the host evaluates), `scan_topn` and
      `scan_topn3` (15 per-tile chunks each) through `CopClient.execute`,
      all `device`; then the peak device memory.
   e. the coprocessor's remaining one-device paths, through the same
      client (the default, `cuda`), at SF10 unless said otherwise:
      e1. overlay rows: lineitem and orders snapshots with 8,192 unfolded
          deltas each (the reference store's compaction threshold: 4,096
          updates, 2,048 deletes, 2,048 inserts; `--seed`), Q6 and
          `scan_topn` through `CopClient.execute` (`device`, a base and an
          overlay batch), Q12 with the overlay on its probe (`device[agg]`)
          and on its build (`host(fragment:build-overlay)`);
      e2. the host interpreter where the reference's gates send it at this
          scale: Q1 (`host(sum magnitude exceeds int64 accumulator)`) and
          Q18-inner (`host(fragment:group-overflow)`: it first takes the
          rank path, so it must launch streamseg, then its ~150k passing
          groups overflow the 65,536-group buffer; the host answers every
          order's group);
      e3. grouped approx_count_distinct (`device`; the register words equal
          the host twin's), then `device_column_stats` over every lineitem
          column (count, min and max exact; registers and NDV equal to the
          host twin's);
      e4. index-ranged scans of orders with indexes on o_custkey and
          o_orderdate (`ranged`): 1,000 seeded customer points and one
          month, over the plain and the overlay snapshot;
      e5. Q7's fragment at SF1 (`device[agg]`): the einsum strategy over
          5,408 dense slots, which builds no one-hot; its strategy, slots
          and the part's peak device memory.
      Part e launches no hand-written kernel except where a request takes
      the rank path (Q18-inner); its launch count is printed, and the
      check that every kernel launched stays on parts a-d.
   f. the SQL read path: TPC-H query text through the port's `Session`
      (parser, planner, root executor, the coprocessor on the card),
      after the earlier parts' client and snapshots are dropped:
      f1. all eight SF10 tables (the arrays generated for parts a-e)
          bulk-loaded into a `Session()` (load seconds), ANALYZE TABLE of
          all eight (device ANALYZE from 2M rows up; seconds), then Q6,
          Q14, Q12, Q5, Q3, Q10 and Q4 as SQL text through
          `Session.query`: each query's final rows equal to the numpy
          answer (`tpch_requests.sql_oracle`: the partial oracles
          finished as the root finishes them), its `last_engines` equal
          to the tag its coprocessor request carries in parts a-d, and Q3
          must launch streamseg; then each one's cold run, warm run,
          device-busy share of one profiled run, parse+plan ms and
          root-operator ms (from the session's stage recorder), the
          time of `WARM_RUNS` runs of the same coprocessor requests sent
          directly to the
          session's client with its snapshots (what the SQL layers add),
          and the part's peak device memory;
      f2. all 22 queries at SF1 (the arrays of the SF1 load) through a
          card `Session()` and a `Session(device="cpu")`, loaded and
          analyzed alike: rows equal exactly (in order where the query
          has ORDER BY), engine tags equal, Q18 must launch streamseg;
          the card's cold run (one warm run before part n) and the CPU's
          seconds.
          Q19 runs at SF0.003 (seed 1) instead: the reference plans it as
          a cross join of lineitem and part whose OR filter the root
          evaluates over every pair (1.2e12 pairs at SF1).
   g. the write path (after f1 and after f2, on their sessions), with the
      launch counters set to 0 before g1, before g1' and before g2:
      g1. on f1's card session at SF10: TPC-H RF1 (`bench/
          tpch_refresh.py`: 0.3 x SF x 1,500 new orders, `G1_RF_SHARE`,
          and their 1-7 lineitems from the generator's distributions,
          as autocommit 1,000-row INSERTs, orders first; each must take
          the `point` fast path) and RF2 (0.25 x SF x 1,500 seeded orders,
          `G1_RF2_SHARE`, and their lineitems deleted by DELETE ... IN,
          lineitem first, each
          statement below 8,192 rows: a commit of N >= 8,192 mutations
          costs the reference's commit path N^2 delta visits); Q6, Q3,
          Q5 and Q12 as SQL after RF2 (Q18 there overflows to the host
          tier, ~58 s: g1' and h2 read it at SF1), and Q6 mid-RF1 (lineitem deltas below the
          8,192 threshold, as overlay) and after RF1 (orders' overlay
          sends the four joins to the host tier there, ~120 s at SF10 per
          point, more than the time limit leaves: g1' reads them), each
          exact against the
          numpy answer over the arrays as modified, with its tags,
          streamseg's launches, cold run, warm p50 (3 runs; a host-tier
          read, seconds of numpy at this scale, only its cold run; the
          device-busy share in g1' only since part q); then one explicit
          transaction (BEGIN, 1,000 lineitem INSERTs, Q6 must see them,
          ROLLBACK, Q6 as before); per statement kind (INSERT, DELETE,
          commits that compacted) p50 and max ms, the device memory held
          after each compacting commit and the part's peak. At least one
          read must launch streamseg over a lineitem epoch that
          compaction rebuilt (checked after part h);
      g1'. the same at SF1 on f2's card and CPU sessions (all five
          queries after RF2; mid-RF1 and after RF1 only Q6, as g1: the
          four joins there take the host tier's build-overlay path): every
          statement's affected count and tags, and every read's rows and
          tags, equal between the two;
      g2. the reference's HTAP mix (`bench.py` flight_htap_mixed), in
          this process (not over the MySQL wire; the store is in memory,
          not durable): sbtest (id bigint primary key, k bigint, c
          varchar(64)) with 10,000 rows by 2,000-row INSERTs and
          lineitem at SF1 bulk-loaded in one Storage; the point SELECT
          and UPDATE must take the `point` fast path; then 2 s with 4
          point readers and 1 writer, and 2 s with 4 readers, 8 writers
          and 1 session scanning Q6 and Q1 (each exact against its numpy
          answer); sum(k) through the coprocessor on the card must equal
          the initial sum plus the acknowledged UPDATEs; point read and
          update p50/p99, QPS, scans per second, sbtest's compactions,
          the peak device memory.
   h. durability and the MySQL wire server (after part g's sessions are
      dropped; the filesystem of the store's temporary directory first,
      from `df -T`: fsync time is the disk's, not the card's):
      h1. the reference's HTAP mix as `bench.py` flight_htap_mixed runs
          it: `Storage(<tmp>, sync_log="commit")`, whose KV engine must be
          the port's NativeOrderedKV (`csrc/kvstore.cpp`, built with g++),
          sbtest's 10,000 rows (the reference's 100,000 until part j,
          20,000 until part o) by 2,000-row INSERTs, lineitem, orders and
          customer at SF1 bulk-loaded (their epoch files written), ANALYZE,
          `checkpoint()`, then `Server(storage, port=0,
          max_connections=256)` driven with `tests/mysql_client.py` (loaded
          by path, an encoding of the protocol independent of the
          server's): a point SELECT and UPDATE over the wire must take the
          `point` path (read from the server-side session's
          `last_engines`); 4 s of 4 readers and 1 writer, 4 s of 4
          readers, 8 writers and 1 client scanning Q6 and Q1 (each exact
          on every scan), and 2 s each of 1, 8 and 32 writers (durable
          update QPS, the group fsync's average batch, the fsync's mean
          time); sum(k) over the wire must equal its start plus the
          acknowledged UPDATEs; then the server's close and a clean
          `storage.close()`;
      h2. `Storage(path)` reopened and timed (recovery, epoch files, TSO
          floor); over a new `Server` on the card: sum(k) and count(*)
          unchanged, Q6, Q1 and Q18 exact with part f2's tags, Q18
          launching streamseg over the lineitem epoch that came from its
          file (`write_launches["h2"]`);
      h3. a child `python3` serving the store (the port only), 8 UPDATE
          writers over the wire for 2 s (4 s before part n), SIGKILL to
          the child with writes in flight, the store reopened on the card
          (timed: the WAL replay since the last checkpoint): sum(k)
          within [base + acknowledged, base + acknowledged + 8] (one write
          in flight a writer), Q6 exact.
      The check that a part g read launched streamseg over a rebuilt
      lineitem epoch runs after part h.
   i. online DDL and the schema surface (`ddl/ddl.py`, `catalog/
      infoschema.py`), each of i1, i2, i3 with the launch counters set to
      0 before it (`ddl_launches`):
      i1. on g1's SF10 card session right after g1, over the data as RF2
          left it: ALTER TABLE lineitem ADD COLUMN l_tag INT DEFAULT 7
          (sum(l_tag), count(*) exactly 7 x rows, rows), MODIFY COLUMN
          l_quantity DECIMAL(18,4) (every stored value times 100; the
          ANALYZE TABLE lineitem after it runs in i2 only, to pay for part
          j), Q6 and Q3 exact against their numpy answers with
          part f1's tags (Q3 must launch streamseg over the lineitem epoch
          the DDL rewrote), CREATE UNIQUE INDEX
          l_ok ON lineitem (l_orderkey), which must fail on its duplicate
          (errno 1105, the reference's for a rolled-back job) and leave no
          index, its job rolled back; DROP COLUMN l_tag,
          Q6 exact again; each statement's wall time, each reorg batch's
          time, the reads' cold run and warm p50, the peak device memory;
      i2. the same on g1''s SF1 card and CPU sessions (every statement's
          outcome and tags equal between the two; Q3 takes the host tier
          over orders' overlay there, as in g1'), plus CREATE UNIQUE INDEX
          c_nk ON customer (c_nationkey, c_custkey) (8 reorg batches; ADMIN
          SHOW DDL JOBS must show it done, SHOW INDEX list it; until part
          o o_ck ON orders (o_custkey, o_orderkey), ~75 batches, and i1
          ran that over SF10's 15M orders until part j), CREATE UNIQUE INDEX
          l_pk ON lineitem (l_orderkey, l_linenumber) (~300 batches) and
          an INSERT of an existing key (1062), a view over lineitem x
          orders read twice, a sequence feeding an INSERT, RENAME TABLE and
          back, SHOW TABLES / CREATE TABLE / INDEX, information_schema
          columns, tables and statistics, CHECKSUM TABLE orders, ADMIN
          CHECK TABLE lineitem, orders, and Q18 and Q1 after the MODIFY
          (Q18's streamseg launches reported);
      i3. on h3's reopened durable store: ALTER TABLE orders ADD COLUMN
          over the wire (orders' epoch file rewritten), SHOW CREATE TABLE
          and information_schema.columns over the wire; then a child
          `python3` serving the store with `TIDB_TPU_FAILPOINTS=
          ddl/before-step=exit(9)@K` (K half way through lineitem's reorg
          batches) runs CREATE UNIQUE INDEX l_pk over the wire and dies;
          the store reopened on the card (timed) resumes the job (the
          persisted state and reorg_pos printed; the reopened epoch has a
          new id, so the validation restarts on it, as in the reference);
          ADMIN SHOW DDL JOBS shows it done, SHOW INDEX lists l_pk, and Q18
          over the wire is exact with f2's tags, launching streamseg.
   j. partitioned tables (each partition its own `TableStore`; the
      reference plans each partition that pruning keeps as its own CopDAG
      request, never a fragment over a partition, so streamseg is expected
      to launch 0 times: `partition_launches`), each of j1, j2, j3 with the
      launch counters set to 0 before it:
      j1. after i1 (its session dropped), on the SF10 arrays: a new card
          `Session()` with orders and lineitem `PARTITION BY
          HASH(l_orderkey) PARTITIONS 4`, bulk-loaded through the port's
          numpy router (`tpch_data.load_table_partitioned`; seconds),
          ANALYZE TABLE lineitem (seconds); Q6 exact with four `device`
          tags and a point read of one l_orderkey pruned to one
          partition, the part's peak device memory; then the same
          partitioning of lineitem at SF0.1 (`J1_ROOT_SF`; generated
          from `--seed`, ANALYZEd): Q1 exact with four `device` tags and
          Q18's inner GROUP BY ... HAVING as SQL exact (its tags printed).
          Over partitions the reference plans no aggregation below the
          partition union, so these two bring every selected row to the
          root, whose host aggregation takes ~30 s a run at SF10. Each
          read's cold run and warm run;
      j2. after i2, on the SF1 arrays: a card `Session()` and a
          `Session(device="cpu")` with lineitem `PARTITION BY RANGE
          (l_orderkey)` (four equal key ranges and MAXVALUE) beside orders
          and customer; every statement's outcome and tags equal between
          the two: TPC-H RF1 and RF2 (half of g1''s share, `J2_RF_SHARE`)
          as routed INSERTs and
          DELETEs, an UPDATE of l_orderkey moving p0's last 2,000 keys
          into p1, an INSERT of a new l_shipmode value into p0 read
          through LIKE and IN from the other partitions (exact counts),
          TRUNCATE PARTITION p2 and DROP PARTITION p1 (device memory
          before and after each), information_schema.partitions, SHOW
          TABLE STATUS, CHECKSUM TABLE and ADMIN CHECK TABLE lineitem; Q6
          exact after the DML, and Q6, Q1 and Q18 exact after the
          partition DDL;
      j3. after i3, in part h's temporary directory: `Storage(<tmp>/pj,
          sync_log="commit")` with SF1 lineitem in 4 hash partitions
          (bulk load, epoch files), closed; a child `python3` runs 10
          routed INSERTs (~40 rows each) with `TIDB_TPU_FAILPOINTS=
          storage/mid-checkpoint=exit(9)@2`, then `checkpoint()`, and dies
          after two of the four partitions' epoch files are rewritten; the
          store reopened on the card (timed): every acknowledged INSERT
          read back, the next INSERT's handles above every handle of every
          partition, Q6 exact with four `device` tags.
   k. the function registry, the session functions and accounts, after
      i2 on f2's card and CPU sessions (an `fx:` op has no device
      lowering: its request is a projected scan, and streamseg is
      expected to launch 0 times: `registry_launches`):
      k1. every statement's outcome, tags and registry row-wise count
          (`REGISTRY_ROW_EVALS` by function) equal on the card and the CPU
          session, its cold run and warm run on the card:
          SUBSTRING_INDEX(l_shipmode, 'A', 1) as a GROUP BY key over
          1992's lineitem (the dictionary path; counts exact against
          numpy), SOUNDEX over a derived table whose l_quantity < 2 is
          pushed (the root Selection), DATE_FORMAT grouped over one month
          of shipdates (row by row), SHA2, REGEXP_LIKE, CONV, HEX and
          FORMAT over ORDER BY ... LIMIT 100 reads of the first orders and
          parts, JSON_CONTAINS and JSON_EXTRACT over a 500-row JSON
          table created and dropped in both sessions, FROM_UNIXTIME under
          time_zone '+00:00' and '+08:00' (eight hours apart, exact), and
          Q1 with DATE_FORMAT(max(l_shipdate), '%W %M %Y') added, exact
          against the numpy oracle at the l_quantity scale i2 left;
      k2. GET_LOCK('k', 0) held by one card session over the card's
          store, refused to a second, freed by RELEASE_ALL_LOCKS(); then
          the port's wire server on that store: SELECT SLEEP(20) ended by
          KILL QUERY from a second connection with errno 1317 within 2 s,
          and the connection's next Q6 exact;
      k3. over the same server, a user with SELECT on Q6's four lineitem
          columns and a role with SELECT on orders: Q6 exact, l_comment
          and orders refused with 1142 (the reference's errno for a column
          too), orders read after SET ROLE, an UPDATE refused; the user
          and the role dropped.
   l. the statement plane (`explain_launches`, the launch counters set to
      0 before l1 and before l2):
      l1. on f1's SF10 session right after f1 (before g1): EXPLAIN ANALYZE
          of Q6, Q3 and Q5: the root's actRows equal to f1's row count,
          each leaf's engine equal to f1's tag, each device leaf showing
          the `kernel` and `device_get` stages, a leaf's stages summing
          to at most its time_ms (but for the cells' rounding: 3
          significant digits a stage, 0.01 ms for the time), Q3 launching
          streamseg; each node's time and stages printed; then TRACE of
          Q6, whose tree must hold `copr.execute` (or `copr.fragment`),
          `device.dispatch` and `device.fetch`;
      l2. after part k, on f2's SF1 card and CPU sessions, card == CPU on
          each of: EXPLAIN ANALYZE of Q1, Q3 and Q18 (plan text, actRows,
          engines; times excluded); 500 seeded point SELECTs over 200
          orders keys (equal plan-cache hit, miss and eviction counts)
          and EXPLAIN ANALYZE's point row showing `plan_cache:hit`; a
          SESSION binding with a LEADING join hint on Q3 (applied:
          @@last_plan_from_binding 1, rows exact and unchanged; its plan
          text stays, as the fragment planner takes lineitem as Q3's
          probe in any order, in both packages) and one on a
          supplier x nation count whose plan text it changes; a GLOBAL
          binding seen from a second session of each store; the slow log
          with tidb_slow_log_threshold = 0 (the card's Q6 entry's stages
          hold `kernel`); one week of orders (< 8,192 rows) INTO OUTFILE,
          the two files byte-equal, and LOAD DATA of it into an empty
          copy of orders on each session, whose read equals the same read
          over the week; TRACE of a 100-row INSERT (the same span names,
          `twopc.prewrite` and `twopc.commit` among them); `SET
          max_execution_time = 100`: SELECT SLEEP(5) raises 3024 within
          1 s, the card's next Q6 exact under the same limit; and the
          part's statements_summary digests with equal exec counts.
   m. the observability planes and the governor (`observe_launches`, the
      launch counters set to 0 before m1 and before m2):
      m1. on f1's SF10 session right after l1 (before g1): Q6's warm p50
          with Top SQL and the wait profile off and on, over M1_AB_PAIRS
          pairs whose order alternates (off first, then on first), with
          each side's range; with both on,
          Q6, Q3 and Q5 once each: each moves `tidb_copr_requests_total`
          by one request under its leaf's engine class (f1's tag, the
          one leaf l1 showed: `device[...]` under device-fragment, a
          CopDAG `device` under device), and the `tidb_copr_column_cache_
          total` hit and miss deltas of each (Q3's is ROADMAP's S1
          reading) are printed; tidb_top_sql has each of the three
          digests with a device time (kernel + device_get) > 0 and at
          most its wall; metrics_schema.tidb_device_buffer_bytes > 0 and
          at most torch.cuda.memory_allocated(); inspection_result
          printed; Q3 launching streamseg; both planes off again;
      m2. after l2 on f2's SF1 card and CPU sessions (auto-analyze off,
          as in l2), card == CPU on each of: with Top SQL, the wait
          profile and the workload history on, Q1 (under @@profiling = 1:
          SHOW PROFILES one row, SHOW PROFILE not empty; frame names not
          compared), Q3 and Q18 once each: tidb_top_sql's digests and
          exec counts, tidb_plan_history's digests, plan digests, engines
          and exec counts; the wait states in tidb_wait_profile of a
          100-row INSERT; with the admission gate at 1 token, that token
          held, Q6 answering 9003 and tidb_events holding admission_shed;
          under the `governor/mem-pressure` failpoint over a 1 MiB limit,
          Q1 answering 8175, tidb_events holding governor_kill, and the
          next Q6 equal to the one before; metrics_schema's table names;
          inspection_summary's rule names. Then every plane off and no
          live `titpu-metrics-history` or `titpu-profiler` thread (part
          k's server started its store's sampler: part k stops it).
   n. the server process as an operator starts it (`server_launches`),
      after i3 on h3's durable store (SF1 lineitem, orders and customer,
      sbtest's 10,000 rows, `sync_log="commit"`), the launch counters set
      to 0 before it: a child `python -m tidb_tpu_torch.server --config
      n.toml --path <store> -P 0 --status <free port> --token-limit 16`
      (n.toml: the status port, Top SQL, the wait profile, a 1 s metrics
      history, a token limit of 64, the workload history, diagnostics,
      the maintenance worker ticking every second, TLS from the test pair
      under tests/data/, PROXY headers required from 127.0.0.1 and the
      lock-order checker armed from start-up):
      n1. the time to its listening line (the store's reopen and CUDA's
          start-up);
      n2. over TLS with a PROXY v1 header, Q6, Q1 and Q18 equal to h1's
          answers; n3. Q18's streamseg launches in the child, read from
          its /metrics (the `tidb_copr_jit_cache_total` lookups of the
          streamseg library, one a launch, and the device-fragment
          requests must grow across the query);
      n4. every ported status route answers 200 with the reference's
          keys; /debug/topsql holds Q18's digest with device time;
          /debug/trace/<conn> the tree of a TRACE; /debug/replicas the
          router's knobs and outcome counters; /debug/keyviz the heat
          plane's knobs; /debug/lockgraph the lock-order checker's graph
          (n.toml arms it: `[analysis] lock-check`); /debug/mesh 501;
      n5. SHOW PROCESSLIST from a second connection (PROXY v2) while the
          first runs SLEEP(2): the proxied hosts and the sleeping
          statement; information_schema.processlist agreeing; a user
          without PROCESS seeing only its own row;
      n6. under SET GLOBAL require_secure_transport = ON a plaintext
          login refused with 3159;
      n7. 300 seeded sbtest UPDATEs, SET GLOBAL tidb_gc_life_time = '1s',
          2.5 s of ticks: sum(k), count(*) and Q6 exact after the GC;
          then the child's lock-order checker: /debug/lockgraph enabled,
          the hot locks `Storage._commit_lock`, `Storage.infoschema_lock`,
          `MVCCStore._mu` (and `NativeOrderedKV._mu` on the native
          engine) registered, no cycle, no blocking call under a hot
          lock, no `lock-order-inversion` row in inspection_result; the
          lock, edge and cycle counts;
      n8. the config rewritten, SIGHUP: the reference's `config reloaded:
          [...]` line, Top SQL off, the flag's token limit kept;
      n9. SIGTERM: `shutting down...` and rc 0; the store reopened in this
          process: sum(k), count(*) unchanged, sbtest's versions between
          one a row and one a row plus part n's own UPDATEs (the child's
          GC dropped every version of the history before part n; how
          many of part n's own it kept depends on whether the clock has
          caught up with the reopened TSO's persisted lease, up to 120 s
          ahead of it), Q18 exact, launching streamseg.
   o. the cluster (`cluster_launches`), after part n closed its reopen
      of h3's store and before j3, the launch counters set to 0 before
      it:
      o1. the leader: `Storage(<store>, shared=True, rpc_listen=
          "127.0.0.1:0", sync_log="commit")` on the card (its engine must
          be the shared-WAL `PyOrderedKV`; the reopen timed) with a
          `Server`; a socket follower: a child `python -m
          tidb_tpu_torch.server --config o.toml --path <private dir> -P 0
          --status <free port>` (o.toml: `[transport] remote` the
          leader's address, `election-timeout-ms = 0`, a 3 s backoff
          budget, `[analysis] lock-check` armed), on the card, the time to
          its listening line; while it
          starts, a shared-directory sibling `Storage(<store>,
          shared=True)` with a card `Session` in this process;
      o2. on the leader, `o_li` (lineitem's columns) filled by INSERT ...
          SELECT of the orders below l_orderkey 1,000 in one statement
          of fewer than 8,192 rows (2,000 in two before part p),
          ANALYZE, and 300 seeded sbtest
          UPDATEs; over the wire the follower's sum(k), count(*) of
          sbtest and GROUP BY l_orderkey HAVING sum(l_quantity) > 150
          over o_li equal to the leader's and the numpy answer; its
          /metrics: requests by engine (a device engine must have served)
          and streamseg's library lookups;
      o3. Q18 on the sibling (the shared lineitem epoch, the WAL
          refreshed), exact with h1's answer, launching streamseg (counted
          in this process); ALTER TABLE sbtest ADD COLUMN on the sibling,
          read on the leader and over the wire on the follower;
      o4. a follower transaction that buffered an UPDATE before the
          leader's ALTER aborts at commit with 8028 and the row keeps its
          value; KILL QUERY from the leader ends SLEEP(20) on the
          follower (the RPC kill mailbox), and from the sibling's session
          one on the leader (the shared-directory mailbox), each with
          1317;
      o5. on the leader, information_schema.cluster_info with the
          reference's columns lists the follower, cluster_load carries
          its device rows (the bytes it uploaded > 0); the follower's
          /status carries its `transport` section; the follower's
          lock-order checker as n7 reads the child's;
      o6. the leader closed: the follower's next read answers the last
          replicated state, its next write 9001 within o.toml's budget;
          SIGTERM: `shutting down...` and rc 0; the sibling closed. Each
          step's time and the part's lap.
   p. follower reads and automatic failover (`failover_launches`), after
      part o in this process (no child process), the launch counters set
      to 0 before it:
      p0. a fresh leader `Storage(<tmp>/p_leader, shared=True,
          rpc_listen="127.0.0.1:0", sync_log="commit")` and two socket
          followers in this process (`election_timeout_ms` 1,500,
          `promote_listen` 127.0.0.1:0), every session on the card;
          sysbench's sbtest (id, k, c CHAR(120), pad CHAR(60), index
          k_1) with 10,000 seeded rows by 2,000-row INSERTs on the
          leader, timed; then the wait (60 s at most, timed) until the
          leader's registry shows both followers serving and applied
          past a leader timestamp taken after the last INSERT: a routed
          read needs a follower that covers its read ts, or one whose
          fold catches up within the serving side's bounded wait
          (~0.65 s), which a host slower than the fold does not give;
      p1. with `tidb_replica_read = 'follower'` on a leader session, sum(k),
          count(*) and a GROUP BY k HAVING count(*) > 12, twice each: each
          routed (`replica@host:port`), equal to the leader's local answer
          and the oracle of acknowledged writes, `served` +1 and the
          process's `device` / `device-fragment` requests up, the serving
          follower's pooled session on `cuda` with a `device` tag; each
          routed read's ms beside the leader's warm local ms; a
          `tidb_read_staleness = -1` read routed and exact; EXPLAIN
          ANALYZE's first row `replica@...`, stage `replica_read:<s>`;
      p2. under `replica/apply-stall` (after an UPDATE) the read falls
          back `stale_fallback` with a Note, exact; once both followers
          have caught up again (as in p0), under `net/partition` toward
          both followers' diag addresses, `unreachable_fallback` with a
          Note, exact;
      p3. the leader's RPC server closed without ceremony: the follower
          with the longest replicated WAL (ties to the lowest node id)
          promotes to term 2 and the other repoints, both timed from the
          close; an INSERT and an UPDATE through each (one answered 9001
          in the moments after the repoint, while a call that exhausted
          its budget against the dead leader has the survivor marked
          degraded, is retried within 5 s and counted); every acknowledged
          row (`id, k` in order), the sum and the HAVING read back on both
          on the card; an old-term `wal_append` refused with
          `StaleTermError`; device memory before and after the promotion;
          streamseg's launches over the two nodes' reads;
      q. the range plane on the same leader (`range_launches`), after p2
         and before p3:
      q0. `Config.seed_heatmap` and `Config.seed_ranges` from a TOML
          ([ranges] enabled, count 4, lease-ms 1000, resolve-ttl-ms
          3000; [heatmap] enabled, bucket-seconds 1), the range table
          bootstrapped first at sbtest's record keys of ids 2,500, 5,000
          and 7,500; the time until the range server hosts 4 ranges;
      q1. p1's three reads on a leader session, 500 seeded point
          SELECTs, 300 UPDATEs of c (sysbench's non-index update) of ids
          in [5000, 7500), paced over 4 s: tidb_hot_ranges' read rows and
          bytes of each scan split over the 4 ranges by the reference's
          rule, the same bytes noted by a cuda and a cpu session's scan,
          the point reads by range, sbtest's written keys all in the hot
          range, a `hot_range` event, a `range-split-advisory` finding in
          information_schema.inspection_result with its key strictly
          inside the hot range, /debug/keyviz's matrix and /status's
          `ranges` from an in-process status server;
      q4a. `[ranges] auto-split = true` by a reseed while the advisory
          fires (UPDATEs go on): the actuator splits the hot range inside
          its bounds, `tidb_range_splits_total{trigger="auto"}` +1, the
          parent's heat retired; auto-split off again;
      q2. 200 cross-range 2PC transactions through
          `leader.ranges.committer(leader.tso)` (keys in 2-3 ranges),
          read back through the router; `closed_over` covering the newest
          commit ts; transactions per second;
      q3. `[replica-read] range-aware = true` by `Config.seed_replica_read`:
          a covered sum(k), count(*) served by a follower on `cuda`; a
          wedge prewrite (ttl 60 s) in sbtest's span: `stale_fallback`
          with the `uncovered ... range#` Note, exact on the leader's
          card; rolled back, routed again within 8 s;
      q4b. a manual `split_range` between routed reads (every answer
          exact, `trigger="manual"` +1; the split's, `export_range`'s and
          `discard_range`'s times); a peer `RangeServer` over the
          leader's root and `range/lease-drop` for one range: the
          transfer counter moves, the term rises, an old-term request
          answers `StaleTermError`, the other ranges keep owner and term;
          the peer closed;
      q5. device memory before and after, streamseg's launches in q;
      p4. every store closed (followers first), no new `titpu-*` thread
          left (the range plane's lease thread included). Each step's
          time.
   Each result of parts a-e is checked exactly against its numpy oracle
   (row results column by column, in order) with the reference's engine
   tag; then the first (cold) run and the wall time of 1 warm run
   (`WARM_RUNS`: the p50 of 5 before part h, 3 before part l, 2 before
   part n; parts i and j read as many), each ending in
   torch.cuda.synchronize(), and the device-busy share of one more warm
   run under torch.profiler (traced kernel and copy time over its wall
   time; in parts c and d also the 8 kernels that took the most of it;
   in part e since part q only ANALYZE's and the ranged reads'). A
   `host(...)` request takes its cold run only (seconds of numpy; 2 warm
   runs before part g needed the room, as part f2's queries went from 3
   warm runs to 1); a `ranged` one takes 2 warm runs, the second of them
   the profiled one;
5. one JSON line of per-kernel numbers, the nvidia-smi line, and last the
   line {"ok": true, "device": {...}}.

Data comes from the port's seeded TPC-H generator (`--seed`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tidb_tpu_torch import obs
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_refresh as RF
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.copr import analyze as AN
from tidb_tpu_torch.copr import streamseg as SS
from tidb_tpu_torch.copr import sumexact as SE
from tidb_tpu_torch.copr import topnpack as TP
from tidb_tpu_torch.copr.client import CopClient, _bucket
from tidb_tpu_torch.copr.fragment import execute_fragment
from tidb_tpu_torch.copr.sumexact import limbs_of
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.plan.fragment import FragmentDAG
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.util import failpoint
from tidb_tpu_torch.util.governor import AdmissionTimeout

# warm runs of each request in parts a-f1, i and j (5 before part h
# needed the room, 3 before part l did, 2 before part n did)
WARM_RUNS = 1
# part m's cuts (depth only): one warm run for e3's ANALYZE, g's reads
# and k1's reads (WARM_RUNS before part m)
M_CUT_WARM_RUNS = 1

# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
L2_BYTES = 50e6


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
# len(f) (with values: they join the last rank), a tail of pad rows that
# fills whole tiles, rows of vals that start unaligned (n % 4 != 0), and
# sizes that are multiples of no block
RAGGED = ((1, 1, 1, 0), (4095, 7, 4, 0), (4097, 20, 8, 3),
          (100_003, 300, 4, 1021), (1_000_003, 4096, 8, 0),
          (777_777, 1, 4, 5), (6000, 7, 4, 3500), (9999, 13, 2, 0))


def _ragged_phase(seed: int) -> None:
    """streamseg.rank_sums against its plain version at RAGGED shapes."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    for n, max_run, K, extra in RAGGED:
        name = f"n={n} runs<={max_run} K={K} pad={extra}"
        keys = _run_keys(rng, n, max_run)
        meta = SS.rank_meta([keys])
        assert meta is not None, name
        vals = rng.integers(-2048, 4096, (K, n + extra)).astype(np.float32)
        v = torch.as_tensor(vals, device=dev)
        f = torch.as_tensor(meta["f"], device=dev)
        nd, nd_pad = meta["nd"], meta["nd_pad"]
        # the kernel's output starts empty: free a NaN-filled block of its
        # size first, so the caching allocator hands that block back
        torch.full((K, nd_pad), float("nan"), device=dev)
        got = _kernels.streamseg_rank_sums(v, f, nd, nd_pad)
        want = SS.rank_sums_plain(v, f, nd, nd_pad)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        print(f"  streamseg {name}: identity={meta['identity']} "
              f"nd={nd} exact={ok}")
        if not ok:
            raise SystemExit(f"streamseg kernel != plain at {name}")


def _shape_phase(li, label: str) -> dict:
    """streamseg.rank_sums at the shape Q18's inner block gives it on
    lineitem `li`: K = 4 arrays (row mask, count mask, two 12-bit limbs of
    l_quantity) over the whole staged epoch, ranks = orders. Exactness
    against the plain version and both library calls, then times."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    meta = SS.rank_meta([li["l_orderkey"]])
    n0, nd, nd_pad = meta["n0"], meta["nd"], meta["nd_pad"]
    n_pad = _bucket(n0)
    qty = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    qty[:n0] = torch.as_tensor(li["l_quantity"].astype(np.int32),
                               device=dev)
    live = torch.arange(n_pad, device=dev) < n0
    lo, hi = limbs_of(qty, 2)
    vals = torch.stack([live.float(), live.float(), lo.float(),
                        hi.float()]).contiguous()
    f = torch.as_tensor(meta["f"], device=dev)
    K = vals.shape[0]
    # library inputs, built outside the timed region: per-row ranks for
    # index_add_, per-rank run lengths (pad rows join the last run) for
    # segment_reduce
    rank64 = torch.cumsum(torch.cat([f, f.new_zeros(n_pad - n0)]), 0)
    lens = np.diff(np.append(meta["r0"][:nd].astype(np.int64), n0))
    lens[-1] += n_pad - n0
    L = torch.as_tensor(lens, device=dev).expand(K, nd).contiguous()
    print(f"  {label} shape: K={K} n0={n0} n_pad={n_pad} nd={nd} "
          f"nd_pad={nd_pad} maxd={meta['maxd']} "
          f"(setup {time.perf_counter() - t0:.1f}s)")

    def kernel():
        return _kernels.streamseg_rank_sums(vals, f, nd, nd_pad)

    def plain():
        return SS.rank_sums_plain(vals, f, nd, nd_pad)

    def index_add():
        return torch.zeros(K, nd_pad, device=dev).index_add_(1, rank64, vals)

    def segment_reduce():
        return torch.segment_reduce(vals, "sum", lengths=L, axis=1)

    want = plain()
    got = kernel()
    seg = torch.nn.functional.pad(segment_reduce(), (0, nd_pad - nd))
    idx = index_add()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    for what, res in (("kernel", got), ("segment_reduce", seg),
                      ("index_add_", idx)):
        if not torch.equal(res, want):
            raise SystemExit(f"streamseg {what} != plain at {label}")
    del got, seg, idx
    ms = _cuda_ms(kernel, 20)
    plain_ms = _cuda_ms(plain, 5)
    lib_ms = {"index_add_": _cuda_ms(index_add, 5),
              "segment_reduce": _cuda_ms(segment_reduce, 5)}
    library_call = min(lib_ms, key=lib_ms.get)
    nbytes = vals.numel() * 4 + f.numel() * 4 + K * nd_pad * 4
    ops = vals.numel()  # one add per value
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    warm = ""
    if nbytes < 10 * L2_BYTES:
        warm = (f"; {nbytes / 1e6:.1f} MB is only {nbytes / L2_BYTES:.1f}x "
                f"the 50 MB L2, so back-to-back launches leave it partly "
                f"warm")
    print(f"  streamseg {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, index_add_ {lib_ms['index_add_']:.4f} ms, segment_reduce "
          f"{lib_ms['segment_reduce']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e9:.4f} GB), {bound_ms / ms:.1%} of the bound, "
          f"exact=True{warm}")
    return {"shape": label, "n_pad": n_pad, "nf": f.numel(), "nd": nd,
            "nd_pad": nd_pad, "K": K, "bytes": nbytes, "max_abs_err": err,
            "exact": True, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_share": bound_ms / ms,
            "library_ms": lib_ms[library_call],
            "library_call": library_call,
            "index_add_ms": lib_ms["index_add_"],
            "segment_reduce_ms": lib_ms["segment_reduce"]}


def _load(sf: float, seed: int, names, first_table_id: int):
    """Generate TPC-H at `sf` and load the named tables: -> (generated
    arrays of those tables, name -> TableInfo, table id -> snapshot)."""
    t0 = time.perf_counter()
    data = TD.generate_tpch(sf, seed)  # all eight tables: part f loads them
    tables, snaps = TR.load_tables(data, names, first_table_id)
    print(f"  generated + loaded SF{sf:g} {', '.join(names)} "
          f"({len(data['lineitem']['l_orderkey'])} lineitem rows) in "
          f"{time.perf_counter() - t0:.1f}s")
    return data, tables, snaps


def _same_columns(got: list, want: list) -> bool:
    return len(got) == len(want) and \
        all(np.array_equal(a, b) for a, b in zip(got, want))


def _device_busy(run, top: int = 0) -> tuple[str, float]:
    """One more warm run under torch.profiler: the summed time of the CUDA
    kernels and copies it traced against the run's wall time, and with
    `top` the `top` kernels that took the most of it (name, launches, ms).
    Only device activity is traced: the CPU ops' events gave the same
    device time and cost up to a second of post-processing a request.
    -> (that text, the profiled run's wall ms)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    if busy_ms == 0:
        return (f"device_busy=not measured (no device event traced) in "
                f"profiled_wall_ms={wall_ms:.2f}", wall_ms)
    out = (f"device_busy_ms={busy_ms:.2f} of profiled_wall_ms={wall_ms:.2f} "
           f"({busy_ms / wall_ms:.1%} busy)")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        out += f"\n      {us / 1e3:9.2f} ms in {n:4d} x {name[:100]}"
    return out, wall_ms


def _host_tier(engine: str) -> bool:
    """Requests the reference serves on the host by design: its host
    interpreter (`host(<reason>)`) and index-ranged scans (`ranged`)."""
    return engine.startswith("host(") or engine == "ranged"


def _timing(first: float, times: list) -> str:
    """The cold run, then the p50 and every warm run, a lone warm run
    as such, or none."""
    out = f"first_ms={first * 1e3:.1f}"
    if not times:
        return f"{out} (cold run only)"
    if len(times) == 1:
        return f"{out} warm_ms={times[0] * 1e3:.2f}"
    return (f"{out} p50_ms={statistics.median(times) * 1e3:.2f} "
            f"runs_ms={[round(t * 1e3, 2) for t in times]}")


# where parts e and g1 spend their time (seconds by kind, summed by
# `_sublap` and printed with the part's lap by `_sublap_line`): the cold
# runs, the oracle checks, the warm and the profiled runs, and the part's
# own host work (snapshots, ANALYZE's host twin, statements, folds, the
# CPU twin, refresh data)
SUBLAPS: dict = {}


@contextlib.contextmanager
def _sublap(kind: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SUBLAPS[kind] = SUBLAPS.get(kind, 0.0) + time.perf_counter() - t0


def _sublap_line(label: str, lap_s: float) -> None:
    got = sorted(SUBLAPS.items(), key=lambda kv: -kv[1])
    SUBLAPS.clear()
    rest = lap_s - sum(v for _, v in got)
    print(f"  sub-laps of {label} ({lap_s:.1f}s): "
          + ", ".join(f"{k} {v:.2f}s" for k, v in got)
          + f", other {rest:.2f}s")


def _arg_key(v):
    """An oracle argument as a cache key: dicts (tables, columns) and
    tuples (a string column's (vocabulary, codes)) by their items, every
    other object (arrays, a vocabulary's list) by identity."""
    if isinstance(v, dict):
        return ("d",) + tuple((k, _arg_key(x)) for k, x in v.items())
    if isinstance(v, tuple):
        return ("t",) + tuple(_arg_key(x) for x in v)
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    return ("id", id(v))


@contextlib.contextmanager
def _oracle_memo():
    """Each numpy oracle of `bench/tpch_requests.py` computed once for the
    same arrays while this is open: parts a-d, e and f1 check requests
    over the same SF10 arrays (part f1's seven SQL queries are parts a-d's
    requests), and so do g1 after RF2 and i1. An entry keeps its
    arguments alive, so an id is never reused while the cache holds
    it."""
    cache: dict = {}
    names = [n for n in dir(TR) if n.endswith("_oracle")
             and n != "sql_oracle" and callable(getattr(TR, n))]
    plain = {n: getattr(TR, n) for n in names}
    saved = []

    def memo(name):
        fn = plain[name]

        def run(*a, **kw):
            key = (name, _arg_key(a), _arg_key(kw))
            hit = cache.get(key)
            if hit is None:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                hit = cache[key] = (out, time.perf_counter() - t0, a, kw)
            else:
                saved.append((name, hit[1]))
            return hit[0]
        return run

    for n in names:
        setattr(TR, n, memo(n))
    try:
        yield
    finally:
        for n, fn in plain.items():
            setattr(TR, n, fn)
        cache.clear()
        # the time each hit did not spend: its first computation's
        print(f"  oracle memo: {len(saved)} hits, "
              f"{sum(t for _, t in saved):.2f}s not spent again "
              f"({', '.join(f'{n} {t:.2f}s' for n, t in saved)})")


def _drive(label: str, queries: list, top: int = 0,
           every_kernel: bool = True, profile: bool = True) -> dict:
    """One checked run of each query, with the launch counters set to 0
    just before this part of the main path and read just after, then the
    p50 of WARM_RUNS warm runs and, with `profile`, one profiled run
    (with its `top` costliest CUDA kernels). A `host(...)` request takes
    its cold run only (seconds of numpy, which the profiler does not
    trace), a `ranged` one 2 warm runs, the second of them profiled.
    queries: [(name, scale, tag, rows in, run, check, kernels this query
    must launch itself)]. `every_kernel`: each kernel must launch in this
    part. -> the launch counts."""
    _kernels.reset_launches()
    firsts, results = [], []
    for name, sf, tag, n_in, run, check, must in queries:
        before = dict(_kernels.LAUNCHES)
        with _sublap("cold runs"):
            t0 = time.perf_counter()
            r = run()
            torch.cuda.synchronize()
            firsts.append(time.perf_counter() - t0)
        if r.engine != tag:
            raise SystemExit(f"{name}: engine {r.engine!r}, want {tag!r}")
        with _sublap("oracle checks"):
            ok = check(r)
        if not ok:
            raise SystemExit(f"{name}: result differs from the oracle")
        for k in must:
            if _kernels.LAUNCHES[k] == before[k]:
                raise SystemExit(f"{name} did not launch kernel {k}")
        results.append(r)
    launches = dict(_kernels.LAUNCHES)
    for k, n in launches.items():
        if n == 0 and every_kernel:
            raise SystemExit(f"kernel {k} was not launched on the {label}")
    print(f"  launches on the {label}: {launches}")
    for (name, sf, _, n_in, run, _, _), first, r in zip(queries, firsts,
                                                        results):
        host = _host_tier(r.engine)
        if r.engine.startswith("host("):
            times = []
            busy = "device busy: not measured (host tier, cold run only)"
        else:
            times = []
            with _sublap("warm runs"):
                for _ in range(1 if host else WARM_RUNS):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            busy = "device busy: not measured (no profiled run here)"
            if profile or host:
                with _sublap("profiled runs"):
                    busy, wall = _device_busy(run, top)
            if host:
                times.append(wall / 1e3)
        nrows = sum(c.num_rows for c in r.chunks)
        print(f"  {name} {sf}: engine={r.engine} rows_in={n_in} "
              f"result_rows={nrows} exact=True {_timing(first, times)}")
        print(f"    {busy}")
        if r.is_partial_agg and nrows <= 8 and \
                len(r.chunks[0].columns) <= 20:
            print(f"    rows: {TR.partial_rows(r.chunks)}")
    return launches


def _main_path(args, cop, at_sf, at_q18_sf) -> tuple[dict, dict]:
    """Phase 4 through `cop`: at_sf and at_q18_sf are `_load` results at
    --sf and --q18-sf. -> (kernel launches over the four parts, request
    name -> the engine tag it was checked against)."""
    d10, t10, s10 = at_sf
    d1, t1, s1 = at_q18_sf
    li10, li1 = d10["lineitem"], d1["lineitem"]
    # Q1 at --q18-sf (the default) reads that scale's lineitem, which is
    # already loaded: no second generation
    d5, t5, s5 = (at_q18_sf if args.q1_sf == args.q18_sf else
                  _load(args.q1_sf, args.seed, ("lineitem",), 21))
    li5 = d5["lineitem"]
    sf10, sf1 = f"SF{args.sf:g}", f"SF{args.q18_sf:g}"

    def agg_check(oracle):
        return lambda r: TR.partial_rows(r.chunks) == oracle()

    def rows_check(oracle):
        return lambda r: _same_columns(TR.row_columns(r.chunks), oracle())

    lt10, lt1 = t10["lineitem"], t1["lineitem"]
    single = [
        ("Q6", sf10, "device", len(li10["l_orderkey"]),
         lambda: cop.execute(TR.q6_dag(lt10), s10[lt10.id]),
         agg_check(lambda: TR.q6_oracle(li10)), ()),
        ("Q1", f"SF{args.q1_sf:g}", "device", len(li5["l_orderkey"]),
         lambda: cop.execute(TR.q1_dag(t5["lineitem"]),
                             s5[t5["lineitem"].id]),
         agg_check(lambda: TR.q1_oracle(li5)), ()),
        ("Q18-inner", sf1, "device[hc]", len(li1["l_orderkey"]),
         lambda: execute_fragment(cop, TR.q18_inner_frag(lt1),
                                  {lt1.id: s1[lt1.id]}),
         agg_check(lambda: TR.q18_inner_oracle(li1)), ()),
    ]

    def join(name, label, tag, tables, snaps, data, must=(), check=None):
        frag = TR.JOIN_REQUESTS[name](tables)
        fsnaps = {t.table.id: snaps[t.table.id]
                  for t in frag.tables + [sm.table for sm in frag.semis]}
        oracle = getattr(TR, f"{name}_oracle")
        if check is None:
            check = (agg_check if frag.agg is not None else rows_check)(
                lambda: oracle(data))
        return (name, label, tag,
                fsnaps[frag.tables[0].table.id].epoch.num_rows,
                lambda: execute_fragment(cop, frag, fsnaps), check, must)

    def dag(name, check=None):
        """A single-table row or TopN request at --sf."""
        req = TR.DAG_REQUESTS[name](t10)
        snap = s10[req.scan.table_id]
        if check is None:
            check = rows_check(lambda: getattr(TR, f"{name}_oracle")(d10))
        return (name, sf10, "device", snap.epoch.num_rows,
                lambda: cop.execute(req, snap), check, ())

    joins = [
        join("q12", sf10, "device[agg]", t10, s10, d10),
        join("q14", sf10, "device[agg]", t10, s10, d10),
        join("q5", sf10, "device[agg]", t10, s10, d10),
        join("q17_outer", sf10, "device[rows]", t10, s10, d10),
        join("q18_outer", sf1, "device[rows]", t1, s1, d1),
        join("q18_join_having", sf1, "device[hc]", t1, s1, d1,
             must=("streamseg.rank_sums",)),
    ]

    def tiles_check(oracle):
        """Row TopN: one chunk per probe tile, each the tile's top rows."""
        n_tiles = -(-len(li10["l_orderkey"]) // cop.TILE_ROWS)
        return lambda r: len(r.chunks) == n_tiles and _same_columns(
            TR.row_columns(r.chunks), oracle(d10, cop.TILE_ROWS))

    topn = [
        join("q3", sf10, "device[fat]", t10, s10, d10,
             must=("streamseg.rank_sums",)),
        join("q10", sf10, "device[fat]", t10, s10, d10),
        join("join_topn", sf10, "device[topn]", t10, s10, d10,
             check=tiles_check(TR.join_topn_oracle)),
        join("cust_having", sf10, "device[hc]", t10, s10, d10),
    ]
    rows = [
        join("q4", sf10, "device[agg+semi]", t10, s10, d10),
        join("q16", sf10, "device[rows+semi]", t10, s10, d10),
        join("q20_semi", sf10, "device[rows+semi]", t10, s10, d10),
        join("semi_having", sf10, "device[hc+semi]", t10, s10, d10,
             must=("streamseg.rank_sums",)),
        dag("q21_rows"),
        dag("q13_orders_scan"),
        dag("row_proj"),
        dag("scan_topn", check=tiles_check(TR.scan_topn_oracle)),
        dag("scan_topn3", check=tiles_check(TR.scan_topn3_oracle)),
    ]
    print("  -- a. single-table requests")
    launches = _drive("single-table path", single)
    torch.cuda.reset_peak_memory_stats()
    print("  -- b. gather joins")
    for k, n in _drive("join path", joins).items():
        launches[k] += n
    print(f"  device memory after the join path: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB during it")
    torch.cuda.reset_peak_memory_stats()
    print("  -- c. TopN consumers")
    for k, n in _drive("TopN path", topn, top=8).items():
        launches[k] += n
    print(f"  device memory after the TopN path: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB during it")
    torch.cuda.reset_peak_memory_stats()
    print("  -- d. semi-joins, rows and scan TopN")
    for k, n in _drive("semi/row path", rows, top=8).items():
        launches[k] += n
    print(f"  device memory after the semi/row path: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB during it")
    # the HAVING / all-groups candidate selection of the sorted-run body,
    # alone, at cust_having's shape: the top HAVING_CAP of n_pad row
    # scores, the passing groups' 1.0 among -inf
    n_pad = _bucket(len(li10["l_orderkey"]))
    name, _, _, _, run, _, _ = topn[-1]
    assert name == "cust_having"
    n_pass = sum(c.num_rows for c in run().chunks)
    score = torch.full((n_pad,), float("-inf"), device="cuda")
    score[torch.randperm(n_pad, device="cuda")[:n_pass]] = 1.0
    ms = _cuda_ms(lambda: TP.topk_desc(score, FragmentDAG.HAVING_CAP), 5)
    print(f"  cust_having's candidate selection alone: topk_desc k="
          f"{FragmentDAG.HAVING_CAP} over {n_pad} scores ({n_pass} at 1.0): "
          f"{ms:.2f} ms")
    del score
    tags = {q[0]: q[2] for q in single + joins + topn + rows}
    return launches, tags


def _q18_groups_check(li):
    """Q18-inner's host answer: every order's group (the HAVING runs above
    the coprocessor), as (l_orderkey, sum(l_quantity), rows) columns;
    lineitem is stored in l_orderkey runs."""
    def check(r) -> bool:
        if len(r.chunks) != 1:
            return False
        key, val, cnt = (c.data for c in r.chunks[0].columns)
        order = np.argsort(key, kind="stable")
        keys, start, counts = np.unique(li["l_orderkey"], return_index=True,
                                        return_counts=True)
        sums = np.add.reduceat(li["l_quantity"], start)
        return all(np.array_equal(a[order], b) for a, b in
                   ((key, keys), (val, sums), (cnt, counts)))
    return check


def _distinct(col: np.ndarray) -> np.ndarray:
    """The distinct values of an integer column (one pass over a table of
    its value range)."""
    lo = int(col.min())
    present = np.zeros(int(col.max()) - lo + 1, dtype=bool)
    present[col - lo] = True
    return lo + np.nonzero(present)[0]


def _analyze(cop, snap, label: str) -> None:
    """`device_column_stats` over every column of `snap`: the cold run,
    the p50 of 3 warm runs and the device-busy share; count, min and max
    exact against numpy, and each column's registers (from the same
    per-tile reductions over the cached tiles) and NDV equal to the host
    twin's. The twin reads each column's distinct values: a register is a
    max over values, so repeats cannot change it."""
    from tidb_tpu_torch.copr.client import widen32
    from tidb_tpu_torch.plan.dag import CopDAG, DAGScan
    offsets = list(range(snap.table.num_columns))

    def run():
        return AN.device_column_stats(cop, snap, offsets)

    with _sublap("cold runs"):
        t0 = time.perf_counter()
        stats = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    with _sublap("ANALYZE twin check"):
        tiles = cop._stage_tiles(
            CopDAG(scan=DAGScan(snap.table.id, offsets)), snap)
        n = snap.epoch.num_rows
        for off in offsets:
            col = snap.epoch.columns[off]
            regs = None
            for cols, vis, _ in tiles:
                (d, v), = widen32([cols[off]])
                r = AN._column_partials(d, v & vis)["regs"].cpu().numpy()
                regs = r if regs is None else np.maximum(regs, r)
            vals = _distinct(col)
            want = AN.hll_group_registers_host(
                AN.hll_hash_src_int(vals), np.ones(len(vals), bool),
                np.zeros(len(vals), np.int64), 1)[0]
            cnt, mn, mx, ndv = stats[off]
            ok = (cnt == n and int(mn) == int(col.min())
                  and int(mx) == int(col.max())
                  and np.array_equal(regs, want)
                  and ndv == AN.hll_ndv(want, float(n)))
            if not ok:
                raise SystemExit(f"ANALYZE column {off}: {stats[off]} "
                                 f"differs from the host twin")
    times = []
    with _sublap("warm runs"):
        for _ in range(M_CUT_WARM_RUNS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    with _sublap("profiled runs"):
        busy, _ = _device_busy(run)
    print(f"  ANALYZE {label}: {len(stats)} columns exact (count, min, max, "
          f"256 registers, NDV) first_ms={first*1e3:.1f} "
          f"p50_ms={statistics.median(times)*1e3:.2f} "
          f"runs_ms={[round(t * 1e3, 2) for t in times]}")
    print(f"    {busy}")
    print(f"    ndv: {[stats[off][3] for off in offsets]}")


def _part_e(args, cop, at_sf, at_q18_sf) -> dict:
    """Phase 4 part e through `cop` (see the module docstring): overlay
    rows, the host tier, HLL and ANALYZE, index-ranged scans, and Q7's
    einsum. -> the part's kernel launches."""
    d10, t10, s10 = at_sf
    d1, t1, s1 = at_q18_sf
    li10, o10 = d10["lineitem"], d10["orders"]
    lt, ot = t10["lineitem"], t10["orders"]
    sf10, sf1 = f"SF{args.sf:g}", f"SF{args.q18_sf:g}"
    n_li = len(li10["l_orderkey"])
    t0 = time.perf_counter()
    with _sublap("overlay snapshots"):
        l_ov, l_vis, l_rows = TR.overlay_snapshot(s10[lt.id], li10,
                                                  args.seed)
        o_ov, _, o_rows = TR.overlay_snapshot(s10[ot.id], o10,
                                              args.seed + 1)
    print(f"  overlay snapshots of lineitem and orders: "
          f"{len(l_ov.overlay_handles)} overlay rows of 8192 deltas each "
          f"({time.perf_counter() - t0:.1f}s)")
    cols6 = ("l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
             "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipmode")

    built = {}
    saved = []

    def once(key, build):
        # built once; a later call's saving is the build's time
        if key in built:
            saved.append(built[key][1])
        else:
            t0 = time.perf_counter()
            out = build()
            built[key] = (out, time.perf_counter() - t0)
        return built[key][0]

    def li_base():
        """The visible base rows of the lineitem overlay snapshot (built
        once: two checks read them)."""
        return once("li_base", lambda: TR.rows_of(
            {c: li10[c] for c in cols6}, l_vis))

    def seen_orders(snap, ov=None):
        """The rows an orders snapshot shows (built once a snapshot: the
        build-overlay Q12 and both ranged reads check against them)."""
        return once((id(snap), id(ov)),
                    lambda: TR.visible_rows(snap, o10, ov))

    def agg_check(oracle):
        return lambda r: TR.partial_rows(r.chunks) == oracle()

    def rows_check(oracle):
        return lambda r: _same_columns(TR.row_columns(r.chunks), oracle())

    n_tiles = -(-n_li // cop.TILE_ROWS)

    def topn_check(r):
        base = TR.scan_topn_oracle(d10, cop.TILE_ROWS, visible=l_vis)
        ov = TR.scan_topn_oracle({"lineitem": l_rows},
                                 len(l_ov.overlay_handles))
        return len(r.chunks) == n_tiles + 1 and _same_columns(
            TR.row_columns(r.chunks),
            [np.concatenate([a, b]) for a, b in zip(base, ov)])

    q12 = TR.q12_frag(t10)
    topn_dag = TR.scan_topn_dag(t10)
    overlay = [
        ("Q6 overlay", sf10, "device", n_li,
         lambda: cop.execute(TR.q6_dag(lt), l_ov),
         agg_check(lambda: sorted(TR.q6_oracle(li_base())
                                  + TR.q6_oracle(l_rows))), ()),
        ("scan_topn overlay", sf10, "device", n_li,
         lambda: cop.execute(topn_dag, l_ov), topn_check, ()),
        ("Q12 probe overlay", sf10, "device[agg]", n_li,
         lambda: execute_fragment(cop, q12, {lt.id: l_ov,
                                             ot.id: s10[ot.id]}),
         agg_check(lambda: sorted(
             TR.q12_oracle({"lineitem": li_base(), "orders": o10})
             + TR.q12_oracle({"lineitem": l_rows, "orders": o10}))), ()),
        ("Q12 build overlay", sf10, "host(fragment:build-overlay)", n_li,
         lambda: execute_fragment(cop, q12, {lt.id: s10[lt.id],
                                             ot.id: o_ov}),
         agg_check(lambda: TR.q12_oracle({
             "lineitem": li10,
             "orders": seen_orders(o_ov, o_rows)[0]})), ()),
    ]
    host = [
        ("Q1", sf10, "host(sum magnitude exceeds int64 accumulator)", n_li,
         lambda: cop.execute(TR.q1_dag(lt), s10[lt.id]),
         agg_check(lambda: TR.q1_oracle(li10)), ()),
        ("Q18-inner", sf10, "host(fragment:group-overflow)", n_li,
         lambda: execute_fragment(cop, TR.q18_inner_frag(lt),
                                  {lt.id: s10[lt.id]}),
         _q18_groups_check(li10), ("streamseg.rank_sums",)),
    ]
    hll = [("approx_count_distinct", sf10, "device", n_li,
            lambda: cop.execute(TR.hll_dag(lt), s10[lt.id]),
            agg_check(lambda: TR.hll_oracle(li10)), ())]
    ot_idx = TR.orders_indexed_table(ot.id)
    rng = np.random.default_rng(args.seed)
    custs = rng.choice(np.unique(o10["o_custkey"]), 1000, replace=False)
    ranged = []
    for label, snap, ov in (("", s10[ot.id], None),
                            (" overlay", o_ov, o_rows)):
        base = snap
        snap = dataclasses.replace(snap, table=ot_idx)

        def seen(base=base, ov=ov):
            # the index changes the table, not the rows it shows
            return seen_orders(base, ov)

        points = TR.ranged_points_dag({"orders": ot_idx}, custs)
        month = TR.ranged_interval_dag({"orders": ot_idx})
        ranged += [
            (f"ranged 1000 points{label}", sf10, "ranged",
             snap.num_visible_rows,
             lambda snap=snap, dag=points: cop.execute(dag, snap),
             rows_check(lambda seen=seen: TR.ranged_points_oracle(
                 *seen(), custs)), ()),
            (f"ranged one month{label}", sf10, "ranged",
             snap.num_visible_rows,
             lambda snap=snap, dag=month: cop.execute(dag, snap),
             rows_check(lambda seen=seen: TR.ranged_interval_oracle(
                 *seen())), ())]
    q7 = TR.q7_frag(t1)
    q7_snaps = {t.table.id: s1[t.table.id] for t in q7.tables}
    einsum = [("Q7", sf1, "device[agg]",
               q7_snaps[q7.tables[0].table.id].epoch.num_rows,
               lambda: execute_fragment(cop, q7, q7_snaps),
               agg_check(lambda: TR.q7_oracle(d1)), ())]

    launches = {k: 0 for k in _kernels.LAUNCHES}
    for title, label, queries in (
            ("e1. overlay rows", "overlay part", overlay),
            ("e2. the host interpreter", "host part", host),
            ("e3. approx_count_distinct and ANALYZE", "HLL part", hll),
            ("e4. index-ranged scans", "ranged part", ranged)):
        torch.cuda.reset_peak_memory_stats()
        print(f"  -- {title}")
        # since part q part e profiles only ANALYZE and the ranged reads
        # (whose profiled run is their second warm run): a depth cut
        for k, n in _drive(label, queries, every_kernel=False,
                           profile=queries is ranged).items():
            launches[k] += n
        if queries is hll:
            _analyze(cop, s10[lt.id], f"lineitem {sf10}")
        print(f"  peak device memory during {label}: "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
              f"({torch.cuda.memory_allocated() / 1e9:.3f} GB held after)")
    print("  -- e5. the einsum strategy at its real size")
    seen_calls = []
    plain = SE.seg_sum_partials

    def recorded(v, seg, segments, n_limbs, strategy="loop"):
        seen_calls.append((segments, strategy, v.shape[0]))
        return plain(v, seg, segments, n_limbs, strategy)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(SE, "seg_sum_partials", recorded):
        for k, n in _drive("einsum part", einsum, every_kernel=False,
                           profile=False).items():
            launches[k] += n
    strategies = sorted(set((seg, strat) for seg, strat, _ in seen_calls))
    if strategies != [(5408, "einsum")]:
        raise SystemExit(f"Q7: strategies {strategies}, want einsum over "
                         f"5408 slots")
    print(f"  Q7 strategy: einsum over 5408 dense slots, tiles of "
          f"{max(rows for _, _, rows in seen_calls)} rows (one-hot it no "
          f"longer builds: {max(rows for _, _, rows in seen_calls) * 5408 * 4 / 1e9:.1f} GB a tile); "
          f"peak device memory during the part: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    print(f"  launches on part e: {launches}; visible rows built once: "
          f"{len(saved)} reuses, {sum(saved):.2f}s not spent again")
    return launches


# TPC-H query -> the parts a-d request that carries its coprocessor work
F1_REQUESTS = {"q6": "Q6", "q14": "q14", "q12": "q12", "q5": "q5",
               "q3": "q3", "q10": "q10", "q4": "q4"}
# coprocessor reads in the executor's operator labels (engine.py); every
# other operator frame is root work on the host
COPR_OPS = {"fragment", "scan", "scan+agg", "scan+topn"}
# Q19's scale and seed in part f2: the reference plans Q19 as a cross join
# whose OR filter the root evaluates over every lineitem x part pair; at
# SF0.003 no lineitem passes the filter with seeds 7 and 42, with seed 1
# some do
Q19_SF, Q19_SEED = 0.003, 1


def _sql_load(sessions, data, label: str) -> None:
    """Bulk-load all eight tables of `data` into each session, table by
    table in the same order, then ANALYZE them; prints the seconds."""
    for s in sessions:
        t0 = time.perf_counter()
        for name in TD.TPCH_DDL:
            TD.load_table(s, name, data[name])
        t1 = time.perf_counter()
        s.execute("analyze table " + ", ".join(TD.TPCH_DDL))
        _sync()
        print(f"  {label} {s.cop.device}: {len(data['lineitem']['l_orderkey'])}"
              f" lineitem rows, bulk load {t1 - t0:.2f}s, ANALYZE TABLE of "
              f"all eight {time.perf_counter() - t1:.2f}s")


def _sync() -> None:
    torch.cuda.synchronize()


def _sql_run(s, sql: str) -> tuple[list, float]:
    """One statement on `s`, ending in a synchronize: -> (rows, seconds)."""
    t0 = time.perf_counter()
    rows = s.query(sql)
    _sync()
    return rows, time.perf_counter() - t0


def _sql_split(s) -> str:
    """The last statement's parse+plan and root-operator milliseconds
    (the session's stage recorder)."""
    plan = sum(s.last_stages.get(k, 0.0) for k in ("parse", "plan_build"))
    root = sum(v for k, v in s.last_op_wall.items() if k not in COPR_OPS)
    copr = sum(v for k, v in s.last_op_wall.items() if k in COPR_OPS)
    return (f"parse+plan_ms={plan * 1e3:.2f} root_ms={root * 1e3:.2f} "
            f"coprocessor_ms={copr * 1e3:.2f}")


def _captured_reads(s, sql: str) -> list:
    """Run `sql` once on `s`, capturing its coprocessor reads: -> a
    callable per read that sends the same request with the same
    snapshots straight to the session's client."""
    from tidb_tpu_torch.copr import fragment as FR
    reads = []
    run_dag, run_frag = CopClient.execute, FR.execute_fragment

    def dag_call(cop, dag, snap):
        reads.append(lambda: run_dag(cop, dag, snap))
        return run_dag(cop, dag, snap)

    def frag_call(cop, frag, snaps):
        reads.append(lambda: run_frag(cop, frag, snaps))
        return run_frag(cop, frag, snaps)

    with mock.patch.object(CopClient, "execute", dag_call), \
            mock.patch.object(FR, "execute_fragment", frag_call):
        s.query(sql)
    return reads


def _part_f1(args, d10, tags) -> tuple:
    """Part f1 (module docstring). -> (the part's kernel launches, the
    session, which parts l1 and g1 go on with, each query's row count)."""
    sf10 = f"SF{args.sf:g}"
    torch.cuda.reset_peak_memory_stats()
    s = Session()
    _sql_load([s], d10, sf10)
    _kernels.reset_launches()
    firsts = {}
    for q, req in F1_REQUESTS.items():
        before = dict(_kernels.LAUNCHES)
        rows, first = _sql_run(s, TPCH_QUERIES[q])
        if s.last_engines != [tags[req]]:
            raise SystemExit(f"{q}: engines {s.last_engines}, want "
                             f"[{tags[req]!r}] (parts a-d's {req})")
        if TR.sql_cells(rows) != TR.sql_oracle(q, d10):
            raise SystemExit(f"{q}: SQL rows differ from the oracle")
        if q == "q3" and _kernels.LAUNCHES["streamseg.rank_sums"] == \
                before["streamseg.rank_sums"]:
            raise SystemExit("q3 did not launch kernel streamseg.rank_sums")
        firsts[q] = (first, len(rows), s.last_engines)
    launches = dict(_kernels.LAUNCHES)
    for k, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {k} was not launched on the SQL path")
    print(f"  launches on the SQL path at {sf10}: {launches}")
    for q, (first, nrows, engines) in firsts.items():
        sql = TPCH_QUERIES[q]
        times = [_sql_run(s, sql)[1] for _ in range(WARM_RUNS)]
        split = _sql_split(s)
        busy, _ = _device_busy(lambda: s.query(sql))
        reads = _captured_reads(s, sql)
        direct = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            for read in reads:
                read()
            _sync()
            direct.append(time.perf_counter() - t0)
        print(f"  {q.upper()} {sf10} SQL: engines={engines} rows={nrows} "
              f"exact=True first_ms={first * 1e3:.1f} "
              f"p50_ms={statistics.median(times) * 1e3:.2f} "
              f"runs_ms={[round(t * 1e3, 2) for t in times]}")
        print(f"    {split} direct_requests_p50_ms="
              f"{statistics.median(direct) * 1e3:.2f}")
        print(f"    {busy}")
    print(f"  peak device memory during f1: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"({torch.cuda.memory_allocated() / 1e9:.3f} GB held after)")
    return launches, s, {q: v[1] for q, v in firsts.items()}


def _rows_equal(q: str, got: list, want: list) -> bool:
    a, b = TR.sql_cells(got), TR.sql_cells(want)
    if "order by" not in TPCH_QUERIES[q].lower():
        a, b = sorted(a, key=repr), sorted(b, key=repr)
    return a == b


def _part_f2(args, d1) -> tuple:
    """Part f2 (module docstring). -> (the part's kernel launches, the
    card and the CPU session at SF1, which part g1' goes on with)."""
    sf1 = f"SF{args.q18_sf:g}"
    torch.cuda.reset_peak_memory_stats()
    queries = sorted(TPCH_QUERIES, key=lambda q: int(q[1:]))
    small = TD.generate_tpch(Q19_SF, Q19_SEED)
    card, cpu = Session(), Session(device="cpu")
    card19, cpu19 = Session(), Session(device="cpu")
    _sql_load([card, cpu], d1, sf1)
    _sql_load([card19, cpu19], small, f"SF{Q19_SF:g} (Q19)")
    _kernels.reset_launches()
    out = {}
    for q in queries:
        c, h = (card19, cpu19) if q == "q19" else (card, cpu)
        sql = TPCH_QUERIES[q]
        before = dict(_kernels.LAUNCHES)
        rows, first = _sql_run(c, sql)
        engines = list(c.last_engines)
        split = _sql_split(c)
        want, cpu_s = _sql_run(h, sql)
        if engines != h.last_engines:
            raise SystemExit(f"{q}: card engines {engines}, CPU "
                             f"{h.last_engines}")
        if not _rows_equal(q, rows, want):
            raise SystemExit(f"{q}: card rows differ from the CPU's")
        if q == "q18" and _kernels.LAUNCHES["streamseg.rank_sums"] == \
                before["streamseg.rank_sums"]:
            raise SystemExit("q18 did not launch kernel streamseg.rank_sums")
        out[q] = (first, cpu_s, len(rows), engines, split)
    launches = dict(_kernels.LAUNCHES)
    for k, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {k} was not launched on the SQL path")
    print(f"  launches on the 22-query SQL path: {launches}")
    total_card = total_cpu = 0.0
    for q, (first, cpu_s, nrows, engines, split) in out.items():
        total_card += first
        total_cpu += cpu_s
        scale = f"SF{Q19_SF:g}" if q == "q19" else sf1
        print(f"  {q.upper()} {scale}: rows={nrows} card==cpu engines="
              f"{engines} card {_timing(first, [])} cpu_s={cpu_s:.3f} "
              f"{split}")
    print(f"  22 queries: card cold runs sum to {total_card:.2f}s, the CPU "
          f"session's runs to {total_cpu:.2f}s; peak device memory during "
          f"f2: {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return launches, card, cpu, {q: v[3] for q, v in out.items()}


# ---- part g: the write path (TPC-H refresh functions, the HTAP mix) ----
G_QUERIES = ("q6", "q3", "q5", "q12", "q18")
# the reads mid-RF1, after RF1 and after RF2. At SF10 (g1) orders' overlay
# sends every join to the host tier before RF2 (Q3, Q5, Q12 and Q18 take
# 17, 34, 10 and 60 s there: more than the time limit leaves), and after
# RF2 Q18 overflows its group buffer to the host tier (58 s); Q3 after RF2
# launches streamseg over the rebuilt lineitem epoch. At SF1 (g1', card ==
# CPU) all five are read after RF2; mid-RF1 and after RF1 only Q6 (the
# joins take the host tier's build-overlay path there, ~20 s a point,
# which e1 reads at SF10 and i2's Q18 at SF1; mid-RF1's joins paid for
# part j)
G1_READS = (("q6",), ("q6",), ("q6", "q3", "q5", "q12"))
G1P_READS = (("q6",), ("q6",), G_QUERIES)
# rows per RF2 DELETE commit: below the 8,192-delta threshold. The
# reference's commit calls maybe_compact once per mutation, and a
# commit's own N >= 8,192 mutations stay unfolded, so each call scans
# all N deltas again: N^2 visits, 3.6e9 for one 60,000-row DELETE at SF10
RF2_ROWS = 8191
# the share of TPC-H's SF x 1,500 refresh orders that g1 sends at SF10:
# 4,500 orders (RF1's 4,500 inserts and RF2's 4,500 deletes pass the
# 8,192-delta threshold) still fold orders once in RF2 (so the joins after
# RF2 stay on the device, Q3 launching streamseg) but make ~4 folds of the
# 60M-row lineitem epoch instead of 18 (7-14 s each), for the time limit
# on slower hosts (0.4 before part j); g1' at SF1 sends the whole refresh
G1_RF_SHARE = 0.3
# RF2's share at SF10: 3,750 orders (3,750 + RF1's 4,500 still pass the
# 8,192-delta threshold, so orders folds once in RF2) and ~15,000
# lineitems, two DELETE statements that fold lineitem where the 4,500
# orders' ~18,000 took three (one fewer 60M-row fold, 14-17 s), for part
# o; g1' at SF1 sends the whole refresh, RF2 as many orders as RF1
G1_RF2_SHARE = 0.25
RANK = "streamseg.rank_sums"
# g2's phases: 1 s, a sixth of the reference's 6 s (3 s before part l, 2 s
# before part m; each phase's scanner still runs one Q6 and one Q1),
# and its sbtest 10,000 rows, a tenth of the reference's 100,000 (part h
# runs the same mix over the wire on a durable store), for the script's
# time limit
G2_SECONDS = 1.0
# (20,000 before part o)
G2_ROWS = 10_000


# the columns each oracle reads, for the reads that check only these: a
# refresh applied to the arrays for such a read copies no other column
ORACLE_COLUMNS = {"q6": {"lineitem": ("l_shipdate", "l_discount",
                                      "l_quantity", "l_extendedprice")}}


def _oracle_view(data: dict, queries) -> dict:
    """`data` cut to the columns the oracles of `queries` read, when every
    one of them is in ORACLE_COLUMNS; else `data` itself."""
    if not all(q in ORACLE_COLUMNS for q in queries):
        return data
    keep: dict = {}
    for q in queries:
        for t, cols in ORACLE_COLUMNS[q].items():
            keep.setdefault(t, set()).update(cols)
    return {t: {c: v for c, v in cols.items() if c in keep.get(t, ())}
            for t, cols in data.items()}


def _stores(s, names=("orders", "lineitem")) -> dict:
    return {n: s.storage.table_store(s.catalog.table(s.current_db, n).id)
            for n in names}


def _mem() -> str:
    return (f"memory_allocated={torch.cuda.memory_allocated() / 1e9:.3f} GB")


def _g_exec(sessions, stmts, kind: str, times: dict, label: str) -> None:
    """Run write statements on each session, the card's first (the others
    must give its affected count and tags); the card's wall time per
    statement kind, and for each commit that compacted (a table's epoch
    changed) its time and the device memory held after it."""
    card = sessions[0]
    stores = _stores(card)
    for sql in stmts:
        before = {n: st.epoch.epoch_id for n, st in stores.items()}
        t0 = time.perf_counter()
        rs = card.execute(sql)
        dt = time.perf_counter() - t0
        folds = any(st.epoch.epoch_id != before[n]
                    for n, st in stores.items())
        kind_s = "compacting commits" if folds else "write statements"
        SUBLAPS[kind_s] = SUBLAPS.get(kind_s, 0.0) + dt
        tags = list(card.last_engines)
        if kind == "INSERT" and tags != ["point"]:
            raise SystemExit(f"{label}: INSERT tags {tags}, want ['point']")
        for other in sessions[1:]:
            with _sublap("CPU twin"):
                r2 = other.execute(sql)
            if r2.affected != rs.affected or other.last_engines != tags:
                raise SystemExit(
                    f"{label}: {kind} affected/tags {r2.affected} "
                    f"{other.last_engines} vs the card's {rs.affected} "
                    f"{tags}")
        times.setdefault(kind, []).append(dt)
        folded = [n for n, st in stores.items()
                  if st.epoch.epoch_id != before[n]]
        if folded:
            times.setdefault("compacting commit", []).append(dt)
            print(f"    {label}: {kind} of {rs.affected} rows folded "
                  f"{folded} in {dt * 1e3:.1f} ms (epoch rows "
                  f"{[stores[n].epoch.num_rows for n in folded]}); "
                  f"{_mem()}")


def _g_reads(sessions, phase: str, data, hits: list,
             queries=G_QUERIES, profile: bool = True) -> None:
    """`queries` as SQL on the card (and the CPU twin's): rows exact
    against the numpy answer over the arrays as modified (and the twin's
    rows and tags equal), streamseg's launches, the cold run, the warm
    time of M_CUT_WARM_RUNS warm runs and, with `profile`, the
    device-busy share (a host-tier read, seconds of numpy at SF10: its
    cold run only)."""
    card = sessions[0]
    li = _stores(card)["lineitem"]
    for q in queries:
        sql = TPCH_QUERIES[q]
        before = _kernels.LAUNCHES[RANK]
        with _sublap("cold runs"):
            rows, first = _sql_run(card, sql)
        launched = _kernels.LAUNCHES[RANK] - before
        tags = list(card.last_engines)
        with _sublap("oracle checks"):
            ok = TR.sql_cells(rows) == TR.sql_oracle(q, data)
        if not ok:
            raise SystemExit(f"{phase} {q}: SQL rows differ from the oracle")
        cpu = ""
        for other in sessions[1:]:
            with _sublap("CPU twin"):
                want, cpu_s = _sql_run(other, sql)
            if other.last_engines != tags or not _rows_equal(q, rows, want):
                raise SystemExit(f"{phase} {q}: card rows/tags {tags} "
                                 f"differ from the CPU's "
                                 f"{other.last_engines}")
            cpu = f" card==cpu cpu_s={cpu_s:.3f}"
        rebuilt = li.epoch.fold_ts > 0
        if launched and rebuilt:
            hits.append(f"{phase} {q}")
        if any(_host_tier(t) for t in tags):
            times = []
            busy = "device busy: not measured (host tier, cold run only)"
        else:
            with _sublap("warm runs"):
                times = [_sql_run(card, sql)[1]
                         for _ in range(M_CUT_WARM_RUNS)]
            busy = "device busy: not measured (no profiled run here)"
            if profile:
                with _sublap("profiled runs"):
                    busy, _ = _device_busy(lambda: card.query(sql))
        print(f"  {phase} {q.upper()}: engines={tags} rows={len(rows)} "
              f"exact=True streamseg_launches={launched} "
              f"lineitem_epoch_rebuilt={rebuilt} (deltas "
              f"{len(li.deltas)}) {_timing(first, times)}{cpu}")
        print(f"    {busy}")


def _part_g1(args, sessions, data, sf: float, label: str,
             reads: tuple, rf2_sf=None, profile: bool = True) -> tuple:
    """Part g1 (SF10, `sessions` = [f1's card session]) or g1' (SF1, [a
    card session, a CPU session]) (module docstring); RF1 sends `sf` x
    1,500 orders and RF2 deletes `rf2_sf` (default `sf`) x 1,500. ->
    (the reads that
    launched streamseg over a lineitem epoch that compaction rebuilt, the
    arrays as RF2 left them)."""
    card = sessions[0]
    with _sublap("refresh data"):
        new = RF.rf1_rows(data, sf, args.seed + 101)
        ins = RF.rf1_statements(new, 1000)
        n_ord = -(-len(new["orders"]["o_orderkey"]) // 1000)
        mid = n_ord + 4
        keys = RF.rf2_keys(data, sf if rf2_sf is None else rf2_sf,
                           args.seed + 102)
    times: dict = {}
    hits: list = []
    print(f"  {label}: RF1 {len(new['orders']['o_orderkey'])} orders, "
          f"{len(new['lineitem']['l_orderkey'])} lineitems in "
          f"{len(ins)} INSERTs; RF2 {len(keys)} orders; {_mem()}")
    _g_exec(sessions, ins[:mid], "INSERT", times, label)
    li = _stores(card)["lineitem"]
    if not 0 < len(li.deltas) < li.COMPACT_THRESHOLD:
        raise SystemExit(f"{label}: mid-RF1 lineitem holds "
                         f"{len(li.deltas)} deltas")
    with _sublap("refresh data"):
        mid1 = RF.apply_rf1(_oracle_view(data, reads[0]),
                            RF.rf1_prefix(new, (mid - n_ord) * 1000))
    _g_reads(sessions, f"{label} mid-RF1", mid1, hits, reads[0], profile)
    del mid1
    _g_exec(sessions, ins[mid:], "INSERT", times, label)
    with _sublap("refresh data"):
        after1 = RF.apply_rf1(data, new)
    _g_reads(sessions, f"{label} after RF1", after1, hits, reads[1],
             profile)
    with _sublap("refresh data"):
        rf2 = RF.rf2_statements(keys, RF.lines_per_order(after1, keys),
                                RF2_ROWS)
    _g_exec(sessions, rf2, "DELETE", times, label)
    with _sublap("refresh data"):
        after2 = RF.apply_rf2(after1, keys)
    _g_reads(sessions, f"{label} after RF2", after2, hits, reads[2],
             profile)
    # one explicit transaction: its Q6 reads its own buffer, the rollback
    # leaves the value before
    with _sublap("transaction check"):
        extra = RF.rf1_rows(after2, sf, args.seed + 103)["lineitem"]
        extra = {c: RF._take(v, np.arange(len(extra["l_orderkey"])) < 1000)
                 for c, v in extra.items()}
        txn_data = RF.apply_rf1(_oracle_view(after2, ("q6",)),
                                {"lineitem": extra})
        for s in sessions:
            s.execute("begin")
            s.execute(RF.insert_statements("lineitem", extra, 1000)[0])
            got = s.query(TPCH_QUERIES["q6"])
            if TR.sql_cells(got) != TR.sql_oracle("q6", txn_data):
                raise SystemExit(f"{label}: Q6 in the transaction does "
                                 "not see its own buffer")
            tags = list(s.last_engines)
            s.execute("rollback")
            if TR.sql_cells(s.query(TPCH_QUERIES["q6"])) != \
                    TR.sql_oracle("q6", after2):
                raise SystemExit(f"{label}: Q6 after ROLLBACK differs")
    print(f"  {label} txn: BEGIN, INSERT 1000 lineitems, Q6 {tags} sees "
          f"them (exact), ROLLBACK, Q6 exact as before")
    for kind, ts in times.items():
        print(f"  {label} {kind}: n={len(ts)} "
              f"p50_ms={statistics.median(ts) * 1e3:.1f} "
              f"max_ms={max(ts) * 1e3:.1f}")
    print(f"  {label} peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {_mem()}")
    return hits, after2


def _htap_phase(storage, n_read: int, n_write: int, n_scan: int,
                secs: float, ids: int, scan_check) -> dict:
    """One phase of the reference's HTAP mix (`bench.py`
    flight_htap_mixed), in this process: threads with their own sessions
    over `storage`; -> latencies, acknowledged UPDATEs and scans."""
    stop = threading.Event()
    lat = {"read": [], "write": []}
    acked = [0]
    scans: list = []
    errs: list = []
    lock = threading.Lock()

    def points(wi: int, write: bool) -> None:
        try:
            s = Session(storage)
            rng = np.random.default_rng(1000 * wi + int(write))
            pick = rng.integers(0, ids, size=1 << 14)
            j, mine, ok = 0, [], 0
            while not stop.is_set():
                i = int(pick[j & 0x3FFF])
                j += 1
                t0 = time.perf_counter()
                if write:
                    ok += s.execute("update sbtest set k = k + 1 "
                                    f"where id = {i}").affected
                else:
                    s.query(f"select id, k, c from sbtest where id = {i}")
                mine.append(time.perf_counter() - t0)
                if s.last_engines != ["point"]:
                    raise SystemExit(f"point tags {s.last_engines}")
            with lock:
                lat["write" if write else "read"] += mine
                acked[0] += ok
        except BaseException as e:  # re-raised by the caller
            errs.append(e)

    def scan() -> None:
        try:
            s = Session(storage)
            while not stop.is_set():
                for q in ("q6", "q1"):
                    t0 = time.perf_counter()
                    rows = s.query(TPCH_QUERIES[q])
                    _sync()
                    scans.append((q, time.perf_counter() - t0))
                    scan_check(q, rows, s.last_engines)
        except BaseException as e:  # re-raised by the caller
            errs.append(e)

    threads = ([threading.Thread(target=points, args=(i, False))
                for i in range(n_read)]
               + [threading.Thread(target=points, args=(i, True))
                  for i in range(n_write)]
               + [threading.Thread(target=scan) for _ in range(n_scan)])
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(secs)
    stop.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return {"wall": wall, "lat": lat, "acked": acked[0], "scans": scans}


def _pct(v: list, q: float) -> float:
    v = sorted(v)
    return v[min(len(v) - 1, int(len(v) * q))] * 1e3 if v else 0.0


def _part_g2(args, d1) -> None:
    """Part g2 (module docstring)."""
    torch.cuda.reset_peak_memory_stats()
    s = Session()
    s.execute("create table sbtest (id bigint primary key, k bigint, "
              "c varchar(64))")
    sb = _stores(s, ("sbtest",))["sbtest"]
    folds = [0]
    compact = sb.compact

    def counted(safe_ts):  # counts the compactions that fold
        epoch = sb.epoch
        compact(safe_ts)
        folds[0] += sb.epoch is not epoch

    sb.compact = counted
    n = G2_ROWS
    t0 = time.perf_counter()
    for lo in range(0, n, 2000):
        s.execute("insert into sbtest values " + ",".join(
            f"({i},{i % 1000},'c{i:020d}')" for i in range(lo, lo + 2000)))
    t_load = time.perf_counter() - t0
    TD.load_table(s, "lineitem", d1["lineitem"])
    print(f"  g2: sbtest {n} rows by 2,000-row INSERTs in {t_load:.2f}s, "
          f"lineitem SF{args.q18_sf:g} bulk-loaded "
          f"({len(d1['lineitem']['l_orderkey'])} rows) in the same Storage")
    for sql in ("select id, k, c from sbtest where id = 5",
                "update sbtest set k = k + 0 where id = 5"):
        s.execute(sql)
        if s.last_engines != ["point"]:
            raise SystemExit(f"g2: {sql!r} took {s.last_engines}, not the "
                             "point fast path")
    base_rows = s.query("select sum(k), count(*) from sbtest")
    base_tags = list(s.last_engines)
    want = {q: TR.sql_oracle(q, d1) for q in ("q1", "q6")}

    def scan_check(q, rows, tags):
        if TR.sql_cells(rows) != want[q]:
            raise SystemExit(f"g2: {q} differs from its oracle under writes")

    for q in ("q6", "q1"):  # warm the scanning path outside the timing
        scan_check(q, s.query(TPCH_QUERIES[q]), None)
    alone = _htap_phase(s.storage, 4, 1, 0, G2_SECONDS, n, scan_check)
    mixed = _htap_phase(s.storage, 4, 8, 1, G2_SECONDS, n, scan_check)
    acked = alone["acked"] + mixed["acked"]
    rows = s.query("select sum(k), count(*) from sbtest")
    if s.last_engines != base_tags or not s.last_engines[0].startswith(
            "device"):
        raise SystemExit(f"g2: sum(k) read took {s.last_engines}")
    if rows != [(base_rows[0][0] + acked, n)]:
        raise SystemExit(f"g2: sum(k), count(*) = {rows}, want "
                         f"{base_rows[0][0]} + {acked} acknowledged "
                         f"UPDATEs, {n}")
    print(f"  g2 (in process, not over the MySQL wire; the store is in "
          f"memory, not durable): sum(k) {base_rows[0][0]} -> "
          f"{rows[0][0]} = initial + {acked} acknowledged UPDATEs "
          f"(engines {s.last_engines}); sbtest compactions {folds[0]}")
    for label, ph, w in (("alone (no scans)", alone, 1),
                         ("under scans", mixed, 8)):
        r, u = ph["lat"]["read"], ph["lat"]["write"]
        print(f"  g2 {label}, 4 readers + {w} writer(s): point read "
              f"{len(r) / ph['wall']:.0f} QPS p50={_pct(r, 0.5):.3f}ms "
              f"p99={_pct(r, 0.99):.3f}ms; update {len(u) / ph['wall']:.0f}"
              f" QPS p50={_pct(u, 0.5):.3f}ms p99={_pct(u, 0.99):.3f}ms")
    for q in ("q6", "q1"):
        ts = [t for name, t in mixed["scans"] if name == q]
        print(f"  g2 {q.upper()} under the mix: {len(ts)} scans, "
              f"{len(ts) / mixed['wall']:.2f}/s, "
              f"p50_ms={_pct(ts, 0.5):.1f} (exact on every run)")
    print(f"  g2 peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")


# ---- part h: durability and the MySQL wire server ----
H_SCANS = ("q6", "q1")
# sbtest's rows in h1: 20,000, a fifth of the reference's 100,000 (the
# durable INSERTs took 27-47 s), and the writer phases 1 s, a sixth of the
# reference's 6 s (3 s before part l, 2 s before part m), paying for parts
# j, l and m as g2's cuts did; the mix phases H_MIX_SECONDS, 4 s (6 s
# before part l): a Q1
# scan over the wire takes ~3-6 s, so the scanner still finishes at least
# one
# (20,000 before part o)
H1_ROWS = 10_000
H_WRITE_SECONDS = 1.0
H_MIX_SECONDS = 4.0
H_READS = ("q6", "q1", "q18")
# h3's writers before the SIGKILL: 2 s (4 s before part n)
H3_WRITE_SECONDS = 2.0
# the child of h3: the port's durable store served on port 0, nothing else
H3_CHILD = """
import sys, threading
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.store.storage import Storage
storage = Storage(sys.argv[1], sync_log="commit")
server = Server(storage, port=0, max_connections=256)
server.start()
print(server.port, flush=True)
threading.Event().wait()
"""


def _mini_client_module():
    """tests/mysql_client.py loaded by path (as bench.py's wire flights
    load it): an encoding of the protocol independent of the server's."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_mysql_client",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                     "mysql_client.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wire_text(rows) -> list:
    """Session rows as the text protocol renders them (what a client
    reads back over the wire)."""
    from tidb_tpu_torch.server.packet import render_text_value
    return [tuple(None if (r := render_text_value(v)) is None else
                  r.decode() for v in row) for row in rows]


def _server_tags(server) -> list:
    """The engine tags of the last statement of the server's newest
    connection, the caller's (the port has no EXPLAIN ANALYZE yet)."""
    _, conn = max(server._conns.items())
    return list(conn.session.last_engines)


def _wire_phase(mc, addr, n_read: int, n_write: int, n_scan: int,
                secs: float, ids: int, expect: dict) -> dict:
    """One phase of the reference's HTAP mix over the wire (`bench.py`
    flight_htap_mixed run_phase): MiniClient threads; -> latencies,
    acknowledged UPDATEs and scans (each exact)."""
    stop = threading.Event()
    lat = {"read": [], "write": []}
    acked = [0]
    scans: list = []
    errs: list = []
    lock = threading.Lock()

    def points(wi: int, write: bool) -> None:
        try:
            cl = mc.MiniClient(*addr)
            rng = np.random.default_rng(1000 * wi + int(write))
            pick = rng.integers(0, ids, size=1 << 14)
            j, mine, ok = 0, [], 0
            while not stop.is_set():
                i = int(pick[j & 0x3FFF])
                j += 1
                t0 = time.perf_counter()
                if write:
                    ok += cl.execute(f"update sbtest set k = k + 1 "
                                     f"where id = {i}")
                else:
                    cl.query(f"select id, k, c from sbtest where id = {i}")
                mine.append(time.perf_counter() - t0)
            cl.close()
            with lock:
                lat["write" if write else "read"] += mine
                acked[0] += ok
        except BaseException as e:  # re-raised by the caller
            errs.append(e)

    def scan() -> None:
        try:
            cl = mc.MiniClient(*addr)
            while not stop.is_set():
                for q in H_SCANS:
                    t0 = time.perf_counter()
                    rows = cl.query(TPCH_QUERIES[q])
                    scans.append((q, time.perf_counter() - t0))
                    if rows != expect[q]:
                        raise SystemExit(f"h1: {q} over the wire differs "
                                         "from its oracle under writes")
            cl.close()
        except BaseException as e:  # re-raised by the caller
            errs.append(e)

    threads = ([threading.Thread(target=points, args=(i, False))
                for i in range(n_read)]
               + [threading.Thread(target=points, args=(i, True))
                  for i in range(n_write)]
               + [threading.Thread(target=scan) for _ in range(n_scan)])
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(secs)
    stop.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return {"wall": wall, "lat": lat, "acked": acked[0], "scans": scans}


def _wire_sum(mc, addr) -> tuple:
    cl = mc.MiniClient(*addr)
    (row,) = cl.query("select sum(k), count(*) from sbtest")
    cl.close()
    return int(row[0]), int(row[1])


def _part_h1(args, d1, path: str, mc) -> dict:
    """Part h1 (module docstring). -> what h2 and h3 check against."""
    from tidb_tpu_torch.kv.native import NativeOrderedKV
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.store.storage import Storage

    torch.cuda.reset_peak_memory_stats()
    storage = Storage(path, sync_log="commit")
    if not isinstance(storage.kv.kv, NativeOrderedKV):
        raise SystemExit(f"h1: the KV engine is {type(storage.kv.kv)}, not "
                         "the port's NativeOrderedKV")
    print(f"  h1: Storage({path!r}, sync_log='commit'), KV engine "
          f"{type(storage.kv.kv).__module__}.{type(storage.kv.kv).__name__}")
    s = Session(storage)
    s.execute("create table sbtest (id bigint primary key, k bigint, "
              "c varchar(64))")
    n = H1_ROWS
    t0 = time.perf_counter()
    for lo in range(0, n, 2000):
        s.execute("insert into sbtest values " + ",".join(
            f"({i},{i % 1000},'c{i:020d}')" for i in range(lo, lo + 2000)))
    t_sb = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in ("lineitem", "orders", "customer"):
        TD.load_table(s, name, d1[name])
    t_bulk = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.execute("analyze table sbtest, lineitem, orders, customer")
    _sync()
    t_an = time.perf_counter() - t0
    t0 = time.perf_counter()
    storage.checkpoint()
    t_cp = time.perf_counter() - t0
    print(f"  h1: sbtest {n} rows by 2,000-row durable INSERTs "
          f"{t_sb:.2f}s; lineitem, orders, customer SF{args.q18_sf:g} bulk "
          f"load (epoch files written and fsynced) {t_bulk:.2f}s; ANALYZE "
          f"{t_an:.2f}s; checkpoint {t_cp:.2f}s")
    # the expected wire text of the reads: the session's rows, each equal
    # to the numpy answer first
    expect = {}
    for q in H_READS:
        rows = s.query(TPCH_QUERIES[q])
        if TR.sql_cells(rows) != TR.sql_oracle(q, d1):
            raise SystemExit(f"h1: {q} in process differs from its oracle")
        expect[q] = _wire_text(rows)
    server = Server(storage, port=0, max_connections=256)
    server.start()
    addr = ("127.0.0.1", server.port)
    probe = mc.MiniClient(*addr)
    for sql in ("select id, k from sbtest where id = 5",
                "update sbtest set k = k + 0 where id = 5"):
        probe.execute(sql)
        if _server_tags(server) != ["point"]:
            raise SystemExit(f"h1: {sql!r} over the wire took "
                             f"{_server_tags(server)}, not the point path")
    for q in H_SCANS:  # the scanning path warm, outside the timing
        if probe.query(TPCH_QUERIES[q]) != expect[q]:
            raise SystemExit(f"h1: {q} over the wire differs from its "
                             "oracle")
    probe.close()
    base = _wire_sum(mc, addr)
    print(f"  h1: point SELECT and UPDATE over the wire take ['point'] "
          f"(server-side session.last_engines); sum(k), count(*) = {base}")
    # the WAL fsync's own time (the disk's, not the card's), beside the
    # group batch
    syncer = storage.kv.kv._syncer
    fsync, fs = syncer._fsync, [0.0]

    def timed_fsync():
        t = time.perf_counter()
        fsync()
        fs[0] += time.perf_counter() - t

    syncer._fsync = timed_fsync
    alone = _wire_phase(mc, addr, 4, 1, 0, H_MIX_SECONDS, n, expect)
    mixed = _wire_phase(mc, addr, 4, 8, 1, H_MIX_SECONDS, n, expect)
    acked = alone["acked"] + mixed["acked"]
    hist = storage.obs.group_commit_batch
    for conc in (1, 8, 32):
        _, sum0, n0 = hist.snapshot()
        fs0 = fs[0]
        ph = _wire_phase(mc, addr, 0, conc, 0, H_WRITE_SECONDS, n, expect)
        _, sum1, n1 = hist.snapshot()
        acked += ph["acked"]
        u = ph["lat"]["write"]
        print(f"  h1 durable write x{conc}: {len(u) / ph['wall']:.0f} QPS "
              f"p50={_pct(u, 0.5):.3f}ms p99={_pct(u, 0.99):.3f}ms; group "
              f"fsync avg batch {(sum1 - sum0) / max(n1 - n0, 1):.2f} over "
              f"{n1 - n0} fsyncs of {(fs[0] - fs0) / max(n1 - n0, 1) * 1e3:.3f}"
              f" ms each ({(fs[0] - fs0) / ph['wall'] * 100:.1f}% of the "
              f"phase)")
    got = _wire_sum(mc, addr)
    if got != (base[0] + acked, n):
        raise SystemExit(f"h1: sum(k), count(*) = {got}, want {base[0]} + "
                         f"{acked} acknowledged UPDATEs, {n}")
    print(f"  h1: sum(k) {base[0]} -> {got[0]} = initial + {acked} "
          f"acknowledged UPDATEs (over the wire)")
    for label, ph, w in (("alone (no scans)", alone, 1),
                         ("under scans", mixed, 8)):
        r, u = ph["lat"]["read"], ph["lat"]["write"]
        print(f"  h1 {label}, 4 readers + {w} writer(s): point read "
              f"{len(r) / ph['wall']:.0f} QPS p50={_pct(r, 0.5):.3f}ms "
              f"p99={_pct(r, 0.99):.3f}ms; durable update "
              f"{len(u) / ph['wall']:.0f} QPS p50={_pct(u, 0.5):.3f}ms "
              f"p99={_pct(u, 0.99):.3f}ms")
    for q in H_SCANS:
        ts = [t for name, t in mixed["scans"] if name == q]
        print(f"  h1 {q.upper()} under the mix over the wire: {len(ts)} "
              f"scans, {len(ts) / mixed['wall']:.2f}/s, "
              f"p50_ms={_pct(ts, 0.5):.1f} (exact on every run)")
    print(f"  h1 peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    server.close()
    t0 = time.perf_counter()
    storage.close()
    print(f"  h1: server closed, clean storage.close() (checkpoint) "
          f"{time.perf_counter() - t0:.2f}s")
    return {"expect": expect, "sum": got,
            "lineitem_rows": len(d1["lineitem"]["l_orderkey"])}


def _part_h2(args, path: str, mc, h1: dict, tags: dict) -> int:
    """Part h2 (module docstring). -> streamseg's launches in the wire
    reads."""
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.store.storage import Storage

    t0 = time.perf_counter()
    storage = Storage(path, sync_log="commit")
    t_open = time.perf_counter() - t0
    li = storage.table_store(storage.catalog.table("test", "lineitem").id)
    epoch = li.epoch
    if epoch.num_rows != h1["lineitem_rows"] or li.deltas:
        raise SystemExit(f"h2: recovered lineitem {epoch.num_rows} rows + "
                         f"{len(li.deltas)} deltas, want "
                         f"{h1['lineitem_rows']} from its epoch file")
    print(f"  h2: Storage(path) reopened in {t_open:.2f}s (catalog, "
          f"statistics, epoch files, KV snapshot; TSO floor "
          f"{storage.tso.current()}); lineitem {epoch.num_rows} rows from "
          f"its epoch file (bulk-loaded: the KV holds none of them)")
    server = Server(storage, port=0)
    server.start()
    addr = ("127.0.0.1", server.port)
    if _wire_sum(mc, addr) != h1["sum"]:
        raise SystemExit("h2: sum(k), count(*) changed across the restart")
    cl = mc.MiniClient(*addr)
    launched = 0
    for q in H_READS:
        before = _kernels.LAUNCHES[RANK]
        t0 = time.perf_counter()
        rows = cl.query(TPCH_QUERIES[q])
        dt = time.perf_counter() - t0
        n_q = _kernels.LAUNCHES[RANK] - before
        got = _server_tags(server)
        if rows != h1["expect"][q]:
            raise SystemExit(f"h2: {q} over the wire differs from its "
                             "oracle after the restart")
        if got != tags[q]:
            raise SystemExit(f"h2: {q} took {got}, parts f2 and g1' "
                             f"{tags[q]}")
        if q == "q18" and (n_q == 0 or li.epoch is not epoch):
            raise SystemExit("h2: q18 did not launch streamseg over the "
                             "recovered lineitem epoch")
        launched += n_q
        print(f"  h2 {q.upper()} over the wire: rows={len(rows)} exact "
              f"engines={got} streamseg_launches={n_q} "
              f"first_ms={dt * 1e3:.1f}")
    cl.close()
    print(f"  h2: sum(k), count(*) = {h1['sum']} unchanged")
    server.close()
    storage.close()
    return launched


def _part_h3(args, path: str, mc, h1: dict, d1):
    """Part h3 (module docstring). -> the reopened store, which part i3
    goes on with."""
    import os
    import signal

    from tidb_tpu_torch.store.storage import Storage

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", H3_CHILD, path],
                             cwd=root, stdout=subprocess.PIPE, text=True)
    try:
        line = child.stdout.readline()
        if not line.strip().isdigit():
            raise SystemExit(f"h3: the child served no port ({line!r})")
        addr = ("127.0.0.1", int(line))
        t_child = time.perf_counter() - t0
        killed = threading.Event()
        acked = [0] * 8
        errs: list = []

        def writer(wi: int) -> None:
            rng = np.random.default_rng(7000 + wi)
            try:
                cl = mc.MiniClient(*addr)
                while True:
                    i = int(rng.integers(0, h1["sum"][1]))
                    acked[wi] += cl.execute(
                        f"update sbtest set k = k + 1 where id = {i}")
            except (ConnectionError, OSError, mc.MySQLError) as e:
                if not killed.is_set():
                    errs.append(e)  # a failure before the kill

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        time.sleep(H3_WRITE_SECONDS)
        in_flight = sum(acked)
        killed.set()
        os.kill(child.pid, signal.SIGKILL)
        child.wait()
        for t in threads:
            t.join()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if errs:
        raise errs[0]
    total = sum(acked)
    print(f"  h3: a child python3 served the store in {t_child:.2f}s; 8 "
          f"writers over the wire, SIGKILL after {H3_WRITE_SECONDS:g} s "
          f"with writes in flight "
          f"({in_flight} acknowledged at the signal, {total} in all)")
    t0 = time.perf_counter()
    storage = Storage(path, sync_log="commit")
    t_rec = time.perf_counter() - t0
    s = Session(storage)
    ((k, cnt),) = s.query("select sum(k), count(*) from sbtest")
    base = h1["sum"][0]
    if not (base + total <= k <= base + total + 8) or cnt != h1["sum"][1]:
        raise SystemExit(f"h3: sum(k) {k} after kill -9, want within "
                         f"[{base + total}, {base + total + 8}] "
                         f"(count {cnt})")
    rows = s.query(TPCH_QUERIES["q6"])
    if TR.sql_cells(rows) != TR.sql_oracle("q6", d1):
        raise SystemExit("h3: q6 after kill -9 differs from its oracle")
    print(f"  h3: reopened after kill -9 in {t_rec:.2f}s (WAL replay since "
          f"the last checkpoint); sum(k) = {k} = base {base} + "
          f"{total} acknowledged + {k - base - total} in flight (<= 8); "
          f"Q6 exact ({s.last_engines})")
    return storage


def _part_h(args, d1, tags: dict) -> tuple:
    """Part h, then parts i3, n and o on h3's store, part p and part j3
    in the same temporary directory (module docstring). -> streamseg's
    launches in h2, in i3, in j3, in n, in o and in p."""
    import shutil
    import tempfile

    mc = _mini_client_module()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-h-")
    try:
        df = subprocess.run(["df", "-T", tmp], capture_output=True,
                            text=True, check=True).stdout.splitlines()
        print(f"  h: store directory {tmp} on: {df[-1]}")
        path = f"{tmp}/db"
        h1 = _part_h1(args, d1, path, mc)
        gc.collect()
        torch.cuda.empty_cache()
        launched = _part_h2(args, path, mc, h1, tags)
        gc.collect()
        torch.cuda.empty_cache()
        storage = _part_h3(args, path, mc, h1, d1)
        print(f"  -- i3. online DDL on the durable store, over the wire "
              f"({_mem()} held before it)")
        _kernels.reset_launches()
        i3 = _part_i3(args, storage, path, mc, h1, tags)
        print(f"  -- n. the server process: python -m "
              f"tidb_tpu_torch.server on i3's store ({_mem()} held "
              f"before it)")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _kernels.reset_launches()
        n = _part_n(args, tmp, path, mc, h1)
        print(f"  [part n took {time.perf_counter() - t0:.1f}s]")
        print(f"  -- o. the cluster: a leader, a shared-directory sibling "
              f"and a socket follower of h3's store ({_mem()} held before "
              f"it)")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _kernels.reset_launches()
        o = _part_o(args, tmp, path, mc, h1, d1)
        print(f"  [part o took {time.perf_counter() - t0:.1f}s]")
        print(f"  -- p. follower reads and automatic failover: a fresh "
              f"leader and two socket followers in this process "
              f"({_mem()} held before it)")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _kernels.reset_launches()
        p = _part_p(args, tmp)
        print(f"  [part p took {time.perf_counter() - t0:.1f}s]")
        print(f"  -- j3. a partitioned table on a durable store, killed "
              f"mid-checkpoint ({_mem()} held before it)")
        t0 = time.perf_counter()
        _kernels.reset_launches()
        j3 = _part_j3(args, tmp, d1)
        print(f"  [part j3 took {time.perf_counter() - t0:.1f}s]")
        return launched, i3, j3, n, o, p
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- part n: the server process ----
# the config file of part n's child (`--config`); {topsql} and {window}
# change at the SIGHUP, the token limit is pinned by a flag
N_CONFIG = """host = "127.0.0.1"
[status]
report-status = true
status-host = "127.0.0.1"
[performance]
topsql-enabled = {topsql}
wait-profile-enabled = true
metrics-history-interval = 1
token-limit = {tokens}
[history]
enabled = true
window-seconds = {window}
[diagnostics]
enabled = true
[gc]
run-interval = "1s"
[security]
ssl-cert = "{cert}"
ssl-key = "{key}"
proxy-protocol-networks = "127.0.0.1"
[analysis]
lock-check = true
"""
N_TOKENS = 16  # --token-limit: beats the file's 64, kept at the SIGHUP
N_V1 = "203.0.113.7"
N_V2 = "198.51.100.9"
N_UPDATES = 300
# the status routes the port serves, with the reference's top-level keys
# (a list route: None)
N_ROUTES = {
    "/status": {"version", "connections", "admission", "governor",
                "top_sql", "inspection"},
    "/slow-query": None, "/statements-summary": None, "/debug/events": None,
    "/debug/metrics/history": {"interval_s", "samples"},
    "/debug/topsql": {"enabled", "window_s", "digest_cap", "windows"},
    "/debug/waitprofile": {"enabled", "window_s", "digest_cap", "windows"},
    "/debug/inspection": {"enabled", "rules", "findings", "summary"},
    "/debug/history": {"enabled", "window_seconds", "history_cap",
                       "regression_ratio", "dir", "records", "live",
                       "window_start", "regressions"},
    "/debug/failpoints": set(),
    "/debug/replicas": {"enabled", "prefer_follower", "max_staleness_ms",
                        "range_aware", "term", "members", "reads"},
    "/debug/profile?seconds=0.2&hz=97": {"hz", "duration_s",
                                         "total_samples", "hot_frames",
                                         "tree"},
    # the keyspace heat plane: its knobs while [heatmap] is off
    "/debug/keyviz": {"enabled", "bucket_seconds", "ring_buckets",
                      "hot_ratio", "sustained_buckets", "key_sample_cap"},
    # the lock-order checker, armed by [analysis] lock-check
    "/debug/lockgraph": {"enabled", "locks", "edges", "cycles", "blocking",
                         "held"},
}
N_UNPORTED = ("/debug/mesh",)
# the hot locks every armed server child creates (the native engine's
# store mutex too, where the store runs on it)
LOCK_HOT = ("Storage._commit_lock", "Storage.infoschema_lock",
            "MVCCStore._mu")
LOCK_INVERSION_SQL = ("select * from information_schema.inspection_result "
                      "where rule = 'lock-order-inversion'")


def _proxy_v1(src: str) -> bytes:
    return f"PROXY TCP4 {src} 10.0.0.1 56324 4000\r\n".encode()


def _proxy_v2(src: str) -> bytes:
    import socket
    import struct
    body = socket.inet_aton(src) + socket.inet_aton("10.0.0.1") + \
        struct.pack(">HH", 55555, 4000)
    return b"\r\n\r\n\x00\r\nQUIT\n" + bytes([0x21, 0x11]) + \
        struct.pack(">H", len(body)) + body


def _http(port: int, route: str):
    """-> (HTTP code, body bytes) of a GET on the status port."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _metric(text: str, family: str, labels: str) -> float:
    m = re.search(rf"^{family}\{{{re.escape(labels)}\}} (\S+)$", text, re.M)
    return float(m[1]) if m else 0.0


def _n_counts(port: int) -> tuple:
    """(streamseg's library lookups, device-fragment requests) from the
    child's /metrics: the only view into its launches. The streamseg
    wrapper looks its library up only right before a launch (after its
    checks and its empty case), so each lookup is one launch."""
    code, body = _http(port, "/metrics")
    if code != 200:
        raise SystemExit(f"n: /metrics answered {code}")
    text = body.decode()
    lookups = _metric(text, "tidb_copr_jit_cache_total", 'result="hit"') + \
        _metric(text, "tidb_copr_jit_cache_total", 'result="miss"')
    frag = _metric(text, "tidb_copr_requests_total",
                   'engine="device-fragment"')
    return int(lookups), int(frag)


def _lockgraph(label: str, status: int, conn, hot: tuple) -> None:
    """An armed child's lock-order checker, read after its reads and
    writes: /debug/lockgraph enabled, `hot` registered as hot locks, no
    cycle and no blocking call under a hot lock, and no
    lock-order-inversion row in inspection_result over `conn`; prints
    the lock, edge and cycle counts."""
    import json as _json
    code, body = _http(status, "/debug/lockgraph")
    g = _json.loads(body) if code == 200 else {}
    locks = {x["name"]: x["hot"] for x in g.get("locks", ())}
    missing = [n for n in hot if locks.get(n) is not True]
    rows = conn.query(LOCK_INVERSION_SQL)
    if code != 200 or g["enabled"] is not True or missing or \
            g["cycles"] or g["blocking"] or rows:
        raise SystemExit(f"{label}: /debug/lockgraph answered {code}, "
                         f"enabled {g.get('enabled')}, hot locks missing "
                         f"{missing}, cycles {g.get('cycles')}, blocking "
                         f"{g.get('blocking')}; lock-order-inversion rows "
                         f"{rows}")
    hot_now = sorted(n for n, h in locks.items() if h)
    print(f"  {label}: /debug/lockgraph armed: {len(locks)} locks "
          f"({len(hot_now)} hot: {hot_now}), {len(g['edges'])} edges "
          f"{[(e['held'], e['acquired'], e['count']) for e in g['edges']]}"
          f", 0 cycles, 0 blocking events; no lock-order-inversion row")


def _n_connect(mc, port: int, preamble: bytes, **kw):
    return mc.MiniClient("127.0.0.1", port, use_ssl=True, preamble=preamble,
                         **kw)


def _part_n(args, tmp: str, path: str, mc, h1: dict) -> dict:
    """Part n (module docstring), on h3's store after i3. -> streamseg's
    launches: in the child (its /metrics) and in the parent's reopen."""
    import json as _json
    import os
    import signal
    import socket

    from tidb_tpu_torch.kv import mvcc as MV
    from tidb_tpu_torch.kv import tablecodec as TC
    from tidb_tpu_torch.kv.native import native_available
    from tidb_tpu_torch.obs import StatementsSummary
    from tidb_tpu_torch.store.storage import Storage

    root = os.path.dirname(os.path.abspath(__file__))
    cert = os.path.join(root, "tests", "data", "tls_test_cert.pem")
    key = os.path.join(root, "tests", "data", "tls_test_key.pem")
    cfg = os.path.join(tmp, "n.toml")
    with open(cfg, "w") as f:
        f.write(N_CONFIG.format(topsql="true", window=60, tokens=64,
                                cert=cert, key=key))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        status = sk.getsockname()[1]
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.server", "--config", cfg,
         "--path", path, "-P", "0", "--status", str(status),
         "--token-limit", str(N_TOKENS)],
        cwd=root, stdout=subprocess.PIPE, text=True)
    try:
        # 1. the listening line: the store's reopen and CUDA's start-up
        line = child.stdout.readline()
        if not line.startswith("tidb-tpu-server listening on 127.0.0.1:"):
            raise SystemExit(f"n: the child printed {line!r}")
        t_listen = time.perf_counter() - t0
        port = int(line.rsplit(":", 1)[1])
        print(f"  n1: python -m tidb_tpu_torch.server --config n.toml "
              f"--path <h3's store> -P 0 --status {status} --token-limit "
              f"{N_TOKENS}: {line.strip()!r} after {t_listen:.2f}s (reopen "
              f"+ CUDA start-up)")
        # 2. TLS with a PROXY v1 header: Q6, Q1, Q18 exact; 3. Q18's
        # streamseg launches, read from the child's /metrics
        a = _n_connect(mc, port, _proxy_v1(N_V1))
        if not a.tls:
            raise SystemExit("n2: the connection did not upgrade to TLS")
        base = a.query("select sum(k), count(*) from sbtest")[0]
        for q in ("q6", "q1", "q18"):
            lk0, fr0 = _n_counts(status)
            t1 = time.perf_counter()
            rows = a.query(TPCH_QUERIES[q])
            dt = time.perf_counter() - t1
            lk, fr = _n_counts(status)
            if rows != h1["expect"][q]:
                raise SystemExit(f"n2: {q} over TLS differs from h1's "
                                 "answer")
            if q == "q18" and (lk - lk0 < 1 or fr - fr0 < 1):
                raise SystemExit(f"n3: q18 in the child: streamseg "
                                 f"lookups +{lk - lk0}, device-fragment "
                                 f"requests +{fr - fr0}")
            print(f"  n2 {q.upper()} over TLS + PROXY v1: rows={len(rows)} "
                  f"exact first_ms={dt * 1e3:.1f}; in the child "
                  f"streamseg_launches={lk - lk0} device-fragment requests "
                  f"+{fr - fr0}")
        # 4. the routes: 200 with the reference's keys, the unported 501
        digest, _ = StatementsSummary.digest(TPCH_QUERIES["q18"])
        (conn_id,) = a.query("select connection_id()")[0]
        a.query("trace select count(*) from orders")
        seen = {}
        for route, keys in N_ROUTES.items():
            code, body = _http(status, route)
            got = _json.loads(body) if code == 200 else None
            if code != 200 or (keys is None and not isinstance(got, list)) \
                    or (keys is not None and not keys <= set(got)):
                shape = sorted(got) if isinstance(got, dict) else type(got)
                raise SystemExit(f"n4: {route} answered {code} {shape}")
            seen[route] = got
        top = {e["digest"]: e for w in seen["/debug/topsql"]["windows"]
               for e in w["digests"].values()}
        q18 = top.get(digest)
        dev = q18 and (q18["stages"].get("kernel", 0.0)
                       + q18["stages"].get("device_get", 0.0))
        if not dev:
            raise SystemExit(f"n4: /debug/topsql holds no device time for "
                             f"Q18's digest {digest}")
        code, body = _http(status, f"/debug/trace/{conn_id}")
        spans = _json.loads(body)["spans"] if code == 200 else []
        if not spans or spans[0][0] != "session.run":
            raise SystemExit(f"n4: /debug/trace/{conn_id} answered {code}")
        for route in N_UNPORTED:
            code, body = _http(status, route)
            if code != 501 or "roadmap_item" not in _json.loads(body):
                raise SystemExit(f"n4: {route} answered {code}, not 501")
        if seen["/status"]["admission"]["token_limit"] != N_TOKENS:
            raise SystemExit(f"n4: token limit "
                             f"{seen['/status']['admission']}")
        by_device = seen["/status"]["top_sql"]["by_device_time"]
        print(f"  n4: {len(N_ROUTES)} routes 200 with the reference's "
              f"keys, /debug/trace/{conn_id} {len(spans)} spans; Q18's "
              f"digest in /debug/topsql with device time "
              f"{dev * 1e3:.3f} ms of {q18['sum_wall_s'] * 1e3:.1f} ms; "
              f"/status top_sql by device: "
              f"{[e['digest'][:8] for e in by_device]}; "
              f"{', '.join(N_UNPORTED)} 501")
        # 5. SHOW PROCESSLIST from a second connection (PROXY v2) while
        # the first sleeps; a user without PROCESS sees only its own row
        root_c = _n_connect(mc, port, _proxy_v2(N_V2))
        root_c.execute("create user 'n_user' identified by 'n_pw'")
        root_c.execute("grant select on test.* to 'n_user'")
        sleeper = threading.Thread(target=a.query, args=("select sleep(2)",))
        sleeper.start()
        time.sleep(0.5)
        plist = root_c.query("show processlist")
        is_rows = root_c.query("select id, user, host, command, info from "
                               "information_schema.processlist")
        u = _n_connect(mc, port, _proxy_v1("192.0.2.5"), user="n_user",
                       password="n_pw")
        mine = u.query("show processlist")
        sleeper.join()
        hosts = {r[2]: r for r in plist}
        if hosts.get(N_V1, [None] * 8)[7] != "select sleep(2)" or \
                N_V2 not in hosts:
            raise SystemExit(f"n5: SHOW PROCESSLIST {plist}")
        # the reader's own row differs by its Info (its own statement)
        if {tuple(r) for r in is_rows if r[2] != N_V2} != \
                {(r[0], r[1], r[2], r[4], r[7]) for r in plist
                 if r[2] != N_V2}:
            raise SystemExit(f"n5: information_schema.processlist "
                             f"{is_rows} vs SHOW {plist}")
        if [r[1] for r in mine] != ["n_user"] or mine[0][2] != "192.0.2.5":
            raise SystemExit(f"n5: without PROCESS: {mine}")
        print(f"  n5: SHOW PROCESSLIST during SLEEP(2): "
              f"{[(r[1], r[2], r[4], r[7]) for r in plist]}; "
              f"information_schema.processlist agrees; a user without "
              f"PROCESS sees {[(r[1], r[2]) for r in mine]}")
        u.close()
        # 6. plaintext refused under require_secure_transport
        root_c.execute("set global require_secure_transport = ON")
        try:
            mc.MiniClient("127.0.0.1", port, preamble=_proxy_v1(N_V1))
            raise SystemExit("n6: a plaintext login was accepted")
        except mc.MySQLError as e:
            if e.code != 3159:
                raise SystemExit(f"n6: plaintext refused with {e.code}")
        root_c.execute("set global require_secure_transport = OFF")
        print("  n6: a plaintext login refused with 3159 "
              "(ER_SECURE_TRANSPORT_REQUIRED) under SET GLOBAL "
              "require_secure_transport = ON")
        # 7. GC by the maintenance worker: UPDATEs, then a low
        # tidb_gc_life_time (the worker ticks every second: [gc]
        # run-interval); the next ticks drop every older version
        acked = 0
        rng = np.random.default_rng(args.seed + 17)
        for i in rng.integers(0, int(base[1]), N_UPDATES):
            acked += a.execute(f"update sbtest set k = k + 1 where id = {i}")
        root_c.execute("set global tidb_gc_life_time = '1s'")
        time.sleep(2.5)
        want = (str(int(base[0]) + acked), base[1])
        got = tuple(a.query("select sum(k), count(*) from sbtest")[0])
        if got != want or a.query(TPCH_QUERIES["q6"]) != h1["expect"]["q6"]:
            raise SystemExit(f"n7: after GC sum(k), count(*) = {got}, "
                             f"want {want} (or Q6 differs)")
        print(f"  n7: {acked} UPDATEs acknowledged, then "
              f"tidb_gc_life_time = '1s' and 2.5 s of 1 s ticks; sum(k), "
              f"count(*) = {got} and Q6 exact after the GC's fold")
        # the child's lock-order checker after its reads and writes
        _lockgraph("n7", status, a, LOCK_HOT + (
            ("NativeOrderedKV._mu",) if native_available() else ()))
        root_c.close()
        lookups, _ = _n_counts(status)
        # 8. SIGHUP: the reloadable knobs the flag did not pin
        with open(cfg, "w") as f:
            f.write(N_CONFIG.format(topsql="false", window=30, tokens=32,
                                    cert=cert, key=key))
        child.send_signal(signal.SIGHUP)
        line = child.stdout.readline().strip()
        want_line = ("config reloaded: ['history.window_seconds', "
                     "'performance.topsql_enabled']")
        st = _json.loads(_http(status, "/status")[1])
        if line != want_line or st["top_sql"]["enabled"] or \
                st["admission"]["token_limit"] != N_TOKENS:
            raise SystemExit(f"n8: SIGHUP printed {line!r}; /status "
                             f"top_sql {st['top_sql']['enabled']}, "
                             f"admission {st['admission']}")
        print(f"  n8: SIGHUP after the rewrite: {line!r}; Top SQL off, "
              f"the flag's token limit {N_TOKENS} kept (the file says 32)")
        a.close()
        # 9. SIGTERM: rc 0
        t1 = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=120)
        rest = child.stdout.read().splitlines()
        t_stop = time.perf_counter() - t1
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
    if rc != 0 or rest != ["shutting down..."]:
        raise SystemExit(f"n9: SIGTERM: rc {rc}, printed {rest}")
    t1 = time.perf_counter()
    storage = Storage(path, sync_log="commit")
    t_open = time.perf_counter() - t1
    s = Session(storage)
    tid = storage.catalog.table("test", "sbtest").id
    lo, hi = TC.record_range(tid)
    versions = sum(1 for _ in storage.kv.kv.scan(MV.CF_WRITE, lo, hi))
    ((k, cnt),) = _wire_text(s.query("select sum(k), count(*) from sbtest"))
    before = _kernels.LAUNCHES[RANK]
    q18 = _wire_text(s.query(TPCH_QUERIES["q18"]))
    launched = _kernels.LAUNCHES[RANK] - before
    # every UPDATE since h1 added a version: sum(k) less h1's initial sum
    ever = int(k) - sum(i % 1000 for i in range(int(cnt)))
    # the GC keeps the newest version below its safepoint and every
    # version above it. Its safepoint is the TSO less tidb_gc_life_time
    # (1 s), taken 2.5 s of ticks after the last UPDATE. A reopened TSO
    # starts at its persisted lease, up to 120 s ahead of the clock, so
    # how many of part n's own versions are still above the safepoint
    # depends on when the clock caught up with the lease: anything from
    # none (versions == rows) to all (rows + acked). The history before
    # part n (ever - acked versions, ever > acked) is below the
    # safepoint either way, so at least that many versions went.
    if (k, cnt) != want or not ever > acked or \
            not int(cnt) <= versions <= int(cnt) + acked or \
            q18 != h1["expect"]["q18"] or not launched:
        raise SystemExit(f"n9: reopened: sum(k), count(*) = {(k, cnt)} "
                         f"(want {want}), {versions} sbtest versions, Q18 "
                         f"exact {q18 == h1['expect']['q18']}, streamseg "
                         f"launches {launched}")
    print(f"  n9: SIGTERM -> 'shutting down...', rc 0 after "
          f"{t_stop:.2f}s; reopened in {t_open:.2f}s: sum(k), count(*) = "
          f"{(k, cnt)} unchanged, sbtest holds {versions} versions = one a "
          f"row + {versions - int(cnt)} of part n's {acked} UPDATEs above "
          f"the safepoint (without the GC: rows + {ever}, every UPDATE "
          f"since h1), Q18 exact "
          f"(streamseg_launches={launched}); the child's streamseg "
          f"library lookups in all: {lookups}")
    storage.close()
    return {"child": lookups, "reopen": launched}


# ---- part o: the cluster on the card ----
# the follower's config file (`--config`): its leader, failover off
# (election-timeout-ms > 0 arms the reference's failover, item 5b of
# ROADMAP queue 1), and the backoff budget a degraded read or write pays
O_CONFIG = """host = "127.0.0.1"
[status]
report-status = true
status-host = "127.0.0.1"
[transport]
remote = "{remote}"
election-timeout-ms = 0
connect-timeout-ms = 1000
backoff-budget-ms = {budget}
lease-ms = 2000
[analysis]
lock-check = true
"""
O_BUDGET_MS = 3000
# o_li's rows through the KV: lineitem's first orders by l_orderkey, in
# statements of fewer than 8,192 rows each (ROADMAP queue 3: a commit of
# N >= 8,192 mutations to one table costs N^2 delta visits); the key
# range stays inside the dense group space, so the follower's GROUP BY
# takes a device path over the rows it folded. One band since part p
# (two before): each row is an fsync under sync_log="commit"
O_BANDS = ((0, 1000),)
O_UPDATES = 300
O_HAVING = ("select l_orderkey, sum(l_quantity) from o_li group by "
            "l_orderkey having sum(l_quantity) > 150 order by l_orderkey")
# the reference's cluster_info columns
O_CLUSTER_INFO = ["instance", "type", "server_id", "version", "pid",
                  "start_time", "uptime_s", "applied_ts", "apply_lag_ms",
                  "serving", "range_id", "range_leader", "range_term",
                  "range_closed_ts", "range_read_rows", "range_read_bytes",
                  "range_write_rows", "range_write_bytes", "error"]


def _o_having_oracle(li) -> list:
    """O_HAVING's rows over O_BANDS of lineitem, as the wire renders
    them (l_quantity in hundredths)."""
    key = np.asarray(li["l_orderkey"])
    qty = np.asarray(li["l_quantity"]).astype(np.int64)
    sel = np.zeros(len(key), bool)
    for lo, hi in O_BANDS:
        sel |= (key >= lo) & (key < hi)
    keys, inv = np.unique(key[sel], return_inverse=True)
    sums = np.bincount(inv, weights=qty[sel]).astype(np.int64)
    return [(str(int(k)), f"{int(v) // 100}.{int(v) % 100:02d}")
            for k, v in zip(keys, sums) if v > 15000]


def _o_metrics(port: int) -> tuple:
    """(`tidb_copr_requests_total` by engine, streamseg's library
    lookups) from the follower's /metrics."""
    code, body = _http(port, "/metrics")
    if code != 200:
        raise SystemExit(f"o: the follower's /metrics answered {code}")
    text = body.decode()
    reqs = {m[0]: int(float(m[1])) for m in re.findall(
        r'^tidb_copr_requests_total\{engine="([^"]*)"\} (\S+)$', text,
        re.M)}
    lookups = _metric(text, "tidb_copr_jit_cache_total", 'result="hit"') + \
        _metric(text, "tidb_copr_jit_cache_total", 'result="miss"')
    return reqs, int(lookups)


def _o_sleep_killed(mc, client, killer, label: str) -> float:
    """SLEEP(20) on `client`'s connection, ended by `killer(conn_id)`:
    -> seconds from the KILL to the statement's end (errno 1317)."""
    (conn_id,) = client.query("select connection_id()")[0]
    errs: list = []

    def sleeper():
        try:
            client.query("select sleep(20)")
        except mc.MySQLError as e:
            errs.append(e)

    t = threading.Thread(target=sleeper)
    t.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    killer(int(conn_id))
    t.join(timeout=20)
    dt = time.perf_counter() - t0
    if t.is_alive() or not errs or errs[0].code != 1317:
        raise SystemExit(f"{label}: SLEEP(20) on connection {conn_id} "
                         f"outlived the KILL ({errs})")
    return dt


def _part_o(args, tmp: str, path: str, mc, h1: dict, d1) -> dict:
    """Part o (module docstring), on h3's store after part n closed its
    reopen. -> {"sibling": streamseg's launches by the sibling's Q18,
    "follower_lookups": the follower's streamseg library lookups}."""
    import json as _json
    import os
    import signal
    import socket

    from tidb_tpu_torch.kv.mvcc import PyOrderedKV
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.store.storage import Storage

    root = os.path.dirname(os.path.abspath(__file__))
    step = {}
    t_step = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_step
        now = time.perf_counter()
        step[name] = now - t_step
        t_step = now

    # o1. the leader, the follower's start, the sibling meanwhile
    t0 = time.perf_counter()
    leader = Storage(path, shared=True, rpc_listen="127.0.0.1:0",
                     sync_log="commit")
    t_open = time.perf_counter() - t0
    eng = leader.kv.kv
    if type(eng) is not PyOrderedKV or not eng._shared:
        raise SystemExit(f"o1: the leader's engine is {type(eng)}, not the "
                         "shared PyOrderedKV")
    server = Server(leader, port=0)
    server.start()
    sl = Session(leader)
    sibling = follower = None
    cfg = os.path.join(tmp, "o.toml")
    with open(cfg, "w") as f:
        f.write(O_CONFIG.format(remote=leader.rpc_server.address,
                                budget=O_BUDGET_MS))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        status = sk.getsockname()[1]
    t0 = time.perf_counter()
    follower = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.server", "--config", cfg,
         "--path", os.path.join(tmp, "o_follower"), "-P", "0",
         "--status", str(status)],
        cwd=root, stdout=subprocess.PIPE, text=True)
    try:
        t1 = time.perf_counter()
        sibling = Storage(path, shared=True)
        t_sib = time.perf_counter() - t1
        ss = Session(sibling)
        line = follower.stdout.readline()
        if not line.startswith("tidb-tpu-server listening on 127.0.0.1:"):
            raise SystemExit(f"o1: the follower printed {line!r}")
        t_listen = time.perf_counter() - t0
        fport = int(line.rsplit(":", 1)[1])
        print(f"  o1: leader Storage(<h3's store>, shared=True, "
              f"rpc_listen={leader.rpc_server.address!r}, sync_log="
              f"'commit') reopened in {t_open:.2f}s, engine "
              f"{type(eng).__module__}.{type(eng).__name__} (shared); "
              f"follower python -m tidb_tpu_torch.server --config o.toml "
              f"(remote {leader.rpc_server.address}) {line.strip()!r} "
              f"after {t_listen:.2f}s; sibling Storage(<h3's store>, "
              f"shared=True) opened meanwhile in {t_sib:.2f}s; node ids: "
              f"leader {leader.coord.node_id}, sibling "
              f"{sibling.coord.node_id}")
        mark("o1")
        # o2. data through the leader's KV; the follower reads it
        sl.execute(TD.TPCH_DDL["lineitem"].replace("create table lineitem",
                                                   "create table o_li"))
        t0 = time.perf_counter()
        n_li = 0
        for lo, hi in O_BANDS:
            n_li += sl.execute(f"insert into o_li select * from lineitem "
                               f"where l_orderkey >= {lo} and l_orderkey "
                               f"< {hi}").affected
        t_ins = time.perf_counter() - t0
        sl.execute("analyze table o_li")
        (k0, cnt) = sl.query("select sum(k), count(*) from sbtest")[0]
        rng = np.random.default_rng(args.seed + 19)
        t0 = time.perf_counter()
        acked = sum(sl.execute(f"update sbtest set k = k + 1 where id = "
                               f"{int(i)}").affected
                    for i in rng.integers(0, int(cnt), O_UPDATES))
        t_upd = time.perf_counter() - t0
        want_sb = [(str(int(k0) + acked), str(cnt))]
        want_hv = _o_having_oracle(d1["lineitem"])
        fc = mc.MiniClient("127.0.0.1", fport)
        req0, lk0 = _o_metrics(status)
        t0 = time.perf_counter()
        got_sb = fc.query("select sum(k), count(*) from sbtest")
        t_fsb = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_hv = fc.query(O_HAVING)
        t_fhv = time.perf_counter() - t0
        req1, lk1 = _o_metrics(status)
        lead_sb = _wire_text(sl.query("select sum(k), count(*) from "
                                      "sbtest"))
        lead_hv = _wire_text(sl.query(O_HAVING))
        tag = sl.last_engines
        dreq = {e: n - req0.get(e, 0) for e, n in req1.items()
                if n - req0.get(e, 0)}
        if got_sb != lead_sb or got_sb != want_sb or got_hv != lead_hv \
                or got_hv != want_hv:
            raise SystemExit(f"o2: the follower read sum(k), count(*) = "
                             f"{got_sb} (leader {lead_sb}, want {want_sb}) "
                             f"and {len(got_hv)} HAVING rows (leader "
                             f"{len(lead_hv)}, oracle {len(want_hv)})")
        if not sum(n for e, n in req1.items() if e.startswith("device")):
            raise SystemExit(f"o2: the follower's /metrics counts no device "
                             f"request: {req1}")
        print(f"  o2: o_li {n_li} rows by {len(O_BANDS)} INSERT ... SELECTs "
              f"on the leader in {t_ins:.2f}s (sync_log='commit'), ANALYZE, "
              f"{acked} of {O_UPDATES} sbtest UPDATEs in {t_upd:.2f}s; over "
              f"the wire the follower read sum(k), count(*) = {got_sb[0]} in "
              f"{t_fsb * 1e3:.1f} ms and {len(got_hv)} rows of GROUP BY "
              f"l_orderkey HAVING in {t_fhv * 1e3:.1f} ms, both equal to the "
              f"leader's and the numpy answer (leader's tag {tag}); the "
              f"follower's requests by engine {req1} (+{dreq} across its "
              f"two reads), streamseg library lookups {lk1}")
        mark("o2")
        # o3. Q18 on the sibling over the shared lineitem epoch and the
        # refreshed WAL; DDL on the sibling seen by the leader and the
        # follower
        before = _kernels.LAUNCHES[RANK]
        t0 = time.perf_counter()
        q18 = _wire_text(ss.query(TPCH_QUERIES["q18"]))
        t_q18 = time.perf_counter() - t0
        q18_tags = list(ss.last_engines)
        sib_launches = _kernels.LAUNCHES[RANK] - before
        if q18 != h1["expect"]["q18"] or sib_launches < 1:
            raise SystemExit(f"o3: the sibling's Q18 exact "
                             f"{q18 == h1['expect']['q18']}, streamseg "
                             f"launches {sib_launches}")
        sib_sb = _wire_text(ss.query("select sum(k), count(*) from sbtest"))
        t0 = time.perf_counter()
        ss.execute("alter table sbtest add column o_tag int default 3")
        t_ddl = time.perf_counter() - t0
        lead_tag = _wire_text(sl.query("select o_tag, count(*) from sbtest "
                                       "group by o_tag"))
        fol_tag = fc.query("select o_tag, count(*) from sbtest group by "
                           "o_tag")
        if sib_sb != want_sb or lead_tag != [("3", str(cnt))] or \
                fol_tag != lead_tag:
            raise SystemExit(f"o3: sibling sum(k) {sib_sb}; o_tag on the "
                             f"leader {lead_tag}, on the follower {fol_tag}")
        print(f"  o3: the sibling's Q18 exact in {t_q18:.2f}s cold "
              f"(engines {q18_tags}, streamseg_launches="
              f"{sib_launches}), its sum(k), count(*) = {sib_sb[0]}; ALTER "
              f"TABLE sbtest ADD COLUMN o_tag INT DEFAULT 3 on the sibling "
              f"in {t_ddl * 1e3:.1f} ms, read on the leader and over the "
              f"wire on the follower: {fol_tag}")
        mark("o3")
        # o4. the schema fence and the two global KILLs
        (k7,) = sl.query("select k from sbtest where id = 7")[0]
        fc.execute("begin")
        fc.execute("update sbtest set k = k + 100 where id = 7")
        sl.execute("alter table sbtest add column o_tag2 int")
        try:
            fc.execute("commit")
            raise SystemExit("o4: the follower's commit passed the fence")
        except mc.MySQLError as e:
            fence = (e.code, str(e))
        (k7b,) = sl.query("select k from sbtest where id = 7")[0]
        got7 = fc.query("select k from sbtest where id = 7")
        if fence[0] != 8028 or "schema" not in fence[1].lower() or \
                k7b != k7 or got7 != [(str(k7),)]:
            raise SystemExit(f"o4: the fenced commit answered {fence}; k of "
                             f"id 7 {k7} -> {k7b} (follower {got7})")
        lc = mc.MiniClient("127.0.0.1", server.port)
        fk = mc.MiniClient("127.0.0.1", fport)
        t_k1 = _o_sleep_killed(
            mc, fk, lambda cid: lc.execute(f"kill query {cid}"), "o4")
        lk = mc.MiniClient("127.0.0.1", server.port)
        t_k2 = _o_sleep_killed(
            mc, lk, lambda cid: ss.execute(f"kill query {cid}"), "o4")
        if fk.query("select 1") != [("1",)] or \
                lk.query("select 1") != [("1",)]:
            raise SystemExit("o4: a killed connection did not survive")
        print(f"  o4: the follower's transaction, buffered before the "
              f"leader's ALTER, aborted at commit with {fence[0]} "
              f"{fence[1]!r}, k of id 7 still {k7}; KILL QUERY from the "
              f"leader ended SLEEP(20) on the follower after {t_k1:.3f}s "
              f"(RPC mailbox); from the sibling's session, on "
              f"the leader after {t_k2:.3f}s (shared-directory mailbox)")
        for c in (lc, fk, lk):
            c.close()
        mark("o4")
        # o5. cluster_info, cluster_load, /status on the follower
        info = sl.execute("select * from information_schema.cluster_info")
        roles = {r[1]: r for r in info.rows}
        if info.column_names != O_CLUSTER_INFO or \
                set(roles) != {"leader", "follower"} or \
                any(r[-1] is not None for r in info.rows):
            raise SystemExit(f"o5: cluster_info {info.column_names} "
                             f"{info.rows}")
        fol_addr = roles["follower"][0]
        # the follower's device rows: the bytes it uploaded, and the
        # cached buffers (0 while every table it reads is an overlay of
        # folded deltas: such batches are staged uncached)
        load = sl.query("select instance, device_type, name, value from "
                        "information_schema.cluster_load where name in "
                        "('tidb_device_transfer_bytes', "
                        "'tidb_device_buffer_bytes')")
        fol_dev = {r[2]: r[3] for r in load
                   if r[0] == fol_addr and r[1] == "device"}
        st = _json.loads(_http(status, "/status")[1])
        if len(fol_dev) != 2 or \
                not fol_dev["tidb_device_transfer_bytes"] > 0 or \
                st["transport"]["mode"] != "socket-follower":
            raise SystemExit(f"o5: cluster_load {load}; the follower's "
                             f"/status transport {st.get('transport')}")
        print(f"  o5: cluster_info from the leader: "
              f"{[(r[0], r[1], r[2], r[7] > 0) for r in info.rows]} with "
              f"the reference's {len(O_CLUSTER_INFO)} columns; cluster_load "
              f"of the follower: {fol_dev}; "
              f"the follower's /status transport mode "
              f"{st['transport']['mode']}, {len(st['transport']['members'])}"
              f" members, breaker {st['transport']['breaker']}")
        # the follower's lock-order checker after its reads, the fenced
        # commit and the KILL
        _lockgraph("o5", status, fc, LOCK_HOT)
        mark("o5")
        # o6. the leader gone: stale reads, 9001 on writes, SIGTERM
        server.close()
        leader.close()
        leader = None
        t0 = time.perf_counter()
        stale = fc.query("select sum(k), count(*) from sbtest")
        t_stale = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            fc.execute("update sbtest set k = k + 1 where id = 1")
            raise SystemExit("o6: a write on the degraded follower passed")
        except mc.MySQLError as e:
            wcode = e.code
        t_write = time.perf_counter() - t0
        fc.close()
        if stale != want_sb or wcode != 9001 or \
                t_write > O_BUDGET_MS / 1000.0 + 1.0:
            raise SystemExit(f"o6: with the leader gone the follower read "
                             f"{stale} (want {want_sb}); its write answered "
                             f"{wcode} after {t_write:.2f}s")
        t0 = time.perf_counter()
        follower.send_signal(signal.SIGTERM)
        rc = follower.wait(timeout=120)
        rest = follower.stdout.read().splitlines()
        t_stop = time.perf_counter() - t0
        if rc != 0 or rest != ["shutting down..."]:
            raise SystemExit(f"o6: SIGTERM: rc {rc}, printed {rest}")
        sibling.close()
        sibling = None
        print(f"  o6: leader closed; the follower's read answered the last "
              f"replicated state {stale[0]} after {t_stale:.2f}s, its write "
              f"9001 after {t_write:.3f}s (budget {O_BUDGET_MS} ms); "
              f"SIGTERM -> 'shutting down...', rc 0 after {t_stop:.2f}s; "
              f"sibling closed")
        mark("o6")
    finally:
        if follower.poll() is None:
            follower.kill()
            follower.wait()
        follower.stdout.close()
        if leader is not None:
            server.close()
        for st_ in (sibling, leader):
            if st_ is not None:
                st_.close()
    print(f"  o: steps (s) {({k: round(v, 2) for k, v in step.items()})}")
    return {"sibling": sib_launches, "follower_lookups": lk1}


# ---- part p: follower reads and automatic failover ----
# sysbench's oltp table (src/lua/oltp_common.lua: id, k, c CHAR(120),
# pad CHAR(60), the secondary index on k), its rows written through the
# leader's KV in statements of fewer than 8,192 rows (a socket follower
# replicates the WAL, never a bulk load: ROADMAP queue 3)
P_DDL = ("create table sbtest (id bigint primary key, k bigint not null "
         "default 0, c char(120) not null default '', pad char(60) not "
         "null default '', key k_1 (k))")
P_ROWS = 10_000
P_BATCH = 2_000
P_ELECTION_MS = 1500
P_SUM = "select sum(k), count(*) from sbtest"
P_HAVING = ("select k, count(*), sum(id) from sbtest group by k "
            "having count(*) > 12 order by k")
P_ALL = "select id, k from sbtest order by id"
# where the followers' serving sessions must run
P_DEVICE = "cuda"


def _p_rows(seed: int) -> tuple:
    """sbtest's seeded rows: k uniform in [1, 1000] (sysbench draws it
    from the table size; a narrower range makes groups for the HAVING
    read), c and pad digit strings of sysbench's lengths."""
    rng = np.random.default_rng(seed + 23)
    k = rng.integers(1, 1001, P_ROWS)
    digits = rng.integers(0, 10, (P_ROWS, 180)).astype(np.uint8) + 48
    c = [bytes(r[:120]).decode() for r in digits]
    pad = [bytes(r[120:]).decode() for r in digits]
    return k, c, pad


def _p_oracle(ids, ks) -> dict:
    """The three reads' answers over the acknowledged rows."""
    ids, ks = np.asarray(ids), np.asarray(ks)
    groups = {}
    for i, k in zip(ids.tolist(), ks.tolist()):
        n, sid = groups.get(k, (0, 0))
        groups[k] = (n + 1, sid + i)
    having = [(k, n, sid) for k, (n, sid) in sorted(groups.items())
              if n > 12]
    return {P_SUM: [(int(ks.sum()), len(ks))], P_HAVING: having,
            P_ALL: sorted(zip(ids.tolist(), ks.tolist()))}


def _p_copr() -> float:
    return sum(obs.COPR_REQUESTS.get(engine=e)
               for e in ("device", "device-fragment"))


def _part_p(args, tmp: str) -> dict:
    """Part p (module docstring): a fresh leader and two in-process
    socket followers on the card. -> {"launches": streamseg's launches
    in the part, "steps": each step's seconds}."""
    import os

    from tidb_tpu_torch.rpc import netfault
    from tidb_tpu_torch.rpc.client import RpcClient, RpcOptions
    from tidb_tpu_torch.rpc.errors import LeaderUnavailable, StaleTermError
    from tidb_tpu_torch.store.storage import Storage

    step = {}
    t_step = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_step
        now = time.perf_counter()
        step[name] = now - t_step
        t_step = now

    def titpu() -> set:
        return {t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("titpu-")}

    def caught_up(label: str) -> float:
        # both followers serving and applied past a leader timestamp
        # taken now, as the leader's registry (the router's view) shows
        ts = int(leader.tso.current())
        t0 = time.perf_counter()
        deadline = time.monotonic() + 60
        while True:
            ms = [m for m in leader.rpc_server.members()
                  if m["role"] == "follower"]
            if len(ms) == 2 and all(m.get("serving") and
                                    int(m["applied_ts"]) >= ts
                                    for m in ms):
                return time.perf_counter() - t0
            if time.monotonic() > deadline:
                raise SystemExit(f"{label}: the followers did not apply "
                                 f"ts {ts} within 60 s: {ms}")
            time.sleep(0.05)

    def why_local() -> str:
        # what the router saw, for a read that was not routed
        fallbacks = {o: reads.get(outcome=o)
                     for o in ("stale_fallback", "unreachable_fallback")}
        state = [(f.remote, f.apply_engine and f.apply_engine.info(),
                  f.failover and f.failover.describe()) for f in followers]
        return (f"; fallbacks {fallbacks}, notes "
                f"{[w[2][:200] for w in sl.warnings]}, members "
                f"{leader.rpc_server.members()}, followers {state}")

    threads0 = titpu()
    launches0 = _kernels.LAUNCHES[RANK]
    base = dict(connect_timeout_ms=500, request_timeout_ms=2000,
                backoff_budget_ms=1500, lock_budget_ms=8000, lease_ms=1000)
    leader = Storage(os.path.join(tmp, "p_leader"), shared=True,
                     rpc_listen="127.0.0.1:0", sync_log="commit",
                     rpc_options=RpcOptions(**base))
    followers = []
    try:
        # p0. the cluster and the data
        for i in range(2):
            followers.append(Storage(
                os.path.join(tmp, f"p_f{i}"),
                remote=leader.rpc_server.address, sync_log="commit",
                rpc_options=RpcOptions(**base,
                                       election_timeout_ms=P_ELECTION_MS,
                                       promote_listen="127.0.0.1:0")))
        sl = Session(leader)
        sl.execute(P_DDL)
        k, c, pad = _p_rows(args.seed)
        t0 = time.perf_counter()
        for lo in range(0, P_ROWS, P_BATCH):
            sl.execute("insert into sbtest values " + ",".join(
                f"({i},{int(k[i])},'{c[i]}','{pad[i]}')"
                for i in range(lo, lo + P_BATCH)))
        t_load = time.perf_counter() - t0
        t_rows = time.monotonic()
        acked = {i: int(k[i]) for i in range(P_ROWS)}
        want = _p_oracle(list(acked), list(acked.values()))
        t_catch = caught_up("p0")
        by_addr = {f.diag_address: f for f in followers}
        print(f"  p0: leader Storage(shared=True, rpc_listen="
              f"{leader.rpc_server.address!r}, sync_log='commit') and two "
              f"socket followers (election-timeout-ms {P_ELECTION_MS}, "
              f"promote-listen 127.0.0.1:0), all on "
              f"{torch.cuda.get_device_name(0)}; sbtest (sysbench's "
              f"schema) {P_ROWS} rows by {P_BATCH}-row INSERTs on the "
              f"leader in {t_load:.2f}s; both followers serving and "
              f"applied past the last INSERT {t_catch:.2f}s later")
        mark("p0")
        # p1. routed reads: each equal to the leader's local answer and
        # the oracle; served +1 and the serving follower's device
        # requests up, per read
        reads = leader.obs.replica_reads
        local = {}
        for q in (P_SUM, P_HAVING):
            sl.query(q)  # cold
            t0 = time.perf_counter()
            local[q] = sl.query(q)
            local[q + "#ms"] = (time.perf_counter() - t0) * 1e3
            if local[q] != want[q]:
                raise SystemExit(f"p1: the leader's {q!r} differs from the "
                                 f"oracle")
        sl.execute("set tidb_replica_read = 'follower'")
        routed = []
        for q in (P_SUM, P_HAVING, P_SUM, P_HAVING):
            served0, dev0 = reads.get(outcome="served"), _p_copr()
            t0 = time.perf_counter()
            rows = sl.query(q)
            dt = (time.perf_counter() - t0) * 1e3
            tag = sl.last_engines[0]
            f = by_addr.get(tag.split("@", 1)[-1])
            fs = f._replica_pool[-1] if f is not None else None
            if rows != local[q] or not tag.startswith("replica@") or \
                    reads.get(outcome="served") != served0 + 1 or \
                    _p_copr() <= dev0 or fs is None or \
                    fs._cop.device.type != P_DEVICE or \
                    not fs.last_engines[0].startswith("device"):
                raise SystemExit(
                    f"p1: routed {q!r}: exact {rows == local[q]}, tag {tag}, "
                    f"served {served0} -> {reads.get(outcome='served')}, "
                    f"device requests {dev0} -> {_p_copr()}, serving "
                    f"session {fs and fs.last_engines}" + why_local())
            routed.append((q, tag, fs.last_engines[0], dt))
        for q, tag, ftag, dt in routed:
            print(f"  p1: {q[:40]!r}... routed to {tag} in {dt:.1f} ms "
                  f"(leader-local warm {local[q + '#ms']:.1f} ms), exact, "
                  f"the follower's engine {ftag} on {P_DEVICE}")
        # bounded staleness: rows older than the 1 s horizon
        time.sleep(max(0.0, t_rows + 1.1 - time.monotonic()))
        sl.execute("set tidb_replica_read = 'leader'")
        sl.execute("set tidb_read_staleness = -1")
        served0 = reads.get(outcome="served")
        t0 = time.perf_counter()
        rows = sl.query(P_SUM)
        t_stale = (time.perf_counter() - t0) * 1e3
        stale_tag = sl.last_engines[0]
        if rows != want[P_SUM] or not sl.last_engines[0].startswith(
                "replica@") or reads.get(outcome="served") != served0 + 1:
            raise SystemExit(f"p1: the bounded-staleness read {rows} "
                             f"{sl.last_engines}" + why_local())
        sl.execute("set tidb_read_staleness = 0")
        sl.execute("set tidb_replica_read = 'follower'")
        ea = sl.execute(f"explain analyze {P_SUM}")
        if not ea.rows[0][3].startswith("replica@") or \
                not ea.rows[0][4].startswith("replica_read:"):
            raise SystemExit(f"p1: EXPLAIN ANALYZE {ea.rows[0]}")
        print(f"  p1: tidb_read_staleness = -1: {P_SUM!r} routed to "
              f"{stale_tag} in {t_stale:.1f} ms, exact; EXPLAIN ANALYZE row "
              f"{ea.rows[0][0]!r} engine {ea.rows[0][3]} stages "
              f"{ea.rows[0][4]}; served {reads.get(outcome='served'):g}")
        mark("p1")
        # p2. typed fallbacks, exact: the followers' apply stalled, then
        # the wire toward both followers cut
        fb0 = {o: reads.get(outcome=o)
               for o in ("stale_fallback", "unreachable_fallback")}
        with failpoint.failpoint("replica/apply-stall", True):
            sl.execute("update sbtest set k = k + 1 where id = 0")
            acked[0] += 1
            want = _p_oracle(list(acked), list(acked.values()))
            t0 = time.perf_counter()
            rows = sl.query(P_SUM)
            t_st = (time.perf_counter() - t0) * 1e3
            note_st = [w for w in sl.warnings if "fell back" in w[2]]
        t_catch2 = caught_up("p2")
        for a in by_addr:
            netfault.arm("net/partition", peer=a, side="peer", dir="send")
        try:
            t0 = time.perf_counter()
            rows2 = sl.query(P_SUM)
            t_un = (time.perf_counter() - t0) * 1e3
            note_un = [w for w in sl.warnings if "fell back" in w[2]]
        finally:
            netfault.heal()
        fb1 = {o: reads.get(outcome=o) for o in fb0}
        if rows != want[P_SUM] or rows2 != want[P_SUM] or \
                fb1["stale_fallback"] != fb0["stale_fallback"] + 1 or \
                fb1["unreachable_fallback"] != \
                fb0["unreachable_fallback"] + 1 or \
                not note_st or "(stale_fallback)" not in note_st[0][2] or \
                not note_un or \
                "(unreachable_fallback)" not in note_un[0][2]:
            raise SystemExit(f"p2: fallbacks {fb0} -> {fb1}, rows {rows} "
                             f"{rows2} (want {want[P_SUM]}), notes "
                             f"{note_st} {note_un}")
        print(f"  p2: replica/apply-stall: {P_SUM!r} fell back "
              f"(stale_fallback, Note {note_st[0][1]}) in {t_st:.1f} ms, "
              f"exact; both followers caught up {t_catch2:.2f}s after the "
              f"stall; net/partition toward both followers: fell back "
              f"(unreachable_fallback) in {t_un:.1f} ms, exact")
        mark("p2")
        # part q on this cluster: the range plane on the leader
        print(f"  -- q. the range plane on p's leader ({_mem()} held "
              f"before it)")
        t_q = time.perf_counter()
        q_out = _part_q(args, tmp, leader, sl, want, by_addr, caught_up)
        print(f"  [part q took {time.perf_counter() - t_q:.1f}s]")
        mark("q")
        # p3. the leader dies: one follower promotes (term 2), the other
        # repoints, writes go on through both, and every acknowledged
        # write reads back on both, on the card
        _sync()
        mem0 = torch.cuda.memory_allocated()
        time.sleep(1.2)  # a failover tick refreshes the voter roll
        votes = {f.diag_address: (f.kv.kv._applied_off, f.coord.node_id)
                 for f in followers}
        t0 = time.perf_counter()
        leader.rpc_server.close()
        deadline = time.monotonic() + 60
        while not any(not f.remote for f in followers):
            if time.monotonic() > deadline:
                raise SystemExit("p3: no follower promoted within 60 s")
            time.sleep(0.02)
        t_prom = time.perf_counter() - t0
        promoted = next(f for f in followers if not f.remote)
        survivor = next(f for f in followers if f.remote)
        while not (survivor._rpc_client.term == 2
                   and not survivor._rpc_client.degraded):
            if time.monotonic() > deadline:
                raise SystemExit("p3: the survivor did not repoint")
            time.sleep(0.02)
        t_rep = time.perf_counter() - t0
        win = max(votes.values(), key=lambda v: (v[0], -v[1]))
        if promoted.rpc_server.term != 2 or \
                votes[survivor.diag_address] == win:
            raise SystemExit(f"p3: term {promoted.rpc_server.term}, votes "
                             f"{votes}")
        _sync()
        mem1 = torch.cuda.memory_allocated()
        sp, ss = Session(promoted), Session(survivor)
        retries = 0

        def write(s_, sql: str) -> None:
            # a follower's call that exhausted its budget against the
            # dead leader just after the repoint marks it degraded until
            # its next successful call: such a write fails typed (9001)
            # and is retried, within 5 s
            nonlocal retries
            until = time.monotonic() + 5
            while True:
                try:
                    s_.execute(sql)
                    return
                except LeaderUnavailable:
                    if time.monotonic() > until:
                        raise
                    retries += 1
                    time.sleep(0.1)

        for n, s_ in enumerate((sp, ss)):
            i = P_ROWS + n
            write(s_, f"insert into sbtest values ({i}, 7, 'p3', 'p3')")
            acked[i] = 7
            write(s_, f"update sbtest set k = k + 2 where id = {n + 1}")
            acked[n + 1] += 2
        want = _p_oracle(list(acked), list(acked.values()))
        launches_f = _kernels.LAUNCHES[RANK]
        seen = {}
        for name, s_ in (("promoted", sp), ("survivor", ss)):
            deadline = time.monotonic() + 30
            while (rows := s_.query(P_ALL)) != want[P_ALL]:
                if time.monotonic() > deadline:
                    raise SystemExit(f"p3: the {name} reads "
                                     f"{len(rows)} rows, not the "
                                     f"{len(acked)} acknowledged")
                time.sleep(0.1)
            for q in (P_SUM, P_HAVING):
                if s_.query(q) != want[q] or \
                        not s_.last_engines[0].startswith("device"):
                    raise SystemExit(f"p3: the {name}'s {q!r}: "
                                     f"{s_.last_engines}")
            seen[name] = list(s_.last_engines)
        launches_f = _kernels.LAUNCHES[RANK] - launches_f
        zombie = RpcClient(promoted.rpc_server.address, RpcOptions(**base))
        try:
            zombie.call("hello")
            zombie.term = 1
            try:
                zombie.call("wal_append", seq=1, expected=0, data=b"x",
                            token=0, term=1)
                raise SystemExit("p3: an old-term wal_append passed")
            except StaleTermError as e:
                fenced = str(e)
        finally:
            zombie.close()
        print(f"  p3: leader's RPC server closed; node "
              f"{votes[next(a for a in votes if by_addr[a] is promoted)][1]}"
              f" (WAL {win[0]} B, votes {sorted(votes.values())}) promoted "
              f"to term {promoted.rpc_server.term} at "
              f"{promoted.rpc_server.address} after {t_prom:.3f}s, the "
              f"survivor repointed after {t_rep:.3f}s; writes on both "
              f"({retries} retried after a typed 9001); "
              f"all {len(acked)} acknowledged rows read back on both "
              f"(engines {seen}); old-term wal_append refused: "
              f"StaleTermError {fenced!r}; device memory "
              f"{mem0 / 1e6:.1f} MB before, {mem1 / 1e6:.1f} MB after the "
              f"promotion; streamseg launches on the promoted leader's and "
              f"the survivor's reads: {launches_f}")
        mark("p3")
    finally:
        # p4. followers first, then the leader; no titpu-* thread left
        errors = []
        for st_ in [*reversed(followers), leader]:
            try:
                st_.close()
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
        if errors:
            raise errors[0]
    deadline = time.monotonic() + 15
    while (left := titpu() - threads0) and time.monotonic() < deadline:
        time.sleep(0.05)
    if left:
        raise SystemExit(f"p4: threads left: {sorted(t.name for t in left)}")
    mark("p4")
    print(f"  p4: every store closed, no titpu-* thread left; steps (s) "
          f"{({k_: round(v, 2) for k_, v in step.items()})}")
    return {"launches": _kernels.LAUNCHES[RANK] - launches0
            - q_out["launches"], "steps": step, "q": q_out}


# ---- part q: the range plane on part p's leader ----
# [ranges] as the reference's defaults but enabled with its default count
# of 4 (split at sbtest's record keys of ids 2,500, 5,000 and 7,500; the
# TOML's split-points are utf-8 strings and a record key is not, so the
# table is bootstrapped with the byte keys and the seed adopts it, first
# writer wins); [heatmap] on with 1 s buckets (a depth cut from 10 s: the
# detector closes its buckets within the part's few seconds)
Q_CONFIG = """[ranges]
enabled = true
count = 4
lease-ms = 1000
resolve-ttl-ms = 3000
auto-split = {auto}

[heatmap]
enabled = true
bucket-seconds = 1

[replica-read]
range-aware = true
"""
Q_SPLIT_IDS = (2500, 5000, 7500)
Q_POINTS = 500
Q_UPDATES = 300
# the hot quarter: sbtest ids [5000, 7500), the third range
Q_HOT = (5000, 7500)
# the UPDATEs are paced over at least this long: the detector needs
# `sustained-buckets` (2) closed hot buckets of 1 s and one more rotation
Q_UPDATE_S = 4.0
Q_TXNS = 200
Q_MANUAL_SPLIT_ID = 1250


def _q_range_of(specs, key: bytes) -> int:
    return next(s.id for s in specs if s.contains(key))


def _part_q(args, tmp: str, leader, sl, want: dict, by_addr: dict,
            caught_up) -> dict:
    """Part q (module docstring) on part p's leader `leader`, its session
    `sl` and its followers (`by_addr`), after p2. -> {"launches":
    streamseg's launches in the part, "steps": each step's seconds}."""
    import os
    from unittest import mock

    from tidb_tpu_torch.config import Config
    from tidb_tpu_torch.kv import tablecodec
    from tidb_tpu_torch.kv.mvcc import OP_PUT, MVCCStore, Mutation
    from tidb_tpu_torch.kv.rangemeta import split_keyspace, table_gaps
    from tidb_tpu_torch.kv.twopc import Snapshot
    from tidb_tpu_torch.rpc.client import RpcClient, RpcOptions
    from tidb_tpu_torch.rpc.errors import NotLeaderError, StaleTermError
    from tidb_tpu_torch.rpc.frame import make_range_ctx
    from tidb_tpu_torch.rpc.ranged import RangeDirectory, RangeServer
    from tidb_tpu_torch.server import Server

    step = {}
    t_step = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_step
        now = time.perf_counter()
        step[name] = now - t_step
        t_step = now

    def config(auto: bool):
        path = os.path.join(tmp, f"q_{int(auto)}.toml")
        with open(path, "w") as f:
            f.write(Q_CONFIG.format(auto=str(auto).lower()))
        return Config.load(path)

    launches0 = _kernels.LAUNCHES[RANK]
    _sync()
    mem0 = torch.cuda.memory_allocated()
    heat = leader.heat
    reads = leader.obs.replica_reads
    tid = leader.catalog.table("test", "sbtest").id
    # q0. arm the heat plane and the range plane as the server process
    # does at startup
    t0 = time.perf_counter()
    cfg = config(auto=False)
    RangeDirectory(leader.path).bootstrap(split_keyspace(
        cfg.ranges.count,
        [tablecodec.record_key(tid, i) for i in Q_SPLIT_IDS]))
    cfg.seed_heatmap(leader)
    cfg.seed_ranges(leader)
    plane = leader.ranges
    srv = plane.server
    deadline = time.monotonic() + 30
    while len(srv.hosted_ids()) < 4:
        if time.monotonic() > deadline:
            raise SystemExit(f"q0: the range server hosts "
                             f"{srv.hosted_ids()} after 30 s")
        time.sleep(0.02)
    t_arm = time.perf_counter() - t0
    specs = sorted(srv.specs, key=lambda s_: s_.start_key)
    if len(specs) != 4 or table_gaps(specs) or not heat.enabled or \
            heat.bucket_seconds != 1:
        raise SystemExit(f"q0: table {specs}, heat {heat.enabled} "
                         f"{heat.bucket_seconds}")
    print(f"  q0: Config.seed_heatmap and Config.seed_ranges on p's leader "
          f"([ranges] count {cfg.ranges.count}, lease-ms "
          f"{cfg.ranges.lease_ms}, resolve-ttl-ms "
          f"{cfg.ranges.resolve_ttl_ms}; [heatmap] bucket-seconds "
          f"{cfg.heatmap.bucket_seconds}): the range server at "
          f"{srv.address} hosts ranges {srv.hosted_ids()} after "
          f"{t_arm:.3f}s")
    mark("q0")

    # q1. heat on the card: p1's three reads on the leader, 500 point
    # SELECTs, 300 UPDATEs in the hot quarter
    def rows_by_range() -> dict:
        return {r[0]: list(r[3:7]) for r in heat.table_rows()}

    noted = []
    orig_note = heat.note_scan

    def note_scan(table_id, rows, nbytes):
        noted.append((table_id, rows, nbytes))
        return orig_note(table_id, rows, nbytes)

    sl.execute("set tidb_replica_read = 'leader'")
    cpu = Session(leader, device="cpu")
    h0 = rows_by_range()
    with mock.patch.object(heat, "note_scan", note_scan):
        for q in (P_SUM, P_HAVING, P_ALL):
            if sl.query(q) != want[q] or not \
                    sl.last_engines[0].startswith("device"):
                raise SystemExit(f"q1: {q!r} on the leader: "
                                 f"{sl.last_engines}")
        card_notes = list(noted)
        h1 = rows_by_range()
        del noted[:]
        if cpu.query(P_SUM) != want[P_SUM]:
            raise SystemExit("q1: the CPU session's sum differs")
        cpu_notes = list(noted)
        h2 = rows_by_range()
        del noted[:]
        if sl.query(P_SUM) != want[P_SUM]:
            raise SystemExit("q1: the card session's sum differs")
        card_sum = list(noted)
        h3 = rows_by_range()
    rids = [s_.id for s_ in specs]

    def split(total: int) -> dict:
        # the reference's rule: an even share a range, the remainder on
        # the first range the table's record span overlaps
        share, rem = divmod(total, len(rids))
        return {rid: share + (rem if i == 0 else 0)
                for i, rid in enumerate(rids)}

    def delta(after: dict, before: dict, col: int) -> dict:
        return {rid: after[rid][col] - before.get(rid, [0] * 4)[col]
                for rid in after}

    want_rows = {rid: 0 for rid in rids}
    want_bytes = dict(want_rows)
    for table_id, n, nb in card_notes:
        if table_id != tid:
            raise SystemExit(f"q1: a scan of table {table_id} noted")
        for rid, v in split(n).items():
            want_rows[rid] += v
        for rid, v in split(nb).items():
            want_bytes[rid] += v
    if not card_notes or delta(h1, h0, 0) != want_rows or \
            delta(h1, h0, 1) != want_bytes:
        raise SystemExit(f"q1: scans noted {card_notes}; read rows "
                         f"{delta(h1, h0, 0)} bytes {delta(h1, h0, 1)}, "
                         f"want {want_rows} {want_bytes}")
    if card_sum != cpu_notes or delta(h3, h2, 1) != delta(h2, h1, 1) or \
            delta(h3, h2, 0) != delta(h2, h1, 0):
        raise SystemExit(f"q1: the card's scan noted {card_sum} "
                         f"{delta(h3, h2, 1)}, the CPU's {cpu_notes} "
                         f"{delta(h2, h1, 1)}")
    rng = np.random.default_rng(args.seed + 31)
    ids = rng.integers(0, P_ROWS, Q_POINTS)
    t0 = time.perf_counter()
    for i in ids.tolist():
        if sl.query(f"select k from sbtest where id = {i}") != \
                [(want[P_ALL][i][1],)] or sl.last_engines != ["point"]:
            raise SystemExit(f"q1: point SELECT of id {i}: "
                             f"{sl.last_engines}")
    t_points = time.perf_counter() - t0
    h4 = rows_by_range()
    want_pts = {rid: 0 for rid in rids}
    for i in ids.tolist():
        want_pts[_q_range_of(specs, tablecodec.record_key(tid, i))] += 1
    if delta(h4, h3, 0) != want_pts or \
            delta(h4, h3, 1) != {r: 32 * n for r, n in want_pts.items()}:
        raise SystemExit(f"q1: point reads {delta(h4, h3, 0)} "
                         f"{delta(h4, h3, 1)}, want {want_pts}")
    hot_rid = _q_range_of(specs, tablecodec.record_key(tid, Q_HOT[0]))
    hot_ids = rng.integers(Q_HOT[0], Q_HOT[1], Q_UPDATES * 10).tolist()
    cs = rng.integers(0, 10, (Q_UPDATES * 10, 120)).astype(np.uint8) + 48

    n_upd = 0

    def update() -> None:
        # sysbench's oltp_update_non_index: c changes, k (indexed) not,
        # so each commit writes one record key
        nonlocal n_upd
        i = hot_ids[n_upd]
        sl.execute(f"update sbtest set c = '{bytes(cs[n_upd]).decode()}' "
                   f"where id = {i}")
        n_upd += 1

    advisory = found = None
    written = []
    orig_write = heat.note_write

    def note_write(items):
        written.extend(items)
        return orig_write(items)

    heat.note_write = note_write
    t0 = time.perf_counter()
    for u in range(Q_UPDATES):
        while time.perf_counter() < t0 + Q_UPDATE_S * u / Q_UPDATES:
            time.sleep(0.002)
        update()
        if advisory is None and u % 10 == 9:
            fs = [f for f in heat.findings()
                  if f["rule"] == "range-split-advisory"]
            if fs:
                found = sl.query(
                    "select rule, item, value from "
                    "information_schema.inspection_result where rule = "
                    "'range-split-advisory'")
                advisory = heat.split_advisory(hot_rid)
    t_upd = time.perf_counter() - t0
    del heat.note_write
    h5 = rows_by_range()
    w_rows = delta(h5, h4, 2)
    # sbtest's record keys written (the other keys: the catalog's and
    # statistics' meta keys of the auto-analyze, which routes to r1)
    rec_lo, rec_hi = tablecodec.record_range(tid)
    rec = [k_ for k_, _ in written if rec_lo <= k_ < rec_hi]
    other = len(written) - len(rec)
    hot_evs = [e for e in leader.obs.events.snapshot()
               if e["kind"] == "hot_range"]
    spec = next(s_ for s_ in specs if s_.id == hot_rid)
    if len(rec) != Q_UPDATES or \
            {_q_range_of(specs, k_) for k_ in rec} != {hot_rid} or \
            w_rows[hot_rid] != Q_UPDATES or \
            sum(w_rows.values()) != Q_UPDATES + other or \
            delta(h5, h4, 3)[hot_rid] <= 0:
        raise SystemExit(f"q1: write rows {w_rows}, bytes "
                         f"{delta(h5, h4, 3)}, {len(rec)} sbtest keys, "
                         f"{other} others")
    if not hot_evs or not hot_evs[-1]["detail"].startswith(f"r{hot_rid} "):
        raise SystemExit(f"q1: hot_range events {hot_evs}")
    if not found or found[0][1] != f"r{hot_rid}" or advisory is None or \
            not (spec.start_key < advisory < spec.end_key) or \
            found[0][2] != advisory.hex()[:48]:
        raise SystemExit(f"q1: inspection_result {found}, advisory "
                         f"{advisory!r} in {spec}")
    server = Server(leader, port=0, status_port=0,
                    status_host="127.0.0.1")
    server.start()
    try:
        code, body = _http(server.status_port, "/debug/keyviz")
        kv = json.loads(body) if code == 200 else {}
        code2, body2 = _http(server.status_port, "/status")
        st_ranges = json.loads(body2).get("ranges") if code2 == 200 \
            else None
    finally:
        server.close()
    if not kv.get("buckets") or len(kv.get("heatmap", ())) != 4 or \
            kv["totals"][str(hot_rid)][2] < Q_UPDATES or not st_ranges \
            or len(st_ranges["hosted"]) != 4:
        raise SystemExit(f"q1: /debug/keyviz {code} "
                         f"{sorted(kv)}, /status ranges {st_ranges}")
    sql_rows = sl.query("select range_id, read_rows, write_rows, hot from "
                        "information_schema.tidb_hot_ranges")
    print(f"  q1: p1's three reads on the leader's card: {len(card_notes)} "
          f"scans noted, read rows {delta(h1, h0, 0)} and bytes "
          f"{delta(h1, h0, 1)} by range, the reference's split; the same "
          f"sum on a cuda and a cpu session noted {card_sum} and "
          f"{cpu_notes}; {Q_POINTS} point SELECTs in {t_points:.2f}s "
          f"({delta(h4, h3, 0)} by range); {Q_UPDATES} UPDATEs of ids in "
          f"[{Q_HOT[0]}, {Q_HOT[1]}) in {t_upd:.2f}s: write rows {w_rows} "
          f"({other} of them meta keys); "
          f"hot_range event {hot_evs[-1]['detail']!r}; inspection_result "
          f"{found[0]}; /debug/keyviz {len(kv['buckets'])} buckets, "
          f"heatmap {kv['heatmap']}; tidb_hot_ranges {sql_rows}")
    mark("q1")

    # q4a. auto-split by a reseed while the advisory fires
    splits0 = {t: obs.RANGE_SPLITS.get(trigger=t) for t in ("auto",
                                                             "manual")}
    hot_before = heat.range_totals(hot_rid)
    config(auto=True).seed_ranges(leader)
    t0 = time.perf_counter()
    deadline = time.monotonic() + 20
    while obs.RANGE_SPLITS.get(trigger="auto") == splits0["auto"]:
        if time.monotonic() > deadline or n_upd >= len(hot_ids):
            raise SystemExit(f"q4: no auto split after {n_upd} UPDATEs; "
                             f"findings {heat.findings()}")
        update()
        time.sleep(max(0.0, Q_UPDATE_S / Q_UPDATES - 0.002))
    t_auto = time.perf_counter() - t0
    # the lease thread bumps its count just after the split lands
    while srv._auto_splits == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    config(auto=False).seed_ranges(leader)
    specs2 = sorted(srv.directory.load_specs(), key=lambda s_: s_.start_key)
    left = next(s_ for s_ in specs2 if s_.id == hot_rid)
    child = next(s_ for s_ in specs2 if s_.start_key == left.end_key)
    if len(specs2) != 5 or table_gaps(specs2) or \
            not (spec.start_key < left.end_key < spec.end_key) or \
            srv._auto_splits != 1 or \
            srv._auto_splits > srv.max_auto_splits or \
            heat.range_totals(hot_rid)[2] >= hot_before[2]:
        raise SystemExit(f"q4: table {specs2}, auto splits "
                         f"{srv._auto_splits}, r{hot_rid} heat "
                         f"{hot_before} -> {heat.range_totals(hot_rid)}")
    print(f"  q4a: [ranges] auto-split = true by a reseed: the actuator "
          f"split r{hot_rid} at {left.end_key.hex()} (the advisory "
          f"{advisory.hex()} at q1) into r{left.id}+r{child.id} (epoch "
          f"{left.epoch}) after {t_auto:.3f}s and {n_upd - Q_UPDATES} more "
          f"UPDATEs; tidb_range_splits_total{{trigger=\"auto\"}} "
          f"{splits0['auto']:g} -> "
          f"{obs.RANGE_SPLITS.get(trigger='auto'):g}; r{hot_rid}'s heat "
          f"{hot_before} retired to {heat.range_totals(hot_rid)}; "
          f"auto-split off again")
    mark("q4a")

    # q2. cross-range 2PC through the range plane's committer
    committer = plane.committer(leader.tso)
    router = committer.rm
    keys = []
    t0 = time.perf_counter()
    commits = []
    try:
        for j in range(Q_TXNS):
            ks = [tablecodec.record_key(tid, 100 + j),
                  tablecodec.record_key(tid, 3000 + j)]
            if j % 2 == 0:
                ks.append(tablecodec.record_key(tid, 9000 + j))
            muts = [Mutation(OP_PUT, k_, b"q2-%d" % j) for k_ in ks]
            commits.append(committer.commit(muts, leader.tso.ts()))
            keys += [(k_, b"q2-%d" % j) for k_ in ks]
        t_txn = time.perf_counter() - t0
        spans = {len({_q_range_of(specs2, k_) for k_ in
                      (tablecodec.record_key(tid, 100 + j),
                       tablecodec.record_key(tid, 3000 + j))})
                 for j in range(Q_TXNS)}
        snap = Snapshot(router, leader.tso, leader.tso.ts())
        bad = [k_ for k_, v in keys if snap.get(k_) != v]
        t0 = time.perf_counter()
        deadline = time.monotonic() + 15
        while min(ts for _, ts in plane.closed_over(b"", b"")) < \
                max(commits):
            if time.monotonic() > deadline:
                raise SystemExit(f"q2: closed_over "
                                 f"{plane.closed_over(b'', b'')} below "
                                 f"{max(commits)}")
            time.sleep(0.05)
        t_cov = time.perf_counter() - t0
    finally:
        router.close()
    if bad or spans != {2}:
        raise SystemExit(f"q2: {len(bad)} keys read back wrong, ranges "
                         f"a txn spans {spans}")
    print(f"  q2: {Q_TXNS} cross-range 2PC transactions ({len(keys)} keys, "
          f"each over 2-3 ranges, sync_log='commit') in {t_txn:.2f}s "
          f"({Q_TXNS / t_txn:.1f} txn/s); every key read back through the "
          f"router; closed_over covers the newest commit ts "
          f"{t_cov:.3f}s after the last commit")
    mark("q2")

    # q3. range-aware routed reads
    cfg.seed_replica_read(leader)
    if not leader.replica_read.range_aware:
        raise SystemExit("q3: range-aware is off after the seed")
    caught_up("q3")
    sl.execute("set tidb_replica_read = 'follower'")

    def routed(label: str) -> tuple:
        served0, dev0 = reads.get(outcome="served"), _p_copr()
        t0 = time.perf_counter()
        rows = sl.query(P_SUM)
        dt = (time.perf_counter() - t0) * 1e3
        tag = next((e for e in sl.last_engines if e.startswith("replica@")),
                   None)
        f = by_addr.get(tag.split("@", 1)[-1]) if tag else None
        fs = f._replica_pool[-1] if f is not None else None
        if rows != want[P_SUM] or tag is None or \
                reads.get(outcome="served") != served0 + 1 or \
                _p_copr() <= dev0 or fs._cop.device.type != P_DEVICE:
            raise SystemExit(f"{label}: {rows} {sl.last_engines} served "
                             f"{served0} -> {reads.get(outcome='served')}")
        return tag, dt

    tag, t_cov_read = routed("q3")
    start, _end = tablecodec.table_range(tid)
    wedge = start + b"\x00wedge"
    wedge_ts = leader.tso.ts()
    router = plane.router()
    try:
        h = router.locate(wedge)
        router.prewrite(h, [Mutation(OP_PUT, wedge, b"x")], wedge,
                        wedge_ts, ttl=60_000)
        time.sleep(0.01)
        fb0 = reads.get(outcome="stale_fallback")
        t0 = time.perf_counter()
        rows = sl.query(P_SUM)
        t_fb = (time.perf_counter() - t0) * 1e3
        notes = [w for w in sl.warnings if "uncovered" in w[2]]
        if rows != want[P_SUM] or \
                reads.get(outcome="stale_fallback") != fb0 + 1 or \
                not notes or "range#" not in notes[0][2] or \
                not any(e.startswith("device") for e in sl.last_engines):
            raise SystemExit(f"q3: the wedged read {rows} "
                             f"{sl.last_engines} {sl.warnings}")
        router.rollback(h, [wedge], wedge_ts)
    finally:
        router.close()
    t0 = time.perf_counter()
    deadline = time.monotonic() + 8
    while True:
        served0 = reads.get(outcome="served")
        if sl.query(P_SUM) != want[P_SUM]:
            raise SystemExit("q3: a read after the rollback differs")
        if reads.get(outcome="served") > served0:
            break
        if time.monotonic() > deadline:
            raise SystemExit(f"q3: not routed again within 8 s: "
                             f"{sl.last_engines} {sl.warnings}")
        time.sleep(0.1)
    t_back = time.perf_counter() - t0
    print(f"  q3: [replica-read] range-aware = true by Config."
          f"seed_replica_read: {P_SUM!r} covered, served by {tag} on "
          f"{P_DEVICE} in {t_cov_read:.1f} ms; a wedge prewrite (ttl 60 s) "
          f"in sbtest's span: stale_fallback in {t_fb:.1f} ms, exact on "
          f"the leader's card, Note {notes[0][2][:160]!r}; rolled back: "
          f"routed again after {t_back:.3f}s")
    mark("q3")

    # q4b. a manual split while routed reads run, then a forced transfer
    timed = {"export_range": 0.0, "discard_range": 0.0}

    def timing(name):
        orig = getattr(MVCCStore, name)

        def run(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(self, *a, **kw)
            finally:
                timed[name] += time.perf_counter() - t0
        return mock.patch.object(MVCCStore, name, run)

    key = tablecodec.record_key(tid, Q_MANUAL_SPLIT_ID)
    man_rid = _q_range_of(specs2, key)
    answers = []
    with timing("export_range"), timing("discard_range"):
        for i in range(6):
            if i == 2:
                t0 = time.perf_counter()
                srv.split_range(man_rid, key)
                t_split = time.perf_counter() - t0
            rows = sl.query(P_SUM)
            answers.append(rows == want[P_SUM])
    specs3 = sorted(srv.directory.load_specs(), key=lambda s_: s_.start_key)
    if not all(answers) or len(specs3) != 6 or table_gaps(specs3) or \
            obs.RANGE_SPLITS.get(trigger="manual") != \
            splits0["manual"] + 1:
        raise SystemExit(f"q4: answers {answers}, table {specs3}")
    print(f"  q4b: r{man_rid} split by hand at sbtest id "
          f"{Q_MANUAL_SPLIT_ID} in {t_split * 1e3:.1f} ms (export_range "
          f"{timed['export_range'] * 1e3:.1f} ms, discard_range "
          f"{timed['discard_range'] * 1e3:.1f} ms over the range leader's "
          f"store) between routed reads: 6 of 6 exact; "
          f"tidb_range_splits_total{{trigger=\"manual\"}} +1")
    d = srv.directory
    drop = 2
    old = {s_.id: d.read_grant(s_.id) for s_ in specs3}
    moved0 = obs.RANGE_TRANSFERS.get()
    peer = RangeServer(leader.path, lease_ms=1000)
    try:
        t0 = time.perf_counter()
        deadline = time.monotonic() + 30
        with failpoint.failpoint("range/lease-drop", drop):
            while obs.RANGE_TRANSFERS.get() == moved0:
                if time.monotonic() > deadline:
                    raise SystemExit("q4: no transfer within 30 s")
                time.sleep(0.02)
        t_move = time.perf_counter() - t0
        while True:
            g = d.read_grant(drop)
            if g and float(g["expires_ms"]) > time.time() * 1000 and \
                    g["term"] > old[drop]["term"]:
                break
            if time.monotonic() > deadline:
                raise SystemExit(f"q4: range {drop}'s grant {g}")
            time.sleep(0.02)
        spec_d = next(s_ for s_ in specs3 if s_.id == drop)
        cli = RpcClient(g["owner"], RpcOptions(connect_timeout_ms=1000,
                                               request_timeout_ms=2000),
                        _heartbeat=False)
        fenced = None
        try:
            while fenced is None:
                try:
                    cli.call("range_get", key=spec_d.start_key, read_ts=1,
                             rc=make_range_ctx(drop, spec_d.epoch,
                                               old[drop]["term"]))
                    raise SystemExit("q4: an old-term range_get passed")
                except StaleTermError as e:
                    fenced = str(e)
                except NotLeaderError:
                    # the grant is written a moment before its new owner
                    # opens the range
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
        finally:
            cli.close()
        kept = {rid: (d.read_grant(rid)["owner"], d.read_grant(rid)["term"])
                for rid in old if rid != drop}
        if kept != {rid: (g_["owner"], g_["term"])
                    for rid, g_ in old.items() if rid != drop}:
            raise SystemExit(f"q4: other ranges moved: {kept} vs {old}")
    finally:
        peer.close()
    print(f"  q4b: range/lease-drop for r{drop} with a peer RangeServer "
          f"over the leader's root: transferred after {t_move:.3f}s "
          f"(tidb_range_transfers_total {moved0:g} -> "
          f"{obs.RANGE_TRANSFERS.get():g}), term {old[drop]['term']} -> "
          f"{g['term']} at {g['owner']}; an old-term request: "
          f"StaleTermError {fenced!r}; the other {len(kept)} ranges kept "
          f"their owner and term; the peer closed")
    mark("q4b")
    _sync()
    mem1 = torch.cuda.memory_allocated()
    launched = _kernels.LAUNCHES[RANK] - launches0
    print(f"  q5: device memory {mem0 / 1e6:.1f} MB before part q, "
          f"{mem1 / 1e6:.1f} MB after; streamseg launches in part q: "
          f"{launched}; steps (s) "
          f"{({k_: round(v, 2) for k_, v in step.items()})}")
    return {"launches": launched, "steps": step, "arm_s": t_arm,
            "txn_s": t_txn, "split_s": t_split, "auto_split_s": t_auto,
            "transfer_s": t_move}


# ---- part i: online DDL and the schema surface ----
I_READS = ("q6", "q3")


def _i_outcome(s, sql: str):
    """One statement -> (affected, rows as cells) or ("error", errno,
    message). ADMIN SHOW DDL JOBS drops its job ids: the card's and the
    CPU's session take theirs from one counter."""
    from tidb_tpu_torch.session import SQLError

    try:
        rs = s.execute(sql)
    except SQLError as e:
        return ("error", e.errno, str(e))
    rows = rs.rows
    if sql.startswith("ADMIN SHOW DDL JOBS"):
        rows = [r[1:] for r in rows]
    return (rs.affected, TR.sql_cells(rows))


def _i_exec(sessions, sql: str, label: str, times: dict):
    """`sql` on each session, the card's first, ending in a synchronize:
    every other session must give its outcome and tags. -> the card's
    outcome; its wall time goes into `times`."""
    card = sessions[0]
    t0 = time.perf_counter()
    out = _i_outcome(card, sql)
    _sync()
    times[sql] = time.perf_counter() - t0
    tags = list(card.last_engines)
    for other in sessions[1:]:
        got = _i_outcome(other, sql)
        if got != out or other.last_engines != tags:
            raise SystemExit(f"{label}: {sql[:60]!r} on the CPU "
                             f"{str(got)[:200]} {other.last_engines}, on "
                             f"the card {str(out)[:200]} {tags}")
    return out


def _i_read(sessions, q: str, label: str, data=None, want_tags=None,
            warm: int = WARM_RUNS) -> tuple:
    """Query `q` on the card (and the CPU twin's): rows exact against the
    numpy answer over `data` where given, and equal to the twin's; tags
    `want_tags` where given; cold run and warm p50. -> (streamseg
    launches of the cold run, tags)."""
    card = sessions[0]
    sql = TPCH_QUERIES[q]
    before = _kernels.LAUNCHES[RANK]
    rows, first = _sql_run(card, sql)
    launched = _kernels.LAUNCHES[RANK] - before
    tags = list(card.last_engines)
    if data is not None and TR.sql_cells(rows) != TR.sql_oracle(q, data):
        raise SystemExit(f"{label} {q}: SQL rows differ from the oracle")
    if want_tags is not None and tags != want_tags:
        raise SystemExit(f"{label} {q}: engines {tags}, want {want_tags}")
    cpu = ""
    for other in sessions[1:]:
        want, cpu_s = _sql_run(other, sql)
        if other.last_engines != tags or not _rows_equal(q, rows, want):
            raise SystemExit(f"{label} {q}: card rows/tags {tags} differ "
                             f"from the CPU's {other.last_engines}")
        cpu = f" card==cpu cpu_s={cpu_s:.3f}"
    if any(_host_tier(t) for t in tags):
        warm = 0  # seconds of numpy: the cold run only
    times = [_sql_run(card, sql)[1] for _ in range(warm)]
    exact = "exact" if data is not None else "rows"
    print(f"  {label} {q.upper()}: engines={tags} rows={len(rows)} {exact} "
          f"streamseg_launches={launched} {_timing(first, times)}{cpu}")
    return launched, tags


def _timed_batches():
    """A patch of `DDL._validate_unique_batch` that times each reorg batch
    (the first includes the index sort, `epoch_index_order`)."""
    from tidb_tpu_torch.ddl import DDL

    times: list = []
    orig = DDL._validate_unique_batch

    def timed(self, *a):
        t0 = time.perf_counter()
        try:
            return orig(self, *a)
        finally:
            times.append(time.perf_counter() - t0)

    return mock.patch.object(DDL, "_validate_unique_batch", timed), times


def _batch_line(times: list) -> str:
    rest = times[1:] or times
    return (f"{len(times)} reorg batches: the first (with the index sort) "
            f"{times[0]:.3f}s, then p50 {statistics.median(rest) * 1e3:.2f}"
            f" ms, max {max(rest) * 1e3:.2f} ms, sum {sum(times):.2f}s")


def _top_job(sessions, label: str, times: dict) -> tuple:
    out = _i_exec(sessions, "ADMIN SHOW DDL JOBS", label, times)
    return out[1][0]


def _part_i12(args, sessions, data, label: str, want_tags,
              full: bool) -> int:
    """Part i1 (SF10, [f1's card session], `want_tags` parts a-d's) or i2
    (SF1, [card, CPU], `full`: the schema surface too) (module
    docstring), over `data` as RF2 left it. -> streamseg's launches."""
    card = sessions[0]
    li = _stores(card)["lineitem"]
    n = len(data["lineitem"]["l_orderkey"])
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    times: dict = {}

    def run(sql):
        return _i_exec(sessions, sql, label, times)

    def say(sql, extra=""):
        print(f"  {label}: {sql[:72]} {times[sql] * 1e3:.1f} ms{extra}")

    sql = "ALTER TABLE lineitem ADD COLUMN l_tag INT DEFAULT 7"
    before = li.epoch.epoch_id
    run(sql)
    say(sql, f" (epoch {before} -> {li.epoch.epoch_id}); {_mem()}")
    sql = "SELECT sum(l_tag), count(*) FROM lineitem"
    if run(sql)[1] != [(7 * n, n)]:
        raise SystemExit(f"{label}: sum(l_tag), count(*) is not 7 x {n}")
    say(sql, f" = ({7 * n}, {n}) exact; engines {card.last_engines}")
    # i1 runs no ANALYZE after the MODIFY (13-20 s at SF10, paying for
    # part j): Q6 and Q3 keep f1's plans and tags; i2 analyzes at SF1
    for sql in ("ALTER TABLE lineitem MODIFY COLUMN l_quantity "
                "DECIMAL(18,4)", "ANALYZE TABLE lineitem")[:2 if full else 1]:
        run(sql)
        say(sql)
    rewritten = li.epoch
    launches = {}
    for q in I_READS:
        launches[q], _ = _i_read(
            sessions, q, label, data,
            want_tags(q) if want_tags is not None else None)
    if li.epoch is not rewritten or not (full or launches["q3"]):
        # at SF1 (i2) orders' overlay sends Q3 to the host tier, as in g1'
        raise SystemExit(f"{label}: q3 did not launch streamseg over the "
                         "lineitem epoch the DDL rewrote")
    if full:
        # o_ck's ~750 reorg batches over SF10 orders (10.7-32.5 s) paid
        # for part j, and its ~75 over SF1 orders (5.1 s a session) for
        # part o: i2 builds the unique index over SF1 customer (150,000
        # rows, 8 batches), i1 runs the failing l_ok, i3 the unique reorg
        patch, batches = _timed_batches()
        sql = ("CREATE UNIQUE INDEX c_nk ON customer (c_nationkey, "
               "c_custkey)")
        with patch:
            out = run(sql)
        if out[0] == "error":
            raise SystemExit(f"{label}: {sql}: {out}")
        say(sql, f"; {_batch_line(batches)}")
        job = _top_job(sessions, label, times)
        if job[2:5] != ("add_index", "public", "done"):
            raise SystemExit(f"{label}: c_nk's job is {job}")
        out = run("SHOW INDEX FROM customer")
        if "c_nk" not in {r[2] for r in out[1]}:
            raise SystemExit(f"{label}: SHOW INDEX FROM customer lists no "
                             "c_nk")
    sql = "CREATE UNIQUE INDEX l_ok ON lineitem (l_orderkey)"
    patch, batches = _timed_batches()
    with patch:
        out = run(sql)
    # the reference's rolled-back job re-raises its error by its text:
    # errno 1105, the validation's duplicate in the message
    if out[:2] != ("error", 1105) or "Duplicate entry" not in out[2]:
        raise SystemExit(f"{label}: {sql}: {out}")
    say(sql, f" -> {out[1]} {out[2]!r}; {_batch_line(batches)}")
    job = _top_job(sessions, label, times)
    if job[2] != "add_index" or job[4] != "rolled back" or any(
            ix.name == "l_ok"
            for ix in card.catalog.table("test", "lineitem").indices):
        raise SystemExit(f"{label}: l_ok's job is {job}, or l_ok is left")
    if full:
        print(f"  {label}: ADMIN SHOW DDL JOBS: c_nk done, l_ok rolled "
              f"back; SHOW INDEX FROM customer lists c_nk")
        _part_i2_surface(sessions, label, times, launches)
        run("DROP INDEX c_nk ON customer")
        say("DROP INDEX c_nk ON customer")
    else:
        print(f"  {label}: ADMIN SHOW DDL JOBS: l_ok rolled back")
    sql = "ALTER TABLE lineitem DROP COLUMN l_tag"
    run(sql)
    say(sql)
    # i1's last read takes its cold run only since part p: its warm run
    # was the session's 64th statement and ran the auto-analyze of the
    # SF10 lineitem (12.7 s of a 23.4 s lap)
    launches["q6 after"], _ = _i_read(
        sessions, "q6", label, data,
        want_tags("q6") if want_tags is not None else None,
        warm=WARM_RUNS if full else 0)
    total = _kernels.LAUNCHES[RANK]
    print(f"  {label}: streamseg launches {total} ({launches}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} "
          f"GB; {_mem()}")
    return total


I2_VIEW = ("CREATE VIEW li_ord AS SELECT o_orderpriority, count(*) AS n, "
           "sum(l_extendedprice) AS rev FROM lineitem, orders "
           "WHERE l_orderkey = o_orderkey AND o_orderdate >= '1995-01-01' "
           "AND o_orderdate < '1995-04-01' GROUP BY o_orderpriority")
I2_SURFACE = [
    I2_VIEW,
    "SELECT * FROM li_ord ORDER BY o_orderpriority",
    "SELECT * FROM li_ord ORDER BY o_orderpriority",
    "CREATE SEQUENCE i2_seq START WITH 100",
    "CREATE TABLE seq_t (id BIGINT PRIMARY KEY, v VARCHAR(8))",
    "INSERT INTO seq_t VALUES (NEXTVAL(i2_seq), 'a'), "
    "(NEXTVAL(i2_seq), 'b')",
    "SELECT id, v FROM seq_t ORDER BY id",
    "RENAME TABLE orders TO orders_r",
    "SELECT count(*) FROM orders_r",
    "RENAME TABLE orders_r TO orders",
    "SHOW TABLES",
    "SHOW CREATE TABLE lineitem",
    "SHOW INDEX FROM orders",
    "SELECT table_name, column_name, column_type, column_key FROM "
    "information_schema.columns WHERE table_schema = 'test' "
    "ORDER BY table_name, ordinal_position",
    "SELECT table_name, table_type, table_rows FROM "
    "information_schema.tables WHERE table_schema = 'test' "
    "ORDER BY table_name",
    "SELECT table_name, index_name, seq_in_index, column_name FROM "
    "information_schema.statistics WHERE table_schema = 'test' "
    "ORDER BY table_name, index_name, seq_in_index",
    "CHECKSUM TABLE orders",
    "ADMIN CHECK TABLE lineitem, orders",
]


def _part_i2_surface(sessions, label: str, times: dict,
                     launches: dict) -> None:
    """The rest of part i2 (module docstring): l_pk and a duplicate
    INSERT, a view, a sequence, RENAME, SHOW, information_schema,
    CHECKSUM, ADMIN CHECK, Q18 and Q1 after the MODIFY."""
    sql = ("CREATE UNIQUE INDEX l_pk ON lineitem (l_orderkey, "
           "l_linenumber)")
    patch, batches = _timed_batches()
    with patch:
        out = _i_exec(sessions, sql, label, times)
    if out[0] == "error":
        raise SystemExit(f"{label}: {sql}: {out}")
    print(f"  {label}: {sql} {times[sql] * 1e3:.1f} ms; "
          f"{_batch_line(batches)}")
    sql = ("INSERT INTO lineitem SELECT * FROM lineitem "
           "WHERE l_orderkey = 1 AND l_linenumber = 1")
    out = _i_exec(sessions, sql, label, times)
    if out[:2] != ("error", 1062):
        raise SystemExit(f"{label}: a duplicate (l_orderkey, l_linenumber) "
                         f"INSERT gave {out}")
    print(f"  {label}: INSERT of an existing (l_orderkey, l_linenumber) -> "
          f"1062 {out[2]!r} on both")
    for sql in I2_SURFACE:
        out = _i_exec(sessions, sql, label, times)
        if out[0] == "error":
            raise SystemExit(f"{label}: {sql}: {out}")
        shown = str(out[1])[:90] if sql.startswith(
            ("SHOW", "CHECKSUM", "SELECT id")) else f"{len(out[1])} rows"
        print(f"  {label}: {sql[:60]} {times[sql] * 1e3:.1f} ms "
              f"card==cpu: {shown}")
    for q in ("q18", "q1"):
        launches[q], _ = _i_read(sessions, q, label, warm=1)


def _part_i3(args, storage, path: str, mc, h1: dict, tags: dict) -> int:
    """Part i3 (module docstring), on h3's reopened store. -> streamseg's
    launches in its Q18."""
    import os

    from tidb_tpu_torch.ddl import DDL
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.store.storage import Storage

    # 1. ADD COLUMN over the wire; the epoch file is rewritten
    orders = storage.catalog.table("test", "orders")
    efile = storage._epoch_file(orders.id)
    mtime = os.stat(efile).st_mtime_ns
    server = Server(storage, port=0)
    server.start()
    cl = mc.MiniClient("127.0.0.1", server.port)
    t0 = time.perf_counter()
    cl.execute("ALTER TABLE orders ADD COLUMN o_flag INT DEFAULT 1")
    dt = time.perf_counter() - t0
    if os.stat(efile).st_mtime_ns == mtime:
        raise SystemExit("i3: ADD COLUMN left orders' epoch file unwritten")
    create = cl.query("SHOW CREATE TABLE orders")[0][1]
    ncols = cl.query("SELECT count(*) FROM information_schema.columns "
                     "WHERE table_schema = 'test' AND "
                     "table_name = 'orders'")
    if "`o_flag` int" not in create or ncols != [("10",)]:
        raise SystemExit(f"i3: SHOW CREATE TABLE / information_schema "
                         f"after ADD COLUMN: {create!r} {ncols}")
    print(f"  i3: ALTER TABLE orders ADD COLUMN o_flag INT DEFAULT 1 over "
          f"the wire {dt * 1e3:.1f} ms (epoch file rewritten); SHOW CREATE "
          f"TABLE lists o_flag; information_schema.columns counts 10")
    cl.close()
    server.close()
    storage.close()
    # 2. a child serving the store dies mid-reorg at the failpoint: at
    # this hit of `ddl/before-step`, after the 3 state steps and half of
    # lineitem's write-reorg batches (~300 at SF1)
    batches = -(-h1["lineitem_rows"] // DDL.REORG_BATCH)
    crash_step = 4 + batches // 2
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               TIDB_TPU_FAILPOINTS=f"ddl/before-step=exit(9)@{crash_step}")
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", H3_CHILD, path],
                             cwd=root, stdout=subprocess.PIPE, text=True,
                             env=env)
    try:
        line = child.stdout.readline()
        if not line.strip().isdigit():
            raise SystemExit(f"i3: the child served no port ({line!r})")
        t_child = time.perf_counter() - t0
        cl = mc.MiniClient("127.0.0.1", int(line))
        t0 = time.perf_counter()
        try:
            cl.execute("CREATE UNIQUE INDEX l_pk ON lineitem "
                       "(l_orderkey, l_linenumber)")
            raise SystemExit("i3: CREATE UNIQUE INDEX outlived the "
                             "failpoint")
        except (ConnectionError, OSError):
            pass
        rc = child.wait(timeout=60)
        t_die = time.perf_counter() - t0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc != 9:
        raise SystemExit(f"i3: the child exited {rc}, not 9")
    print(f"  i3: a child python3 served the store in {t_child:.2f}s; "
          f"CREATE UNIQUE INDEX l_pk over the wire died with it (exit 9 at "
          f"`ddl/before-step` hit {crash_step} of {batches + 3}) after "
          f"{t_die:.2f}s")
    # 3. reopen on the card: the job resumes from its persisted state
    read = []
    orig = DDL.run_job

    def run_job(self, job):
        read.append((job.kind, job.schema_state, job.reorg_pos))
        return orig(self, job)

    patch, batches = _timed_batches()
    t0 = time.perf_counter()
    with mock.patch.object(DDL, "run_job", run_job), patch:
        storage = Storage(path, sync_log="commit")
    t_open = time.perf_counter() - t0
    if not read or read[0][1] != "write reorg" or read[0][2] <= 0:
        raise SystemExit(f"i3: the reopen read no job mid-reorg: {read}")
    print(f"  i3: reopened in {t_open:.2f}s, resuming {read[0][0]} from its "
          f"persisted state {read[0][1]!r}, reorg_pos={read[0][2]} (the "
          f"reopened epoch has a new id, so the scan restarts on it); "
          f"{_batch_line(batches)}")
    # 4. the job done, the index public, Q18 over the wire
    server = Server(storage, port=0)
    server.start()
    cl = mc.MiniClient("127.0.0.1", server.port)
    job = cl.query("ADMIN SHOW DDL JOBS")[0]
    idx = {r[2] for r in cl.query("SHOW INDEX FROM lineitem")}
    if job[2:6] != ("lineitem", "add_index", "public", "done") or \
            "l_pk" not in idx:
        raise SystemExit(f"i3: after the reopen the job is {job}, indexes "
                         f"{idx}")
    li = storage.table_store(storage.catalog.table("test", "lineitem").id)
    before = _kernels.LAUNCHES[RANK]
    t0 = time.perf_counter()
    rows = cl.query(TPCH_QUERIES["q18"])
    dt = time.perf_counter() - t0
    launched = _kernels.LAUNCHES[RANK] - before
    got = _server_tags(server)
    if rows != h1["expect"]["q18"] or got != tags["q18"] or not launched:
        raise SystemExit(f"i3: q18 over the wire: exact "
                         f"{rows == h1['expect']['q18']}, engines {got} "
                         f"(f2: {tags['q18']}), streamseg launches "
                         f"{launched}")
    print(f"  i3: ADMIN SHOW DDL JOBS: {job[1:6]}; SHOW INDEX FROM lineitem "
          f"lists l_pk; Q18 over the wire exact engines={got} "
          f"streamseg_launches={launched} over lineitem epoch "
          f"{li.epoch.epoch_id} first_ms={dt * 1e3:.1f}")
    cl.close()
    server.close()
    storage.close()
    return launched


# ---- part j: partitioned tables ----
J_READS = ("q6", "q1", "q18")
J1_BY = "partition by hash(l_orderkey) partitions 4"
Q18_INNER_SQL = ("select l_orderkey, sum(l_quantity) from lineitem "
                 "group by l_orderkey having sum(l_quantity) > 300")
HOVERCRAFT = "HOVERCRAFT"
# the scale of j1's Q1 and Q18-inner: over partitions the reference plans
# no aggregation below the partition union, so each partition's request
# returns its selected rows and the root aggregates them on the host (a
# cold Q1 took 29.9-32.6 s at SF10, ~2.3 s at SF1 in j2); the four runs
# of each read fit part j's 120 s only this small
J1_ROOT_SF = 0.1
# j2's refresh: half of g1''s share (750 orders, ~3,000 lineitems in 5
# routed INSERTs where the whole refresh took 9), for part o; no
# partition reaches the fold threshold either way
J2_RF_SHARE = 0.5


def _j_range_by(li) -> tuple:
    """Four RANGE partitions of equal key width over `li`'s l_orderkey,
    and MAXVALUE. -> (the clause, the width)."""
    step = int(li["l_orderkey"].max()) // 5 + 1
    defs = ", ".join(f"partition p{i} values less than ({step * (i + 1)})"
                     for i in range(4))
    return (f"partition by range (l_orderkey) ({defs}, "
            f"partition pmax values less than maxvalue)"), step


def _j_load(s, data, by: str, names=("orders",),
            analyze: bool = True) -> tuple:
    """`names` bulk-loaded as they are and lineitem through the port's
    partition router; ANALYZE TABLE lineitem. -> (rows per partition,
    load seconds, ANALYZE seconds or None)."""
    t0 = time.perf_counter()
    for name in names:
        TD.load_table(s, name, data[name])
    counts = TD.load_table_partitioned(s, "lineitem", data["lineitem"], by)
    t1 = time.perf_counter()
    if not analyze:
        return counts, t1 - t0, None
    s.execute("analyze table lineitem")
    _sync()
    return counts, t1 - t0, time.perf_counter() - t1


def _j_q18_inner_oracle(li) -> list:
    """Q18-inner's final rows over `li`, whose l_orderkey the generator
    emits in order (checked): each order's sum from its run, the exact
    HAVING."""
    okey, qty = li["l_orderkey"], li["l_quantity"]
    if not (okey[1:] >= okey[:-1]).all():
        raise SystemExit("j1: lineitem's l_orderkey is not in order")
    starts = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    sums = np.add.reduceat(qty, starts)
    ok = sums > TR.Q18_THRESHOLD
    return [(k, ("dec", v, 2))
            for k, v in zip(okey[starts][ok].tolist(), sums[ok].tolist())]


def _j_read(sessions, label: str, sql: str, want, warm: int = WARM_RUNS,
            want_tags=None) -> tuple:
    """`sql` on the card (and the CPU twin's): rows exact against `want`
    (cells) and equal to the twin's, tags `want_tags` where given; the
    cold run and the warm p50 of `warm` runs (a host-tier read: its cold
    run only). -> (tags, streamseg launches of the cold run, the timing
    text)."""
    card = sessions[0]
    before = _kernels.LAUNCHES[RANK]
    rows, first = _sql_run(card, sql)
    launched = _kernels.LAUNCHES[RANK] - before
    tags = list(card.last_engines)
    got = sorted(TR.sql_cells(rows), key=repr)
    if got != sorted(want, key=repr):
        raise SystemExit(f"{label}: {sql[:60]}: rows differ from the oracle")
    if want_tags is not None and tags != want_tags:
        raise SystemExit(f"{label}: {sql[:60]}: engines {tags}, want "
                         f"{want_tags}")
    cpu = ""
    for other in sessions[1:]:
        rows2, cpu_s = _sql_run(other, sql)
        if other.last_engines != tags or \
                sorted(TR.sql_cells(rows2), key=repr) != got:
            raise SystemExit(f"{label}: {sql[:60]}: card rows/tags {tags} "
                             f"differ from the CPU's {other.last_engines}")
        cpu = f" card==cpu cpu_s={cpu_s:.3f}"
    if any(_host_tier(t) for t in tags):
        warm = 0
    times = [_sql_run(card, sql)[1] for _ in range(warm)]
    return tags, launched, f"{_timing(first, times)}{cpu}"


def _j1_reads(s, label: str, reads) -> None:
    for name, sql, want, tags in reads:
        got, launched, timing = _j_read([s], label, sql, want,
                                        want_tags=tags)
        if name == "point" and len(got) != 1:
            raise SystemExit(f"{label}: the point read was not pruned to "
                             f"one partition: {got}")
        print(f"  {label} {name}: engines={got} rows={len(want)} exact "
              f"streamseg_launches={launched} {timing}")


def _part_j1(args, d10) -> int:
    """Part j1 (module docstring). -> streamseg's launches."""
    label = f"j1 SF{args.sf:g}"
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    s = Session()
    counts, t_load, t_an = _j_load(s, d10, J1_BY)
    print(f"  {label}: orders and lineitem ({J1_BY}: {counts} rows) "
          f"bulk-loaded through the router in {t_load:.2f}s; ANALYZE TABLE "
          f"lineitem (4 partitions) {t_an:.2f}s; {_mem()}")
    li = d10["lineitem"]
    n = len(counts)
    k = int(li["l_orderkey"][len(li["l_orderkey"]) // 3])
    m = li["l_orderkey"] == k
    _j1_reads(s, label, [
        ("q6", TPCH_QUERIES["q6"], TR.sql_oracle("q6", d10), ["device"] * n),
        ("point", f"select count(*), sum(l_quantity) from lineitem where "
         f"l_orderkey = {k}",
         [(int(m.sum()), ("dec", int(li["l_quantity"][m].sum()), 2))],
         None)])
    print(f"  {label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB (i1: 11.125 GB "
          f"unpartitioned)")
    del s
    gc.collect()
    torch.cuda.empty_cache()
    # Q1 and Q18-inner at J1_ROOT_SF (module docstring)
    d = TD.generate_tpch(J1_ROOT_SF, args.seed)
    label = f"j1 SF{J1_ROOT_SF:g}"
    s = Session()
    counts, t_load, t_an = _j_load(s, d, J1_BY, ())
    print(f"  {label}: lineitem ({J1_BY}: {counts} rows) bulk-loaded "
          f"through the router in {t_load:.2f}s; ANALYZE TABLE lineitem "
          f"(4 partitions) {t_an:.2f}s")
    _j1_reads(s, label, [
        ("q1", TPCH_QUERIES["q1"], TR.sql_oracle("q1", d),
         ["device"] * len(counts)),
        ("q18-inner", Q18_INNER_SQL, _j_q18_inner_oracle(d["lineitem"]),
         None)])
    total = _kernels.LAUNCHES[RANK]
    print(f"  j1: streamseg launches {total}; {_mem()}")
    return total


def _j_exec(sessions, sql: str, label: str, times: dict):
    """`_i_exec`, where the statement must succeed."""
    out = _i_exec(sessions, sql, label, times)
    if out[0] == "error":
        raise SystemExit(f"{label}: {sql[:72]}: {out}")
    return out


def _j_reads(sessions, label: str, data, queries=J_READS) -> int:
    launched = 0
    for q in queries:
        tags, n, timing = _j_read(sessions, label, TPCH_QUERIES[q],
                                  TR.sql_oracle(q, data), warm=0)
        launched += n
        print(f"  {label} {q.upper()}: engines={tags} exact "
              f"streamseg_launches={n} {timing}")
    return launched


def _j_with_keys(li, old_lo: int, old_hi: int, shift: int) -> dict:
    """lineitem's arrays after `UPDATE ... SET l_orderkey = l_orderkey +
    shift WHERE l_orderkey >= old_lo AND l_orderkey < old_hi`."""
    out = dict(li)
    k = li["l_orderkey"]
    out["l_orderkey"] = np.where((k >= old_lo) & (k < old_hi), k + shift, k)
    return out


def _part_j2(args, d1) -> int:
    """Part j2 (module docstring). -> streamseg's launches."""
    label = f"j2 SF{args.q18_sf:g}"
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    by, step = _j_range_by(d1["lineitem"])
    card, cpu = Session(), Session(device="cpu")
    sessions = [card, cpu]
    for s in sessions:
        # no ANALYZE (j1 analyzes the partitions at SF10): the two
        # sessions plan alike without statistics
        counts, t_load, _ = _j_load(s, d1, by, ("orders", "customer"),
                                    analyze=False)
        print(f"  {label} {s.cop.device}: lineitem {counts} rows in 4 "
              f"ranges of {step} keys and MAXVALUE, loaded in "
              f"{t_load:.2f}s")
    times: dict = {}
    launched = 0
    # 1. TPC-H's refresh: RF1's lineitem INSERTs routed, RF2's DELETEs
    sf = args.q18_sf * J2_RF_SHARE
    new = RF.rf1_rows(d1, sf, args.seed + 101)
    for sql in RF.rf1_statements(new, 1000):
        _j_exec(sessions, sql, label, times)
    after1 = RF.apply_rf1(d1, new)
    keys = RF.rf2_keys(after1, sf, args.seed + 102)
    for sql in RF.rf2_statements(keys, RF.lines_per_order(after1, keys),
                                 RF2_ROWS):
        _j_exec(sessions, sql, label, times)
    data = RF.apply_rf2(after1, keys)
    ins = [t for q, t in times.items() if q.startswith("insert")]
    dels = [t for q, t in times.items() if q.startswith("delete")]
    print(f"  {label}: RF1 {len(new['lineitem']['l_orderkey'])} lineitems "
          f"in {len(ins)} routed INSERTs (with orders'), p50 "
          f"{statistics.median(ins) * 1e3:.1f} ms; RF2 {len(keys)} orders "
          f"in {len(dels)} DELETEs, p50 "
          f"{statistics.median(dels) * 1e3:.1f} ms")
    # 2. an UPDATE moving p0's last 2,000 keys into p1, then a new
    # l_shipmode value into p0, read through LIKE and IN from the others
    lo = step - 2000
    sql = (f"UPDATE lineitem SET l_orderkey = l_orderkey + {step} "
           f"WHERE l_orderkey >= {lo} AND l_orderkey < {step}")
    out = _j_exec(sessions, sql, label, times)
    li = _j_with_keys(data["lineitem"], lo, step, step)
    print(f"  {label}: {sql} moved {out[0]} rows p0 -> p1 in "
          f"{times[sql] * 1e3:.1f} ms")
    row = {c: RF._take(v, np.arange(len(v[1] if isinstance(v, tuple)
                                         else v)) == 0)
           for c, v in li.items()}
    row["l_shipmode"] = ([HOVERCRAFT], np.zeros(1, np.int64))
    sql = RF.insert_statements("lineitem", row)[0]
    _j_exec(sessions, sql, label, times)
    row["l_shipmode"] = RF._take(li["l_shipmode"],
                                 np.arange(len(li["l_orderkey"])) == 0)
    data = dict(data, lineitem={c: RF._concat(li[c], row[c]) for c in li})
    vocab, codes = li["l_shipmode"]
    k = li["l_orderkey"]
    others = k >= step  # every partition but p0, which took the new value
    checks = [
        (f"SELECT count(*) FROM lineitem WHERE l_shipmode LIKE 'HOV%'",
         [(1,)]),
        (f"SELECT count(*) FROM lineitem WHERE l_shipmode LIKE '%AIL' "
         f"AND l_orderkey >= {step}",
         [(int(np.isin(codes[others], [vocab.index("MAIL"),
                                      vocab.index("RAIL")]).sum()),)]),
        (f"SELECT l_shipmode, count(*) FROM lineitem WHERE l_shipmode IN "
         f"('{HOVERCRAFT}', 'MAIL', 'SHIP') AND l_orderkey >= {step} "
         f"GROUP BY l_shipmode",
         [(m, int((codes[others] == vocab.index(m)).sum()))
          for m in ("MAIL", "SHIP")]),
    ]
    for sql, want in checks:
        tags, n, timing = _j_read(sessions, label, sql, want, warm=0)
        launched += n
        print(f"  {label}: {sql[:64]}... = {want} exact engines={tags} "
              f"{timing}")
    # after the DML Q6 only (Q1 and Q18 over partitions are root-bound,
    # ~8 s a pair on each session: read after the partition DDL only,
    # since part l)
    launched += _j_reads(sessions, f"{label} after the DML", data, ("q6",))
    # 3. TRUNCATE PARTITION p2, DROP PARTITION p1: device memory around
    # each (the card session's client frees the partition's tensors)
    for sql, a, b in (("ALTER TABLE lineitem TRUNCATE PARTITION p2",
                       2 * step, 3 * step),
                      ("ALTER TABLE lineitem DROP PARTITION p1",
                       step, 2 * step)):
        _sync()
        m0 = torch.cuda.memory_allocated()
        _j_exec(sessions, sql, label, times)
        m1 = torch.cuda.memory_allocated()
        k = data["lineitem"]["l_orderkey"]
        keep = (k < a) | (k >= b)
        data = dict(data, lineitem={c: RF._take(v, keep)
                                    for c, v in data["lineitem"].items()})
        print(f"  {label}: {sql} {times[sql] * 1e3:.1f} ms; device memory "
              f"{m0 / 1e9:.3f} -> {m1 / 1e9:.3f} GB")
    for sql in ("SELECT partition_name, partition_method, "
                "partition_description, table_rows FROM "
                "information_schema.partitions WHERE table_name = "
                "'lineitem' ORDER BY partition_ordinal_position",
                "SHOW TABLE STATUS LIKE 'lineitem'",
                "CHECKSUM TABLE lineitem", "ADMIN CHECK TABLE lineitem"):
        out = _j_exec(sessions, sql, label, times)
        print(f"  {label}: {sql[:48]} {times[sql] * 1e3:.1f} ms -> "
              f"{str(out[1])[:160]}")
    rows = sum(r[3] for r in _i_outcome(card, "SELECT partition_name, "
               "partition_method, partition_description, table_rows FROM "
               "information_schema.partitions WHERE table_name = "
               "'lineitem'")[1])
    if rows != len(data["lineitem"]["l_orderkey"]):
        raise SystemExit(f"{label}: information_schema counts {rows} rows")
    launched += _j_reads(sessions, f"{label} after TRUNCATE/DROP", data)
    print(f"  {label}: card == CPU on every statement; streamseg launches "
          f"{launched}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return launched


J3_CHILD = """
import json
import sys
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage
path, stmts = sys.argv[1], json.load(open(sys.argv[2]))
st = Storage(path, sync_log="commit")
s = Session(st, device="cpu")  # writes only: no coprocessor on the card
for i, sql in enumerate(stmts):
    print(f"ACK={i} {s.execute(sql).affected}", flush=True)
st.checkpoint()
print("DONE", flush=True)
"""


def _part_j3(args, tmp: str, d1) -> int:
    """Part j3 (module docstring), in part h's temporary directory. ->
    streamseg's launches."""
    import os

    from tidb_tpu_torch.store.storage import Storage

    label = "j3"
    path = f"{tmp}/pj"
    li = d1["lineitem"]
    shift = int(li["l_orderkey"].max()) + 1
    # ~40 rows an INSERT: the child's time is the SQL path's, row by row
    width = 40
    t0 = time.perf_counter()
    st = Storage(path, sync_log="commit")
    s = Session(st)
    counts = TD.load_table_partitioned(s, "lineitem", li, J1_BY)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    st.close()
    t_close = time.perf_counter() - t0
    print(f"  {label}: Storage(sync_log='commit'), lineitem SF"
          f"{args.q18_sf:g} ({J1_BY}: {counts} rows) bulk-loaded with its "
          f"epoch files in {t_load:.2f}s, clean close {t_close:.2f}s")
    mtimes = {f: os.stat(f"{path}/epochs/{f}").st_mtime_ns
              for f in os.listdir(f"{path}/epochs")}
    # 10 INSERTs, each of the rows of `width` order keys with the keys
    # moved past every key there is: strings every partition knows
    # (after a reopen the partitions no longer share dictionaries,
    # ROADMAP queue 3)
    k = li["l_orderkey"]
    stmts = []
    for i in range(10):
        m = (k >= i * width) & (k < (i + 1) * width)
        rows = {c: RF._take(v, m) for c, v in li.items()}
        rows["l_orderkey"] = rows["l_orderkey"] + shift
        stmts += RF.insert_statements("lineitem", rows, batch=len(k))
    with open(f"{tmp}/pj-inserts.json", "w") as f:
        json.dump(stmts, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               TIDB_TPU_FAILPOINTS="storage/mid-checkpoint=exit(9)@2")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", J3_CHILD, path,
                           f"{tmp}/pj-inserts.json"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    t_child = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    acked = [tuple(map(int, ln[4:].split())) for ln in lines
             if ln.startswith("ACK=")]
    if proc.returncode != 9 or "DONE" in lines or len(acked) != 10:
        raise SystemExit(f"{label}: the child exited {proc.returncode} "
                         f"after {len(acked)} INSERTs (want 9 at the "
                         f"checkpoint after 10): {proc.stderr[-2000:]}")
    rewritten = [f for f, t in mtimes.items()
                 if os.stat(f"{path}/epochs/{f}").st_mtime_ns != t]
    if len(rewritten) != 2:
        raise SystemExit(f"{label}: the checkpoint rewrote {rewritten}, "
                         f"not 2 of the 4 partitions' epoch files")
    print(f"  {label}: a child python3 ran 10 routed INSERTs "
          f"({sum(n for _, n in acked)} rows acknowledged), then "
          f"checkpoint(), and died at `storage/mid-checkpoint` hit 2 of 4 "
          f"(exit 9) in {t_child:.2f}s")
    t0 = time.perf_counter()
    st = Storage(path, sync_log="commit")
    t_open = time.perf_counter() - t0
    s = Session(st)
    _kernels.reset_launches()
    # every acknowledged INSERT is back, window by window
    for i, n in acked:
        got = s.query(f"select count(*) from lineitem where l_orderkey >= "
                      f"{shift + i * width} and l_orderkey < "
                      f"{shift + (i + 1) * width}")
        want = int(((k >= i * width) & (k < (i + 1) * width)).sum())
        if got != [(n,)] or n != want:
            raise SystemExit(f"{label}: INSERT {i} acknowledged {n} rows "
                             f"(want {want}); read back {got}")
    # the next INSERT takes a handle above every partition's handles
    part = st.catalog.table("test", "lineitem").partition
    stores = [st.table_store(d.id) for d in part.defs]
    top = max(max([int(stores[j].epoch.handles.max(initial=0))]
                  + [h for _, h, _ in stores[j].deltas])
              for j in range(len(stores)))
    cols = ", ".join(c.name for c in st.catalog.table("test",
                                                      "lineitem").columns)
    sel = cols.replace("l_orderkey", f"l_orderkey + {2 * shift}", 1)
    s.execute(f"insert into lineitem select {sel} from lineitem "
              f"where l_orderkey = {int(k[0])}")
    fresh = [h for ps in stores for _, h, _ in ps.deltas if h > top]
    if len(fresh) != int((k == k[0]).sum()):
        raise SystemExit(f"{label}: the INSERT after the reopen took "
                         f"handles {fresh}, not above {top}")
    extra = {c: RF._take(v, (k >= 0) & (k < 10 * width))
             for c, v in li.items()}
    extra2 = {c: RF._take(v, k == k[0]) for c, v in li.items()}
    data = RF.apply_rf1(RF.apply_rf1({"lineitem": li},
                                     {"lineitem": extra}),
                        {"lineitem": extra2})
    tags, launched, timing = _j_read([s], label, TPCH_QUERIES["q6"],
                                     TR.sql_oracle("q6", data),
                                     want_tags=["device"] * len(stores))
    print(f"  {label}: reopened in {t_open:.2f}s from the 4 epoch files "
          f"({len(rewritten)} rewritten by the checkpoint) and the WAL; every "
          f"acknowledged INSERT read back; the next INSERT took handles "
          f"{min(fresh)}..{max(fresh)} above {top}; Q6 exact engines="
          f"{tags} {timing}")
    st.close()
    return _kernels.LAUNCHES[RANK]


# ---- part k: the function registry, the session functions, accounts ----
# k1's reads on f2's sessions after i2 (card == CPU): lineitem and orders
# as g1' left them (i2 changed only l_quantity's type, to DECIMAL(18,4),
# and dropped the column it added), part as f2 loaded it. The reference
# keeps a WHERE with a registry call wholly in the root Selection (so
# SOUNDEX filters a derived table whose own filter is pushed), and
# evaluates a registry projection over every row the scan returns,
# before the root's Sort and Limit: each read's pushed filter bounds the
# rows the registry sees (~2% of lineitem for SOUNDEX, one month of
# shipdates, ~1/84, for DATE_FORMAT, the first ~250 orders and 500
# parts), and the root's grouping of SUBSTRING_INDEX's keys is cut to
# 1992's shipdates (~1/7), for part k's 60 s
K1_READS = (
    ("substring_index",
     "SELECT substring_index(l_shipmode, 'A', 1) AS k, count(*) "
     "FROM lineitem WHERE l_shipdate < '1993-01-01' GROUP BY k "
     "ORDER BY k"),
    ("soundex",
     "SELECT count(*) FROM (SELECT l_shipmode FROM lineitem "
     "WHERE l_quantity < 2) t WHERE soundex(l_shipmode) = 'M400'"),
    ("date_format",
     "SELECT date_format(l_shipdate, '%Y-%m') AS m, sum(l_quantity), "
     "count(*) FROM lineitem WHERE l_shipdate >= '1994-03-01' "
     "AND l_shipdate < '1994-04-01' GROUP BY m ORDER BY m"),
    ("sha2",
     "SELECT o_orderkey, sha2(o_comment, 256) FROM orders "
     "WHERE o_orderkey < 1000 ORDER BY o_orderkey LIMIT 100"),
    ("part",
     "SELECT p_partkey, regexp_like(p_name, '^forest'), "
     "conv(p_partkey, 10, 36), hex(p_name), format(p_retailprice, 1) "
     "FROM part WHERE p_partkey <= 500 ORDER BY p_partkey LIMIT 100"),
)
K1_JSON_ROWS = 500
K1_Q1 = TPCH_QUERIES["q1"].replace(
    "count(*) as count_order",
    "count(*) as count_order, "
    "date_format(max(l_shipdate), '%W %M %Y') as last_ship")
K_TZ_READ = ("SELECT o_orderkey, from_unixtime(o_orderkey) FROM orders "
             "WHERE o_orderkey < 1000 ORDER BY o_orderkey LIMIT 100")
K3_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")


def _k_row_evals() -> dict:
    from tidb_tpu_torch import obs
    return {dict(k).get("func"): v
            for k, v in obs.REGISTRY_ROW_EVALS.samples()}


def _k_delta(before: dict) -> dict:
    return {f: int(v - before.get(f, 0))
            for f, v in _k_row_evals().items() if v != before.get(f, 0)}


def _k_read(card, cpu, label: str, sql: str, times: dict,
            want=None) -> list:
    """`sql` on the card session (cold, then M_CUT_WARM_RUNS warm runs)
    and on the CPU
    session: outcome and tags equal, and the rows `want` where given;
    the registry's row-wise count of the card's cold run and of the CPU
    run must be equal. -> the card's rows as cells."""
    before = _k_row_evals()
    t0 = time.perf_counter()
    out = _i_outcome(card, sql)
    _sync()
    first = time.perf_counter() - t0
    rows_card = _k_delta(before)
    tags = list(card.last_engines)
    before = _k_row_evals()
    got = _i_outcome(cpu, sql)
    rows_cpu = _k_delta(before)
    if got != out or cpu.last_engines != tags:
        raise SystemExit(f"{label}: {sql[:60]!r} on the CPU {str(got)[:200]}"
                         f" {cpu.last_engines}, on the card "
                         f"{str(out)[:200]} {tags}")
    if out[0] == "error":
        raise SystemExit(f"{label}: {sql[:60]!r}: {out}")
    if rows_card != rows_cpu:
        raise SystemExit(f"{label}: {sql[:60]!r}: registry row-wise calls "
                         f"{rows_card} on the card, {rows_cpu} on the CPU")
    if want is not None and out[1] != want:
        raise SystemExit(f"{label}: {sql[:60]!r}: rows differ from the "
                         f"oracle: {str(out[1])[:200]} vs {str(want)[:200]}")
    warm = [_sql_run(card, sql)[1] for _ in range(M_CUT_WARM_RUNS)]
    times[label] = first
    print(f"  {label}: engines={tags} rows={len(out[1])} card==cpu"
          f"{' exact' if want is not None else ''} row_evals={rows_card} "
          f"{_timing(first, warm)}")
    return out[1]


def _k_substring_index_oracle(li) -> list:
    import datetime as dt
    from tidb_tpu_torch.copr.funcs import REGISTRY
    vocab, codes = li["l_shipmode"]
    keep = li["l_shipdate"] < (dt.date(1993, 1, 1) - dt.date(1970, 1, 1)).days
    counts = np.bincount(codes[keep], minlength=len(vocab))
    groups: dict = {}
    for v, n in zip(vocab, counts.tolist()):
        if n:
            k = REGISTRY["SUBSTRING_INDEX"].fn(v, "A", 1)
            groups[k] = groups.get(k, 0) + n
    return sorted(groups.items())


def _k_q1_oracle(li, qty_scale: int) -> list:
    """TPC-H Q1's oracle rows (`TR.sql_oracle`) with l_quantity at
    `qty_scale` (i2 widened it to 4: sum_qty's scale follows, avg_qty's
    is the scale plus 4) and the last shipdate of each group, formatted
    '%W %M %Y'."""
    import datetime as dt
    rows = TR.sql_oracle("q1", {"lineitem": li})
    m = li["l_shipdate"] <= (dt.date(1998, 9, 2)
                             - dt.date(1970, 1, 1)).days
    rf_vocab, rf = li["l_returnflag"]
    ls_vocab, ls = li["l_linestatus"]
    out = []
    for r in rows:
        g = m & (rf == rf_vocab.index(r[0])) & (ls == ls_vocab.index(r[1]))
        last = dt.date(1970, 1, 1) + dt.timedelta(
            days=int(li["l_shipdate"][g].max()))
        r = list(r)
        if qty_scale != 2:
            u = r[2][1] * 10 ** (qty_scale - 2)
            r[2] = ("dec", u, qty_scale)
            r[6] = ("dec", TR._div_round(u * 10 ** 4, r[9]), qty_scale + 4)
        out.append(tuple(r) + (last.strftime("%A %B %Y"),))
    return out


def _part_k1(card, cpu, data, times: dict) -> None:
    li = data["lineitem"]
    want = {"substring_index": TR.sql_cells(_k_substring_index_oracle(li))}
    for name, sql in K1_READS:
        _k_read(card, cpu, f"k1 {name}", sql, times, want.get(name))
    nv = np.random.default_rng(7).integers(0, 7, K1_JSON_ROWS)
    vals = ", ".join(
        f"({i}, '{{\"a\": {i}, \"n\": {{\"v\": {int(v)}}}, "
        f"\"tags\": [\"t{int(v)}\", \"x\"]}}')"
        for i, v in enumerate(nv))
    for sql in ("CREATE TABLE k_json (id INT PRIMARY KEY, doc JSON)",
                f"INSERT INTO k_json VALUES {vals}"):
        _i_exec([card, cpu], sql, "k1 json", times)
    n3 = int((nv == 3).sum())
    _k_read(card, cpu, "k1 json_contains",
            "SELECT count(*) FROM k_json WHERE "
            "json_contains(doc, '3', '$.n.v') = 1", times, [(n3,)])
    _k_read(card, cpu, "k1 json_extract",
            "SELECT id, json_extract(doc, '$.tags[0]'), "
            "json_extract(doc, '$.n') FROM k_json ORDER BY id LIMIT 100",
            times)
    _i_exec([card, cpu], "DROP TABLE k_json", "k1 json", times)
    zones = {}
    for tz in ("+00:00", "+08:00"):
        _i_exec([card, cpu], f"SET time_zone = '{tz}'", "k1 tz", times)
        zones[tz] = _k_read(card, cpu, f"k1 from_unixtime {tz}", K_TZ_READ,
                            times)
    _i_exec([card, cpu], "SET time_zone = 'SYSTEM'", "k1 tz", times)
    import datetime as dt
    for (k, a), (_, b) in zip(zones["+00:00"], zones["+08:00"]):
        ta = dt.datetime.strptime(a, "%Y-%m-%d %H:%M:%S")
        tb = dt.datetime.strptime(b, "%Y-%m-%d %H:%M:%S")
        if ta != dt.datetime(1970, 1, 1) + dt.timedelta(seconds=k) or \
                tb - ta != dt.timedelta(hours=8):
            raise SystemExit(f"k1: from_unixtime({k}) is {a} at +00:00 and "
                             f"{b} at +08:00")
    qty, = [c for c in card.catalog.table("test", "lineitem").columns
            if c.name == "l_quantity"]
    _k_read(card, cpu, "k1 q1+date_format", K1_Q1, times,
            TR.sql_cells(_k_q1_oracle(li, qty.ftype.scale)))


def _part_k2(card, data, mc, server) -> None:
    """User locks on two card sessions over `card`'s storage, then SLEEP
    over the wire ended by KILL QUERY from a second connection."""
    a, b = Session(card.storage), Session(card.storage)
    steps = [(a, "SELECT get_lock('k', 0)", [(1,)]),
             (b, "SELECT get_lock('k', 0)", [(0,)]),
             (b, "SELECT is_free_lock('k')", [(0,)]),
             (a, "SELECT release_all_locks()", [(1,)]),
             (b, "SELECT get_lock('k', 0)", [(1,)]),
             (b, "SELECT release_all_locks()", [(1,)])]
    for s, sql, want in steps:
        got = s.query(sql)
        if got != want:
            raise SystemExit(f"k2: {sql} gave {got}, want {want}")
    print("  k2: GET_LOCK('k', 0) held by one card session, refused to the "
          "other (0), freed by RELEASE_ALL_LOCKS(), then taken by it")
    addr = ("127.0.0.1", server.port)
    ca, cb = mc.MiniClient(*addr), mc.MiniClient(*addr)
    ida = int(ca.query("SELECT connection_id()")[0][0])
    box: dict = {}

    def sleeper():
        t0 = time.perf_counter()
        try:
            box["rows"] = ca.query("SELECT SLEEP(20)")
        except mc.MySQLError as e:
            box["err"] = e.code
        box["s"] = time.perf_counter() - t0

    th = threading.Thread(target=sleeper)
    th.start()
    time.sleep(0.5)
    t_kill = time.perf_counter()
    cb.execute(f"KILL QUERY {ida}")
    th.join(timeout=10.0)
    ended = time.perf_counter() - t_kill
    if th.is_alive() or box.get("err") != 1317 or ended > 2.0:
        raise SystemExit(f"k2: SLEEP(20) after KILL QUERY: {box}, ended "
                         f"{ended:.2f}s after the KILL")
    want = _wire_text(card.query(TPCH_QUERIES["q6"]))
    if TR.sql_cells(card.query(TPCH_QUERIES["q6"])) != \
            TR.sql_oracle("q6", data) or ca.query(TPCH_QUERIES["q6"]) != want:
        raise SystemExit("k2: Q6 on the killed connection is not exact")
    print(f"  k2: SELECT SLEEP(20) over the wire ended by KILL QUERY from a "
          f"second connection: errno {box['err']} {ended * 1e3:.1f} ms "
          f"after the KILL ({box['s']:.2f}s in all); its next Q6 exact, "
          f"engines {server._conns[ida].session.last_engines}")
    ca.close()
    cb.close()


def _part_k3(card, data, mc, server) -> None:
    """A non-root user over the wire: column grants, a role, refusals."""
    addr = ("127.0.0.1", server.port)
    root = mc.MiniClient(*addr)
    for sql in ("CREATE USER 'k3' IDENTIFIED BY 'k3pw'",
                f"GRANT SELECT ({', '.join(K3_COLUMNS)}) ON lineitem TO "
                "'k3'",
                "CREATE ROLE 'k3_orders'",
                "GRANT SELECT ON test.orders TO 'k3_orders'",
                "GRANT 'k3_orders' TO 'k3'"):
        root.execute(sql)
    k3 = mc.MiniClient(*addr, user="k3", password="k3pw")

    def refused(sql: str) -> tuple:
        try:
            k3.query(sql)
        except mc.MySQLError as e:
            return e.code, str(e)
        raise SystemExit(f"k3: {sql!r} was not refused")

    t0 = time.perf_counter()
    q6 = k3.query(TPCH_QUERIES["q6"])
    t_q6 = time.perf_counter() - t0
    if q6 != _wire_text(card.query(TPCH_QUERIES["q6"])) or \
            TR.sql_cells(card.query(TPCH_QUERIES["q6"])) != \
            TR.sql_oracle("q6", data):
        raise SystemExit("k3: Q6 as k3 is not exact")
    tags = _server_tags(server)
    col = refused("SELECT l_comment FROM lineitem LIMIT 1")
    tab = refused("SELECT count(*) FROM orders")
    k3.execute("SET ROLE 'k3_orders'")
    n_orders = int(k3.query("SELECT count(*) FROM orders")[0][0])
    upd = refused("UPDATE lineitem SET l_quantity = 1 WHERE l_orderkey = 1")
    # the reference types a column refusal as 1142 (MySQL: 1143)
    if col[0] != 1142 or "l_comment" not in col[1] or tab[0] != 1142 or \
            upd[0] != 1142 or n_orders != len(data["orders"]["o_orderkey"]):
        raise SystemExit(f"k3: l_comment {col}, orders {tab}, UPDATE {upd}, "
                         f"orders after SET ROLE {n_orders}")
    k3.close()
    for sql in ("DROP USER 'k3'", "DROP ROLE 'k3_orders'"):
        root.execute(sql)
    root.close()
    print(f"  k3: as 'k3' over the wire: Q6 exact {t_q6 * 1e3:.1f} ms "
          f"engines {tags}; l_comment refused {col[0]}, orders refused "
          f"{tab[0]}, after SET ROLE orders read ({n_orders} rows), UPDATE "
          f"refused {upd[0]}; user and role dropped")


def _part_k(card, cpu, data) -> int:
    """Part k (module docstring) on f2's sessions after i2. -> streamseg's
    launches during the part."""
    t0 = time.perf_counter()
    _kernels.reset_launches()
    times: dict = {}
    before = _k_row_evals()
    _part_k1(card, cpu, data, times)
    print(f"  k1: registry row-wise calls by function (card and CPU): "
          f"{_k_delta(before)}")
    from tidb_tpu_torch.server import Server
    mc = _mini_client_module()
    server = Server(card.storage, port=0)
    server.start()
    try:
        _part_k2(card, data, mc, server)
        _part_k3(card, data, mc, server)
    finally:
        server.close()
        # the server started the store's metrics-history sampler; this
        # in-memory store is never closed, so stop it here
        card.storage.metrics_history.stop()
    launched = _kernels.LAUNCHES[RANK]
    print(f"  k: streamseg launches {launched} (an fx: op has no device "
          f"lowering: its requests are projected scans); part k took "
          f"{time.perf_counter() - t0:.1f}s")
    return launched


# ---- part l: the statement plane (EXPLAIN ANALYZE, TRACE, plan cache,
# bindings, digests, the slow log, INTO OUTFILE / LOAD DATA, deadlines) ----
L1_QUERIES = ("q6", "q3", "q5")
L2_EXPLAIN = ("q1", "q3", "q18")
# l2's point reads: 500 seeded o_orderkey lookups over 200 keys
L2_POINTS, L2_POINT_KEYS = 500, 200
# a join hint through a SESSION binding on Q3, and on a two-table join
# whose plan the hint does change (the fragment planner takes lineitem as
# Q3's probe whatever the order asked for, in both packages)
L2_LEADING = "LEADING(orders, customer, lineitem)"
L2_JOIN2 = ("select count(*) from supplier, nation "
            "where s_nationkey = n_nationkey")
L2_JOIN2_HINT = "LEADING(nation, supplier)"
# one week of orders for INTO OUTFILE / LOAD DATA: ~4,400 rows at SF1,
# under 8,192 (a commit of N >= 8,192 mutations costs the reference's
# commit path N^2 delta visits)
L2_WEEK = ("o_orderdate >= date '1995-03-01' "
           "and o_orderdate < date '1995-03-08'")
L2_COPY_READ = ("select count(*), sum(o_totalprice), min(o_orderdate), "
                "max(o_custkey), sum(o_shippriority) from {t}")


def _l_stages(cell: str) -> dict:
    """'staging:0.12ms kernel:1.5ms' -> {stage: ms}."""
    out = {}
    for part in (cell or "").split():
        k, _, v = part.partition(":")
        out[k] = float(v.removesuffix("ms"))
    return out


_EST = re.compile(r" est=\d+")


def _l_plan(line: str) -> str:
    """A plan line without its row estimate: l2's card and CPU sessions
    auto-analyze at different statements since f2 (the card's timed runs
    are its own), so their estimates may differ; the CPU tests hold
    EXPLAIN text with estimates to the reference."""
    return _EST.sub("", line)


def _l_untimed(rows) -> list:
    """EXPLAIN ANALYZE rows without their times and estimates: plan,
    actRows, engine."""
    return [(_l_plan(r[0]), r[1], r[3]) for r in rows]


def _l_hinted(sql: str, hint: str) -> str:
    return re.sub(r"(?i)^\s*select", f"select /*+ {hint} */", sql, count=1)


def _part_l1(s, nrows: dict, tags: dict) -> int:
    """Part l1 (module docstring) on f1's SF10 session. -> streamseg's
    launches under EXPLAIN ANALYZE."""
    t0 = time.perf_counter()
    _kernels.reset_launches()
    for q in L1_QUERIES:
        before = _kernels.LAUNCHES[RANK]
        rows = s.query("explain analyze " + TPCH_QUERIES[q])
        _sync()
        launched = _kernels.LAUNCHES[RANK] - before
        want = tags[F1_REQUESTS[q]]
        if rows[0][1] != nrows[q]:
            raise SystemExit(f"l1 {q}: root actRows {rows[0][1]}, f1 "
                             f"returned {nrows[q]} rows")
        leaves = [r for r in rows if r[3]]
        if [r[3] for r in leaves] != [want]:
            raise SystemExit(f"l1 {q}: leaf engines "
                             f"{[r[3] for r in leaves]}, f1's tag {want!r}")
        for r in leaves:
            st = _l_stages(r[4])
            # the cells print each stage to 3 significant digits and the
            # time to 0.01 ms: the sum may pass time_ms by that rounding
            if r[3].startswith("device") and not \
                    {"kernel", "device_get"} <= set(st):
                raise SystemExit(f"l1 {q}: device leaf stages {r[4]!r}")
            if sum(st.values()) > r[2] * 1.005 + 0.01:
                raise SystemExit(f"l1 {q}: stages {r[4]!r} sum past the "
                                 f"leaf's {r[2]} ms")
        if q == "q3" and launched == 0:
            raise SystemExit("l1 q3: EXPLAIN ANALYZE did not launch "
                             "kernel streamseg.rank_sums")
        print(f"  l1 EXPLAIN ANALYZE {q.upper()}: root actRows="
              f"{rows[0][1]} (f1's rows) leaf engine={want} "
              f"streamseg_launches={launched}")
        for r in rows:
            print(f"    {r[2]} ms | {r[0].strip()[:90]} | actRows={r[1]} "
                  f"| {r[3]} | {r[4]}")
    launches = _kernels.LAUNCHES[RANK]
    rows = s.query("trace " + TPCH_QUERIES["q6"])
    ops = [r[0].strip() for r in rows]
    for want in (("copr.execute", "copr.fragment"), ("device.dispatch",),
                 ("device.fetch",)):
        if not any(o.startswith(want) for o in ops):
            raise SystemExit(f"l1: TRACE of Q6 lacks {want}: {ops}")
    print("  l1 TRACE Q6 (start ms, duration ms):")
    for r in rows:
        print(f"    {r[1]} {r[2]} {r[0]}")
    print(f"  l1 took {time.perf_counter() - t0:.1f}s")
    return launches


def _l_both(card, cpu, sql: str, label: str):
    """`sql` on both sessions: outcome and tags equal. -> the card's
    outcome."""
    out = _i_outcome(card, sql)
    got = _i_outcome(cpu, sql)
    if got != out or cpu.last_engines != card.last_engines:
        raise SystemExit(f"{label}: {sql[:70]!r} card {str(out)[:200]} "
                         f"{card.last_engines}, CPU {str(got)[:200]} "
                         f"{cpu.last_engines}")
    return out


def _l_counts(s) -> tuple:
    o = s.storage.obs
    return (o.plan_cache_hits.get(), o.plan_cache_misses.get(),
            o.plan_cache_evictions.get())


def _part_l2(card, cpu, data, tmp: str) -> int:
    """Part l2 (module docstring) on f2's SF1 sessions after part k. ->
    streamseg's launches during it."""
    import os

    t0 = time.perf_counter()
    _kernels.reset_launches()
    sessions = (card, cpu)
    # no auto-analyze during l2: it bumps the statistics generation the
    # plan-cache entries are stamped with, at statements that differ
    # between the two sessions (their statement counts differ since f2)
    # and a table that was written but has no statistics (i2's seq_t,
    # information_schema's stores, a table whose MODIFY dropped them)
    # would still be: run each store's pending auto-analyzes now, the
    # step a session takes every 64 statements
    pending = []
    for s in sessions:
        s.execute("set global tidb_auto_analyze_ratio = 1000000")
        pending.append(s.storage.stats.auto_analyze(s.storage, s.catalog))
    print(f"  l2: auto-analyze off for the part; pending auto-analyzes run "
          f"first: card {pending[0]}, CPU {pending[1]}")
    digests0 = [{e["digest"]: e["exec_count"]
                 for e in s.storage.obs.statements.snapshot()}
                for s in sessions]
    # 1. EXPLAIN ANALYZE: plan text, actRows and engines, times excluded
    for q in L2_EXPLAIN:
        sql = "explain analyze " + TPCH_QUERIES[q]
        got = [s.query(sql) for s in sessions]
        if _l_untimed(got[0]) != _l_untimed(got[1]):
            raise SystemExit(f"l2 EXPLAIN ANALYZE {q}: card "
                             f"{_l_untimed(got[0])} vs CPU "
                             f"{_l_untimed(got[1])}")
        leaf = [r[3] for r in got[0] if r[3]]
        print(f"  l2 EXPLAIN ANALYZE {q.upper()}: card == CPU (plan, "
              f"actRows {got[0][0][1]}, engines {leaf}); card root "
              f"{got[0][0][2]} ms, CPU {got[1][0][2]} ms")
    # 2. the plan cache: seeded point reads, then EXPLAIN ANALYZE's point
    # row (before any binding: a binding turns the point path off), on a
    # new session of each store: the plan cache is the session's, and
    # f2's two sessions hold different entries (the card's timed runs)
    pts = [Session(card.storage), Session(cpu.storage, device="cpu")]
    rng = np.random.default_rng(14)
    keys = rng.choice(data["orders"]["o_orderkey"], L2_POINT_KEYS,
                      replace=False)
    picks = rng.choice(keys, L2_POINTS)
    before = [_l_counts(s) for s in pts]
    t_pts = time.perf_counter()
    for k in picks:
        sql = f"select o_totalprice from orders where o_orderkey = {int(k)}"
        out = _l_both(*pts, sql, "l2 point")
        if pts[0].last_engines != ["point"] or len(out[1]) != 1:
            raise SystemExit(f"l2 point: {sql} {out} {pts[0].last_engines}")
    t_pts = time.perf_counter() - t_pts
    deltas = [tuple(b - a for a, b in zip(before[i], _l_counts(s)))
              for i, s in enumerate(pts)]
    if deltas[0] != deltas[1] or deltas[0][0] == 0:
        raise SystemExit(f"l2 plan cache: card (hits, misses, evictions) "
                         f"{deltas[0]}, CPU {deltas[1]}")
    sql = f"select o_totalprice from orders where o_orderkey = {int(picks[-1])}"
    pt = [s.query("explain analyze " + sql) for s in pts]
    if _l_untimed(pt[0]) != _l_untimed(pt[1]) or \
            pt[0][0][4] != "plan_cache:hit" or pt[1][0][4] != "plan_cache:hit":
        raise SystemExit(f"l2 EXPLAIN ANALYZE point: {pt}")
    print(f"  l2 plan cache: {L2_POINTS} point SELECTs over {L2_POINT_KEYS} "
          f"seeded orders keys on both sessions in {t_pts:.2f}s, (hits, "
          f"misses, evictions) {deltas[0]} on each; EXPLAIN ANALYZE point "
          f"row {pt[0][0][0]} {pt[0][0][4]} {pt[0][0][2]} ms")
    # 3. a SESSION binding with a join hint on Q3, and one on a two-table
    # join whose plan text the hint changes; a GLOBAL binding seen from a
    # second session
    def explain(sessions, sql):
        got = [[_l_plan(r[0]) for r in s.query("explain " + sql)]
               for s in sessions]
        if got[0] != got[1]:
            raise SystemExit(f"l2 EXPLAIN {sql[:60]!r}: {got}")
        return got[0]

    q3 = TPCH_QUERIES["q3"]
    for sql, hint in ((q3, L2_LEADING), (L2_JOIN2, L2_JOIN2_HINT)):
        base = explain(sessions, sql)
        _l_both(card, cpu, f"create session binding for {sql} using "
                f"{_l_hinted(sql, hint)}", "l2 binding")
        bound = explain(sessions, sql)
        rows = _l_both(card, cpu, sql, "l2 binding")
        used = _l_both(card, cpu, "select @@last_plan_from_binding",
                       "l2 binding")
        want = TR.sql_oracle("q3", data) if sql == q3 else \
            [(len(data["supplier"]["s_suppkey"]),)]
        if rows[1] != want or used[1] != [(1,)]:
            raise SystemExit(f"l2 binding {hint}: rows {rows[1]} (want "
                             f"{want}), @@last_plan_from_binding {used}")
        if sql == L2_JOIN2 and bound == base:
            raise SystemExit(f"l2 binding {hint}: the plan did not change")
        print(f"  l2 SESSION binding /*+ {hint} */ on "
              f"{' '.join(sql.split())[:40]!r}...: card == CPU, plan text "
              f"changed={bound != base}, rows exact, "
              f"@@last_plan_from_binding=1")
        _l_both(card, cpu, f"drop session binding for {sql}", "l2 binding")
    _l_both(card, cpu, f"create global binding for {L2_JOIN2} using "
            f"{_l_hinted(L2_JOIN2, L2_JOIN2_HINT)}", "l2 global binding")
    sibs = [Session(card.storage), Session(cpu.storage, device="cpu")]
    seen = explain(sibs, L2_JOIN2)
    _l_both(*sibs, L2_JOIN2, "l2 global binding")
    used = _l_both(*sibs, "select @@last_plan_from_binding",
                   "l2 global binding")
    if used[1] != [(1,)] or seen != bound:
        raise SystemExit(f"l2 GLOBAL binding: a second session read "
                         f"{used}, plan {seen}")
    _l_both(card, cpu, f"drop global binding for {L2_JOIN2}",
            "l2 global binding")
    print("  l2 GLOBAL binding: a second session of each store plans with "
          "it (@@last_plan_from_binding=1, the bound plan); dropped")
    # 4. the slow log with every statement logged: the card's Stages cell
    _l_both(card, cpu, "set tidb_slow_log_threshold = 0", "l2 slow log")
    q6 = _l_both(card, cpu, TPCH_QUERIES["q6"], "l2 slow log")
    _l_both(card, cpu, "set tidb_slow_log_threshold = 300", "l2 slow log")
    ent = [e for e in card.storage.obs.slow_queries()
           if e["sql"] == TPCH_QUERIES["q6"]][-1]
    if "kernel" not in ent["stages"] or len(ent["plan_digest"]) != 32:
        raise SystemExit(f"l2 slow log: {ent}")
    print(f"  l2 slow log (threshold 0): Q6 digest {ent['plan_digest']} "
          f"{ent['duration_ms']} ms stages {ent['stages']}")
    # 5. one week of orders INTO OUTFILE (byte-equal files), LOAD DATA into
    # an empty copy on each session, the copy read like the week
    week = (f"select * from orders where {L2_WEEK} order by o_orderkey "
            f"into outfile ")
    paths = [os.path.join(tmp, f"l2_week_{n}.tsv") for n in ("card", "cpu")]
    n_rows = []
    t_io = {}
    for s, path in zip(sessions, paths):
        t1 = time.perf_counter()
        n_rows.append(s.execute(f"{week}'{path}'").affected)
        t_io.setdefault("outfile", []).append(time.perf_counter() - t1)
    blobs = [open(p, "rb").read() for p in paths]
    if blobs[0] != blobs[1] or n_rows[0] != n_rows[1] or \
            not 0 < n_rows[0] < 8192:
        raise SystemExit(f"l2 INTO OUTFILE: rows {n_rows}, files equal "
                         f"{blobs[0] == blobs[1]}")
    ddl = TD.TPCH_DDL["orders"].replace("create table orders",
                                        "create table orders_w")
    for s, path in zip(sessions, paths):
        s.execute(ddl)
        t1 = time.perf_counter()
        loaded = s.execute(f"load data infile '{path}' into table "
                           f"orders_w").affected
        t_io.setdefault("load", []).append(time.perf_counter() - t1)
        if loaded != n_rows[0]:
            raise SystemExit(f"l2 LOAD DATA: {loaded} of {n_rows[0]} rows")
    copy = _l_both(card, cpu, L2_COPY_READ.format(t="orders_w"), "l2 copy")
    orig = _l_both(card, cpu, L2_COPY_READ.format(t=f"orders where "
                                                  f"{L2_WEEK}"), "l2 copy")
    if copy != orig:
        raise SystemExit(f"l2 LOAD DATA: copy {copy} vs orders {orig}")
    print(f"  l2 INTO OUTFILE: {n_rows[0]} orders of one week, {len(blobs[0])}"
          f" bytes, card == CPU byte for byte (card {t_io['outfile'][0]:.2f}"
          f"s, CPU {t_io['outfile'][1]:.2f}s); LOAD DATA into an empty copy "
          f"on each (card {t_io['load'][0]:.2f}s, CPU {t_io['load'][1]:.2f}"
          f"s), the copy's read equal to the week's: {copy[1]}")
    # 6. TRACE of a 100-row INSERT: the 2PC phases, span names equal
    base = int(data["orders"]["o_orderkey"].max()) + 10_000_000
    values = ", ".join(f"({base + i}, 1, 'O', 1.00, date '1998-01-01', "
                       f"'1-URGENT', 'Clerk#1', 0, 'l2')" for i in range(100))
    names = [[r[0] for r in s.query(f"trace insert into orders_w values "
                                     f"{values}")] for s in sessions]
    if names[0] != names[1] or not all(
            any(n.strip().startswith(w) for n in names[0])
            for w in ("twopc.prewrite", "twopc.commit")):
        raise SystemExit(f"l2 TRACE INSERT: card {names[0]}, CPU {names[1]}")
    spans = {}
    for n in names[0]:
        spans[n.strip()] = spans.get(n.strip(), 0) + 1
    print(f"  l2 TRACE of a 100-row INSERT: card == CPU, spans (count) "
          f"{spans}")
    # 7. @@max_execution_time: SLEEP ends with 3024 within 1 s, and the
    # next Q6 under the same limit is exact
    ended = []
    for s in sessions:
        s.execute("set max_execution_time = 100")
        t1 = time.perf_counter()
        out = _i_outcome(s, "select sleep(5)")
        ended.append(time.perf_counter() - t1)
        if out[:2] != ("error", 3024) or ended[-1] > 1.0:
            raise SystemExit(f"l2 max_execution_time: {out} after "
                             f"{ended[-1]:.2f}s")
    after = card.query(TPCH_QUERIES["q6"])
    for s in sessions:
        s.execute("set max_execution_time = 0")
    # (the CPU session's Q6 after its limit is off: it may take longer
    # than 100 ms there)
    if TR.sql_cells(after) != TR.sql_oracle("q6", data) or \
            q6[1] != TR.sql_cells(after) or \
            TR.sql_cells(cpu.query(TPCH_QUERIES["q6"])) != q6[1]:
        raise SystemExit("l2 max_execution_time: the next Q6 is not exact")
    print(f"  l2 max_execution_time = 100: SELECT SLEEP(5) raised 3024 "
          f"after {ended[0] * 1e3:.1f} ms (card), {ended[1] * 1e3:.1f} ms "
          f"(CPU); the card's next Q6 exact")
    for s in sessions:
        s.execute("drop table orders_w")
        s.execute("set global tidb_auto_analyze_ratio = 0.5")
    # 8. statements_summary: the same digests and exec counts over l2
    deltas = []
    for s, d0 in zip(sessions, digests0):
        deltas.append({e["digest"]: e["exec_count"] - d0.get(e["digest"], 0)
                       for e in s.storage.obs.statements.snapshot()
                       if e["exec_count"] != d0.get(e["digest"], 0)})
    if deltas[0] != deltas[1]:
        raise SystemExit(f"l2 statements_summary: card {len(deltas[0])} "
                         f"digests, CPU {len(deltas[1])}")
    print(f"  l2 statements_summary: {len(deltas[0])} digests with equal "
          f"exec counts on both ({sum(deltas[0].values())} executions)")
    launched = _kernels.LAUNCHES[RANK]
    print(f"  l2: card == CPU on every check; streamseg launches "
          f"{launched}; l2 took {time.perf_counter() - t0:.1f}s")
    return launched


# ---- part m: the observability planes and the governor (process
# counters, Top SQL, the wait profile, the event log, metrics_schema, the
# workload history, inspection, the profiler, the governor and the gate) ----
M1_QUERIES = ("q6", "q3", "q5")
M1_AB_PAIRS = 6
M2_QUERIES = ("q1", "q3", "q18")
M_PLANE_THREADS = ("titpu-metrics-history", "titpu-profiler")


def _m_engine_class(tag: str) -> str:
    """The `tidb_copr_requests_total` engine label a leaf's tag counts
    under: a fragment leaf (`device[...]`) under device-fragment, a
    CopDAG leaf under device, the host tiers under theirs."""
    if tag.startswith("device["):
        return "device-fragment"
    if tag.startswith("host(fragment:"):
        return "host-fragment"
    if tag.startswith("host("):
        return "host"
    return tag


def _m_requests() -> dict:
    return {dict(k)["engine"]: v for k, v in obs.COPR_REQUESTS.samples()}


def _m_planes(s, on: bool) -> None:
    """Top SQL and the wait profile on (their rings emptied first) or
    off."""
    o = s.storage.obs
    if on:
        o.topsql.clear()
        o.waitprofile.clear()
    o.topsql.configure(enabled=on, window_s=3600)
    o.waitprofile.configure(enabled=on, window_s=3600)


def _m_top(s, digests: dict) -> dict:
    """digest -> (exec count, device seconds, wall seconds) over every
    Top SQL window, for the statements of `digests`."""
    out = {}
    for b in s.storage.obs.topsql.snapshot():
        for e in b["digests"].values():
            if e["digest"] not in digests:
                continue
            n, dev, wall = out.get(e["digest"], (0, 0.0, 0.0))
            out[e["digest"]] = (
                n + e["exec_count"],
                dev + e["stages"].get("kernel", 0.0)
                + e["stages"].get("device_get", 0.0),
                wall + e["sum_wall_s"])
    return out


def _part_m1(s, tags: dict) -> int:
    """Part m1 (module docstring) on f1's SF10 session after l1. ->
    streamseg's launches during it."""
    t0 = time.perf_counter()
    _kernels.reset_launches()
    q6 = TPCH_QUERIES["q6"]
    runs = {False: [], True: []}
    for i in range(M1_AB_PAIRS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            _m_planes(s, on)
            runs[on].append(_sql_run(s, q6)[1] * 1e3)
    off, on = sorted(runs[False]), sorted(runs[True])
    print(f"  m1 Q6 warm p50 over {M1_AB_PAIRS} alternating pairs: planes "
          f"off {statistics.median(off):.2f} ms [{off[0]:.2f}-{off[-1]:.2f}]"
          f", Top SQL and the wait profile on {statistics.median(on):.2f} "
          f"ms [{on[0]:.2f}-{on[-1]:.2f}]")
    _m_planes(s, True)
    digests = {}
    for q in M1_QUERIES:
        sql = TPCH_QUERIES[q]
        digests[obs.StatementsSummary.digest(sql)[0]] = q
        want = _m_engine_class(tags[F1_REQUESTS[q]])
        req0 = _m_requests()
        hit0, miss0 = (obs.COL_CACHE.get(result=r) for r in ("hit", "miss"))
        _, dt = _sql_run(s, sql)
        delta = {k: v - req0.get(k, 0.0) for k, v in _m_requests().items()
                 if v != req0.get(k, 0.0)}
        if delta != {want: 1.0}:
            raise SystemExit(f"m1 {q}: tidb_copr_requests_total moved by "
                             f"{delta}; its one leaf {tags[F1_REQUESTS[q]]} "
                             f"counts under {want}")
        hits = obs.COL_CACHE.get(result="hit") - hit0
        misses = obs.COL_CACHE.get(result="miss") - miss0
        print(f"  m1 {q.upper()}: {dt * 1e3:.2f} ms, requests {delta} "
              f"(leaf {tags[F1_REQUESTS[q]]}), tidb_copr_column_cache_total "
              f"hit {hits:g} miss {misses:g}")
    _sync()
    top = _m_top(s, digests)
    rows = s.query("select digest, exec_count from "
                   "information_schema.tidb_top_sql where operator = "
                   "'(stmt)'")
    seen = {r[0] for r in rows}
    for d, q in digests.items():
        n, dev, wall = top.get(d, (0, 0.0, 0.0))
        if d not in seen or not 0 < dev <= wall:
            raise SystemExit(f"m1 {q}: tidb_top_sql row {d in seen}, device "
                             f"{dev} s of wall {wall} s")
        print(f"  m1 tidb_top_sql {q.upper()} {d}: {n} execs, device time "
              f"(kernel + device_get) {dev * 1e3:.2f} of {wall * 1e3:.2f} "
              f"ms wall")
    buf = s.query("select max(value) from "
                  "metrics_schema.tidb_device_buffer_bytes")[0][0]
    alloc = torch.cuda.memory_allocated()
    if not 0 < buf <= alloc:
        raise SystemExit(f"m1: tidb_device_buffer_bytes {buf} outside (0, "
                         f"memory_allocated {alloc}]")
    print(f"  m1 metrics_schema.tidb_device_buffer_bytes {buf:.0f} of "
          f"{alloc} allocated; jit cache {_m_jit()}")
    for r in s.query("select rule, item, severity, value, details from "
                     "information_schema.inspection_result"):
        print(f"  m1 inspection_result: {r[0]} {r[1]} {r[2]} {r[3]} "
              f"{r[4][:120]}")
    _m_planes(s, False)
    launched = _kernels.LAUNCHES[RANK]
    if launched == 0:
        raise SystemExit("m1: Q3 did not launch kernel streamseg.rank_sums")
    print(f"  m1: streamseg launches {launched}; m1 took "
          f"{time.perf_counter() - t0:.1f}s")
    return launched


def _m_jit() -> str:
    return (f"hit {obs.JIT_CACHE.get(result='hit'):g} miss "
            f"{obs.JIT_CACHE.get(result='miss'):g}, "
            f"{_kernels.loaded_count()} librar(ies) loaded")


def _m_kinds(s) -> list:
    return [r[0] for r in s.query("select kind from "
                                  "information_schema.tidb_events")]


def _part_m2(card, cpu, data) -> int:
    """Part m2 (module docstring) on f2's SF1 sessions after l2. ->
    streamseg's launches during it."""
    t0 = time.perf_counter()
    _kernels.reset_launches()
    sessions = (card, cpu)
    # no auto-analyze during m2, as in l2: each session would re-plan at
    # its own statement counts
    for s in sessions:
        s.execute("set global tidb_auto_analyze_ratio = 1000000")
        s.storage.stats.auto_analyze(s.storage, s.catalog)
        _m_planes(s, True)
        s.storage.history.configure(enabled=True, window_seconds=3600)
    # 1. Top SQL and the history plane over Q1, Q3, Q18; @@profiling on
    # for Q1 alone
    digests = {obs.StatementsSummary.digest(TPCH_QUERIES[q])[0]: q
               for q in M2_QUERIES}
    for q in M2_QUERIES:
        rows = []
        for s in sessions:
            if q == "q1":
                s.execute("set profiling = 1")
            rows.append(s.query(TPCH_QUERIES[q]))
            if q == "q1":
                s.execute("set profiling = 0")
        if not _rows_equal(q, rows[0], rows[1]) or \
                card.last_engines != cpu.last_engines:
            raise SystemExit(f"m2 {q}: card and CPU rows or tags differ")
    tops = [{d: v[0] for d, v in _m_top(s, digests).items()}
            for s in sessions]
    plans = [sorted((r[0], r[1], r[2], r[3]) for r in s.query(
        "select digest, plan_digest, engines, exec_count from "
        "information_schema.tidb_plan_history") if r[0] in digests)
        for s in sessions]
    if tops[0] != tops[1] or set(tops[0]) != set(digests) or \
            plans[0] != plans[1] or len(plans[0]) != len(M2_QUERIES):
        raise SystemExit(f"m2 Top SQL / history: card {tops[0]} {plans[0]}, "
                         f"CPU {tops[1]} {plans[1]}")
    for d, pd, eng, n in plans[0]:
        print(f"  m2 {digests[d].upper()}: digest {d} execs (Top SQL) "
              f"{tops[0][d]}, plan digest {pd} engines {eng} execs "
              f"(history) {n}: card == CPU")
    profs = [(s.query("show profiles"), s.query("show profile"))
             for s in sessions]
    for s, (ps, p) in zip(sessions, profs):
        if len(ps) != 1 or "sum(l_quantity)" not in ps[0][2] or not p:
            raise SystemExit(f"m2 @@profiling: SHOW PROFILES {ps}, SHOW "
                             f"PROFILE {len(p)} rows")
    print(f"  m2 @@profiling: SHOW PROFILES one row on each (card "
          f"{profs[0][0][0][1]:.3f} s, CPU {profs[1][0][0][1]:.3f} s), SHOW "
          f"PROFILE {len(profs[0][1])} / {len(profs[1][1])} frame rows")
    # 2. the wait states of a 100-row INSERT
    states = []
    for s in sessions:
        s.execute("create table m2_w (a bigint primary key, b bigint)")
        s.execute("insert into m2_w values " + ", ".join(
            f"({i}, {i * 7})" for i in range(100)))
        states.append(sorted({r[0] for r in s.query(
            "select state from information_schema.tidb_wait_profile "
            "where digest_text like 'insert into m2_w%'")}))
        s.execute("drop table m2_w")
    if states[0] != states[1] or "prewrite" not in states[0]:
        raise SystemExit(f"m2 wait profile: card {states[0]}, CPU "
                         f"{states[1]}")
    print(f"  m2 tidb_wait_profile of a 100-row INSERT: {states[0]}, card "
          f"== CPU")
    # 3. the admission gate at one token, the token held: Q6 sheds
    q6 = TPCH_QUERIES["q6"]
    base = _l_both(card, cpu, q6, "m2 Q6")
    for s in sessions:
        gate = s.storage.admission
        gate.configure(tokens=1, timeout_ms=100)
        held = gate.acquire(0)
        try:
            s.query(q6)
            out = ("ok",)
        except AdmissionTimeout as e:  # the shed under test
            out = ("error", e.errno, str(e))
        finally:
            if held:
                gate.release()
            gate.configure(tokens=0)
        if out[:2] != ("error", 9003) or \
                "admission_shed" not in _m_kinds(s):
            raise SystemExit(f"m2 admission: {out}, events {_m_kinds(s)}")
    print("  m2 admission gate at 1 token, held: Q6 answered 9003 on both, "
          "tidb_events holds admission_shed")
    # 4. the governor under governor/mem-pressure: Q1 killed with 8175
    for s in sessions:
        gov = s.storage.governor
        gov.configure(limit_bytes=1 << 20, cooldown_ms=0)
        try:
            with failpoint.failpoint("governor/mem-pressure", 2 << 20):
                out = _i_outcome(s, TPCH_QUERIES["q1"])
        finally:
            gov.configure(limit_bytes=0)
        if out[:2] != ("error", 8175) or "governor_kill" not in _m_kinds(s):
            raise SystemExit(f"m2 governor: {out}, events {_m_kinds(s)}")
    after = _l_both(card, cpu, q6, "m2 Q6 after the kill")
    if after != base or TR.sql_cells(after[1]) != TR.sql_cells(base[1]):
        raise SystemExit("m2 governor: the next Q6 is not exact")
    print("  m2 governor under governor/mem-pressure: Q1 answered 8175 on "
          "both, tidb_events holds governor_kill; the next Q6 exact")
    # 5. metrics_schema's tables and inspection_summary's rules
    names = []
    for s in sessions:
        db = s.current_db
        s.execute("use metrics_schema")
        names.append(sorted(r[0] for r in s.query("show tables")))
        s.execute(f"use {db}")
    rules = [sorted(r[0] for r in s.query(
        "select rule from information_schema.inspection_summary"))
        for s in sessions]
    if names[0] != names[1] or rules[0] != rules[1] or not rules[0]:
        raise SystemExit(f"m2 metrics_schema {names} / inspection_summary "
                         f"{rules}")
    print(f"  m2 metrics_schema: {len(names[0])} tables, inspection_summary: "
          f"{len(rules[0])} rules, card == CPU")
    # every plane off, the samplers stopped
    for s in sessions:
        _m_planes(s, False)
        s.storage.history.configure(enabled=False)
        s.storage.metrics_history.stop()
        s.execute("set global tidb_auto_analyze_ratio = 0.5")
    live = [t.name for t in threading.enumerate()
            if t.is_alive() and t.name in M_PLANE_THREADS]
    if live:
        raise SystemExit(f"m2: plane threads still alive: {live}")
    launched = _kernels.LAUNCHES[RANK]
    print(f"  m2: card == CPU on every check; streamseg launches {launched}; "
          f"jit cache {_m_jit()}; m2 took {time.perf_counter() - t0:.1f}s")
    return launched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--sf", type=float, default=10.0,
                    help="scale factor of Q6 and of the kernel phase")
    # SF1, --q18-sf's lineitem, since part q (SF2 before: its generation
    # alone took ~6 s; SF5 before part p: ~18 s)
    ap.add_argument("--q1-sf", type=float, default=1.0)
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
    logs = _kernels.build_all(force=True)
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and (int(m[1]) or int(m[2])):
                raise SystemExit(f"{name}: ptxas spills registers: "
                                 f"{line.strip()}")
    cfg = _kernels.streamseg_launch_config(4)
    print(f"  streamseg launch (K=4): {cfg['blocks_per_sm']} blocks/SM x "
          f"{cfg['sms']} SMs, {cfg['smem_bytes']} B shared memory a block, "
          f"{cfg['tile_rows']}-row tiles")

    print("== 3. kernels vs plain")
    _ragged_phase(args.seed)
    d10, t10, s10 = _load(args.sf, args.seed, (
        "lineitem", "orders", "customer", "supplier", "nation", "region",
        "part", "partsupp"), 1)
    d1, t1, s1 = _load(args.q18_sf, args.seed,
                       ("lineitem", "orders", "customer", "supplier",
                        "nation"), 11)
    li10, li1 = d10["lineitem"], d1["lineitem"]
    shapes = [_shape_phase(li10, f"SF{args.sf:g}"),
              _shape_phase(li1, f"SF{args.q18_sf:g}")]

    print("== 4. main path")
    t_part = time.perf_counter()

    def lap(name: str) -> float:
        nonlocal t_part
        now = time.perf_counter()
        took = now - t_part
        print(f"  [{name} took {took:.1f}s]")
        t_part = now
        return took

    cop = CopClient()
    sql_launches, write_launches = {}, {}
    # parts a-d, e and f1 check over the same SF10 arrays
    with _oracle_memo():
        launches, tags = _main_path(args, cop, (d10, t10, s10),
                                    (d1, t1, s1))
        lap("parts a-d")
        SUBLAPS.clear()
        _part_e(args, cop, (d10, t10, s10), (d1, t1, s1))
        _sublap_line("part e", lap("part e"))
        # part f reuses the generated arrays; the earlier parts' client
        # (and its device caches) and snapshots go first
        del cop, t10, s10, t1, s1
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  -- f. the SQL read path (device memory held before it: "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB)")
        sql_launches["f1"], s10, f1_rows = _part_f1(args, d10, tags)
    lap("part f1")
    print("  -- l1. EXPLAIN ANALYZE and TRACE on f1's session")
    explain_launches = {"l1": _part_l1(s10, f1_rows, tags)}
    lap("part l1")
    print("  -- m1. the observability planes on f1's session")
    observe_launches = {"m1": _part_m1(s10, tags)}
    lap("part m1")
    print(f"  -- g. the write path ({_mem()} held before it)")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    SUBLAPS.clear()
    # g1's reads after RF2 and i1's check over the same arrays
    with _oracle_memo():
        # g1's reads without their profiled runs since part q (a depth
        # cut of ~9 s; g1' still profiles its reads)
        hits, after10 = _part_g1(args, [s10], d10, args.sf * G1_RF_SHARE,
                                 f"g1 SF{args.sf:g}", G1_READS,
                                 rf2_sf=args.sf * G1_RF2_SHARE,
                                 profile=False)
        write_launches["g1"] = _kernels.LAUNCHES[RANK]
        _sublap_line("part g1", lap("part g1"))
        print(f"  launches in g1: {dict(_kernels.LAUNCHES)}; streamseg "
              f"over a rebuilt lineitem epoch: {hits}")
        print(f"  -- i1. online DDL on g1's session ({_mem()} held before "
              f"it)")
        ddl_launches = {"i1": _part_i12(
            args, [s10], after10, f"i1 SF{args.sf:g}",
            lambda q: [tags[F1_REQUESTS[q]]], full=False)}
    lap("part i1")
    del s10, after10
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  -- j1. a HASH-partitioned lineitem at SF{args.sf:g} ({_mem()} "
          f"held before it)")
    partition_launches = {"j1": _part_j1(args, d10)}
    lap("part j1")
    gc.collect()
    torch.cuda.empty_cache()
    sql_launches["f2"], card1, cpu1, f2_tags = _part_f2(args, d1)
    lap("part f2")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    _, after1 = _part_g1(args, [card1, cpu1], d1, args.q18_sf,
                         f"g1' SF{args.q18_sf:g}", G1P_READS)
    write_launches["g1'"] = _kernels.LAUNCHES[RANK]
    lap("part g1'")
    print(f"  -- i2. online DDL and the schema surface on g1''s sessions "
          f"({_mem()} held before it)")
    ddl_launches["i2"] = _part_i12(args, [card1, cpu1], after1,
                                   f"i2 SF{args.q18_sf:g}", None, full=True)
    lap("part i2")
    print(f"  -- k. the function registry, the session functions and "
          f"accounts on f2's sessions ({_mem()} held before it)")
    registry_launches = _part_k(card1, cpu1, after1)
    lap("part k")
    print(f"  -- l2. the statement plane on f2's sessions, card == CPU "
          f"({_mem()} held before it)")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        explain_launches["l2"] = _part_l2(card1, cpu1, after1, tmp)
    lap("part l2")
    print(f"  -- m2. the observability planes and the governor on f2's "
          f"sessions, card == CPU ({_mem()} held before it)")
    observe_launches["m2"] = _part_m2(card1, cpu1, after1)
    lap("part m2")
    del card1, cpu1, after1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  -- j2. a RANGE-partitioned lineitem at SF{args.q18_sf:g}, "
          f"card == CPU ({_mem()} held before it)")
    partition_launches["j2"] = _part_j2(args, d1)
    lap("part j2")
    gc.collect()
    torch.cuda.empty_cache()
    _kernels.reset_launches()
    _part_g2(args, d1)
    write_launches["g2"] = _kernels.LAUNCHES[RANK]
    lap("part g2")
    print(f"  streamseg launches in part g: {write_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  -- h. durability and the MySQL wire server ({_mem()} held "
          f"before it; {smi})")
    _kernels.reset_launches()
    (write_launches["h2"], ddl_launches["i3"], partition_launches["j3"],
     server_launches, cluster_launches, failover) = _part_h(args, d1,
                                                            f2_tags)
    lap("parts h, i3, n, o, p, j3")
    if not hits:
        raise SystemExit("g1: no request launched streamseg over a "
                         "lineitem epoch that compaction rebuilt")

    print("== 5. result")
    # top-level numbers at the first (SF10) shape; every shape's in
    # "shapes"; launches over the four parts of the main path, and over
    # each SQL part
    top = shapes[0]
    kern = {"name": "streamseg.rank_sums", "route": "cuda",
            "source": "tidb_tpu_torch/csrc/streamseg.cu",
            "replaces": "tidb_tpu/copr/streamseg.py:194",
            "launches": launches["streamseg.rank_sums"],
            **{k: top[k] for k in (
                "max_abs_err", "exact", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_share", "library_ms", "library_call")},
            "shape": top["shape"], "shapes": shapes,
            "sql_launches": {k: v["streamseg.rank_sums"]
                             for k, v in sql_launches.items()},
            "write_launches": write_launches,
            "ddl_launches": ddl_launches,
            "partition_launches": sum(partition_launches.values()),
            "partition_launches_by_part": partition_launches,
            "registry_launches": registry_launches,
            "explain_launches": explain_launches,
            "observe_launches": observe_launches,
            "server_launches": server_launches,
            "cluster_launches": cluster_launches,
            "failover_launches": failover["launches"],
            "range_launches": failover["q"]["launches"]}
    print(json.dumps({"kernels": [kern]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
