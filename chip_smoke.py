#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opengemini_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--hours H] [--seed S] [--phases 3,5,...]

Phases, in order; any failure ends the run with a nonzero exit:

1. Device and build: requires CUDA, prints the card's name and power
   limit (nvidia-smi), builds the six CUDA kernels from csrc/ (nvcc,
   sm_90a, one process per source) and, at the same time, the repo's
   native/codecs.cpp, native/seriesindex.cpp, native/lineproto.cpp and
   native/textindex.cpp and the port's native/lpformat.cpp and
   native/gorillascan.cpp (g++) into
   build/.
2. Kernels against their plain PyTorch versions on the card, on seeded
   data (70% mask density, fully empty rows, value and time ties):
   count/min/max/first/last/sel_* must match exactly, sum/mean/ssd within
   rtol 1e-10 (summation order; kernel 1's ssd in f32 within 1e-5);
   widen_packed (widths 1 and 2, odd counts, all 256 byte values),
   unpack_bits (1, 7, 8 and 8 MiB bytes) and probe_count (random and
   all-zero masks) exactly. The segmented forms of widen_packed and
   unpack_bits exactly, on segment tables of 1 and 256 rows with empty
   and single-value (single-byte) segments at odd source offsets, widths
   1 and 2 mixed, and a chunk of eight C1-sized gorilla blocks. Kernels
   1-3 on adversarial inputs
   (adversarial_cases: NaN at the would-be min, max, first and last,
   masked-in +-inf, ties of -0.0 and 0.0, empty, prefix and padded
   masks, W in 1, 12, 13, 33, 720, 2048 and K in 1, 2, 361, f32, views
   one element into their storage; kernel 1 also on rows at 1e9 + N(0, 1)
   and 1e15 + 256 k), with the same tolerances. Kernels 1-3 timed at the
   main path's shapes with the main path's masks, and their lone launch
   and host time per call with one output buffer against one allocation
   per output. Kernel 6 against torch.count_nonzero(m, dim=1) (lone and
   back to back), and the host time of its wrapper split into its stages
   (checks, output allocation, device and stream lookup, the ctypes call,
   the counter). Kernel 4 at one segment against the one PyTorch call
   that computes it, at both widths ((131399, 2) against
   raw.view(uint16).to(int32), (131071, 1) against raw.to(int32)): the
   CUDA-event time of each and the host time of a call (1000 calls, not
   synchronised).
3. End to end on a TSBS devops cpu-only deployment (4000 hosts, the 10
   cpu tags, the 10 usage_* fields, one sample every 10 s for 4 h from
   2016-01-01T00:00:00Z; `--hours`, cut from 12 h to 6 h so that the
   script with phase 13 stays within 1050 s, and to 4 h for phase 15):
   the port's HTTP server on
   localhost takes CREATE DATABASE, the first minute of every host as
   line protocol on
   /write (parsed by the native parser, native/lineproto.cpp, in
   segments; its points/s print) and the rest through
   convert.load_columnar, both logged to the WAL; the flush threshold
   lies above the data's size, so the queries read the memtable (the
   script checks that no TSF file was written). A bad /write body must
   answer 400 with errno 2001, module "write" and the X-Ogt-Errno
   header. Four queries run 5 times each (Q1, Q2 and Q4 once:
   E2E_RUNS) through
   /query (on one
   kept-alive HTTP/1.1 connection, as client libraries keep it; every
   query of the script does) and every answer is checked against a
   numpy oracle (counts, min, max, first, last
   exact; mean, stddev rtol 1e-9). The launch counters are read around
   each query's runs: Q1-Q3 must launch the grid kernel (and raise
   the grid-batch counter), Q4 both bucket kernels. The server's
   /debug/vars query_stages counters are read around them too: each
   stage's ms over the requests (parse, the executor's map_shards,
   scan, colcache, device_compute and render, and the answer's encode),
   the rest of the request walls (to the answer's last byte) as
   `other`, and the stage that took the most; the stages must cover 90%
   of every query's request walls (checked once all phases ran). Q3
   once more with
   chunked=true&chunk_size=100 (newline-delimited JSON documents equal
   to the plain answer's rows), and EXPLAIN ANALYZE of Q1, printed. Then
   a sixth run of each query, all four in one torch.profiler capture,
   each in an annotation: per query the device's busy time (the union
   of its kernel, copy and memset spans), its kernels' time, its copies
   each way, over the run's wall, and how many of the run's device calls
   the trace holds no record of.
4. The kernels again, at the shapes the end-to-end phase gave them:
   checked and timed (CUDA events, median of 20 launches).
5. Cold scan from disk (TSBS devops cpu + diskio, 4000 hosts, 6 h
   (COLD_HOURS, cut from 12), the
   device profile OGT_DEVICE_PROFILE=1): loaded in time order, one hour
   of every host at a time, the first minute through /write and the rest
   through convert.load_columnar, under the default 64 MiB flush
   threshold (the load flushes a file each time the memtable passes it);
   flush_all, then a restart (a new Engine and HttpService on
   the same root: meta, series index, TSF files, WAL). The
   decoded-column cache is off in this phase (its disabled path), so
   every run decodes. C1 (Q1's shape),
   C2 (Q2's) and C3 (count/min/max of the diskio read_bytes counter
   GROUP BY time(1m)) run once each (COLD_RUNS, C2 cut for phase 15, C1
   and C3 for phase 16's operations; phase 6 times them warm), plus one
   traced run; every answer
   equals the numpy oracle; each must take the fused device decode
   (executor/grid_decode_fused up, device/decode_fallbacks_total not),
   C1 and C2 launch unpack_bits and grid_window_agg, C3 widen_packed, and
   the phase launches probe_count once. Launches per run are exact, in
   every timed run and in the traced run: widen_packed once in C3 (one
   launch for all of the plan's FOR-delta blocks), unpack_bits once per
   gorilla chunk of the plan in C1 (at most MAX_C1_CHUNKS, 9) and five
   times that in C2; they print beside the per-block decode's (the
   blocks of each run: 132, 133 and 665 at 12 h), with
   each cold query's device kernel count and time in its traced run. The
   phase's device-memory peak prints and must stay within 6 GiB. The
   stage split prints per query as in phase 3, and EXPLAIN ANALYZE of
   C1. Then the next minute of every
   host goes through /write, the engine restarts without a flush, and
   count(usage_user) over that minute must be 4000 x 6 (WAL replay). The
   kernels run again at the shapes this phase gave them (for kernels 4
   and 5 the segment tables of C3's plan and of C1's and C2's chunks),
   checked and timed.
6. The decoded-column cache's device tier, on phase 5's root after a
   restart (and a flush of the replayed minute): both tiers on (2 GiB
   host, 1 GiB device), C1 and C3 twice each (CACHE_RUNS). The
   first run fills (a device-tier miss; the fused decode's grid is
   retained); the warm run must hit the device tier, answer as the
   oracle,
   launch kernel 3 on the retained tensors and neither kernel 4 nor 5;
   their stage split prints. A traced warm run of each must copy at
   most 1 MiB to the card. Then
   one row of a new series goes through /write into C1's first window
   and the engine flushes: the next C1 run must miss and count the row.
   Device memory within 6 GiB.
7. Compaction of the same root: Shard.compact_level until it merges
   nothing, then Shard.compact, each call's wall, the files and bytes
   on disk before and after; C1 and C3 once each (COMPACT_RUNS, cut
   from 2 for phase 16's operations) on the merged
   file (cache off: the fused decode on every run, no fallback) equal
   to the oracle (C1 with phase 6's row), with their stage split, then
   a restart and C3 again. The stage splits of phases 6 and 7 are held
   to the same 90% as phases 3 and 5.
8. The host query path and the schema statements, with a budget of
   its own (HOST_PHASE_S, 180 s). (a) The reference's black-box tables
   (tests/parity_cases.json, compared by tests/parity_common.py's
   result_matches) replayed through the port's HttpService, one Engine
   per case: on the card (Engine(root), the default device), then on
   the CPU. Each query must match on both or on neither, and the count
   must equal tests/test_torch_parity.py's (its queries less its XFAIL
   dict); the launches of kernels 1-3 the device aggregates made print.
   (b) On phase 7's compacted root, with the decoded-column cache off:
   the TSBS devops queries as TSBS writes them for InfluxDB (high-cpu-1,
   a raw select with a field predicate; lastpoint, a raw select over
   every series; groupby-orderby-limit, which must launch kernel 3),
   SHOW TAG VALUES of hostname and SHOW SERIES CARDINALITY, each checked
   against the oracle, run five times (lastpoint and
   groupby-orderby-limit once: HOST_RUNS, cut from 2 for phase 16's
   operations; fewer, with a progress line
   saying so, when the first run shows five would not fit the budget)
   with its p50 and its stage split (raw selects: map_shards, scan and
   render; SHOW: show); then the same root reopened with device="cpu"
   must give the same five answers. The kernels 1-3 are checked and
   timed again at the largest new shapes the phase gave them.
9. Subqueries, joins, unions and SELECT INTO, with a budget of its own
   (SUBQUERY_PHASE_S, 60 s, shortened if the script's 1200 s would
   not leave AFTER_PHASE9_S after it), on phase 7's compacted root with
   the decoded-column cache off, over the span's first 4 h
   (SUBQUERY_HOURS, cut from 12 to 6, then to 4): S1, the mean and
   max per hour of the per-host 10-minute maxima (a Grafana panel: a
   FROM subquery whose inner select must take the chunked path, its
   chunk count printed, and launch kernel 3, and whose outer aggregate
   must launch a kernel on the spill engine, on the card); J1, an INNER
   JOIN of per-host mean(usage_user) and max(read_bytes) (two aggregate
   subqueries) on hostname; U1, a UNION ALL of two raw selects (host_7's
   cpu, host_9's diskio), each with its own WHERE; I1, SELECT ... INTO
   cpu_1h of the hourly per-host means (a POST; it writes, so it runs
   last), then count(usage_user) and host_7's mean read back. Each
   answer equals the numpy oracle (counts, min and max exact, means
   rtol 1e-9; phase 6's host_extra row included). Each runs five times
   (fewer, with a progress line saying so, when the runs would not fit
   the budget beside the CPU comparison) with its p50, its stage split
   (the `subquery` and `subquery(chunked)` spans printed beside the
   stages; they nest, so the 90% check does not apply), the launches
   per kernel, the rows materialized into spill engines, the launches
   on them, and the device-memory peak. Then the same root reopened
   with device="cpu" must give the card's answers to S1, J1, U1 and
   I1's read-backs (floats within rtol 1e-12). The kernels 1-3 are
   checked and timed again at the largest new shapes the phase gave
   them.

10. A dashboard panel over twice the cold span (12 h at COLD_HOURS 6,
   24 h before the cut), with a budget of its own (DASHBOARD_PHASE_S,
   90 s), on phase 7's compacted root: (a) day 2 of TSBS devops cpu
   (hours 6-12 of the same 4000 hosts but the first minute, which
   phase 5 wrote; the device profile on) loaded hour by hour through
   convert.load_columnar and flushed, with the
   decoded-column cache's host tier at its default 256 MiB (the device
   tier off, as deployed); (b) R0, Grafana's "last 12 hours" panel
   (mean, max and count of usage_user GROUP BY time(1m)) with the
   incremental result cache on: a window-aligned sliced scan (17.28 M
   rows by the chunk metadata, above the slice threshold, which the
   phase scales with the span: DASH_SLICE_ROWS, 12 M) that must
   take at least 2 slices and launch kernel 3 once per slice; (c) R1,
   R0 again, which must scan 0 rows, launch nothing and answer the same;
   then the next minute of every host through /write and R2, the panel
   a minute on, which must reuse 719 cached windows and scan the 24 000
   rows of the new one (one slice), equal to the oracle and to its
   cache-off run in one pass (counts and maxima bit for bit, means
   within rel 1e-12); (d) P1, per-host count and mean over day 2
   (kernel 1) and percentile_approx(usage_user, 95) per host, within one
   global bin width of numpy's nearest-rank percentile, with the series
   each served from chunk metadata printed; (e) K1, a cache-off R0 on a
   second connection, listed by SHOW QUERIES, killed by KILL QUERY: it
   must answer "query <qid> killed", leave /debug/queries, give back
   its device memory, and R0 in one pass (the slice threshold raised
   for that run) must then equal the oracle and the sliced R0 (counts
   and maxima bit for bit, means within rel 1e-12; whether they are
   bit for bit prints). Each run prints its wall, slices, rows scanned,
   windows from the cache, decoded-column cache hits and misses and
   resident bytes, launches, stages and device memory peak. The kernels
   1-3 are checked and timed again at the largest new shapes of phases
   8, 9 and 10.
11. The data lifecycle at TSBS devops width, with a budget of its own
   (LIFECYCLE_PHASE_S, 120 s), on a root of its own: (a) cpu for 4000
   hosts, 1 h at 10 s (1.44 M rows) under the device profile through
   convert.load_columnar, flushed every 20 min (three files), and
   syslog (tags hostname and severity, a string message from seeded
   sshd, CRON and kernel templates; the kernel's "Out of memory: Killed
   process" on 40 hosts, severity err) for 30 min through /write
   (720 000 lines), flushed; (b) T1, count(message) WHERE match(message,
   'memory') GROUP BY hostname, whose text-sidecar lookups must leave
   the 40 OOM hosts' series of the 4000; T2, a raw select of the
   'killed' lines of severity err in a 20 min range; (c) P0, the
   per-minute mean/max/count of usage_user over 80 min with the result
   cache on (kernel 3); D1 (DELETE one host), D2 (DELETE 10 minutes),
   D3 (DROP SERIES of one syslog host), each a delete rewrite by POST
   with its wall, files and rows kept, each followed by P0, which must
   answer the oracle of the rows left (no deleted row from the cache)
   and launch kernel 3 (after D2 the cached P0 rescans only the emptied
   windows, with nothing to launch, and a cache-off P0 must launch it
   and answer the same); (d) D4, DROP MEASUREMENT syslog, then a
   /write of syslog lines, which purges and is accepted; read back they
   are the new lines alone; (e) 20 more minutes of cpu in a file of
   their own; after a restart, a bitflip rule armed on that file
   through /debug/ctrl?mod=diskfault: P0 (cache off) answers the
   statement error "file quarantined after media fault: <file>: ..."
   (HTTP 200, as the reference's /query), the .quar marker exists and
   /debug/vars lists the file; the rule healed, P0 answers the oracle
   without that file's rows (kernel 3); a restart keeps it
   quarantined, and purge_quarantined removes the file, its marker and
   its sidecar; (f) T1, T2, P0 and D4's read-back on the card, then the
   root reopened with device="cpu" must give the same answers. Each
   step prints its wall, stage split, launches (kernels 3-5 apart) and
   device memory peak. Kernels 1-6 are checked and timed again at the
   largest new shapes phase 11 gave them.
12. The offload planner on the card, with a budget of its own
   (PLANNER_PHASE_S, 90 s), on phase 7's compacted root with the
   decoded-column cache off (every run scans; the route is the
   planner's alone): through /debug/ctrl the planner is cleared and
   armed at the reference's default knobs (PLANNER_KNOBS) and devobs
   armed; C3 runs PLANNER_RUNS (5) times. Each run prints the decision
   ring's record (route, reason, est_ms, uses), the routes
   /debug/queries showed while it ran, its wall, the fused decode's
   blocks by codec and kernels 4 and 5's launches, and is checked: the
   answer equals the oracle; a device run decodes blocks, no gorilla
   one, and launches kernel 4 once if they hold FOR-delta blocks (at
   COLD_HOURS 6 the compacted read_bytes is varint only: none), a host
   run neither 4 nor 5, both kernel 3 once; the decision is the one the
   reference's rules
   (planner_expected, the ladder of opengemini_tpu/query/offload.py
   written out) give from the inputs it had (the static route, the
   samples, the uses, the estimates, the family's measured first-run
   walls, the pre-warm state), and the chosen route counts one more
   sample. Then C3 forced to the host and to the device (one answer);
   both routes' EWMA walls; one run with the device tier on and a 1 s
   profiler capture from its first grid launch (a second capture
   answers 409; the trace is read back), after which the ledger lists the tier's owner and
   stays within torch.cuda.memory_allocated(); /debug/device's
   inventory (grid_decode_fused at C3's grid with its uses, the six
   build: entries) and probe; a pre-warm sweep; /api/v2/write of 100
   lines, read back; readonly (a /write answers 403 with errno 2003, the
   count stays), disableread (SELECT and EXPLAIN refused, SHOW
   answered) and flush (one more file); /metrics parsed (parse_metrics),
   its query GETs and planner counters against the phase's requests and
   the ring. Kernels 3-5 are checked again at its new shapes.
13. PromQL on the card, with a budget of its own (PROM_PHASE_S, 100 s),
   on a root of its own (build/prom): TSBS devops as its
   victoriametrics target loads it, cpu usage_user and diskio
   read_bytes as the Prometheus metrics cpu_usage_user and
   diskio_read_bytes with the ten host tags as labels (4000 hosts, 10 s,
   PROM_HOURS h from 2016-01-01: 5.76 M samples at 2 h, cut from 6 h)
   through
   convert.load_columnar under the device profile, flushed and compacted
   to one file (the load's samples/s print); the next minute of all
   8000 series through POST /api/v1/prom/write (snappy with literals
   only, the script's own prompb encoder; samples/s print) into a file
   of its own, and one POST /api/v1/otlp/metrics (a gauge and a sum for
   100 hosts). PQ1-PQ7 (prom_queries: the TSBS PromQL query types and
   the range functions of the tiled and dense paths) on the device
   route (/debug/ctrl?mod=offload&host_kernels=0, the planner off).
   First PQ2-PQ4 with the route forced to the device
   (/debug/ctrl?mod=offload&force=device, which passes the encoded
   decode's cost gate): the value matrix decodes on the card through
   decode_rows_matrix, kernel 5 must launch, and the device-decode H2D
   bytes print beside the padded (S, N) matrix each decode replaces;
   decode_rows_matrix against materialize_enc bit for bit at PQ3's
   geometry. Then each PQ once (PROM_RUNS, cut from 5 to 3 for phase
   16, then to 2, then to 1 for phase 18; twice when the first run
   passes PROM_SLOW_MS)
   with its p50, its stage split (prom_collect, prom_prepare,
   prom_kernel, render, encode) and launches, the forced answers equal
   to these; PQ1 (max) and PQ3 (mean) against numpy; every PQ once on
   the host route (host_kernels=1), the same answers, both walls
   printed; PQ3 and PQ4 in one torch.profiler capture (the device's busy
   share); the written minute and the OTLP points read back exactly
   (PQ6, /api/v1/prom/read of host_7's diskio_read_bytes over the last
   hour, InfluxQL); /api/v1/labels, /label/hostname/values and
   /series; then the root reopened with device="cpu" must give the
   card's answers (max, the instant values and topk exactly, the rest
   within rel 1e-9). Kernels 4 and 5 are checked and timed at its
   shapes.
14. The continuous tier on the card, with a budget of its own
   (CONT_PHASE_S, 60 s), on a root of its own (build/smoke_continuous):
   TSBS devops cpu at 4000 hosts x 10 fields x 2 h (2.88 M rows) through
   /write (the port's native line writer formats the bodies) into an RP
   of 1 h shards; the rollup cpu_1m (usage_user, 1 min, with its sketches)
   declared through /debug/ctrl?mod=rollup and folded by one governed
   service tick (its wall and rows); D1, mean and max of usage_user by 5
   min and host over the span, 2 runs (CONT_DASH_RUNS): 21 windows from rollup rows and a
   raw tail of 15 min through the grid on the card (windows_spliced,
   rows, launches and the route print; the rollup rows read from the
   `rollup` span of an EXPLAIN ANALYZE), against the oracle and against
   the unspliced answer, kernel 3 (or 1-2) checked and timed at the raw
   tail's shape, its launches there left out of the counts; a late write into a spliced window (D2: re-dirtied, the
   late point in the answer); CQ cq5 (mean(*) INTO cpu_5m GROUP BY
   time(5m), * RESAMPLE FOR 15m) ticked at an explicit now and read
   back; stream s1 (mean, max, count of usage_user by minute and
   region) over one more written minute, flushed; CREATE DOWNSAMPLE
   rewriting the aged first shard on the card, the query before and
   after against the oracle (no stale cache hit); the RP cut to 1 h and
   one retention tick dropping that shard; the governor (mod=governor,
   2 slots and a queue of 1) under 8 concurrent dashboards (200s, 503s
   with Retry-After, its /debug/vars section); and the slow log
   (mod=obs, /debug/slow). Each step's wall and the memory peak print.
15. The PromQL rule tier on the card, with a budget of its own
   (RULES_PHASE_S, 60 s), on phase 13's root reopened (build/prom), the
   decoded-column cache's host tier at its deployed 256 MiB: one rule
   group (60 s) declared through /debug/ctrl?mod=rules with four rules
   (RULES): F1, topk(10, rate(diskio_read_bytes[5m])), the fallback leg
   through the port's PromEngine, declared first and ticked alone with
   the route forced to the device (its decode launches kernel 5); then
   R1, sum by (region) (increase(diskio_read_bytes[1h])), R2, avg by
   (hostname) (avg_over_time(cpu_usage_user[5m])) (4000 series written
   back) and A1, max_over_time(cpu_usage_user[5m]) > 90 for 120 s, all
   three tiled (a 60 s lattice, 65 tiles covered per tick); a cold
   tick at an explicit now inside the loaded span, then 10 ticks a
   minute apart past the span's end, the next minute of all 8000 series
   through /api/v1/prom/write before each, and a late sample into the
   last folded tile before the sixth. Every tick prints its wall, the
   tiles folded against those covered, the rows collected and the
   fallback evaluations; the cold tick, the late one, the last before
   the restart and the first after it (RULES_VERIFY_TICKS, cut from
   every tick) are verified bit for bit against a from-scratch
   evaluation (verify_last_tick, outside the timed tick):
   the cold tick folds 65 tiles, an incremental one 2 (the new tile of
   each selector), the late one 4; R1, R2 and F1 read back by name
   (last_over_time(name[1s]) at the tick) equal the tick's results
   exactly, and at the cold and the late tick (RULES_EXPR_TICKS) their
   expressions evaluated anew (rel 1e-9), A1's series equal numpy's max
   exactly and its alerts a numpy run of the state machine (pending,
   then firing after for_s), /api/v1/rules lists the four rules. A flush
   and a restart (a new Engine, HttpService and RuleManager) reload the
   group, watermark and alert state; the first tick after it refolds,
   verifies and fires only what numpy says. Then castor (CREATE MODEL
   on host_7's per-minute mean, an InfluxQL aggregate on the card, and
   detect() at threshold 1.5 with the model and with 'mad', against
   numpy), a subscription forwarding one minute of cpu for every host
   to a sink on localhost (exactly those lines), the scrub (a full
   pass verifying every block byte, then a bitflip rule
   quarantining exactly the subscription's flushed file), a monitor
   tick read back from _internal, /debug/ctrl?mod=durability (ok, none
   missing), and the root on the CPU recomputing the card's last tick
   from scratch (R1, R2 and A1 bit for bit, F1 within rel 1e-12). Each
   step's wall and the memory peak print.
16. A three-node cluster on the card, with a budget of its own
   (CLUSTER_PHASE_S, 100 s), on roots of its own (build/cluster/n1-n4),
   in this process: openGemini's cluster mode with every node meta and
   data (the JAX package's [meta] node-id/peers and [cluster]
   data-routing, replication-factor 2, write-consistency "one"), each
   node wired as its server/app.py wires one (ClusterNode: an Engine
   and an HttpService with auth on, a MetaStore over HttpTransport with
   attach_engine and attach_users and one shared token, a DataRouter,
   a HintReplayService). (a) A meta leader is elected (the wall and
   each node's /raft/status print); the data nodes register through
   /cluster/register; the admin (the bootstrap) and `reader` (READ ON
   benchmark) are created through the leader and listed by SHOW USERS
   on every node; CREATE DATABASE benchmark WITH SHARD DURATION 1h
   reaches every engine. (b) TSBS devops cpu, 4000 hosts, 2 h
   (CLUSTER_HOURS) from 2016-01-01: the first minute through n1's
   /write as the admin, routed (split by owner, forwarded to
   /internal/write; its points/s print), the rest through
   convert.load_columnar into each owner of each hour's group; every
   node flushes. Placement is hour 0 on [n2, n1], hour 1 on [n3, n2],
   hour 2 on [n3, n1] (CLUSTER_PLACEMENT, the reference's owners), so
   n1 is the primary of no loaded group. (c) On n1 with the admin's
   credentials on one kept-alive connection, K1 (Q1's shape), K2
   (Q2's), K3 (Q4's) and K4 (a raw select of host_7's usage_user over
   the ten minutes around hour 0's end) once each (CLUSTER_RUNS, cut
   from 3 for phase 18; more runs, where set, only while the phase's
   budget lasts, and a line says so where it does not), against the
   oracle; each prints its p50, its stage split beside the
   remote_partials span (the stages are process-wide: the peers' scans
   count in them), the bytes each peer's answers carried, and its
   launches by node (NodeLaunches: a peer's while it computes its
   partials), which must be those the placement implies: each serving
   peer CLUSTER_PEER_LAUNCHES (K1 kernel 3, K2 kernel 1, whose peers
   decline the grid, K3 kernels 1 and 2, K4 none: /internal/scan, the
   binary wire), the coordinator its own reduction where it is a
   primary, no other node any, and their sum the launch counters'
   process-wide deltas. EXPLAIN ANALYZE of K1
   must show each serving peer's grafted select_partials subtree (scan,
   decode, partial_merge); `reader` gets 403 on /write and 200 on
   /query. (d) n3 stops (its listener, meta store and engine; a new
   leader's wall when it led); after one probe round SHOW CLUSTER on n1
   shows it down and K1 equals the oracle with hour 1 from n2; the next
   minute of every host (4000 x 6 points, hour 2) through n1's /write
   with consistency=one answers 204 with n3's copy hinted (the hint
   file and counters print); K1 over the span and the minute equals
   the oracle (hour 2 local on n1, hours 0-1 n2's partials). (e) n3
   restarts on its root and address and rejoins; n1's replay drains the
   hints (rows and wall); n3's engine counts 4000 x 6 rows in the
   minute; K1 and K3 through n3 equal the oracle. (g)-(k) The cluster
   operations on the card (cluster_operations), in a database of their
   own, `ops` (1 h groups), whose moved group holds one TSBS minute of
   every host (24 000 points: cut from an hour, 1.44 M points, because
   the migration's wire is one JSON point at a time): the benchmark
   groups pinned by placement overrides; the minute through n1's
   /write; n4 joins the meta group and op=add registers it (SHOW
   CLUSTER lists four data nodes); op=move&dest=n4 and op=migrate stage
   the group on n4 (n1, the retained owner, holds the same digest and
   takes no push), commit it there (its committed marker) and drop it at
   its source (owners before and after, no staging left, the
   migration's points/s); n4 is named
   the group's primary and K1 over the minute through n1 takes n4's
   partials (kernel 3 on n4); rows rewritten in the other owner's copy
   alone make the content digests differ until op=antientropy on n4
   repairs the pair (K1 then shows them); with DataReplication attached
   to every router, the next minute through n1's /write answers 204
   once its owners' raft group committed it (read at the answer: the
   entry in the leader's log, committed, applied and matched by the
   follower, and in the follower's log; the leader's engine counts the
   rows, the follower's within a heartbeat); op=decommission on n4 drains its group back to owners
   among n1-n3 and leaves the roster (SHOW CLUSTER lists three; K1 over
   the minute equals numpy); no migrate_round moves a benchmark group.
   /internal/load is read through collect_loads (the balancer's input;
   balance_round is not driven: it could move a 1.44 M-point hour). (f)
   The three nodes flush, stop and reopen with device="cpu" on the same
   roots and addresses: K1 and K3 on n1, and K1 over ops, give the
   card's answers (counts, min, max, first, last and spread bit for
   bit, means and stddev within rel 1e-12). Each step's wall and the
   device memory peak print. `--phases 16` runs it alone.
17. The device mesh (ROADMAP A8.3) through the port's ts-server main,
   with a budget of its own (MESH_PHASE_S, 60 s), on phase 7's compacted
   root (no load of its own; `--phases 5,6,7,17` runs it on a fresh
   one). (a) server/app.build() from a TOML whose [device] section
   (mesh-axes = ["shard"]) lays a mesh over the visible cards, one
   shard on an H100; C1, C3 and B1 (Q4's selectors by host over the
   span's second hour: the bucketed layout, kernels 1 and 2) over HTTP,
   each against the oracle, C1 and C3 through the mesh's fused decode
   (kernel 3 once per shard); then PQ3 on phase 13's root through a
   second server built from the same TOML with the mesh turned off and
   on (_apply_mesh_config): the two answers equal within rel 1e-9, the
   mesh's through the sharded tiled kernels. (b) Four shards on the one
   card (runtime.set_mesh(make_mesh(4, devices=[cuda:0] * 4))) with the
   decoded-column cache's device tier on: C1 and C3 cold, each shard
   decoding its own rows (kernel 5 once per gorilla chunk of its plan,
   kernel 4 where its plan has FOR-delta blocks: none in the compacted
   C3 at 6 h, whose read_bytes is varint only) and kernel 3 once per
   shard, then warm (kernel 3 once per shard, neither 4 nor 5, and no
   mesh_h2d_bytes), B1 (kernels 1 and 2 once per shard per bucket),
   every answer equal to step (a)'s (means within rel 1e-9). (c) Hot
   reload through _apply_mesh_config: 4 shards -> 1 -> off -> 4, C1
   after each: the retained entry reshards in place (one reshard, its
   wall printed), the device tier's resident bytes do not grow, no
   decode and no mesh transfer, the answer equal. (d) Kernels 1-3 and 5
   at the shard shapes come back for the kernel checks after the
   phases. `[mesh]` lines print each query's p50 at 1 and 4 shards, its
   launches by kernel, mesh_h2d_bytes, the reshard walls and the ledger
   bytes. C2 is cut from the phase: 20 s a run on the card would take
   it past its budget (and after phase 6's row its answer holds a
   4001st series).
18. The edges (ROADMAP A9) through the port's ts-server main, with a
   budget of its own (EDGES_PHASE_S, 45 s), last, on phase 7's compacted
   root (`--phases 5,6,7,18` runs it on a fresh one). server/app.build()
   from a TOML with [data] enable-tag-array, [services] obs-dir
   (build/edges_bucket) and, where pyarrow.flight exists, [flight] on
   port 0. (a) Log mode at fleet width: POST /repo/fleet, the logstream
   app (a TTL), 15 minutes of ndjson from every TSBS host (one line each
   EDGE_STEP_S, 120 000 lines at 4000 hosts, in bodies of
   EDGE_BODY_LINES; cut from an hour, EDGE_LINES_PER_HOST) with the tags
   host, service and level (90/8/2%), a message from fixed templates and
   the fields latency_ms and status, flushed (the .tidx sidecars exist);
   L1 (full text "error AND timeout", every scroll page), L2 (histogram
   by minute), L3 (mean latency by service per 5 minutes), L4 (max
   latency by host), L5 (the context of one host's row) and L6
   (consume/cursor-time and consume/logs over the first minute), each
   twice against a numpy oracle (counts, extremes and rows exact, means
   rtol 1e-9) with its p50, stage split and launches; L3 and L4 must
   launch kernel 3 or 1 (count(content) takes the bucketed batch, kernel
   1, as the reference's does). (e) The root backed up (tools/backup.py)
   and restored into build/edges_restored; then DELETE of the logstream
   and the repository, and DELETE /query answers 404 JSON. (b) The
   object store: benchmark's group offloaded through
   engine.offload_shard (its wall and bytes), C1 and C3 over the span's
   first hour (force=device) hydrate it (the download's wall) and
   cold-decode it on the card (kernels 5 and 3 in C1, 3 in C3, whose
   compacted read_bytes is varint only), each equal to its answer before
   the offload; the group stays local after. (c) 4000 /write lines with
   host=[a,b,c] (12 000 points), GROUP BY host against the expanded
   oracle; Arrow Flight where pyarrow.flight exists (every host's value
   by DoPut, their count, max and sum by DoGet; a line says so where it
   does not); a restart that replays the WAL, the same answer. (d) SHOW
   STATS and SHOW DIAGNOSTICS answer; their section names print. (e)
   Engine(build/edges_restored) on the card answers L2 as before; the
   tag-array measurement is exported (tools/export.py) where pyarrow
   exists, its rows equal to the points, and a line says so where it
   does not. (f) /api/v1/consume over one minute of benchmark: the
   span's first minute of cpu written again as edge_cpu (the memtable; a
   consume page decodes every series from its cursor on, and the
   compacted file's packed chunks hold each series' whole span), the
   page against the oracle. Lockdep stays unarmed. `[edges]` lines print
   each step's wall.
19. The mesh across processes and cards (ROADMAP A8.4), with a budget
   of its own (MESHX_PHASE_S, 45 s), last, on phase 7's compacted root
   (`--phases 5,6,7,17,19`; a copy of the root for each rank after the
   first). One process of the port's ts-server main per visible card
   (CUDA_VISIBLE_DEVICES), each with the [device] keys
   coordinator-address, num-processes and process-id: one NCCL group,
   one global mesh, a shard a card. Each rank disarms its planner and
   forces the device decode; C1, C3 and B1 go to every rank at once, one
   query after the other, and every rank's answer must equal the oracle
   and phase 17's one-process answer. `[meshx]` lines print the world
   size, per rank and query the launches by kernel and the collectives'
   calls, bytes sent and wall (the rank's /debug/device mesh section),
   and per rank its local shards; every rank must issue as many
   collectives, launch kernel 3 in C1 and C3 and kernels 1 and 2 in B1,
   and C1 kernel 5 on some rank. On one card it is a world of one
   process: no byte crosses a card, and the group's init, the global
   mesh and every collective call still run.

The incremental result cache (OGT_RESULT_CACHE) is off in phases 3-9,
12, 13, 14, 15 and 16, so their repeated runs measure every execution;
phases 10 and 11 turn it on for their panels. The offload planner is
off in phases 3-11 and 13-16 (each disarms it through
/debug/ctrl?mod=offload&arm=0 at its start: every route is the static
gate's, so their launches per run are exact); phase 12 arms it. Phase 5
arms devobs for its transfer histogram (the decode's H2D bytes), and
phase 12 for the planner's walls. Launch counters start at 0 before
each main path (phases 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
18; phase 19's ranks count from their start)
and are read after it; the {"kernels": [...]} line sums them, with
launches_per_phase, launches_per_query and launches_parity_on_card.
`--phases` runs only the named phases after 2 (for a short call that
checks one path; 15 needs 13, 17, 18 and 19 need 5, 6 and 7); the
default runs all.

Cuts made (listed in PERF.md): for phases 13-15, to keep the script
within 1050 s, phase 3's span 12 h -> 6 h -> 4 h, phase 13's span 6 h
-> 2 h, C2's timed runs 3 -> 2 -> 1, phase 7's C1 and C3 3 -> 2, phase
8's lastpoint and groupby-orderby-limit 5 -> 2; for phase 16, to keep
it within 1100 s, in this order: phase 9's span 12 h -> 6 h
(SUBQUERY_HOURS), PQ runs 5 -> 3 (PROM_RUNS), phase 15's verified ticks
every tick -> the cold, the late, the last before the restart and the
first after it (RULES_VERIFY_TICKS), phase 12's C3 runs 8 -> 5
(PLANNER_RUNS) and phase 6's runs 4 -> 3 (CACHE_RUNS); for phase 16's
operations (its budget 75 s -> 100 s), phase 8's lastpoint and
groupby-orderby-limit 2 -> 1 (HOST_RUNS), phase 7's C1 and C3 2 -> 1
(COMPACT_RUNS), phase 5's C1 and C3 2 -> 1 (COLD_RUNS) and phase 6's
runs 3 -> 2 (CACHE_RUNS); then, the script having taken 1011.7-1167.3
s on an H100 against its 1200 s limit, the cold span of phases 5-10 and
12 12 h -> 6 h (COLD_HOURS; phase 10's panel 24 h -> 12 h and its slice
threshold with it, DASH_SLICE_ROWS), phase 9's span 6 h -> 4 h
(SUBQUERY_HOURS) and its budget 150 s -> 60 s (SUBQUERY_PHASE_S), so
that repeats do not take back what the spans give, and PQ runs 3 -> 2
(PROM_RUNS); for phase 17, C2 (its queries are C1, C3, B1 and PQ3) and
a second warm run at 4 shards; for phase 18, in this order, phase 16's
K runs 3 -> 1 (CLUSTER_RUNS), phase 13's PQ runs 2 -> 1 (PROM_RUNS),
phase 3's Q1, Q2 and Q4 runs 2 -> 1 (E2E_RUNS) and phase 14's dashboard
runs 3 -> 2 (CONT_DASH_RUNS), then phase 18's own span: 120 -> 30
log lines per host (EDGE_LINES_PER_HOST: an hour -> 15 minutes, all
4000 hosts).

Output: progress lines, then a {"kernels": [...]} line, the nvidia-smi
line, and last {"ok": true, "device": {...}}. Without CUDA (or without
the opengemini_tpu_torch package beside this file) it exits nonzero
before printing any result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.client import HTTPConnection

T0_NS = 1451606400 * 10**9  # 2016-01-01T00:00:00Z
STEP_NS = 10 * 10**9
FIELDS = ("usage_user", "usage_system", "usage_idle", "usage_nice",
          "usage_iowait", "usage_irq", "usage_softirq", "usage_steal",
          "usage_guest", "usage_guest_nice")
REGIONS = ("us-east-1", "us-west-1", "us-west-2", "eu-west-1",
           "eu-central-1", "ap-southeast-1", "ap-southeast-2",
           "ap-northeast-1", "sa-east-1")
MEAN_RTOL = 1e-9
KERNEL_RTOL = 1e-10
# kernel 1's ssd in f32: (x - mean)^2 rounds at each term, in another order
# than the plain version's, over up to 2048 terms (f32 epsilon 1.2e-7)
F32_SSD_RTOL = 1e-5
N_HOSTS = 4000
# the cold-scan span of phases 5-10 and 12: cut from 12 h to 6 h when the
# script, at 1011.7-1167.3 s on an H100, had outgrown its 1200 s limit
# (below about 6 h the byte gate keeps C1 on the host)
COLD_HOURS = 6
# H100 SXM peaks (NVIDIA data sheet): device memory bytes/s and fp64
# (non-tensor) flop/s
H100_PEAKS = (3.35e12, 34e12)
# the kernels' __global__ names in csrc/, as a profiler trace shows them
PORT_KERNELS = ("bucket_basic_kernel", "bucket_selectors_kernel",
                "grid_window_kernel", "widen_kernel", "unpack_bits_kernel",
                "probe_count_kernel")
REPLACES = {
    "bucket_stats_basic": "opengemini_tpu/ops/pallas_segment.py:143",
    "bucket_stats_selectors": "opengemini_tpu/ops/pallas_segment.py:274",
    "grid_window_agg": "opengemini_tpu/ops/pallas_segment.py:328",
    "widen_packed": "opengemini_tpu/ops/pallas_segment.py:360",
    "unpack_bits": "opengemini_tpu/ops/pallas_segment.py:393",
    "probe_count": "opengemini_tpu/utils/devobs.py:607",
}
# the memtable phase (3) and the cold-scan phase (5) each drive these
E2E_KERNELS = ("bucket_stats_basic", "bucket_stats_selectors",
               "grid_window_agg")
COLD_KERNELS = ("grid_window_agg", "widen_packed", "unpack_bits",
                "probe_count")
# timed runs of a query where not five: C2 takes about 20 s a run after
# an 80 s first one (NVIDIA H100 80GB HBM3 at 700 W); Q1, Q2 and Q4
# (phase 3) once (cut from 2 to pay for phase 18); C2 once (cut
# from 2 so that the script with phase 15 stays within 1050 s); C1 and
# C3 (phase 5, whose first-run walls they keep: phase 6 times them
# warm), phase 7's queries and phase 8's two slowest once each (cut
# from 2 to pay for phase 16's operations); phase 6 runs each query
# twice, a fill and a warm run (CACHE_RUNS, cut from 4 for phase 16's
# cluster, then from 3 for its operations)
COLD_RUNS = {"C1": 1, "C2": 1, "C3": 1}
E2E_RUNS = {"Q1": 1, "Q2": 1, "Q4": 1}
CACHE_RUNS = 2
COMPACT_RUNS = 1
HOST_RUNS = {"lastpoint": 1, "groupby-orderby-limit": 1}
# C1's gorilla chunks per run: its values (8.64 M at COLD_HOURS 6, 17.28 M
# at 12) in chunks of at most 2^20 (ops/device_decode._CHUNK_VALUES)
# whole blocks of 131072: 9 (17 at 12 h)
MAX_C1_CHUNKS = -(-N_HOSTS * COLD_HOURS * 360 // (1 << 20))
# phase 5's device-memory budget: a gorilla chunk's (2^20, 64) gather
# temporaries, a few at once, beside C2's five grids
COLD_PEAK_LIMIT = 6 << 30
# phase 6's cache budgets (MiB): the host tier holds C1's and C3's decoded
# chunk columns (times, sids, values; about 0.4 GiB each), the device tier
# their two (5680, 6, 384) grids of values and mask (118 MB each; 236 MB
# at 12 h)
CC_HOST_MB = 2048
CC_DEVICE_MB = 1024
# a warm device-tier run copies nothing to the card; allow for stray
# scalars
WARM_H2D_LIMIT = 1 << 20
# phase 6's new row: a usage_user value of a new series in C1's first
# window, above every generated one (0..100)
EXTRA_VALUE = 1000.0
# TSBS devops diskio (pkg/data/usecases/devops/diskio.go): monotonic
# counters, each step |N(mean, 1)|
DISKIO_FIELDS = (("reads", 50), ("writes", 50), ("read_bytes", 100),
                 ("write_bytes", 100), ("read_time", 5), ("write_time", 5),
                 ("io_time", 5))


def p50_of(walls) -> float:
    """The median of a query's timed runs; of an even count the lower
    middle (of two runs the faster, as a first run carries the one-off
    structural scans)."""
    return sorted(walls)[(len(walls) - 1) // 2]


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing and bounds --------------------------------------------------------


def time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` single launches, each between two CUDA events:
    the time a lone call costs, the wrapper's host work included."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 50) -> float:
    """Time per launch of `reps` launches back to back between two CUDA
    events: where the kernel outlasts its launch, the launches queue up
    and this is the kernel's own time on the card."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def peaks(name: str):
    if "H100" not in name:
        raise CheckFailed(f"no peak rates for {name!r}: the bounds are "
                          "for an H100")
    return H100_PEAKS


def bound(name: str, shape, n_valid: int, dev_name: str):
    """(bound_ms, bound_by): the larger of the least bytes the function
    must move (mask bytes, the masked-in values and times, the outputs)
    over the memory rate and its fp64 operations over the fp64 rate."""
    bw, flops = peaks(dev_name)
    if is_segmented(shape):  # a segment table: each row's bytes
        rows = shape[2]
        if name == "widen_packed":
            return sum(c * (w + 4) for _s, c, w in rows) / bw * 1e3, "bytes"
        return sum(33 * n for _s, n in rows) / bw * 1e3, "bytes"
    if name == "widen_packed":
        cnt, width = shape
        return cnt * (width + 4) / bw * 1e3, "bytes"
    if name == "unpack_bits":
        (nbytes,) = shape
        return nbytes * (1 + 32) / bw * 1e3, "bytes"
    if name == "probe_count":
        rows, cols = shape
        return rows * (cols + 4) / bw * 1e3, "bytes"
    if name == "grid_window_agg":
        s, k, w = shape
        cells, rows = s * k * w, s * w
        nbytes = cells + n_valid * 8 + rows * (4 + 4 * 8)
        ops = 5 * n_valid
    elif name == "bucket_stats_basic":
        g, w = shape
        cells, rows = g * w, g
        nbytes = cells + n_valid * 8 + rows * (4 + 5 * 8)
        ops = 8 * n_valid
    else:
        g, w = shape
        cells, rows = g * w, g
        nbytes = cells + n_valid * (8 + 4 + 4) + rows * (2 * 8 + 4 * 4) \
            + 6 * rows * 4
        ops = 8 * n_valid
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2/4: kernels against their plain versions -----------------------------


def _offset(t):
    """A contiguous copy of `t` that starts one element into its storage:
    no longer 16-byte aligned, so the kernels take their scalar path."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# the main path's layouts at 4000 hosts x 12 h, phase 5's span before its
# cut to 6 h, kept as the larger (models/grid.py _pad_rows
# and _pad_lanes; models/ragged.py pow2 rows of 1024): real rows and
# lanes of the grids, and samples per host of the bucket rows
PATH_LAYOUTS = {(5680, 6, 768): (4000, 720), (5680, 360, 16): (4000, 12),
                (32768, 1024): (4320,)}


def _adversarial(v, m, hi=None, lo=None, g=None):
    """Rows (grid: series) by class r % 11 on top of seeded values: a NaN
    at the would-be min (1), first (2), last (3) and max (4) of a row,
    masked-in +inf (5) and -inf (6) among the values, ties of -0.0 and
    0.0 at the min (7) and at the max (8), rows all +inf (9) or all -inf
    (10). Grid windows have no time, so classes 2 and 3 put a NaN in a
    masked-in and in a masked-out cell."""
    import torch

    inf = float("inf")
    rows = v.shape[0]
    cls = torch.arange(rows, device=v.device) % 11
    sel = lambda c: (cls == c).nonzero()[:, 0]  # noqa: E731
    rand = torch.rand(v.shape, generator=g, device=v.device)
    flat_v, flat_m = v.reshape(rows, -1), m.reshape(rows, -1)
    flat_r = rand.reshape(rows, -1)
    if hi is not None:
        key = hi.to(torch.int64) * (1 << 30) + lo.to(torch.int64)
        big = torch.iinfo(torch.int64).max
        at = {2: torch.where(m, key, big).argmin(1),
              3: torch.where(m, key, -big).argmax(1)}
    else:
        at = {2: (flat_m & (flat_r < 0.2)).to(torch.uint8).argmax(1),
              3: (~flat_m).to(torch.uint8).argmax(1)}
    at[1] = torch.where(flat_m, flat_v, inf).argmin(1)
    at[4] = torch.where(flat_m, flat_v, -inf).argmax(1)
    for c, cols in at.items():
        r = sel(c)
        flat_v[r, cols[r]] = float("nan")
    for c, x in ((5, inf), (6, -inf)):
        r = sel(c)
        flat_v[r] = torch.where(flat_r[r] < 0.1, x, flat_v[r])
    zeros = torch.where(flat_r < 0.15, -0.0, 0.0).to(v.dtype)
    for c, sign in ((7, 1.0), (8, -1.0)):
        r = sel(c)
        flat_v[r] = torch.where(flat_r[r] < 0.3, zeros[r], sign * flat_v[r])
    for c, x in ((9, inf), (10, -inf)):
        flat_v[sel(c)] = x


def _large_offset(v, g=None):
    """Rows with a large common offset: even rows 1e9 + N(0, 1) (a counter
    near 1e9), odd rows 1e15 + 256 k for integers k in [0, 10) (an
    epoch-like gauge). Steps of 256 keep every partial sum of up to 2048
    values (below 2^61) exact, so the mean is the same bits in any order
    of addition; with steps of 1 the row's sum rounds and the two-pass ssd
    itself moves with the order far beyond KERNEL_RTOL (the TPU kernel's
    too). A one-pass sum of squares loses the spread of both kinds of
    row."""
    import torch

    noise = torch.randn(v[0::2].shape, generator=g, device=v.device,
                        dtype=torch.float64)
    v[0::2] = 1e9 + noise
    k = torch.randint(0, 10, v[1::2].shape, generator=g, device=v.device)
    v[1::2] = 1e15 + 256.0 * k.to(torch.float64)


def make_inputs(kind: str, shape, seed: int, dtype: str = "f64",
                values: str = "random", mask: str = "random",
                offset: bool = False):
    """Seeded inputs on the card. values: "random" (in [0, 100),
    integer-valued (ties) on even rows), "adversarial" (NaN, +-inf and
    +-0 ties by row class, _adversarial) or "offset" (f64 rows with a
    large common offset, _large_offset); f32 values are whole numbers,
    so that every sum is exact in any order. mask: "random" (70%
    density, every 97th row empty), "prefix" (bucket rows: each row a
    prefix of random length, some empty and some full) or "path" (the
    main path's layout, PATH_LAYOUTS: a grid's real rows and lanes, a
    host's samples in rows of W). Buckets get few distinct times (time
    ties) on every third row. offset: every tensor starts one element
    into its storage (the scalar edge path)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rows, w = shape[0], shape[-1]
    v = torch.rand(shape, generator=g, device=dev, dtype=torch.float64) * 100
    v[::2] = torch.floor(v[::2] / 10)
    if dtype == "f32":
        v = torch.floor(v)
    m = torch.rand(shape, generator=g, device=dev) < 0.7
    m[::97] = False
    if mask == "prefix":
        n = torch.randint(0, w + 1, (rows, 1), generator=g, device=dev)
        n[::5] = 0
        n[1::5] = w
        m = torch.arange(w, device=dev)[None, :] < n
    elif mask == "path" and kind == "grid":
        real_rows, real_lanes = PATH_LAYOUTS[tuple(shape)]
        m = torch.zeros(shape, dtype=torch.bool, device=dev)
        m[:real_rows, :, :real_lanes] = True
    elif mask == "path":
        (per_host,) = PATH_LAYOUTS[tuple(shape)]
        sub = -(-per_host // w)
        hosts = min(rows // sub, 4000)
        n = torch.zeros(rows, dtype=torch.int64, device=dev)
        lens = torch.tensor([w] * (sub - 1) + [per_host - w * (sub - 1)],
                            device=dev)
        n[:hosts * sub] = lens.repeat(hosts)
        m = torch.arange(w, device=dev)[None, :] < n[:, None]
    x = {"m": m}
    if kind == "bucket":
        hi = torch.randint(0, 1 << 20, shape, generator=g, device=dev,
                           dtype=torch.int32)
        lo = torch.randint(0, 1 << 30, shape, generator=g, device=dev,
                           dtype=torch.int32)
        hi[::3] = torch.randint(0, 2, (hi[::3].shape[0], w), generator=g,
                                device=dev, dtype=torch.int32)
        lo[::3] = torch.randint(0, 3, (lo[::3].shape[0], w), generator=g,
                                device=dev, dtype=torch.int32)
        x.update(hi=hi, lo=lo, idx=torch.randint(
            0, 1 << 30, shape, generator=g, device=dev, dtype=torch.int32))
    if values == "adversarial":
        _adversarial(v, m, x.get("hi"), x.get("lo"), g)
    elif values == "offset":
        _large_offset(v, g)
    x["v"] = v.float() if dtype == "f32" else v
    if offset:
        x = {k: _offset(t) for k, t in x.items()}
    return x


EXACT = {"count", "min", "max", "first", "last", "sel_first", "sel_last",
         "sel_min", "sel_max"}


def compare(name: str, got: dict, want: dict) -> float:
    """Exact keys equal, float sums within KERNEL_RTOL (an f32 ssd within
    F32_SSD_RTOL); returns the max absolute error over all outputs."""
    import torch

    err = 0.0
    check(set(got) == set(want), f"{name}: outputs {sorted(got)} != {sorted(want)}")
    for key in want:
        a, b = got[key], want[key]
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}.{key}: {a.shape}/{a.dtype} != {b.shape}/{b.dtype}")
        if key in EXACT:
            same = torch.equal(a, b) if not a.is_floating_point() else bool(
                ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
            check(same, f"{name}.{key} differs from the plain version")
        else:  # equal where not finite (inf, NaN), else within rtol
            rtol = F32_SSD_RTOL if key == "ssd" and a.dtype == torch.float32 \
                else KERNEL_RTOL
            tol = rtol * torch.maximum(a.abs(), b.abs()) + 1e-300
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            check(bool((same | ((a - b).abs() <= tol)).all()),
                  f"{name}.{key} beyond rtol {rtol}")
        if a.numel():
            d = (a.double() - b.double()).abs()
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
            err = max(err, float(d.max()))
    return err


def decode_inputs(name: str, shape, seed: int, zero_mask: bool = False):
    """Seeded inputs of kernels 4-6 on the card: every byte value occurs
    in a widen input; probe masks are random in {-2..2} (or all zero).
    A segmented shape gives a payload of its length and its table."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if is_segmented(shape):  # the payload's bytes and the table
        _tag, nraw, rows = shape
        raw = torch.randint(0, 256, (nraw,), generator=g, device="cuda",
                            dtype=torch.uint8)
        k = min(256, nraw)
        raw[:k] = torch.arange(k, device="cuda", dtype=torch.uint8)
        return (raw, np.array(rows, np.int64).reshape(len(rows), -1))
    if name == "widen_packed":
        cnt, width = shape
        raw = torch.randint(0, 256, (cnt * width,), generator=g,
                            device="cuda", dtype=torch.uint8)
        k = min(256, raw.numel())
        raw[:k] = torch.arange(k, device="cuda", dtype=torch.uint8)
        return (raw, width, cnt)
    if name == "unpack_bits":
        (nbytes,) = shape
        return (torch.randint(0, 256, (nbytes,), generator=g, device="cuda",
                              dtype=torch.uint8), nbytes)
    m = torch.randint(-2, 3, shape, generator=g, device="cuda",
                      dtype=torch.int8)
    return (torch.zeros_like(m) if zero_mask else m,)


def library_call(name: str, args):
    """The one PyTorch call that computes a kernel's function, or None:
    widen_packed is a conversion at width 1 and a uint16 view plus a
    conversion at width 2; probe_count is torch.count_nonzero(m, dim=1)
    (the same counts as int64 of shape (R,), where the kernel gives int32
    (R, 1)); unpack_bits has none."""
    import torch

    if name == "probe_count":
        (m,) = args
        return lambda: torch.count_nonzero(m, dim=1)
    if name != "widen_packed" or len(args) != 3:
        return None
    raw, width, _cnt = args
    if width == 1:
        return lambda: raw.to(torch.int32)
    return lambda: raw.view(torch.uint16).to(torch.int32)


def decode_kernel_case(name: str, shape, seed: int, dev_name: str,
                       timed: bool, zero_mask: bool = False):
    """Kernels 4-6 against their plain versions, exactly."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    args = decode_inputs(name, shape, seed, zero_mask)
    entry = name + "_segments" if is_segmented(shape) else name
    run = lambda: getattr(cs, entry)(*args)  # noqa: E731
    plain = lambda: getattr(cs, entry + "_plain")(*args)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype
          and torch.equal(got, want),
          f"{name}{shape_label(name, shape)} differs from the plain version")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    b_ms, b_by = bound(name, shape, 0, dev_name)
    rec = {"shape": shape_json(name, shape), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        rec["ms"] = time_ms(run)
        rec["device_ms"] = device_ms(run)
        rec["plain_ms"] = time_ms(plain, reps=5)
        rec["library_ms"] = None
        lib = library_call(name, args)
        if (lib is None and name == "widen_packed" and is_segmented(shape)
                and all(w == 2 for _s, _c, w in shape[2])):
            # a plan of width-2 segments only: the library call on one
            # contiguous payload of as many values
            n = sum(c for _s, c, _w in shape[2])
            flat = decode_inputs(name, (n, 2), seed + 1)
            lib = library_call(name, flat)
            check(torch.equal(lib(), cs.widen_packed_plain(*flat)),
                  f"{name}({n}, 2): the library call differs from the "
                  "plain version")
            rec["library_ms"] = time_ms(lib)
            rec["library_device_ms"] = device_ms(lib)
            rec["library_on"] = (f"one contiguous payload of {n} "
                                 "width-2 values")
            lib = None
        if lib is not None:  # it computes the same values, then its times
            check(torch.equal(lib().reshape(-1).to(torch.int64),
                              want.reshape(-1).to(torch.int64)),
                  f"{name}{shape_label(name, shape)}: the library call "
                  "differs from the plain version")
            rec["library_ms"] = time_ms(lib)
            rec["library_device_ms"] = device_ms(lib)
    del args, got, want
    torch.cuda.empty_cache()
    return rec


def kernel_case(name: str, shape, seed: int, dev_name: str, timed: bool,
                **kinds):
    """Kernels 1-3 against their plain versions on make_inputs(shape,
    seed, **kinds); timed: lone and back-to-back ms of the kernel, the
    plain version's ms."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    if name in ("widen_packed", "unpack_bits", "probe_count"):
        return decode_kernel_case(name, shape, seed, dev_name, timed)
    x = make_inputs("grid" if name == "grid_window_agg" else "bucket",
                    shape, seed, **kinds)
    if name == "bucket_stats_selectors":
        args = (x["v"], x["hi"], x["lo"], x["idx"], x["m"])
    else:
        args = (x["v"], x["m"])
    run = lambda: getattr(cs, name)(*args)  # noqa: E731
    plain = lambda: getattr(cs, name + "_plain")(*args)  # noqa: E731
    got = run()
    want = plain()
    torch.cuda.synchronize()
    err = compare(f"{name}{tuple(shape)} {kinds or ''}", got, want)
    n_valid = int(x["m"].sum())
    b_ms, b_by = bound(name, shape, n_valid, dev_name)
    rec = {"shape": list(shape), "max_abs_err": err, "bound_ms": b_ms,
           "bound_by": b_by, **kinds}
    if timed:
        rec["ms"] = time_ms(run)
        rec["device_ms"] = device_ms(run)
        rec["plain_ms"] = time_ms(plain, reps=5)
    del x, got, want
    torch.cuda.empty_cache()
    return rec


# phase 2: every bucket width of the ladder (models/ragged.py WIDTHS) at
# a large row count, the 4000-host Q4 shape, and the unpadded Q1/Q2 grids
CHECK_SHAPES = {
    "bucket_stats_basic": [(131072, 16), (131072, 64), (131072, 256),
                           (32768, 1024)],
    "bucket_stats_selectors": [(131072, 16), (131072, 64), (131072, 256),
                               (32768, 1024)],
    "grid_window_agg": [(4000, 6, 720), (4000, 360, 12)],
    # odd counts; every byte value occurs (decode_inputs); (131399, 2) is
    # the largest block of the cold phase's FOR-delta column
    "widen_packed": [(1, 1), (257, 1), (131071, 1), (1, 2), (257, 2),
                     (131071, 2), (131399, 2), (1_000_001, 2)],
    "unpack_bits": [(1,), (7,), (8,), (8 << 20,)],
    "probe_count": [(8, 8), (1000, 37)],
}


def segment_tables(name: str, seed: int) -> dict:
    """Phase 2's segment tables of the segmented kernels 4 and 5, as
    ("segments", payload bytes, rows) shapes: one segment and 256, empty
    segments, odd source offsets, widths 1 and 2 mixed (widen), single
    bytes and a chunk of eight C1-sized gorilla blocks (unpack)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def laid_out(lens, widths=None):
        """Rows laid out in order, each after an odd gap."""
        rows, off = [], 1
        for r, n in enumerate(lens):
            n = int(n)
            if widths is None:
                rows.append((off, n))
                off += n + 2 * int(rng.integers(0, 8)) + 1
            else:
                w = int(widths[r])
                rows.append((off, n, w))
                off += n * w + 2 * int(rng.integers(0, 8)) + 1
        return ("segments", off, tuple(rows))

    if name == "widen_packed":
        lens = rng.integers(0, 2000, 256)
        lens[::17] = 0
        lens[5::23] = 1
        return {
            "1 segment": laid_out([131399], [2]),
            "256 segments, widths 1 and 2, empty and single": laid_out(
                lens, rng.integers(1, 3, 256)),
            "empty segments only": laid_out([0, 0, 0], [1, 2, 1]),
            "widths alternating": laid_out([3, 4, 5, 6, 7, 8, 9],
                                           [1, 2, 1, 2, 1, 2, 1]),
        }
    lens = rng.integers(0, 5000, 256)
    lens[::13] = 0
    lens[3::11] = 1
    return {
        "1 segment": laid_out([981621]),
        "256 segments, empty and single": laid_out(lens),
        "single bytes": laid_out([1] * 200),
        "empty segments only": laid_out([0, 0]),
        "C1 chunk (8 blocks)": laid_out(rng.integers(690_000, 700_000, 8)),
    }


def adversarial_cases() -> list:
    """(kernel, shape, make_inputs kinds) of phase 2's adversarial checks:
    grids at every W in (1, 12, 13, 33, 720, 2048) and K in (1, 2, 361)
    with S = 37 (no multiple of a CTA's rows), bucket rows at those W and
    the ladder's (16, 64, 256, 1024) with G = 1037; f64 and f32 (whole
    numbers; kernel 1's f32 ssd within F32_SSD_RTOL), aligned and offset
    views, random, prefix and the main path's padded masks; kernel 1 also
    on rows with a large common offset (_large_offset)."""
    adv = {"values": "adversarial"}
    cases = []
    for w in (1, 12, 13, 33, 720, 2048):
        for k in (1, 2, 361):
            cases += [("grid_window_agg", (37, k, w), adv),
                      ("grid_window_agg", (37, k, w), {**adv, "dtype": "f32"}),
                      ("grid_window_agg", (37, k, w), {**adv, "offset": True})]
    for shape in PATH_LAYOUTS:
        if len(shape) == 3:
            cases.append(("grid_window_agg", shape, {**adv, "mask": "path"}))
    for w in (1, 12, 13, 16, 33, 64, 256, 720, 1024, 2048):
        for name in ("bucket_stats_basic", "bucket_stats_selectors"):
            cases += [(name, (1037, w), adv),
                      (name, (1037, w), {**adv, "mask": "prefix"}),
                      (name, (1037, w), {**adv, "offset": True})]
        for name in ("bucket_stats_basic", "bucket_stats_selectors"):
            cases.append((name, (1037, w),
                          {**adv, "mask": "prefix", "dtype": "f32"}))
        cases += [("bucket_stats_basic", (1037, w), {"values": "offset"}),
                  ("bucket_stats_basic", (1037, w),
                   {"values": "offset", "mask": "prefix"})]
    for name in ("bucket_stats_basic", "bucket_stats_selectors"):
        cases.append((name, (32768, 1024), {**adv, "mask": "path"}))
    return cases


# kernels 1-3 at the main path's shapes with the main path's masks
PATH_CASES = (((5680, 6, 768), "grid_window_agg"),
              ((5680, 360, 16), "grid_window_agg"),
              ((32768, 1024), "bucket_stats_selectors"),
              ((32768, 1024), "bucket_stats_basic"))


def separate_outputs_call(name: str, args):
    """The wrapper of kernel 1, 2 or 3 with one allocation per output in
    place of its one output buffer: the same checks and launch, one
    torch.empty per output."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    v, dev = args[0], args[0].device

    def call():
        if name == "grid_window_agg":
            cs._check(name, v, mask=args[1], dim=3)
        elif name == "bucket_stats_basic":
            cs._check(name, v, mask=args[1])
        else:
            cs._check(name, v, ints=args[1:4], mask=args[4])
        cs._require_cuda_or_cpu(name, v)
        lib, fn = cs._entry(name, v.dtype)
        if name == "grid_window_agg":
            s_dim, k, w = v.shape
            cnt = torch.empty((s_dim, w), dtype=torch.int32, device=dev)
            outs = [torch.empty((s_dim, w), dtype=v.dtype, device=dev)
                    for _ in range(4)]
            cs._launch(name, fn, lib, dev, v.data_ptr(), args[1].data_ptr(),
                       s_dim, k, w, cnt.data_ptr(),
                       *(o.data_ptr() for o in outs))
            return cnt, outs
        g, w = v.shape
        if name == "bucket_stats_basic":
            cnt = torch.empty(g, dtype=torch.int32, device=dev)
            outs = [torch.empty(g, dtype=v.dtype, device=dev)
                    for _ in range(5)]
            cs._launch(name, fn, lib, dev, v.data_ptr(), args[1].data_ptr(),
                       g, w, cnt.data_ptr(), *(o.data_ptr() for o in outs))
            return cnt, outs
        vals = [torch.empty(g, dtype=v.dtype, device=dev) for _ in range(2)]
        sels = [torch.empty(g, dtype=torch.int32, device=dev)
                for _ in range(4)]
        cs._launch(name, fn, lib, dev, *(a.data_ptr() for a in args), g, w,
                   *(o.data_ptr() for o in vals + sels))
        return vals, sels
    return call


def one_buffer_against_separate(seed: int) -> dict:
    """Kernels 1-3 at the main path's shapes: lone-launch ms and host us
    per call of the wrapper (one output buffer) against the same launch
    with one allocation per output, in turns."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    out = {}
    for i, (shape, name) in enumerate(PATH_CASES):
        x = make_inputs("grid" if len(shape) == 3 else "bucket", shape,
                        seed + 450 + i)
        args = ((x["v"], x["hi"], x["lo"], x["idx"], x["m"])
                if name == "bucket_stats_selectors" else (x["v"], x["m"]))
        one = lambda: getattr(cs, name)(*args)  # noqa: E731
        sep = separate_outputs_call(name, args)
        rec = {"shape": list(shape), "ms": time_ms(one),
               "separate_ms": time_ms(sep), "host_us": host_us(one, 200),
               "separate_host_us": host_us(sep, 200)}
        rec["ms_2"], rec["separate_ms_2"] = time_ms(one), time_ms(sep)
        out[f"{name}{tuple(shape)}"] = rec
        log(f"[kernel] {name}{tuple(shape)} one output buffer against one "
            f"allocation per output: lone ms {rec['ms']:.4f} / "
            f"{rec['ms_2']:.4f} vs {rec['separate_ms']:.4f} / "
            f"{rec['separate_ms_2']:.4f}; host per call "
            f"{rec['host_us']:.2f} vs {rec['separate_host_us']:.2f} us")
        del x, args
        torch.cuda.empty_cache()
    return out


def host_us(fn, calls: int = 1000) -> float:
    """Host time of one call, in microseconds: `calls` calls enqueued
    back to back (no synchronisation between them) over perf_counter."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def probe_host_stages(seed: int, calls: int = 1000, rounds: int = 5) -> dict:
    """Where a lone call of kernel 6's wrapper spends its host time, at
    (8, 8): each stage of cuda_segment.probe_count alone, `calls` calls
    each over perf_counter (host_us), beside the whole wrapper and
    torch.count_nonzero; `rounds` rounds in turns, the median of each
    (and the spread of the wrapper's). The stages repeat the wrapper's
    statements: the checks, the output's torch.empty, the device and
    stream lookup of _launch, the ctypes call with its argument
    conversion (which holds cudaLaunchKernel and cudaGetLastError; these
    launches count nowhere) and the launch counter (on a copy); `loop` is
    the empty call."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    name = "probe_count"
    (m,) = decode_inputs(name, (8, 8), seed)
    lib, fn = cs._entry(name)
    rows, cols = m.shape
    out = torch.empty((rows, 1), dtype=torch.int32, device=m.device)
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    counts = dict(cs.LAUNCHES)

    def checks():
        if m.dtype != torch.int8 or m.dim() != 2:
            raise TypeError(name)
        if not m.is_contiguous():
            raise ValueError(name)
        cs._require_cuda_or_cpu(name, m)

    def device_stream():
        cur = torch._C._cuda_getDevice()
        if m.device.index is None or m.device.index == cur:
            return torch._C._cuda_getCurrentRawStream(cur)
        return None

    def counter():
        counts[name] += 1

    stages = {
        "loop": lambda: None,
        "checks": checks,
        "entry": lambda: cs._entry(name),
        "output": lambda: torch.empty((rows, 1), dtype=torch.int32,
                                      device=m.device),
        "device_stream": device_stream,
        "ctypes_call": lambda: fn(m.data_ptr(), rows, cols, out.data_ptr(),
                                  stream),
        "counter": counter,
        "wrapper": lambda: cs.probe_count(m),
        "count_nonzero": lambda: torch.count_nonzero(m, dim=1),
    }
    runs = {k: [] for k in stages}
    for _ in range(rounds):
        for k, f in stages.items():
            runs[k].append(host_us(f, calls))
    got = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    parts = ("checks", "entry", "output", "device_stream", "ctypes_call",
             "counter")
    got["stages_sum"] = sum(got[k] for k in parts)
    got["wrapper_runs"] = runs["wrapper"]
    got["count_nonzero_runs"] = runs["count_nonzero"]
    log(f"[kernel] probe_count(8, 8) host us per call (median of {rounds} "
        f"rounds in turns, {calls} calls each, not synced): "
        + ", ".join(f"{k} {got[k]:.2f}" for k in stages)
        + f", stages_sum {got['stages_sum']:.2f}; wrapper runs "
        + ", ".join(f"{x:.2f}" for x in runs["wrapper"]))
    return got


def probe_against_floor(seed: int, reps: int = 50,
                        back_to_back: int = 200) -> dict:
    """Kernel 6 at (8, 8) beside the launch floor: the ms of a lone call
    (time_ms, median of `reps`) and of a call back to back (device_ms,
    `back_to_back` calls) of its wrapper (cuda_segment.probe_count), of
    its ctypes entry point alone (ogt_probe_count), of the empty kernel
    its library holds (ogt_probe_empty, through the same ctypes
    binding: what any launch costs) and of torch.count_nonzero(m, dim=1).
    The entry point's counts are checked against the plain version; these
    launches count nowhere."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    (m,) = decode_inputs("probe_count", (8, 8), seed)
    lib, fn = cs._entry("probe_count")
    rows, cols = m.shape
    out = torch.full((rows, 1), -1, dtype=torch.int32, device=m.device)
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    calls = {
        "wrapper": lambda: cs.probe_count(m),
        "entry": lambda: fn(m.data_ptr(), rows, cols, out.data_ptr(),
                            stream),
        "empty": lambda: lib.ogt_probe_empty(stream),
        "count_nonzero": lambda: torch.count_nonzero(m, dim=1),
    }
    check(calls["entry"]() == 0 and calls["empty"]() == 0,
          "probe_count's entry points did not launch")
    torch.cuda.synchronize()
    check(torch.equal(out, cs.probe_count_plain(m)),
          "ogt_probe_count differs from the plain version")
    got = {k: {"ms": time_ms(f, reps), "device_ms": device_ms(f, back_to_back)}
           for k, f in calls.items()}
    log("[kernel] probe_count(8, 8) against the launch floor, ms lone / "
        "back to back: " + ", ".join(
            f"{k} {v['ms']:.4f} / {v['device_ms']:.4f}"
            for k, v in got.items()))
    return got


def phase_kernels(dev_name: str, seed: int) -> dict:
    results = {}
    for i, (name, shapes) in enumerate(CHECK_SHAPES.items()):
        results[name] = []
        for j, shape in enumerate(shapes):
            rec = kernel_case(name, shape, seed + 100 * i + j, dev_name,
                              timed=True)
            results[name].append(rec)
            log(f"[kernel] {name}{tuple(shape)} ok max_abs_err="
                f"{rec['max_abs_err']:.3e} ms={rec['ms']:.4f} "
                f"plain_ms={rec['plain_ms']:.4f} "
                f"bound_ms={rec['bound_ms']:.4f}"
                + (f" library_ms={rec['library_ms']:.4f} (back to back "
                   f"{rec['library_device_ms']:.4f}; device_ms "
                   f"{rec['device_ms']:.4f})"
                   if rec.get("library_ms") is not None else ""))
    for name, shape, kinds in adversarial_cases():
        kernel_case(name, shape, seed + 300, dev_name, timed=False, **kinds)
    log(f"[kernel] kernels 1-3 match their plain versions on "
        f"{len(adversarial_cases())} adversarial cases (NaN at the would-be "
        "min, max, first and last; masked-in +-inf; +-0 ties; empty, "
        "prefix and padded masks; W in 1, 12, 13, 33, 720, 2048; K in 1, "
        "2, 361; f32; offset views; kernel 1 on rows at 1e9 and 1e15)")
    for i, (shape, name) in enumerate(PATH_CASES):
        rec = kernel_case(name, shape, seed + 400 + i, dev_name, timed=True,
                          mask="path")
        results[name].append(rec)
        log(f"[kernel] {name}{tuple(shape)} main-path mask ok ms="
            f"{rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.4f} (masked-in values only)")
    results["one_buffer"] = one_buffer_against_separate(seed)
    results["probe_host"] = probe_host_stages(seed)
    results["probe_floor"] = probe_against_floor(seed)
    for shape in CHECK_SHAPES["probe_count"]:  # an all-zero mask counts 0
        decode_kernel_case("probe_count", shape, seed, dev_name, timed=False,
                           zero_mask=True)
        log(f"[kernel] probe_count{shape} all-zero mask ok")
    for i, name in enumerate(ENTRIES):
        for j, (what, shape) in enumerate(
                segment_tables(name, seed + 50 + i).items()):
            rec = decode_kernel_case(name, shape, seed + 500 + 10 * i + j,
                                     dev_name, timed=True)
            results[name].append(rec)
            log(f"[kernel] {name}_segments {what} {tuple(rec['shape'])} ok "
                f"(exact) ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
                f"plain_ms={rec['plain_ms']:.4f} "
                f"bound_ms={rec['bound_ms']:.4f}")
    results["widen_host"] = widen_against_library(seed)
    return results


def widen_against_library(seed: int) -> dict:
    """Kernel 4 at one segment against the one PyTorch call that computes
    it, at both widths: CUDA-event ms of single launches and the host
    time of a call (the wrapper's checks, allocation and launch)."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs

    out = {}
    for shape in ((131399, 2), (131071, 1)):
        args = decode_inputs("widen_packed", shape, seed)
        run = lambda: cs.widen_packed(*args)  # noqa: E731
        lib = library_call("widen_packed", args)
        rec = {"shape": list(shape), "ms": time_ms(run),
               "library_ms": time_ms(lib), "device_ms": device_ms(run),
               "library_device_ms": device_ms(lib), "host_us": host_us(run),
               "library_host_us": host_us(lib)}
        rec["ratio"] = rec["ms"] / rec["library_ms"]
        out[f"{shape[0]}x{shape[1]}"] = rec
        call = "raw.to(int32)" if shape[1] == 1 else \
            "raw.view(uint16).to(int32)"
        log(f"[kernel] widen_packed{shape} against {call}"
            f": ms {rec['ms']:.4f} vs {rec['library_ms']:.4f} (ratio "
            f"{rec['ratio']:.3f}); back to back {rec['device_ms']:.4f} vs "
            f"{rec['library_device_ms']:.4f} ms; host per call "
            f"{rec['host_us']:.2f} us vs "
            f"{rec['library_host_us']:.2f} us (1000 calls, not synced)")
        del args
        torch.cuda.empty_cache()
    return out


# -- phase 3: end to end ---------------------------------------------------


def host_tags(n_hosts: int, rng):
    """The 10 TSBS cpu tags per host, as sorted (key, value) tuples."""
    out = []
    for h in range(n_hosts):
        region = REGIONS[int(rng.integers(len(REGIONS)))]
        tags = {
            "hostname": f"host_{h}",
            "region": region,
            "datacenter": f"{region}{'abc'[int(rng.integers(3))]}",
            "rack": str(int(rng.integers(100))),
            "os": ("Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10")[
                int(rng.integers(3))],
            "arch": ("x64", "x86")[int(rng.integers(2))],
            "team": ("SF", "NYC", "LON", "CHI")[int(rng.integers(4))],
            "service": str(int(rng.integers(20))),
            "service_version": str(int(rng.integers(2))),
            "service_environment": ("production", "staging", "test")[
                int(rng.integers(3))],
        }
        out.append(tuple(sorted(tags.items())))
    return out


def make_values(n_hosts: int, n_t: int, rng):
    """Per field a (hosts, samples) float64 random walk held in [0, 100]
    (the TSBS cpu field model)."""
    import numpy as np

    vals = {}
    for f in FIELDS:
        start = rng.random((n_hosts, 1)) * 100.0
        steps = rng.normal(0.0, 1.0, (n_hosts, n_t))
        steps[:, 0] = 0.0
        vals[f] = np.clip(start + np.cumsum(steps, axis=1), 0.0, 100.0)
    return vals


def http(port: int, method: str, path: str, params: dict, body: bytes = b""):
    url = f"http://127.0.0.1:{port}{path}?{urllib.parse.urlencode(params)}"
    req = urllib.request.Request(url, data=body if method == "POST" else None,
                                 method=method)
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        return r.status, (json.loads(data) if data else None)


# one HTTP/1.1 connection per server port, kept alive across the
# queries as a client library keeps it
_CONNS: dict = {}


def stop_server(svc, engine) -> None:
    """Close this script's connection to `svc`, stop it, close `engine`."""
    conn = _CONNS.pop(svc.port, None)
    if conn is not None:
        conn.close()
    svc.stop()
    engine.close()


def query_timed(port: int, q: str, method: str = "GET"
                ) -> tuple[dict, float, float]:
    """(result, request ms, wall ms) of one /query on the kept-alive
    connection: the request ends with the answer's last byte, the wall
    after its JSON decode and a synchronize (what a p50 times). A
    statement that writes (SELECT INTO) goes by POST."""
    import torch

    conn = _CONNS.get(port)
    if conn is None:
        conn = _CONNS[port] = HTTPConnection("127.0.0.1", port,
                                             timeout=600)
    path = "/query?" + urllib.parse.urlencode(
        {"db": "benchmark", "q": q, "epoch": "ns"})
    t0 = time.perf_counter()
    conn.request(method, path)
    r = conn.getresponse()
    status, data = r.status, r.read()
    t1 = time.perf_counter()
    check(status == 200, f"/query status {status}")
    res = json.loads(data)["results"][0]
    check("error" not in res, f"query error: {res.get('error')}")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return res, (t1 - t0) * 1e3, (t2 - t0) * 1e3


def query(port: int, q: str) -> dict:
    return query_timed(port, q)[0]


def http_raw(port: int, method: str, path: str, params: dict,
             body: bytes = b""):
    """(status, headers, body bytes) of one request, error answers
    included."""
    url = f"http://127.0.0.1:{port}{path}?{urllib.parse.urlencode(params)}"
    req = urllib.request.Request(url, data=body if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


# a query's stages in order: the HTTP request's headers and parameters,
# the SQL parse, the executor's spans and its aggregate plan
# (query/executor.py) and the answer's JSON and write (server/http.py)
STAGES = ("request", "parse", "map_shards", "plan", "scan", "colcache",
          "device_compute", "host_compute", "show", "render", "encode")
# the stages must cover this share of a query's request wall (to the
# answer's last byte); the rest is the HTTP transport
STAGE_COVER = 0.9


def stage_ns(port: int) -> dict:
    """The server's cumulative query stage counters (/debug/vars)."""
    status, doc = http(port, "GET", "/debug/vars", {})
    check(status == 200, f"/debug/vars status {status}")
    return doc.get("query_stages", {})


def stage_split(port: int, before: dict, walls: list, qn: str,
                extra: tuple = (), after: dict | None = None) -> dict:
    """Each stage's ms over the runs since `before` (the /debug/vars
    deltas to `after`, by default the counters now), the rest of their
    request walls (`walls`) as `other`, the stage that took the most and
    the share of the walls the stages cover (main() checks every query's
    share against STAGE_COVER once all phases ran). The `extra` spans
    print beside them: they nest around the stages, so they count in no
    share."""
    if after is None:
        after = stage_ns(port)
    wall = sum(walls)
    ms = {st: (after.get(f"{st}_ns", 0) - before.get(f"{st}_ns", 0)) / 1e6
          for st in (*STAGES, *extra)}
    covered = sum(ms[st] for st in STAGES)
    ms["other"] = wall - covered
    top = max(STAGES, key=ms.get)
    log(f"[stages] {qn} over {len(walls)} requests ({wall:.1f} ms): "
        + ", ".join(f"{st} {ms[st]:.1f}" for st in (*STAGES, "other"))
        + f" ms; most: {top} ({100 * ms[top] / wall:.1f}% of the wall); "
        f"the stages cover {100 * covered / wall:.1f}%"
        + ("; around them " + ", ".join(f"{st} {ms[st]:.1f} ms"
                                        for st in extra) if extra else ""))
    return dict(ms, wall_ms=wall, most=top, covered=covered / wall)


def explain_analyze(port: int, qn: str, q: str) -> list:
    """EXPLAIN ANALYZE of one query, printed; checks the stage spans."""
    status, doc = http(port, "GET", "/query", {
        "db": "benchmark", "q": "EXPLAIN ANALYZE " + q})
    check(status == 200, f"EXPLAIN ANALYZE {qn} status {status}")
    res = doc["results"][0]
    check("error" not in res, f"EXPLAIN ANALYZE {qn}: {res.get('error')}")
    lines = [row[0] for row in res["series"][0]["values"]]
    for line in lines:
        log(f"[explain] {qn} {line}")
    names = {line.strip().rsplit(": ", 1)[0] for line in lines}
    for st in ("map_shards", "scan", "device_compute", "render"):
        check(st in names, f"EXPLAIN ANALYZE {qn}: no {st} span")
    return lines


class Counted:
    """Counts the calls of module.name (and those that return None)
    while it is entered."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.original = getattr(module, name)
        self.calls = self.nones = 0

    def __enter__(self):
        def counted(*args, **kw):
            self.calls += 1
            out = self.original(*args, **kw)
            self.nones += out is None
            return out

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def close(a, b, rtol=MEAN_RTOL) -> bool:
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(a),
                                                          np.abs(b))))


def merged_ms(spans) -> float:
    """Length of the union of (start, end) microsecond spans, in ms."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


# runtime calls that put one activity (kernel, copy, memset) on the device
DEVICE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
                "cudaMemcpy", "cudaMemsetAsync", "cudaMemset")


def device_time(events, start: float, end: float) -> dict:
    """Device activity that a run between host times start and end (us,
    the trace's clock) put on the card, from torch.profiler's chrome
    trace events. `missing` counts the run's runtime calls whose device
    activity the trace lacks (0 when the trace is complete)."""
    busy, kernels, copies = [], [], {"HtoD": [], "DtoH": []}
    nbytes = {"HtoD": 0, "DtoH": 0}
    port_ms = other_ms = 0.0
    calls, seen = set(), set()
    for e in events:
        if e.get("ph") != "X":
            continue
        ts = float(e["ts"])
        span = (ts, ts + float(e.get("dur", 0)))
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        if cat == "cuda_runtime" and name in DEVICE_CALLS:
            if start <= ts <= end:
                calls.add(corr)
            continue
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if not start <= ts <= end:
            continue
        seen.add(corr)
        busy.append(span)
        ms = (span[1] - span[0]) / 1e3
        if cat == "kernel":
            kernels.append(span)
            if any(k in name for k in PORT_KERNELS):
                port_ms += ms
            else:
                other_ms += ms
        for way in copies:
            if cat == "gpu_memcpy" and way in name:
                copies[way].append(span)
                nbytes[way] += int(e.get("args", {}).get("bytes", 0))
    return {"busy_ms": merged_ms(busy), "kernel_ms": merged_ms(kernels),
            "kernels": len(kernels), "port_kernel_ms": port_ms,
            "other_kernel_ms": other_ms,
            "h2d_ms": merged_ms(copies["HtoD"]), "h2d_bytes": nbytes["HtoD"],
            "d2h_ms": merged_ms(copies["DtoH"]), "d2h_bytes": nbytes["DtoH"],
            "device_calls": len(calls), "missing": len(calls - seen)}


def traced_queries(port: int, queries: dict, trace_path: str,
                   run=None) -> dict:
    """One more run of each query, all in one torch.profiler session (CPU
    and CUDA activity), each inside a user annotation on this thread;
    returns per query its result, wall ms, launches and device time.
    `run(port, q)` makes the request (default: an InfluxQL /query)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from opengemini_tpu_torch.ops import cuda_segment as cs

    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a session's first device records can go missing from the trace:
        # let small copies and kernels take them
        for _ in range(32):
            torch.ones(8, device="cuda").add_(1).cpu()
        torch.cuda.synchronize()
        for qn, q in queries.items():
            l0 = dict(cs.LAUNCHES)
            with record_function(f"smoke/{qn}"):
                t0 = time.perf_counter()
                res = (run or query)(port, q)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            out[qn] = {"result": res, "wall_ms": wall, "launches": {
                k: cs.LAUNCHES[k] - l0[k] for k in l0}}
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith("smoke/") \
                and e.get("cat") == "user_annotation":
            ts = float(e["ts"])
            out[name[6:]]["device"] = device_time(
                events, ts, ts + float(e.get("dur", 0)))
    return out


# the wrappers of each kernel that a main path may call
ENTRIES = {"widen_packed": ("widen_packed", "widen_packed_segments"),
           "unpack_bits": ("unpack_bits", "unpack_bits_segments")}


def is_segmented(shape) -> bool:
    return bool(shape) and shape[0] == "segments"


def shape_of(entry: str, args) -> tuple:
    """The shape a kernel wrapper was called at: (cnt, width) for
    widen_packed, (nbytes,) for unpack_bits, ("segments", payload bytes,
    table rows) for their segmented forms, else its first tensor's."""
    import numpy as np

    if entry.endswith("_segments"):
        raw, segs = args
        cols = 3 if entry.startswith("widen") else 2
        rows = np.asarray(segs, np.int64).reshape(-1, cols).tolist()
        return ("segments", int(raw.numel()), tuple(map(tuple, rows)))
    if entry == "widen_packed":
        return (args[2], args[1])
    if entry == "unpack_bits":
        return (args[1],)
    return tuple(args[0].shape)


def shape_json(name: str, shape) -> list:
    """A shape as the output gives it: a segment table as [values (or
    bytes) in all, rows], widen_packed's with the values of each width."""
    if not is_segmented(shape):
        return list(shape)
    rows = shape[2]
    if name == "widen_packed":
        mix = {}
        for _s, c, w in rows:
            mix[f"width {w}"] = mix.get(f"width {w}", 0) + c
        return [sum(c for _s, c, _w in rows), len(rows), mix]
    return [sum(n for _s, n in rows), len(rows)]


def shape_label(name: str, shape) -> str:
    return str(tuple(shape_json(name, shape)))


class ShapeRecorder:
    """Wraps every cuda_segment kernel wrapper to record the shapes it is
    given: `seen` over the whole run, `now` (when a dict) per query."""

    def __init__(self):
        from opengemini_tpu_torch.ops import cuda_segment as cs

        self.cs = cs
        self.seen = {k: set() for k in cs.LAUNCHES}
        self.now = None
        self.originals = {(k, e): getattr(cs, e) for k in cs.LAUNCHES
                          for e in ENTRIES.get(k, (k,))}

    def _wrap(self, name, entry):
        original = self.originals[(name, entry)]

        def wrapped(*args):
            shape = shape_of(entry, args)
            self.seen[name].add(shape)
            if self.now is not None:
                self.now.setdefault(name, set()).add(shape)
            return original(*args)
        return wrapped

    def __enter__(self):
        for name, entry in self.originals:
            setattr(self.cs, entry, self._wrap(name, entry))
        return self

    def __exit__(self, *exc):
        for (_name, entry), fn in self.originals.items():
            setattr(self.cs, entry, fn)


def fresh_root(name: str) -> str:
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", name)
    shutil.rmtree(root, ignore_errors=True)
    return root


def phase_e2e(hours: int, seed: int, n_hosts: int = N_HOSTS) -> dict:
    import numpy as np
    import torch

    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ingest import line_protocol, native_lp
    from opengemini_tpu_torch.ingest.line_protocol import series_key
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

    n_t = hours * 360
    log(f"[e2e] TSBS cpu-only: {n_hosts} hosts x {len(FIELDS)} fields x "
        f"{hours} h at 10 s = {n_hosts * n_t} rows")
    if hours < 12:
        log(f"[e2e] span cut from 12 h to {hours} h")
    t_gen = time.perf_counter()
    rng = np.random.default_rng(seed)
    tags = host_tags(n_hosts, rng)
    vals = make_values(n_hosts, n_t, rng)
    log(f"[e2e] data generated in {time.perf_counter() - t_gen:.1f} s")

    # from here on the main path runs: every launch counter starts at 0,
    # and each wrapper also records the shapes it is given, per query
    rec = ShapeRecorder().__enter__()
    cs.reset_launches()
    # a flush threshold above the data's size: the queries read the
    # memtable
    root = fresh_root("smoke_db")
    engine = Engine(root, flush_threshold_bytes=1 << 40)
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    svc = HttpService(engine, port=0)
    svc.start()
    disarm_planner(svc.port)
    try:
        status, _ = http(svc.port, "POST", "/query",
                         {"q": "CREATE DATABASE benchmark"})
        check(status == 200, "CREATE DATABASE failed")
        # the first minute of every host as line protocol through /write
        first = 6
        t_load = time.perf_counter()
        lines = []
        for h in range(n_hosts):
            key = series_key("cpu", tags[h])
            for i in range(first):
                fv = ",".join(f"{f}={float(vals[f][h, i])!r}" for f in FIELDS)
                lines.append(f"{key} {fv} {T0_NS + i * STEP_NS}")
        body = "\n".join(lines).encode()
        del lines
        with Counted(native_lp, "parse_columnar") as native, \
                Counted(line_protocol, "parse_lines") as python:
            t_write = time.perf_counter()
            status, _ = http(svc.port, "POST", "/write",
                             {"db": "benchmark", "precision": "ns"}, body)
            t_write = time.perf_counter() - t_write
        check(status == 204, f"/write status {status}")
        check(native.calls > 0 and native.nones == 0 and python.calls == 0,
              f"/write parsed by native {native.calls} times ({native.nones} "
              f"handed back), by Python {python.calls} times")
        log(f"[e2e] /write: {n_hosts * first} points ({len(body)} B) in "
            f"{t_write * 1e3:.1f} ms, {n_hosts * first / t_write:.0f} "
            f"points/s, native parser ({native.calls} segments)")
        del body
        # a bad body: 400 with the errno taxonomy, nothing stored
        bad = (f"cpu,hostname=bad v=4 {T0_NS}\nbad line here\n"
               f"cpu,hostname=bad v=5 {T0_NS + 1}").encode()
        status, headers, raw = http_raw(
            svc.port, "POST", "/write", {"db": "benchmark"}, bad)
        doc = json.loads(raw)
        want = {"error": "partial write: line 2: bad field", "errno": 2001,
                "module": "write"}
        check(status == 400 and doc == want
              and headers.get("X-Ogt-Errno") == "2001",
              f"bad /write: {status} {doc} X-Ogt-Errno "
              f"{headers.get('X-Ogt-Errno')}")
        log(f"[e2e] bad /write: {status} {json.dumps(doc)} X-Ogt-Errno "
            f"{headers.get('X-Ogt-Errno')}")
        # the rest through the columnar bulk load
        rest = n_t - first
        times = (T0_NS + np.arange(first, n_t, dtype=np.int64) * STEP_NS)
        table = {
            "series_keys": [series_key("cpu", t) for t in tags],
            "series": np.repeat(np.arange(n_hosts, dtype=np.int64), rest),
            "times": np.tile(times, n_hosts),
            "fields": {f: (np.ascontiguousarray(vals[f][:, first:]).reshape(-1),
                           np.ones(n_hosts * rest, dtype=np.bool_))
                       for f in FIELDS},
        }
        n = convert.load_columnar(engine, "benchmark", {"cpu": table})
        check(n == n_hosts * rest, f"columnar load wrote {n}")
        del table
        shards = engine.shards_for_range("benchmark", None, 0, 2**62)
        in_mem = sum(len(sh.mem) for sh in shards)
        check(in_mem == n_hosts * n_t
              and not any(sh._files for sh in shards),
              f"{in_mem} rows in the memtable, TSF files "
              f"{[len(sh._files) for sh in shards]}")
        log(f"[e2e] loaded in {time.perf_counter() - t_load:.1f} s "
            f"(WAL and memtable, no flush)")

        where = (f"time >= '2016-01-01T00:00:00Z' AND "
                 f"time < '2016-01-01T{hours:02d}:00:00Z'")
        f5 = FIELDS[:5]
        queries = {
            "Q1": "SELECT mean(usage_user), max(usage_user), "
                  f"count(usage_user) FROM cpu WHERE {where} GROUP BY time(1m)",
            "Q2": "SELECT " + ", ".join(f"mean({f})" for f in f5)
                  + f" FROM cpu WHERE {where} GROUP BY time(1h), hostname",
            "Q3": "SELECT " + ", ".join(f"max({f})" for f in f5)
                  + f" FROM cpu WHERE hostname='host_7' AND {where} "
                  "GROUP BY time(1m)",
            "Q4": "SELECT first(usage_user), last(usage_user), "
                  "min(usage_user), max(usage_user), mean(usage_user), "
                  "stddev(usage_user), spread(usage_user) FROM cpu "
                  f"WHERE {where} GROUP BY hostname",
        }
        needs = {"Q1": ("grid_window_agg",), "Q2": ("grid_window_agg",),
                 "Q3": ("grid_window_agg",),
                 "Q4": ("bucket_stats_basic", "bucket_stats_selectors")}
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "smoke_trace")
        os.makedirs(trace_dir, exist_ok=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p50, per_query = {}, {}
        for qn, q in queries.items():
            lat = []
            grid0 = STATS.counters("executor").get("grid_batches", 0)
            fb0 = STATS.counters("executor").get("grid_fallbacks", 0)
            l0 = dict(cs.LAUNCHES)
            rec.now = {}
            st0 = stage_ns(svc.port)
            requests = []
            for _ in range(E2E_RUNS.get(qn, 5)):
                res, req_ms, wall_ms = query_timed(svc.port, q)
                lat.append(wall_ms)
                requests.append(req_ms)
                verify(qn, res, vals, tags, n_hosts, n_t)
            stages = stage_split(svc.port, st0, requests, qn)
            p50[qn] = p50_of(lat)
            grids = STATS.counters("executor").get("grid_batches", 0) - grid0
            fbs = STATS.counters("executor").get("grid_fallbacks", 0) - fb0
            got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
            per_query[qn] = {
                "launches": got, "stages_ms": stages,
                "shapes": {k: sorted(v) for k, v in rec.now.items()}}
            if qn != "Q4":
                check(grids > 0 and fbs == 0,
                      f"{qn}: grid_batches +{grids}, fallbacks +{fbs}")
            for k in needs[qn]:
                check(got[k] > 0, f"{qn}: kernel {k} not launched")
            log(f"[e2e] {qn} ok p50={p50[qn]:.1f} ms "
                f"(runs {', '.join(f'{x:.1f}' for x in lat)}) "
                f"grid_batches +{grids}; launches in {len(lat)} runs "
                f"{json.dumps(got)} at {json.dumps(per_query[qn]['shapes'])}")
        rec.now = None
        # a chunked answer: newline-delimited JSON, one document per
        # chunk of 100 rows, the same rows as the plain answer
        status, headers, raw = http_raw(svc.port, "GET", "/query", {
            "db": "benchmark", "q": queries["Q3"], "epoch": "ns",
            "chunked": "true", "chunk_size": "100"})
        docs = [json.loads(line) for line in raw.decode().splitlines()]
        rows = [r for d in docs for sr in d["results"][0]["series"]
                for r in sr["values"]]
        plain = query(svc.port, queries["Q3"])["series"][0]["values"]
        check(status == 200 and headers.get("Transfer-Encoding") == "chunked"
              and len(docs) == -(-len(plain) // 100) and rows == plain,
              f"chunked Q3: {status}, {len(docs)} documents, "
              f"{len(rows)} rows against {len(plain)}")
        log(f"[e2e] chunked Q3: {len(docs)} documents of at most 100 rows, "
            f"equal to the plain answer's {len(plain)} rows")
        explain_analyze(svc.port, "Q1", queries["Q1"])
        # a sixth run of each query under the profiler: where its time goes
        traced = traced_queries(svc.port, queries,
                                os.path.join(trace_dir, "queries.json"))
        for qn, tr in traced.items():
            verify(qn, tr.pop("result"), vals, tags, n_hosts, n_t)
            dev, wall = tr.get("device"), tr["wall_ms"]
            check(dev is not None, f"{qn}: no annotation in the trace")
            if dev["busy_ms"] == 0.0:
                log(f"[trace] {qn} wall {wall:.1f} ms: the trace holds no "
                    "device activity (device time not measured)")
                continue
            log(f"[trace] {qn} wall {wall:.1f} ms, device busy "
                f"{dev['busy_ms']:.3f} ms ({100 * dev['busy_ms'] / wall:.3f}% "
                f"of the wall), kernels {dev['kernel_ms']:.3f} ms "
                f"({dev['kernels']} kernels: port {dev['port_kernel_ms']:.3f} "
                f"ms, others {dev['other_kernel_ms']:.3f} ms), host-to-device "
                f"{dev['h2d_ms']:.3f} ms for {dev['h2d_bytes']} B, "
                f"device-to-host {dev['d2h_ms']:.3f} ms for {dev['d2h_bytes']}"
                f" B; {dev['device_calls']} device calls, "
                f"{dev['missing']} without a device record; launches "
                f"{json.dumps(tr['launches'])}")
        launches = {k: cs.LAUNCHES[k] for k in E2E_KERNELS}
        for k, cnt in launches.items():
            check(cnt > 0, f"kernel {k} never launched on the main path")
        peak = torch.cuda.max_memory_allocated()
        log(f"[e2e] launches (5 timed + 1 traced run per query) {launches}; "
            f"device memory peak {peak / 2**20:.1f} MiB; p50 ms "
            f"{json.dumps(p50)}; card {smi_line()}")
        return {"launches": launches, "shapes": rec.seen, "p50_ms": p50,
                "per_query": per_query, "traced": traced, "peak_bytes": peak}
    finally:
        stop_server(svc, engine)
        rec.__exit__()
        # the WAL of this phase holds every row as text: gigabytes
        import shutil

        shutil.rmtree(root, ignore_errors=True)


def verify(qn: str, res: dict, vals, tags, n_hosts: int, n_t: int,
           extra: float | None = None) -> None:
    """Check one answer against the numpy oracle; `extra` is one more
    usage_user value in Q1's first window (a row of another series)."""
    import numpy as np

    series = res.get("series", [])
    if qn == "Q1":
        check(len(series) == 1, "Q1: one series")
        rows = series[0]["values"]
        v = vals["usage_user"].reshape(n_hosts, n_t // 6, 6)
        check(len(rows) == n_t // 6, "Q1: window count")
        times = [r[0] for r in rows]
        check(times == [T0_NS + w * 60 * 10**9 for w in range(n_t // 6)],
              "Q1: window times")
        want_cnt = np.full(n_t // 6, n_hosts * 6)
        want_max = v.max(axis=(0, 2))
        want_sum = v.sum(axis=(0, 2))
        if extra is not None:
            want_cnt[0] += 1
            want_max[0] = max(want_max[0], extra)
            want_sum[0] += extra
        cnt = np.array([r[3] for r in rows])
        check((cnt == want_cnt).all(), "Q1: counts")
        check(np.array_equal(np.array([r[2] for r in rows]), want_max),
              "Q1: max")
        check(close([r[1] for r in rows], want_sum / want_cnt), "Q1: mean")
    elif qn == "Q2":
        check(len(series) == n_hosts, "Q2: one series per host")
        for s in series:
            h = int(s["tags"]["hostname"].split("_")[1])
            rows = s["values"]
            check(len(rows) == n_t // 360, f"Q2 host {h}: window count")
            for j, f in enumerate(FIELDS[:5]):
                want = vals[f][h].reshape(n_t // 360, 360).mean(axis=1)
                check(close([r[1 + j] for r in rows], want),
                      f"Q2 host {h}: mean({f})")
    elif qn == "Q3":
        check(len(series) == 1, "Q3: one series")
        rows = series[0]["values"]
        for j, f in enumerate(FIELDS[:5]):
            want = vals[f][7].reshape(n_t // 6, 6).max(axis=1)
            check(np.array_equal(np.array([r[1 + j] for r in rows]), want),
                  f"Q3: max({f})")
    else:
        check(len(series) == n_hosts, "Q4: one series per host")
        v = vals["usage_user"]
        for s in series:
            h = int(s["tags"]["hostname"].split("_")[1])
            (row,) = s["values"]
            _t, fst, lst, mn, mx, mean, sd, spread = row
            x = v[h]
            check(fst == x[0] and lst == x[-1], f"Q4 host {h}: first/last")
            check(mn == x.min() and mx == x.max(), f"Q4 host {h}: min/max")
            check(spread == x.max() - x.min(), f"Q4 host {h}: spread")
            check(close([mean], [x.mean()]), f"Q4 host {h}: mean")
            check(close([sd], [x.std(ddof=1)]), f"Q4 host {h}: stddev")


# -- phase 5: the cold scan from disk -------------------------------------


def make_counters(n_hosts: int, n_t: int, rng):
    """Per diskio field a (hosts, samples) int64 monotonic counter from 0,
    each step |N(mean, 1)| rounded (the TSBS diskio model)."""
    import numpy as np

    out = {}
    for f, mean in DISKIO_FIELDS:
        steps = np.abs(np.rint(rng.normal(mean, 1.0, (n_hosts, n_t))))
        out[f] = np.cumsum(steps.astype(np.int64), axis=1)
    return out


def lp_lines(tags, vals, counters, lo: int, hi: int, n_hosts: int) -> str:
    """Line protocol of samples [lo, hi) of every host, cpu then diskio."""
    from opengemini_tpu_torch.ingest.line_protocol import series_key

    lines = []
    for h in range(n_hosts):
        cpu, dio = series_key("cpu", tags[h]), series_key("diskio", tags[h])
        for i in range(lo, hi):
            t = T0_NS + i * STEP_NS
            fv = ",".join(f"{f}={float(vals[f][h, i])!r}" for f in FIELDS)
            lines.append(f"{cpu} {fv} {t}")
            iv = ",".join(f"{f}={int(counters[f][h, i])}i"
                          for f, _m in DISKIO_FIELDS)
            lines.append(f"{dio} {iv} {t}")
    return "\n".join(lines)


def column_tables(tags, vals, counters, lo: int, hi: int, n_hosts: int):
    """convert.load_columnar tables of samples [lo, hi) of every host."""
    import numpy as np

    from opengemini_tpu_torch.ingest.line_protocol import series_key

    n = hi - lo
    times = T0_NS + np.arange(lo, hi, dtype=np.int64) * STEP_NS
    ones = np.ones(n_hosts * n, dtype=np.bool_)
    common = {"series": np.repeat(np.arange(n_hosts, dtype=np.int64), n),
              "times": np.tile(times, n_hosts)}

    def fields(src, names):
        return {f: (np.ascontiguousarray(src[f][:, lo:hi]).reshape(-1), ones)
                for f in names}

    return {
        "cpu": {"series_keys": [series_key("cpu", t) for t in tags],
                "fields": fields(vals, FIELDS), **common},
        "diskio": {"series_keys": [series_key("diskio", t) for t in tags],
                   "fields": fields(counters, [f for f, _m in DISKIO_FIELDS]),
                   **common},
    }


def verify_cold(qn: str, res: dict, vals, counters, tags, n_hosts: int,
                n_t: int, extra: float | None = None) -> None:
    import numpy as np

    if qn in ("C1", "C2"):
        verify("Q" + qn[1], res, vals, tags, n_hosts, n_t,
               extra if qn == "C1" else None)
        return
    (series,) = res.get("series", [None])
    rows = series["values"]
    v = counters["read_bytes"][:, :n_t].reshape(n_hosts, n_t // 6, 6)
    check(len(rows) == n_t // 6, "C3: window count")
    check([r[0] for r in rows] == [T0_NS + w * 60 * 10**9
                                   for w in range(n_t // 6)], "C3: times")
    check(all(r[1] == n_hosts * 6 for r in rows), "C3: counts")
    check(np.array_equal(np.array([r[2] for r in rows]), v.min(axis=(0, 2))),
          "C3: min")
    check(np.array_equal(np.array([r[3] for r in rows]), v.max(axis=(0, 2))),
          "C3: max")


def short_shapes(shapes: dict) -> dict:
    """Shapes per kernel for a log line: a kernel given many shapes (one
    per decoded block) shows their count and range."""
    return {k: v if len(v) <= 4 else f"{len(v)} shapes from {v[0]} to {v[-1]}"
            for k, v in shapes.items()}


class ChunkCounter:
    """Counts the gorilla chunks the decode cuts its plans into
    (device_decode._gorilla_chunks), which sets kernel 5's launches."""

    def __init__(self):
        from opengemini_tpu_torch.ops import device_decode

        self.dd = device_decode
        self.original = device_decode._gorilla_chunks
        self.n = 0

    def __enter__(self):
        def counted(rows):
            out = self.original(rows)
            self.n += len(out)
            return out

        self.dd._gorilla_chunks = counted
        return self

    def __exit__(self, *exc):
        self.dd._gorilla_chunks = self.original


def launches_per_run(qn: str, got: dict, n_chunks: int, runs: int) -> dict:
    """Kernels 4 and 5's launches in one run of a cold query, from the
    counts of its `runs` timed runs, checked exactly: kernel 4 once per
    run in C3 (one launch for the plan's every FOR-delta block), kernel 5
    once per gorilla chunk in C1 and C2 (C1 at most MAX_C1_CHUNKS, C2's
    five fields five times C1's)."""
    per_run = {k: got[k] // runs for k in ("widen_packed", "unpack_bits")}
    for k, n in per_run.items():
        check(got[k] == runs * n, f"{qn}: {k} launched {got[k]} times in "
              f"{runs} runs, not the same count in every run")
    check(per_run["unpack_bits"] * runs == n_chunks,
          f"{qn}: {got['unpack_bits']} unpack launches for {n_chunks} chunks")
    if qn == "C3":
        check(per_run == {"widen_packed": 1, "unpack_bits": 0},
              f"C3: launches per run {per_run}, not one widen")
    else:
        check(per_run["widen_packed"] == 0
              and 0 < per_run["unpack_bits"] <= MAX_C1_CHUNKS
              * (5 if qn == "C2" else 1),
              f"{qn}: launches per run {per_run}")
    return per_run


def decode_summary(per_query: dict, traced: dict) -> None:
    """Kernels 4 and 5's launches per run beside the per-block decode's
    (PR 2), and each cold query's device kernels in its traced run."""
    c1 = per_query["C1"]["per_run"]["unpack_bits"]
    c2 = per_query["C2"]["per_run"]["unpack_bits"]
    check(c2 == 5 * c1, f"C2 unpack launches per run {c2}, not 5 x {c1}")

    def blocks(qn: str, codec: str) -> int:
        """A run's blocks of `codec`: the per-block decode's launches."""
        pq = per_query[qn]
        return (pq["counters"].get(f"device/decode_blocks_{codec}_total", 0)
                // len(pq["runs_ms"]))

    log(f"[cold] launches per run: widen_packed C3 "
        f"{per_query['C3']['per_run']['widen_packed']} (per block: "
        f"{blocks('C3', 'delta')}), unpack_bits C1 {c1} "
        f"({blocks('C1', 'gorilla')}), C2 {c2} ({blocks('C2', 'gorilla')})")
    for qn, tr in traced.items():
        dev = tr.get("device") or {}
        log(f"[cold] {qn} traced run: {dev.get('kernels')} device kernels, "
            f"{dev.get('kernel_ms', 0.0):.3f} ms (port "
            f"{dev.get('port_kernel_ms', 0.0):.3f} ms, others "
            f"{dev.get('other_kernel_ms', 0.0):.3f} ms)")


H2D_DECODE = 'device_h2d_bytes{site="device-decode"}'


def decode_counters() -> dict:
    """The device decode's counters, by "module/name", and the bytes of
    the armed per-site transfer histogram of the decode (H2D_DECODE;
    phase 5 arms devobs for it)."""
    from opengemini_tpu_torch.utils import stats

    snap = stats.GLOBAL.snapshot()
    keys = ["executor/grid_decode_fused", "executor/grid_decode_fallbacks",
            "device/decode_fallbacks_total"]
    keys += [f"device/{k}" for k in snap.get("device", {})
             if k.startswith("decode_blocks_")]
    out = {k: snap.get(k.split("/", 1)[0], {}).get(k.split("/", 1)[1], 0)
           for k in keys}
    out[H2D_DECODE] = sum(
        h["sum_ns"] for name, labels, h in stats.histograms_snapshot()
        if name == "device_h2d_bytes" and labels == (("site",
                                                      "device-decode"),))
    return out


def cold_queries(n_t: int) -> dict:
    """C1-C3 over the cold phase's span of n_t samples."""
    where = f"time >= {T0_NS} AND time < {T0_NS + n_t * STEP_NS}"
    f5 = FIELDS[:5]
    return {
        "C1": "SELECT mean(usage_user), max(usage_user), "
              f"count(usage_user) FROM cpu WHERE {where} GROUP BY time(1m)",
        "C2": "SELECT " + ", ".join(f"mean({f})" for f in f5)
              + f" FROM cpu WHERE {where} GROUP BY time(1h), hostname",
        "C3": "SELECT count(read_bytes), min(read_bytes), "
              f"max(read_bytes) FROM diskio WHERE {where} GROUP BY time(1m)",
    }


def phase_cold(hours: int, seed: int, q1_h2d_bytes: int | None,
               n_hosts: int = N_HOSTS) -> dict:
    import numpy as np
    import torch

    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.utils import devobs

    # the decoded-column cache off (its bit-identical disabled path): the
    # launch counts below are those of a decode on every run
    colcache.GLOBAL.configure(budget_mb=0)
    n_t = hours * 360
    log(f"[cold] TSBS devops cpu + diskio: {n_hosts} hosts x ({len(FIELDS)} "
        f"+ {len(DISKIO_FIELDS)}) fields x {hours} h at 10 s = "
        f"{2 * n_hosts * n_t} rows, device profile on")
    if hours < 12:
        log(f"[cold] span cut from 12 h to {hours} h")
    rng = np.random.default_rng(seed + 7)
    tags = host_tags(n_hosts, rng)
    vals = make_values(n_hosts, n_t, rng)
    counters = make_counters(n_hosts, n_t + 6, rng)
    extra = make_values(n_hosts, 6, rng)  # the minute after the span
    root = fresh_root("smoke_cold")
    os.environ["OGT_DEVICE_PROFILE"] = "1"
    rec = ShapeRecorder().__enter__()
    chunks = ChunkCounter().__enter__()
    svc = None
    engine = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def start():
        nonlocal engine, svc
        engine = Engine(root)
        check(engine.device.type == "cuda", f"engine on {engine.device}")
        svc = HttpService(engine, port=0)
        svc.start()
        disarm_planner(svc.port)
        # the decode's transfer histogram (H2D_DECODE) is devobs' armed
        # accounting
        status, doc = http(svc.port, "POST", "/debug/ctrl",
                           {"mod": "devobs", "arm": "1"})
        check(status == 200 and doc["armed"] is True, "devobs not armed")

    def restart():
        # a new process probes the card again; so does a restart here
        stop_server(svc, engine)
        devobs.reset_probe()
        start()

    try:
        # the load and the restart are the main path too: counts from 0
        cs.reset_launches()
        start()
        status, _ = http(svc.port, "POST", "/query",
                         {"q": "CREATE DATABASE benchmark"})
        check(status == 200, "CREATE DATABASE failed")
        t_load = time.perf_counter()
        status, _ = http(svc.port, "POST", "/write",
                         {"db": "benchmark", "precision": "ns"},
                         lp_lines(tags, vals, counters, 0, 6, n_hosts).encode())
        check(status == 204, f"/write status {status}")
        for hr in range(hours):
            lo = 6 if hr == 0 else hr * 360
            tables = column_tables(tags, vals, counters, lo, (hr + 1) * 360,
                                   n_hosts)
            n = convert.load_columnar(engine, "benchmark", tables)
            check(n == 2 * n_hosts * ((hr + 1) * 360 - lo),
                  f"hour {hr}: load wrote {n}")
        shards = engine.shards_for_range("benchmark", None, 0, 2**62)
        on_way = sum(len(sh._files) for sh in shards)
        check(on_way > 0, "no threshold flush during the load")
        engine.flush_all()
        files = sum(len(sh._files) for sh in shards)
        log(f"[cold] loaded in {time.perf_counter() - t_load:.1f} s into "
            f"{files} TSF files ({on_way} from the "
            f"{engine.flush_threshold_bytes / 2**20:g} MiB threshold during "
            f"the load, the rest from flush_all)")
        t_re = time.perf_counter()
        restart()
        log(f"[cold] restarted (meta, series index, TSF, WAL) in "
            f"{time.perf_counter() - t_re:.1f} s")

        queries = cold_queries(n_t)
        needs = {"C1": ("unpack_bits", "grid_window_agg"),
                 "C2": ("unpack_bits", "grid_window_agg"),
                 "C3": ("widen_packed", "grid_window_agg")}
        torch.cuda.synchronize()
        p50, per_query = {}, {}
        for qn, q in queries.items():
            lat = []
            c0 = decode_counters()
            l0 = dict(cs.LAUNCHES)
            rec.now = {}
            chunks.n = 0
            st0 = stage_ns(svc.port)
            requests = []
            runs = COLD_RUNS.get(qn, 5)
            for _ in range(runs):
                res, req_ms, wall_ms = query_timed(svc.port, q)
                lat.append(wall_ms)
                requests.append(req_ms)
                verify_cold(qn, res, vals, counters, tags, n_hosts, n_t)
            stages = stage_split(svc.port, st0, requests, qn)
            p50[qn] = p50_of(lat)
            c1 = decode_counters()
            d = {k: c1.get(k, 0) - c0.get(k, 0) for k in c1}
            got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
            per_query[qn] = {
                "launches": got, "runs_ms": lat, "counters": d,
                "stages_ms": stages,
                "shapes": {k: [shape_json(k, x) for x in sorted(v)]
                           for k, v in rec.now.items()}}
            check(d["executor/grid_decode_fused"] > 0,
                  f"{qn}: the fused device decode did not run")
            check(d["device/decode_fallbacks_total"] == 0
                  and d["executor/grid_decode_fallbacks"] == 0,
                  f"{qn}: decode fell back to the host")
            for k in needs[qn]:
                check(got[k] > 0, f"{qn}: kernel {k} not launched")
            per_query[qn]["per_run"] = per_run = launches_per_run(
                qn, got, chunks.n, runs)
            blocks = {k.split("_")[2]: v for k, v in d.items()
                      if k.startswith("device/decode_blocks_") and v}
            log(f"[cold] {qn} ok p50={p50[qn]:.1f} ms (runs "
                f"{', '.join(f'{x:.1f}' for x in lat)}); fused "
                f"+{d['executor/grid_decode_fused']}, blocks by codec "
                f"{json.dumps(blocks)}, device-decode H2D "
                f"{d[H2D_DECODE] / runs / 1e6:.1f} MB "
                f"per run; launches in {runs} runs {json.dumps(got)} at "
                f"{json.dumps(short_shapes(per_query[qn]['shapes']))}")
        rec.now = None
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "smoke_trace")
        os.makedirs(trace_dir, exist_ok=True)
        traced = traced_queries(svc.port, queries,
                                os.path.join(trace_dir, "cold.json"))
        for qn, tr in traced.items():
            verify_cold(qn, tr.pop("result"), vals, counters, tags, n_hosts,
                        n_t)
            dev, wall = tr.get("device"), tr["wall_ms"]
            check(dev is not None, f"{qn}: no annotation in the trace")
            if dev["busy_ms"] == 0.0:
                log(f"[trace] {qn} wall {wall:.1f} ms: the trace holds no "
                    "device activity (device time not measured)")
                continue
            log(f"[trace] {qn} wall {wall:.1f} ms, device busy "
                f"{dev['busy_ms']:.3f} ms ({100 * dev['busy_ms'] / wall:.3f}% "
                f"of the wall), kernels {dev['kernel_ms']:.3f} ms "
                f"({dev['kernels']} kernels: port {dev['port_kernel_ms']:.3f} "
                f"ms, others {dev['other_kernel_ms']:.3f} ms), host-to-device "
                f"{dev['h2d_ms']:.3f} ms for {dev['h2d_bytes']} B "
                f"({dev['h2d_bytes'] / 1e6:.1f} MB"
                + (f"; Q1's decoded grid in this run {q1_h2d_bytes / 1e6:.1f}"
                   " MB)" if qn == "C1" and q1_h2d_bytes else ")")
                + f", device-to-host {dev['d2h_ms']:.3f} ms for "
                f"{dev['d2h_bytes']} B; {dev['device_calls']} device calls, "
                f"{dev['missing']} without a device record; launches "
                f"{json.dumps(tr['launches'])}")
            for k, n in per_query[qn]["per_run"].items():
                check(tr["launches"][k] == n, f"{qn} traced run: {k} "
                      f"launched {tr['launches'][k]} times, not {n}")
        decode_summary(per_query, traced)
        explain_analyze(svc.port, "C1", queries["C1"])
        # WAL replay: the next minute of every host, then a restart
        # without a flush
        nxt = {f: np.concatenate([vals[f], extra[f]], axis=1) for f in FIELDS}
        status, _ = http(svc.port, "POST", "/write",
                         {"db": "benchmark", "precision": "ns"},
                         lp_lines(tags, nxt, counters, n_t, n_t + 6,
                                  n_hosts).encode())
        check(status == 204, f"/write status {status}")
        restart()
        lo_ns = T0_NS + n_t * STEP_NS
        res = query(svc.port, f"SELECT count(usage_user) FROM cpu WHERE "
                              f"time >= {lo_ns} AND time < {lo_ns + 60 * 10**9}")
        got_n = res["series"][0]["values"][0][1]
        check(got_n == n_hosts * 6,
              f"WAL replay: count {got_n} != {n_hosts * 6}")
        log(f"[cold] WAL replay ok: count(usage_user) over the minute after "
            f"the span = {got_n} after a restart without a flush")
        launches = {k: cs.LAUNCHES[k] for k in COLD_KERNELS}
        for k in COLD_KERNELS:
            check(launches[k] > 0, f"kernel {k} never launched on the cold path")
        check(launches["probe_count"] == 1,
              f"probe_count launched {launches['probe_count']} times, not once")
        peak = torch.cuda.max_memory_allocated()
        log(f"[cold] launches (load, restart, {COLD_RUNS} timed runs "
            f"+ 1 traced run per query, WAL check) "
            f"{launches}; device memory peak "
            f"{peak / 2**20:.1f} MiB (limit {COLD_PEAK_LIMIT / 2**20:.0f}); "
            f"p50 ms {json.dumps(p50)}; card {smi_line()}")
        check(peak <= COLD_PEAK_LIMIT, f"phase 5 device memory peak {peak} B")
        return {"launches": launches, "shapes": rec.seen, "p50_ms": p50,
                "per_query": per_query, "traced": traced, "peak_bytes": peak,
                "root": root, "queries": queries, "files": files, "oracle": {
                    "vals": vals, "counters": counters, "tags": tags,
                    "extra": extra, "n_hosts": n_hosts, "n_t": n_t}}
    finally:
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        devobs.set_enabled(False)
        if svc is not None:
            stop_server(svc, engine)
        rec.__exit__()
        chunks.__exit__()


# -- phase 6: the decoded-column cache's device tier ------------------------


def serve(root: str):
    """A fresh Engine and HttpService on `root` (a restart)."""
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.utils import devobs

    devobs.reset_probe()  # a new process probes the card again
    engine = Engine(root)
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    svc = HttpService(engine, port=0)
    svc.start()
    return engine, svc


def phase_colcache(cold: dict) -> dict:
    """C1 and C3 with both tiers of the decoded-column cache on, on phase
    5's root after a restart: a fill, then warm runs that must hit the
    device tier, launch kernel 3 on the retained tensors and neither
    kernel 4 nor 5, and copy nothing to the card; then a write and a
    flush, after which C1 must miss and count the new row."""
    import torch

    from opengemini_tpu_torch.ingest.line_protocol import series_key
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.storage import colcache

    o = cold["oracle"]
    cc = colcache.GLOBAL
    cc.clear()
    cc.configure(budget_mb=CC_HOST_MB, device=True,
                 device_budget_mb=CC_DEVICE_MB)
    os.environ["OGT_DEVICE_PROFILE"] = "1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launches()
    engine, svc = serve(cold["root"])
    disarm_planner(svc.port)
    try:
        # the WAL check's minute, replayed into the memtable, goes to a
        # file: a scan that merges memtable rows decodes on the host
        engine.flush_all()
        queries = {qn: cold["queries"][qn] for qn in ("C1", "C3")}
        decode_k = {"C1": "unpack_bits", "C3": "widen_packed"}
        per_query = {}
        for qn, q in queries.items():
            runs = []
            for i in range(CACHE_RUNS):
                if i == 1:  # the warm runs' stage split
                    st0 = stage_ns(svc.port)
                c0, l0 = cc.counters(), dict(cs.LAUNCHES)
                res, req, ms = query_timed(svc.port, q)
                verify_cold(qn, res, o["vals"], o["counters"], o["tags"],
                            o["n_hosts"], o["n_t"])
                c1 = cc.counters()
                runs.append({
                    "ms": ms, "request_ms": req,
                    "launches": {k: cs.LAUNCHES[k] - l0[k] for k in l0},
                    "cache": {k: c1[k] - c0[k] for k in (
                        "device_hits", "device_misses", "hits", "misses")}})
            fill, warm = runs[0], runs[1:]
            stages = stage_split(svc.port, st0,
                                 [r["request_ms"] for r in warm],
                                 f"{qn} warm, device tier")
            check(fill["cache"]["device_misses"] == 1
                  and fill["cache"]["device_hits"] == 0
                  and fill["launches"][decode_k[qn]] > 0,
                  f"{qn} fill: {fill}")
            for r in warm:
                check(r["cache"]["device_hits"] == 1
                      and r["cache"]["device_misses"] == 0
                      and r["launches"]["grid_window_agg"] > 0
                      and r["launches"]["widen_packed"] == 0
                      and r["launches"]["unpack_bits"] == 0,
                      f"{qn} warm run: {r}")
            per_query[qn] = {"fill_ms": fill["ms"], "stages_ms": stages,
                             "warm_ms": [r["ms"] for r in warm],
                             "warm_p50_ms": p50_of([r["ms"] for r in warm]),
                             "runs": runs}
            log(f"[colcache] {qn} ok: fill {fill['ms']:.1f} ms (launches "
                f"{json.dumps(fill['launches'])}), warm "
                f"{', '.join(f'{r:.1f}' for r in per_query[qn]['warm_ms'])}"
                f" ms (device hits {len(warm)} of {len(warm)}, host hits "
                f"{sum(r['cache']['hits'] for r in warm)}, launches "
                f"{json.dumps(warm[-1]['launches'])} a run)")
        c = cc.counters()
        log(f"[colcache] resident: host {c['bytes'] / 2**20:.1f} MiB in "
            f"{c['entries']} entries, device {c['device_bytes'] / 2**20:.1f}"
            f" MiB in {c['device_entries']} entries")
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "smoke_trace")
        traced = traced_queries(svc.port, queries,
                                os.path.join(trace_dir, "colcache.json"))
        for qn, tr in traced.items():
            verify_cold(qn, tr.pop("result"), o["vals"], o["counters"],
                        o["tags"], o["n_hosts"], o["n_t"])
            dev = tr.get("device") or {}
            check(dev.get("h2d_bytes", -1) <= WARM_H2D_LIMIT
                  and tr["launches"]["grid_window_agg"] > 0
                  and tr["launches"][decode_k[qn]] == 0,
                  f"{qn} traced warm run: {dev}, {tr['launches']}")
            log(f"[colcache] {qn} traced warm run: wall {tr['wall_ms']:.1f} "
                f"ms, host-to-device {dev['h2d_bytes']} B in "
                f"{dev['h2d_ms']:.3f} ms, device busy {dev['busy_ms']:.3f} "
                f"ms, kernels {dev['kernels']} ({dev['kernel_ms']:.3f} ms)")
        # a write changes the shard's data_version, so the signature: the
        # next run misses, and its answer holds the new row
        tags = tuple((k, "host_extra" if k == "hostname" else v)
                     for k, v in o["tags"][0])
        line = f"{series_key('cpu', tags)} usage_user={EXTRA_VALUE!r} {T0_NS}"
        status, _ = http(svc.port, "POST", "/write", {"db": "benchmark"},
                         line.encode())
        check(status == 204, f"/write status {status}")
        engine.flush_all()
        c0 = cc.counters()
        res, _req, ms = query_timed(svc.port, queries["C1"])
        verify_cold("C1", res, o["vals"], o["counters"], o["tags"],
                    o["n_hosts"], o["n_t"], extra=EXTRA_VALUE)
        d = cc.counters()["device_misses"] - c0["device_misses"]
        check(d == 1, f"C1 after a write: device misses +{d}")
        log(f"[colcache] a write and a flush: C1 missed the device tier and "
            f"counted the new row ({ms:.1f} ms)")
        launches = dict(cs.LAUNCHES)
        check(launches["grid_window_agg"] > 0,
              "kernel 3 never launched in phase 6")
        peak = torch.cuda.max_memory_allocated()
        check(peak <= COLD_PEAK_LIMIT, f"phase 6 device memory peak {peak} B")
        log(f"[colcache] launches {json.dumps(launches)}; device memory "
            f"peak {peak / 2**20:.1f} MiB; card {smi_line()}")
        return {"launches": launches, "per_query": {
                    qn: {"launches": {k: sum(r["launches"][k]
                                             for r in pq["runs"])
                                      for k in cs.LAUNCHES}, **pq}
                    for qn, pq in per_query.items()},
                "traced": traced, "peak_bytes": peak}
    finally:
        stop_server(svc, engine)
        cc.configure(budget_mb=0)


# -- phase 7: compaction -------------------------------------------------------


def disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, names in os.walk(path) for f in names)


def phase_compact(cold: dict) -> dict:
    """Phase 5's root (with phase 6's flush) compacted: compact_level
    until it has nothing to merge, then compact; C1 and C3 then decode
    the merged files on the card and must equal the oracle, also after a
    restart."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.storage import colcache

    o = cold["oracle"]
    colcache.GLOBAL.configure(budget_mb=0)  # decode on every run
    os.environ["OGT_DEVICE_PROFILE"] = "1"  # merged blocks stay decodable
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launches()
    engine, svc = serve(cold["root"])
    disarm_planner(svc.port)
    try:
        shards = engine.all_shards()
        check(len(shards) == 1, f"{len(shards)} shards")
        (sh,) = shards
        files0, bytes0 = sh.file_count(), disk_bytes(sh.path)
        level_ms = []
        while True:
            t0 = time.perf_counter()
            merged = sh.compact_level()
            if not merged:
                break
            level_ms.append((time.perf_counter() - t0) * 1e3)
        files1 = sh.file_count()
        t0 = time.perf_counter()
        full = sh.compact()
        full_ms = (time.perf_counter() - t0) * 1e3
        files2, bytes2 = sh.file_count(), disk_bytes(sh.path)
        check(files2 == 1 and (full or files1 == 1),
              f"compaction left {files2} files")
        log(f"[compact] {files0} TSF files (phase 5's {cold['files']}, the "
            f"rest from phase 6's flushes), {bytes0 / 2**20:.1f} MiB on "
            f"disk -> compact_level x {len(level_ms)} "
            f"({', '.join(f'{x:.0f}' for x in level_ms)} ms) -> {files1} "
            f"files -> compact {full_ms:.0f} ms -> {files2} file, "
            f"{bytes2 / 2**20:.1f} MiB on disk")
        per_query = {}
        for qn in ("C1", "C3"):
            q = cold["queries"][qn]
            c0, l0 = decode_counters(), dict(cs.LAUNCHES)
            st0 = stage_ns(svc.port)
            lat, requests = [], []
            for _ in range(COMPACT_RUNS):
                res, req, ms = query_timed(svc.port, q)
                verify_cold(qn, res, o["vals"], o["counters"], o["tags"],
                            o["n_hosts"], o["n_t"], extra=EXTRA_VALUE)
                lat.append(ms)
                requests.append(req)
            stages = stage_split(svc.port, st0, requests, f"{qn} compacted")
            d = {k: v - c0.get(k, 0) for k, v in decode_counters().items()}
            got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
            # the merged blocks decode on the card too (which codecs
            # the merge chose sets kernels 4 and 5's share)
            check(d["executor/grid_decode_fused"] == COMPACT_RUNS
                  and d["device/decode_fallbacks_total"] == 0
                  and got["grid_window_agg"] > 0,
                  f"{qn} after compaction: fused "
                  f"+{d['executor/grid_decode_fused']}, fallbacks "
                  f"+{d['device/decode_fallbacks_total']}, launches {got}")
            blocks = {k.split("_")[2]: v for k, v in d.items()
                      if k.startswith("device/decode_blocks_") and v}
            p50 = p50_of(lat)
            per_query[qn] = {"runs_ms": lat, "p50_ms": p50,
                             "launches": got, "blocks": blocks,
                             "stages_ms": stages}
            log(f"[compact] {qn} ok p50={p50:.1f} ms (runs "
                f"{', '.join(f'{x:.1f}' for x in lat)}); blocks by codec in "
                f"{len(lat)} runs {json.dumps(blocks)}; launches "
                f"{json.dumps(got)}")
        stop_server(svc, engine)
        svc = None
        t0 = time.perf_counter()
        engine, svc = serve(cold["root"])
        res, _req, _ms = query_timed(svc.port, cold["queries"]["C3"])
        verify_cold("C3", res, o["vals"], o["counters"], o["tags"],
                    o["n_hosts"], o["n_t"])
        log(f"[compact] reopened the compacted root: C3 ok "
            f"({(time.perf_counter() - t0) * 1e3:.1f} ms with the restart)")
        launches = dict(cs.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(peak <= COLD_PEAK_LIMIT, f"phase 7 device memory peak {peak} B")
        log(f"[compact] launches {json.dumps(launches)}; device memory peak "
            f"{peak / 2**20:.1f} MiB; card {smi_line()}")
        return {"launches": launches, "per_query": per_query,
                "files": [files0, files1, files2],
                "disk_bytes": [bytes0, bytes2],
                "compact_level_ms": level_ms, "compact_ms": full_ms,
                "peak_bytes": peak}
    finally:
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        if svc is not None:
            stop_server(svc, engine)


# -- phase 8: the host query path and the schema statements -------------------

# phase 8's budget of its own (s): a query whose first run shows that five
# would not fit runs once, and a progress line says so
HOST_PHASE_S = 180.0
# held back from that budget for the CPU comparison of the later queries
HOST_RESERVE_S = 45.0
PARITY_CASES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "parity_cases.json")


def tsbs_queries(n_t: int) -> dict:
    """TSBS devops queries as its influx dialect writes them
    (cmd/tsbs_generate_queries/uses/devops), over the cold phase's span."""
    import datetime as dt

    def rfc(ns: int) -> str:
        return dt.datetime.fromtimestamp(
            ns // 10**9, dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")

    lo, hi = rfc(T0_NS), rfc(T0_NS + n_t * STEP_NS)
    return {
        "high-cpu-1": "SELECT * from cpu where (hostname = 'host_7') and "
                      f"usage_user > 90.0 and time >= '{lo}' and "
                      f"time < '{hi}'",
        "lastpoint": 'SELECT * from cpu group by "hostname" order by time '
                     "desc limit 1",
        "groupby-orderby-limit": "SELECT max(usage_user) from cpu WHERE "
                                 f"time < '{hi}' group by time(1m) ORDER BY "
                                 "time DESC LIMIT 5",
        "show-tag-values": 'SHOW TAG VALUES FROM cpu WITH KEY = "hostname"',
        "show-series-cardinality": "SHOW SERIES CARDINALITY",
    }


def parity_replay(device: str | None) -> dict:
    """tests/parity_cases.json through the port's HttpService on
    Engine(root, device=device) (None: the default, the card): {query
    id: matches}, for every query the reference suite does not skip.
    tests/parity_common.py is read for its comparison only."""
    sys.path.insert(0, os.path.dirname(PARITY_CASES))
    import parity_common as pc

    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage.engine import Engine

    out = {}
    for case in pc.load_cases():
        todo = [(i, q) for i, q in enumerate(case["queries"])
                if not q.get("skip")]
        if not todo:
            continue
        engine = Engine(fresh_root("smoke_parity"), device=device)
        svc = HttpService(engine, port=0)
        # a short poll: a stop returns within 10 ms, not the listener's
        # default half second, once per case
        svc._thread = threading.Thread(target=svc.httpd.serve_forever,
                                       kwargs={"poll_interval": 0.01},
                                       daemon=True)
        svc._thread.start()
        if not out:
            disarm_planner(svc.port)
        try:
            db, rp = case.get("db", "db0"), case.get("rp", "rp0")
            for w in [{}] + case.get("writes", []):
                wdb, wrp = w.get("db", db), w.get("rp", rp)
                if wdb not in engine.databases:
                    engine.create_database(wdb)
                d = engine.databases[wdb]
                if wrp not in d.rps:
                    engine.create_retention_policy(wdb, wrp, 0, default=True)
                d.default_rp = wrp
                if w:
                    status, _ = http(svc.port, "POST", "/write",
                                     {"db": wdb, "rp": wrp},
                                     "\n".join(w["lines"]).encode())
                    check(status == 204, f"{case['name']}: /write {status}")
            for i, q in todo:
                params = dict(q.get("params") or {"db": case["db"]})
                params["q"] = q["command"]
                status, _h, body = http_raw(svc.port, "POST", "/query",
                                            params)
                try:
                    actual = json.loads(body)
                except json.JSONDecodeError:
                    actual = {"error": f"http {status}"}
                ok, _why = pc.result_matches(q["exp"], actual)
                out[f"{case['name']}#{i}"] = ok
        finally:
            stop_server(svc, engine)
    return out


def expected_parity_count() -> int:
    """The CPU count tests/test_torch_parity.py holds the port to: the
    queries the reference does not skip, less its XFAIL dict."""
    sys.path.insert(0, os.path.dirname(PARITY_CASES))
    import test_torch_parity as tp

    return sum(1 for c in tp.CASES for q in c["queries"]
               if not q.get("skip")) - len(tp.XFAIL)


def verify_tsbs(qn: str, res: dict, o: dict, n_t: int) -> None:
    """Phase 8's answers against the cold phase's oracle."""
    import numpy as np

    n_hosts = o["n_hosts"]
    series = res.get("series", [])
    if qn == "high-cpu-1":
        want = int((o["vals"]["usage_user"][7, :n_t] > 90.0).sum())
        got = len(series[0]["values"]) if series else 0
        check(got == want, f"{qn}: {got} rows, the oracle {want}")
        if series:
            cols = series[0]["columns"]
            for row in series[0]["values"]:
                check(row[cols.index("hostname")] == "host_7"
                      and row[cols.index("usage_user")] > 90.0, f"{qn}: {row}")
    elif qn == "lastpoint":
        # the WAL check's minute holds every host's newest sample
        check(len(series) == 1 and len(series[0]["values"]) == 1
              and series[0]["values"][0][0] == T0_NS + (n_t + 5) * STEP_NS,
              f"{qn}: {json.dumps(series)[:300]}")
    elif qn == "groupby-orderby-limit":
        rows = series[0]["values"]
        v = o["vals"]["usage_user"][:, :n_t].reshape(n_hosts, n_t // 6, 6)
        mx = v.max(axis=(0, 2))
        w = n_t // 6
        check([r[0] for r in rows] == [T0_NS + (w - 1 - k) * 60 * 10**9
                                       for k in range(5)], f"{qn}: times")
        check(np.array_equal(np.array([r[1] for r in rows]),
                             mx[::-1][:5]), f"{qn}: max")
    elif qn == "show-tag-values":
        # every host, and phase 6's host_extra
        check(len(series[0]["values"]) == n_hosts + 1,
              f"{qn}: {len(series[0]['values'])} values")
    else:
        # cpu and diskio series of every host, and phase 6's host_extra
        rows = series[0]["values"]
        check(len(rows) == 1 and rows[0][2] == 2 * n_hosts + 1,
              f"{qn}: {rows}")


def phase_host(cold: dict) -> dict:
    """(a) the parity tables on the card against the CPU; (b) TSBS devops
    queries and the SHOW statements on phase 7's compacted root, each
    equal to the port's answer on the same root with device="cpu"."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.storage.engine import Engine

    t_phase = time.perf_counter()
    colcache.GLOBAL.configure(budget_mb=0)  # decode on every run
    rec = ShapeRecorder().__enter__()
    svc = engine = None
    try:
        # (a) parity: the card's answers, then the CPU's
        cs.reset_launches()
        t0 = time.perf_counter()
        on_card = parity_replay(None)
        parity_launches = dict(cs.LAUNCHES)
        card_s = time.perf_counter() - t0
        on_cpu = parity_replay("cpu")
        n_card = sum(on_card.values())
        n_cpu = sum(on_cpu.values())
        want = expected_parity_count()
        differ = sorted(k for k in on_card if on_card[k] != on_cpu.get(k))
        check(not differ, f"parity differs between the card and the CPU: "
                          f"{differ[:10]}")
        check(n_card == n_cpu == want,
              f"parity: card {n_card}, CPU {n_cpu}, the CPU test {want}")
        dev_k = {k: parity_launches[k] for k in E2E_KERNELS}
        check(sum(dev_k.values()) > 0, "parity: no device aggregate launched")
        log(f"[parity] {n_card} of {len(on_card)} reference queries match on "
            f"the card ({card_s:.1f} s), the same {n_cpu} on the CPU "
            f"(tests/test_torch_parity.py: {want}); launches of kernels 1-3 "
            f"by the device aggregates {json.dumps(dev_k)}")

        # (b) TSBS devops queries on the compacted root
        o = cold["oracle"]
        n_t = o["n_t"]
        queries = tsbs_queries(n_t)
        engine, svc = serve(cold["root"])
        disarm_planner(svc.port)
        per_query, answers = {}, {}
        for qn, q in queries.items():
            l0, st0 = dict(cs.LAUNCHES), stage_ns(svc.port)
            rec.now = {}
            res, req, ms = query_timed(svc.port, q)
            verify_tsbs(qn, res, o, n_t)
            walls, requests = [ms], [req]
            while len(walls) < HOST_RUNS.get(qn, 5):
                # another run, and as long again for the CPU comparison,
                # must fit what is left beside HOST_RESERVE_S
                left = HOST_PHASE_S - (time.perf_counter() - t_phase)
                if left < 2 * walls[-1] / 1e3 + HOST_RESERVE_S:
                    log(f"[host] {qn}: {len(walls)} run(s) (the last "
                        f"{walls[-1]:.1f} ms); five would not fit phase "
                        f"8's {HOST_PHASE_S:.0f} s")
                    break
                again, req, ms = query_timed(svc.port, q)
                check(again == res, f"{qn}: runs differ")
                walls.append(ms)
                requests.append(req)
            stages = stage_split(svc.port, st0, requests, qn)
            got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
            per_query[qn] = {"runs_ms": walls, "p50_ms": p50_of(walls),
                             "launches": got, "stages_ms": stages,
                             "shapes": {k: [shape_json(k, x) for x in
                                            sorted(v)]
                                        for k, v in rec.now.items()}}
            answers[qn] = res
            log(f"[host] {qn} ok p50={per_query[qn]['p50_ms']:.1f} ms (runs "
                f"{', '.join(f'{x:.1f}' for x in walls)}); launches "
                f"{json.dumps({k: v for k, v in got.items() if v})}")
        check(per_query["groupby-orderby-limit"]["launches"][
                  "grid_window_agg"] > 0,
              "groupby-orderby-limit did not launch kernel 3")
        rec.now = None
        launches = dict(cs.LAUNCHES)
        stop_server(svc, engine)
        svc = None
        # the same root with device="cpu": the same answers
        engine = Engine(cold["root"], device="cpu")
        svc = HttpService(engine, port=0)
        svc.start()
        for qn, q in queries.items():
            res, _req, ms = query_timed(svc.port, q)
            check(res == answers[qn], f"{qn}: the card's answer differs from "
                                      "the CPU's")
            per_query[qn]["cpu_ms"] = ms
        log(f"[host] the five answers equal the port's on the same root with "
            f"device=\"cpu\" (cpu ms "
            f"{json.dumps({qn: round(p['cpu_ms'], 1) for qn, p in per_query.items()})})")
        wall_s = time.perf_counter() - t_phase
        log(f"[host] phase 8 took {wall_s:.1f} s (budget "
            f"{HOST_PHASE_S:.0f} s); launches {json.dumps(launches)}; card "
            f"{smi_line()}")
        return {"launches": launches, "per_query": per_query,
                "parity": {"card": n_card, "cpu": n_cpu, "test": want,
                           "queries": len(on_card),
                           "launches": parity_launches},
                "shapes": rec.seen, "wall_s": wall_s}
    finally:
        rec.__exit__()
        if svc is not None:
            stop_server(svc, engine)


# -- phase 9: subqueries, joins, unions and SELECT INTO ------------------------

# phase 9's budget of its own (s), as phase 8's: a query whose run shows
# that five would not fit runs fewer times, and a progress line says so
SUBQUERY_PHASE_S = 60.0
# held back from that budget for the CPU comparison: at least this, and
# 1.5 x the card's first runs of the queries it repeats (the queries are
# host-bound, so the CPU takes about as long)
SUBQUERY_RESERVE_S = 30.0
# the script's time limit, and what phase 9 leaves of it for the checks
# after it: its runs stop early rather than let the script overrun
SCRIPT_LIMIT_S = 1200.0
# phase 13's budget (s): the load, the seven PQs, both routes, a traced
# run, the encoded decode, the read-backs and the CPU reopen
PROM_PHASE_S = 100.0
# the reserve after phase 18 (the later phases' kernel checks and the
# output), and the budgets of phases 18, 17, 16, 15 and 14 before it
AFTER_PHASE19_S = 60.0
AFTER_PHASE18_S = AFTER_PHASE19_S + 45.0  # phase 19's MESHX_PHASE_S
AFTER_PHASE17_S = AFTER_PHASE18_S + 45.0  # phase 18's EDGES_PHASE_S
AFTER_PHASE16_S = AFTER_PHASE17_S + 60.0  # phase 17's MESH_PHASE_S
AFTER_PHASE15_S = AFTER_PHASE16_S + 100.0  # phase 16's CLUSTER_PHASE_S
AFTER_PHASE14_S = AFTER_PHASE15_S + 60.0  # phase 15's RULES_PHASE_S
AFTER_PHASE13_S = AFTER_PHASE14_S + 60.0  # phase 14's CONT_PHASE_S
AFTER_PHASE12_S = AFTER_PHASE13_S + PROM_PHASE_S
AFTER_PHASE11_S = AFTER_PHASE12_S + 90.0  # phase 12's PLANNER_PHASE_S
AFTER_PHASE10_S = AFTER_PHASE11_S + 120.0  # phase 11's LIFECYCLE_PHASE_S
AFTER_PHASE9_S = AFTER_PHASE10_S + 90.0  # phase 10's DASHBOARD_PHASE_S
# the span stages of a subquery: the inner select, and the inner chunks
# with their materialization; they nest around the executor's stages
SUBQUERY_STAGES = ("subquery", "subquery(chunked)")
# phase 9's span (h) of the cold phase's COLD_HOURS: cut from 12 to 6 for
# phase 16, to 4 with COLD_HOURS (S1 must still take the chunked inner
# path, above subquery.SUBQUERY_CHUNK_ROWS, and launch on the spill
# engine)
SUBQUERY_HOURS = 4


def subquery_queries(n_t: int) -> dict:
    """Phase 9's statements over the cold phase's span of n_t samples:
    S1 a dashboard's aggregate of per-host maxima, J1 per-host CPU load
    beside disk reads, U1 one host's CPU beside another's disk counters,
    I1 downsampling by hand (it writes, so it runs last)."""
    w = f"time >= {T0_NS} AND time < {T0_NS + n_t * STEP_NS}"
    return {
        "S1": 'SELECT mean("m"), max("m") FROM (SELECT max(usage_user) AS m '
              f"FROM cpu WHERE {w} GROUP BY time(10m), hostname) "
              "GROUP BY time(1h)",
        "J1": "SELECT c.m, d.r FROM (SELECT mean(usage_user) AS m FROM cpu "
              f"WHERE {w} GROUP BY hostname) AS c INNER JOIN (SELECT "
              f"max(read_bytes) AS r FROM diskio WHERE {w} GROUP BY "
              "hostname) AS d ON c.hostname = d.hostname GROUP BY hostname",
        "U1": "SELECT usage_user, usage_system FROM cpu WHERE hostname = "
              f"'host_7' AND {w} UNION ALL SELECT reads, writes FROM diskio "
              f"WHERE hostname = 'host_9' AND {w}",
        "I1": "SELECT mean(usage_user) AS usage_user INTO cpu_1h FROM cpu "
              f"WHERE {w} GROUP BY time(1h), hostname",
    }


def i1_readbacks() -> dict:
    return {"I1 count": "SELECT count(usage_user) FROM cpu_1h",
            "I1 host_7": "SELECT mean(usage_user) FROM cpu_1h WHERE "
                         "hostname = 'host_7'"}


def verify_subquery(qn: str, res: dict, o: dict, n_t: int) -> None:
    """Phase 9's answers over the first n_t samples against the cold
    phase's oracle (phase 6's host_extra row included: one more cpu
    series, usage_user only, one row at T0)."""
    import numpy as np

    n_hosts = o["n_hosts"]
    hours = n_t // 360
    v = o["vals"]["usage_user"][:, :n_t]
    series = res.get("series", [])
    if qn == "S1":
        m = v.reshape(n_hosts, n_t // 60, 60).max(axis=2)  # 10m maxima
        hourly = m.reshape(n_hosts, hours, 6)
        want_sum = hourly.sum(axis=(0, 2))
        want_cnt = np.full(hours, n_hosts * 6)
        want_max = hourly.max(axis=(0, 2))
        want_sum[0] += EXTRA_VALUE
        want_cnt[0] += 1
        want_max[0] = max(want_max[0], EXTRA_VALUE)
        check(len(series) == 1, f"S1: {len(series)} series")
        rows = series[0]["values"]
        check([r[0] for r in rows] == [T0_NS + k * 3600 * 10**9
                                       for k in range(hours)], "S1: times")
        check(close([r[1] for r in rows], want_sum / want_cnt), "S1: mean")
        check(np.array_equal(np.array([r[2] for r in rows]), want_max),
              "S1: max")
    elif qn == "J1":
        check(len(series) == n_hosts, f"J1: {len(series)} series")
        rb = o["counters"]["read_bytes"][:, :n_t]
        for s in series:
            h = int(s["tags"]["hostname"].split("_")[1])
            check(s["columns"] == ["time", "c.m", "d.r"], f"J1: {s['columns']}")
            (row,) = s["values"]
            check(close([row[1]], [v[h].mean()]), f"J1 host {h}: mean")
            check(row[2] == int(rb[h].max()), f"J1 host {h}: max")
    elif qn == "U1":
        us = o["vals"]["usage_system"][7, :n_t]
        dio = o["counters"]
        times = [T0_NS + i * STEP_NS for i in range(n_t)]
        want = ([[t, float(a), float(b)]
                 for t, a, b in zip(times, us, v[7])]
                + [[t, int(a), int(b)] for t, a, b in
                   zip(times, dio["writes"][9, :n_t], dio["reads"][9, :n_t])])
        check(len(series) == 1 and series[0]["name"] == "cpu,diskio"
              and series[0]["columns"] == ["time", "usage_system",
                                           "usage_user"], "U1: the series")
        check(series[0]["values"] == want, "U1: rows")
    elif qn == "I1":
        check(series[0]["values"] == [[0, n_hosts * hours + 1]],
              f"I1: {series[0]['values']}")
    elif qn == "I1 count":
        check(series[0]["values"][0][1] == n_hosts * hours + 1,
              f"I1 count: {series[0]['values']}")
    else:  # I1 host_7: the mean of host_7's hourly means
        want = v[7].reshape(hours, 360).mean(axis=1).mean()
        check(close([series[0]["values"][0][1]], [want]), "I1 host_7")


def same_answer(a, b) -> bool:
    """Equal answers, floats within rtol 1e-12 (the kernels and their
    plain versions sum in other orders)."""
    import math

    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_answer(a[k], b[k])
                                            for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(same_answer, a, b))
    return type(a) is type(b) and a == b


class SubqueryProbe:
    """Wraps the port's subquery steps while entered: the chunk plans,
    the rows each materialization writes into a spill engine, and the
    kernel launches of the outer selects on the spill engines."""

    def __init__(self):
        from opengemini_tpu_torch.ops import cuda_segment as cs
        from opengemini_tpu_torch.query import subquery as sq

        self.cs, self.sq = cs, sq
        self.originals = {
            "plan": sq.SubqueryMixin._plan_subquery_chunks,
            "outer": sq.SubqueryMixin._run_outer_on,
            "materialize": sq._materialize_into}
        self.reset()

    def reset(self):
        self.chunks, self.rows = [], 0
        self.outer_launches = {k: 0 for k in self.cs.LAUNCHES}

    def __enter__(self):
        orig = self.originals

        def plan(ex, *a):
            out = orig["plan"](ex, *a)
            if out is not None:
                self.chunks.append(len(out))
            return out

        def outer(ex, *a):
            l0 = dict(self.cs.LAUNCHES)
            try:
                return orig["outer"](ex, *a)
            finally:
                for k, n in self.cs.LAUNCHES.items():
                    self.outer_launches[k] += n - l0[k]

        def materialize(tmp_engine, mst, series_list, spent=0):
            out = orig["materialize"](tmp_engine, mst, series_list, spent)
            self.rows += out - spent
            return out

        self.sq.SubqueryMixin._plan_subquery_chunks = plan
        self.sq.SubqueryMixin._run_outer_on = outer
        self.sq._materialize_into = materialize
        return self

    def __exit__(self, *exc):
        self.sq.SubqueryMixin._plan_subquery_chunks = self.originals["plan"]
        self.sq.SubqueryMixin._run_outer_on = self.originals["outer"]
        self.sq._materialize_into = self.originals["materialize"]


def phase_subquery(cold: dict, deadline: float) -> dict:
    """S1, J1, U1 and I1 on phase 7's compacted root (cache off), each
    against the oracle, then S1, J1, U1 and I1's read-backs on the same
    root with device="cpu", equal to the card's. Each query runs once,
    in order, then again while its runs fit the budget beside the CPU
    comparison (1.5 x the card's first runs of S1, J1 and U1, at least
    SUBQUERY_RESERVE_S); `deadline` (the perf_counter by which the phase
    must end) can shorten the budget."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.storage.engine import Engine

    t_phase = time.perf_counter()
    budget = min(SUBQUERY_PHASE_S, deadline - t_phase)
    colcache.GLOBAL.configure(budget_mb=0)  # decode on every run
    o = cold["oracle"]
    n_t = SUBQUERY_HOURS * 360
    queries = subquery_queries(n_t)
    rec = ShapeRecorder().__enter__()
    probe = SubqueryProbe().__enter__()
    svc = engine = None
    try:
        torch.cuda.synchronize()
        cs.reset_launches()
        engine, svc = serve(cold["root"])
        disarm_planner(svc.port)
        runs = {qn: {"walls": [], "requests": [], "stages": {},
                     "launches": {k: 0 for k in cs.LAUNCHES},
                     "outer": {k: 0 for k in cs.LAUNCHES}, "shapes": {},
                     "peak": 0, "chunks": [], "rows": 0}
                for qn in queries}
        answers = {}

        def run(qn: str) -> None:
            """One timed run of `qn`, added to runs[qn]."""
            r = runs[qn]
            l0, st0 = dict(cs.LAUNCHES), stage_ns(svc.port)
            rec.now = r["shapes"]
            probe.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res, req, ms = query_timed(svc.port, queries[qn],
                                       "POST" if qn == "I1" else "GET")
            if qn in answers:
                check(same_answer(res, answers[qn]), f"{qn}: runs differ")
            else:
                verify_subquery(qn, res, o, n_t)
                answers[qn] = res
                r["chunks"], r["rows"] = probe.chunks[:1], probe.rows
            st1 = stage_ns(svc.port)
            for k in st1:
                r["stages"][k] = r["stages"].get(k, 0) + st1[k] - st0.get(k, 0)
            for k in cs.LAUNCHES:
                r["launches"][k] += cs.LAUNCHES[k] - l0[k]
                r["outer"][k] += probe.outer_launches[k]
            r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
            r["walls"].append(ms)
            r["requests"].append(req)

        for qn in queries:
            run(qn)
        reserve = max(SUBQUERY_RESERVE_S, 1.5 * sum(
            runs[qn]["walls"][0] for qn in ("S1", "J1", "U1")) / 1e3)
        for qn in queries:  # I1, which writes, stays last
            walls = runs[qn]["walls"]
            while len(walls) < 5:
                left = budget - (time.perf_counter() - t_phase)
                if left < walls[-1] / 1e3 + reserve:
                    log(f"[subquery] {qn}: {len(walls)} run(s) (the last "
                        f"{walls[-1]:.1f} ms); five would not fit phase 9's "
                        f"{budget:.0f} s beside {reserve:.0f} s for the CPU")
                    break
                run(qn)
        rec.now = None
        per_query = {}
        for qn, r in runs.items():
            n = len(r["walls"])
            p50 = p50_of(r["walls"])
            per_query[qn] = {
                "runs_ms": r["walls"], "p50_ms": p50,
                "launches": r["launches"],
                "stages_ms": stage_split(svc.port, {}, r["requests"], qn,
                                         extra=SUBQUERY_STAGES,
                                         after=r["stages"]),
                "peak_bytes": r["peak"], "chunks": r["chunks"],
                "rows_per_run": r["rows"],
                "outer_launches": {k: v // n for k, v in r["outer"].items()
                                   if v},
                "shapes": {k: [shape_json(k, x) for x in sorted(v)]
                           for k, v in r["shapes"].items()}}
            got = {k: v for k, v in r["launches"].items() if v}
            log(f"[subquery] {qn} ok p50={p50:.1f} ms (runs "
                f"{', '.join(f'{x:.1f}' for x in r['walls'])}); {r['rows']} "
                f"rows into the spill engines a run"
                + (f", {r['chunks'][0]} inner chunks" if r["chunks"] else "")
                + f"; launches in {n} runs {json.dumps(got)} (a run on the "
                f"spill engines {json.dumps(per_query[qn]['outer_launches'])})"
                f"; device memory peak {r['peak'] / 2**20:.1f} MiB")
        s1 = per_query["S1"]
        check(s1["chunks"] and s1["chunks"][0] >= 2,
              f"S1 took no chunked inner path: {s1['chunks']}")
        inner3 = (s1["launches"]["grid_window_agg"]
                  - s1["outer_launches"].get("grid_window_agg", 0)
                  * len(s1["runs_ms"]))
        check(inner3 > 0, "S1: kernel 3 not launched on the inner chunks")
        check(sum(s1["outer_launches"].get(k, 0) for k in E2E_KERNELS) > 0,
              "S1: the outer aggregate launched no kernel on the spill engine")
        check(sum(per_query["J1"]["launches"][k] for k in E2E_KERNELS) > 0,
              "J1: its sides launched no kernel")
        for qn, q in i1_readbacks().items():
            res, _req, ms = query_timed(svc.port, q)
            verify_subquery(qn, res, o, n_t)
            answers[qn] = res
            log(f"[subquery] {qn} ok ({ms:.1f} ms): "
                f"{json.dumps(res['series'][0]['values'])}")
        launches = dict(cs.LAUNCHES)
        stop_server(svc, engine)
        svc = None
        # the same root with device="cpu": the same answers
        engine = Engine(cold["root"], device="cpu")
        svc = HttpService(engine, port=0)
        svc.start()
        cpu_ms = {}
        for qn, q in {**{k: queries[k] for k in ("S1", "J1", "U1")},
                      **i1_readbacks()}.items():
            res, _req, ms = query_timed(svc.port, q)
            check(same_answer(res, answers[qn]),
                  f"{qn}: the card's answer differs from the CPU's")
            cpu_ms[qn] = ms
        log(f"[subquery] S1, J1, U1 and I1's read-backs equal the port's on "
            f"the same root with device=\"cpu\" (cpu ms "
            f"{json.dumps({k: round(v, 1) for k, v in cpu_ms.items()})})")
        wall_s = time.perf_counter() - t_phase
        log(f"[subquery] phase 9 took {wall_s:.1f} s (budget {budget:.0f} s);"
            f" launches {json.dumps(launches)}; card {smi_line()}")
        return {"launches": launches, "per_query": per_query,
                "cpu_ms": cpu_ms, "shapes": rec.seen, "wall_s": wall_s}
    finally:
        probe.__exit__()
        rec.__exit__()
        if svc is not None:
            stop_server(svc, engine)


# -- phase 10: a dashboard panel over twice the cold span, refreshed ----------

# phase 10's budget: the day-2 load and one run of each statement; it is
# printed beside the phase's wall
DASHBOARD_PHASE_S = 90.0
# phase 10's slice threshold (rows): the executor's default
# (SLICE_THRESHOLD_ROWS, 24 M) scaled by COLD_HOURS / 12, so that the
# panel over twice the cold span slices as the 24 h panel did at 12 h
DASH_SLICE_ROWS = 24_000_000 * COLD_HOURS // 12
# the percentile P1 asks for (sketch.py bounds its error by one global
# bin width of the exact nearest-rank percentile)
P1_PERCENTILE = 95


def rfc3339(ns: int) -> str:
    from datetime import datetime, timezone

    return datetime.fromtimestamp(ns // 10**9, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def panel(lo_ns: int, hi_ns: int) -> str:
    """The Grafana panel: mean, max and count of usage_user per minute."""
    return ("SELECT mean(usage_user), max(usage_user), count(usage_user) "
            f"FROM cpu WHERE time >= '{rfc3339(lo_ns)}' AND "
            f"time < '{rfc3339(hi_ns)}' GROUP BY time(1m)")


def day2_values(o: dict, seed: int, n_more: int):
    """Day 2 of every cpu field (n_t samples) and the n_more samples
    after it: its first minute is the one phase 5 wrote through /write
    (`extra`, already on disk), the rest a random walk on from there."""
    import numpy as np

    rng = np.random.default_rng(seed + 10)
    n_t = o["n_t"]
    out = {}
    for f in FIELDS:
        first = o["extra"][f]
        steps = rng.normal(0.0, 1.0, (o["n_hosts"], n_t - 6 + n_more))
        out[f] = np.concatenate([first, np.clip(
            first[:, -1:] + np.cumsum(steps, axis=1), 0.0, 100.0)], axis=1)
    return out


def cpu_lines(tags, vals, lo: int, hi: int, n_hosts: int, base: int) -> str:
    """Line protocol of cpu samples [lo, hi) of `vals` for every host,
    whose sample 0 lies at sample `base` of the data set."""
    from opengemini_tpu_torch.ingest.line_protocol import series_key

    lines = []
    for h in range(n_hosts):
        key = series_key("cpu", tags[h])
        for i in range(lo, hi):
            fv = ",".join(f"{f}={float(vals[f][h, i])!r}" for f in FIELDS)
            lines.append(f"{key} {fv} {T0_NS + (base + i) * STEP_NS}")
    return "\n".join(lines)


def cpu_table(tags, vals, lo: int, hi: int, n_hosts: int, base: int) -> dict:
    """convert.load_columnar's cpu table of samples [lo, hi) of `vals`,
    whose sample 0 lies at sample `base` of the data set."""
    import numpy as np

    from opengemini_tpu_torch.ingest.line_protocol import series_key

    n = hi - lo
    times = T0_NS + np.arange(base + lo, base + hi, dtype=np.int64) * STEP_NS
    ones = np.ones(n_hosts * n, dtype=np.bool_)
    return {"series_keys": [series_key("cpu", t) for t in tags],
            "series": np.repeat(np.arange(n_hosts, dtype=np.int64), n),
            "times": np.tile(times, n_hosts),
            "fields": {f: (np.ascontiguousarray(vals[f][:, lo:hi]).reshape(-1),
                           ones) for f in FIELDS}}


def verify_panel(qn: str, res: dict, usage, w0: int, extra: bool) -> None:
    """A panel's rows against the oracle: `usage` (hosts, samples) from
    the first sample of window w0; phase 6's host_extra row in window 0."""
    import numpy as np

    (series,) = res.get("series", [None])
    rows = series["values"]
    W = usage.shape[1] // 6
    v = usage[:, :W * 6].reshape(usage.shape[0], W, 6)
    cnt = np.full(W, usage.shape[0] * 6)
    tot = v.sum(axis=(0, 2))
    mx = v.max(axis=(0, 2))
    if extra:
        cnt[0] += 1
        tot[0] += EXTRA_VALUE
        mx[0] = max(mx[0], EXTRA_VALUE)
    check(len(rows) == W, f"{qn}: {len(rows)} windows, not {W}")
    check([r[0] for r in rows] == [T0_NS + (w0 + w) * 60 * 10**9
                                   for w in range(W)], f"{qn}: times")
    check(close([r[1] for r in rows], tot / cnt), f"{qn}: mean")
    check(np.array_equal(np.array([r[2] for r in rows]), mx), f"{qn}: max")
    check([r[3] for r in rows] == cnt.tolist(), f"{qn}: count")


def same_bits(a: dict, b: dict) -> tuple[bool, bool]:
    """(equal with the means at rel 1e-12 and every other value exact,
    equal bit for bit) of two panel answers."""
    ra, rb = a["series"][0]["values"], b["series"][0]["values"]
    if len(ra) != len(rb) or any(x[0] != y[0] or x[2:] != y[2:]
                                 for x, y in zip(ra, rb)):
        return False, False
    return close([x[1] for x in ra], [y[1] for y in rb], 1e-12), ra == rb


class DashboardProbe:
    """While entered: the slice plans of the sliced scans and the slices
    they scanned, and the series the pre-aggregation and sketch paths
    served from chunk metadata (their dedup probe said no merge)."""

    def __init__(self):
        from opengemini_tpu_torch.query import executor as ex
        from opengemini_tpu_torch.query import hostpath as hp

        self.mods = (ex, hp)
        self.originals = (ex._plan_scan_slices,
                          ex._series_needs_merged_decode,
                          hp._series_needs_merged_decode,
                          ex.Executor._scan_sliced)
        self.reset()

    def reset(self):
        self.slices, self.ran, self.probed, self.from_meta = [], [], 0, 0

    def __enter__(self):
        ex, hp = self.mods
        plan0, need0, _, sliced0 = self.originals

        def plan(*a):
            out = plan0(*a)
            self.slices.append(len(out) if out else 0)
            return out

        def need(*a):
            got = need0(*a)
            self.probed += 1
            self.from_meta += not got[0]
            return got

        def sliced(executor, *a):
            rows, out = sliced0(executor, *a)
            self.ran.append(len(out))
            return rows, out

        ex._plan_scan_slices = plan
        ex._series_needs_merged_decode = need
        hp._series_needs_merged_decode = need
        ex.Executor._scan_sliced = sliced
        return self

    def __exit__(self, *exc):
        ex, hp = self.mods
        (ex._plan_scan_slices, ex._series_needs_merged_decode,
         hp._series_needs_merged_decode,
         ex.Executor._scan_sliced) = self.originals


def phase_dashboard(cold: dict, seed: int, deadline: float) -> dict:
    """On phase 7's compacted root (COLD_HOURS): day 2 of TSBS devops cpu
    (as many hours again) written and flushed, then a Grafana panel over
    both (R0, "last 12 hours" at COLD_HOURS 6) with
    the result cache on: a sliced scan, kernel 3 once per slice; R1, the
    same panel again, from the cache alone; the next minute written and
    R2, the panel moved on by a minute, scanning that minute only; P1,
    per-host count and mean and percentile_approx over day 2; K1, a
    cache-off R0 killed from a second connection, then R0 again in one
    pass, equal to the sliced R0. Every answer against the oracle."""
    import numpy as np
    import torch

    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.query import executor as ex
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

    t_phase = time.perf_counter()
    o = cold["oracle"]
    n_hosts, n_t = o["n_hosts"], o["n_t"]
    span_ns = n_t * STEP_NS
    # the deployment's decoded-column cache: the host tier at its default
    # budget, the device tier off
    cc = colcache.GLOBAL
    cc.configure(budget_mb=256, device=False)
    vals2 = day2_values(o, seed, 6)
    usage = np.concatenate([o["vals"]["usage_user"][:, :n_t],
                            vals2["usage_user"][:, :n_t]], axis=1)
    q_day = panel(T0_NS, T0_NS + 2 * span_ns)
    q_next = panel(T0_NS + 60 * 10**9, T0_NS + 2 * span_ns + 60 * 10**9)
    w_day2 = (f"time >= {T0_NS + span_ns} AND time < {T0_NS + 2 * span_ns}")
    q_p1 = ("SELECT count(usage_user), mean(usage_user) FROM cpu WHERE "
            f"{w_day2} GROUP BY hostname")
    q_pct = (f"SELECT percentile_approx(usage_user, {P1_PERCENTILE}) FROM cpu "
             f"WHERE {w_day2} GROUP BY hostname")
    rec = ShapeRecorder().__enter__()
    probe = DashboardProbe().__enter__()
    svc = engine = None
    per_query: dict = {}

    def executor_stat(name: str) -> int:
        return STATS.counters("executor").get(name, 0)

    def run(qn: str, q: str, cache: bool, check_launch: bool = True,
            mono: bool = False) -> dict:
        """One timed run of `q`, printed with its slices, scan rows,
        cache counters, launches, stages and memory peak."""
        os.environ["OGT_RESULT_CACHE"] = "1" if cache else "0"
        threshold = ex.SLICE_THRESHOLD_ROWS
        if mono:  # one pass: the threshold raised for this run only
            ex.SLICE_THRESHOLD_ROWS = 1 << 62
        probe.reset()
        l0, st0, c0 = dict(cs.LAUNCHES), stage_ns(svc.port), cc.counters()
        x0 = {k: executor_stat(k) for k in (
            "rows_scanned", "inc_cache_windows_reused", "inc_cache_full_hits")}
        rec.now = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            res, req, ms = query_timed(svc.port, q)
        finally:
            ex.SLICE_THRESHOLD_ROWS = threshold
        c1 = cc.counters()
        got = {
            "result": res, "wall_ms": ms,
            "launches": {k: cs.LAUNCHES[k] - l0[k] for k in l0},
            "slices_planned": max(probe.slices, default=0),
            "slices": sum(probe.ran),
            "from_meta": probe.from_meta, "probed": probe.probed,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "colcache": {k: c1[k] - c0[k] for k in ("hits", "misses")},
            "colcache_bytes": c1["bytes"],
            **{k: executor_stat(k) - v for k, v in x0.items()}}
        got["stages_ms"] = stage_split(svc.port, st0, [req], qn,
                                       extra=("inc_cache",))
        got["shapes"] = {k: [shape_json(k, x) for x in sorted(v)]
                         for k, v in rec.now.items()}
        rec.now = None
        launched = {k: v for k, v in got["launches"].items() if v}
        log(f"[dashboard] {qn} {ms:.1f} ms: {got['slices']} of "
            f"{got['slices_planned']} planned slices scanned, "
            f"{got['rows_scanned']} rows scanned, windows from the cache "
            f"{got['inc_cache_windows_reused']} (full hits "
            f"{got['inc_cache_full_hits']}), colcache hits/misses "
            f"{got['colcache']['hits']}/{got['colcache']['misses']} with "
            f"{got['colcache_bytes'] / 2**20:.1f} MiB resident, launches "
            f"{json.dumps(launched)}, device memory peak "
            f"{got['peak_bytes'] / 2**20:.1f} MiB")
        if check_launch:
            check(launched, f"{qn}: no kernel launched")
        per_query[qn] = {k: v for k, v in got.items() if k != "result"}
        return got

    slice_rows = ex.SLICE_THRESHOLD_ROWS
    ex.SLICE_THRESHOLD_ROWS = DASH_SLICE_ROWS
    try:
        torch.cuda.synchronize()
        cs.reset_launches()
        engine, svc = serve(cold["root"])
        disarm_planner(svc.port)
        # (a) day 2, hour by hour, then a flush, as phase 5 writes
        os.environ["OGT_DEVICE_PROFILE"] = "1"
        t_load = time.perf_counter()
        # the first minute is on disk since phase 5: no row is written
        # twice, so no chunk overlaps another and the scans may keep
        # their blocks encoded for the card
        for hr in range(n_t // 360):
            lo, hi = max(hr * 360, 6), (hr + 1) * 360
            n = convert.load_columnar(engine, "benchmark", {
                "cpu": cpu_table(o["tags"], vals2, lo, hi, n_hosts, n_t)})
            check(n == n_hosts * (hi - lo), f"day 2 hour {hr}: wrote {n}")
        engine.flush_all()
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        shards = engine.shards_for_range("benchmark", None, 0, 2**62)
        files = sum(len(sh._files) for sh in shards)
        rows, chunks = (sum(x) for x in zip(*(
            sh.approx_rows("cpu", T0_NS, T0_NS + 2 * span_ns)
            for sh in shards)))
        load_s = time.perf_counter() - t_load
        log(f"[dashboard] day 2: {n_hosts * (n_t - 6)} cpu rows in "
            f"{load_s:.1f} s (its first minute is phase 5's); "
            f"{files} TSF files; cpu over {2 * n_t // 360} h: {rows} rows in "
            f"{chunks} "
            "chunks by their metadata")

        # (b) R0: the sliced scan, the cache on (and empty for it)
        r0 = run("R0", q_day, cache=True)
        verify_panel("R0", r0["result"], usage, 0, True)
        check(r0["slices"] >= 2, f"R0 took {r0['slices']} slices")
        check(r0["launches"]["grid_window_agg"] == r0["slices"],
              f"R0: kernel 3 launched {r0['launches']['grid_window_agg']} "
              f"times over {r0['slices']} slices")
        # (c) R1: the panel again, all from the cache
        r1 = run("R1", q_day, cache=True, check_launch=False)
        check(r1["result"] == r0["result"], "R1 differs from R0")
        check(r1["rows_scanned"] == 0 and r1["inc_cache_full_hits"] == 1,
              f"R1 scanned {r1['rows_scanned']} rows")
        check(not any(r1["launches"].values()),
              f"R1 launched {r1['launches']}")
        # the next minute of every host, then R2: the panel a minute on
        minute = {f: vals2[f][:, n_t:] for f in FIELDS}
        status, _ = http(svc.port, "POST", "/write",
                         {"db": "benchmark", "precision": "ns"},
                         cpu_lines(o["tags"], minute, 0, 6, n_hosts,
                                   2 * n_t).encode())
        check(status == 204, f"/write status {status}")
        r2 = run("R2", q_next, cache=True)
        W = 2 * n_t // 6
        check(r2["inc_cache_windows_reused"] == W - 1
              and r2["rows_scanned"] == n_hosts * 6,
              f"R2 reused {r2['inc_cache_windows_reused']} windows and "
              f"scanned {r2['rows_scanned']} rows")
        # one slice holds the new window; its 24 000 rows fill one of
        # the slice's 80 or so windows, and the grid may refuse so sparse a
        # layout for the bucketed batch (kernel 1)
        check(r2["slices"] == 1 and 0 < sum(r2["launches"].values()) <= 2,
              f"R2: {r2['slices']} slices, launches {r2['launches']}")
        verify_panel("R2", r2["result"], np.concatenate(
            [usage[:, 6:], minute["usage_user"]], axis=1), 1, False)
        r2_off = run("R2 cache off", q_next, cache=False, mono=True)
        ok, bitwise = same_bits(r2["result"], r2_off["result"])
        check(ok, "R2 differs from its cache-off run")
        per_query["R2"]["bitwise_to_cache_off"] = bitwise
        log("[dashboard] R2 equals its cache-off run in one pass "
            + ("bit for bit" if bitwise else "(counts and maxima bit for "
               "bit, means within rel 1e-12: the cached windows summed in "
               "R0's slices, the new one in its own batch)"))
        # (d) P1: per-host count and mean (kernel 1), percentile_approx
        p1 = run("P1", q_p1, cache=True)
        series = p1["result"]["series"]
        check(len(series) == n_hosts, f"P1: {len(series)} series")
        d2 = vals2["usage_user"][:, :n_t]
        for s in series:
            h = int(s["tags"]["hostname"].split("_")[1])
            (row,) = s["values"]
            check(row[1] == n_t and close([row[2]], [d2[h].mean()]),
                  f"P1 host {h}: {row}")
        check(p1["launches"]["bucket_stats_basic"] > 0,
              "P1: kernel 1 not launched")
        pct = run("P1 percentile", q_pct, cache=True, check_launch=False)
        series = pct["result"]["series"]
        check(len(series) == n_hosts, f"P1 percentile: {len(series)} series")
        worst = 0.0
        for s in series:
            h = int(s["tags"]["hostname"].split("_")[1])
            exact = np.percentile(d2[h], P1_PERCENTILE, method="inverted_cdf")
            # the sketch's bin: 1.0 wide when a host's day is constant
            # (the random walk held at 0 or 100; sketch.HistSketch._width)
            span = d2[h].max() - d2[h].min()
            width = span / 256 if span > 0 else 1.0
            err = abs(s["values"][0][1] - exact)
            check(err <= width * (1 + 1e-9),
                  f"P1 percentile host {h}: {err} > one bin {width}")
            worst = max(worst, err / width)
        log(f"[dashboard] P1 served {p1['from_meta']} of {p1['probed']} "
            f"series from chunk metadata, the percentile "
            f"{pct['from_meta']} of {pct['probed']}: at {n_hosts} hosts "
            f"every flush packs (PACK_MIN_SERIES 64), so every series "
            f"decodes; the percentile's worst error {worst:.3f} of one "
            "global bin width")
        # (e) K1: a cache-off R0 killed from a second connection
        k1 = kill_panel(svc.port, q_day, cc)
        r0_mono = run("R0 one pass", q_day, cache=False, mono=True)
        verify_panel("R0 one pass", r0_mono["result"], usage, 0, True)
        ok, bitwise = same_bits(r0["result"], r0_mono["result"])
        check(ok, "the sliced R0 differs from the one-pass R0")
        check(r0_mono["slices"] == 0, "R0 one pass sliced")
        log(f"[dashboard] sliced R0 equals the one-pass R0 "
            + ("bit for bit" if bitwise else "(counts and maxima bit for "
               "bit, means within rel 1e-12)"))
        per_query["R0"]["bitwise_to_one_pass"] = bitwise
        launches = dict(cs.LAUNCHES)
        wall_s = time.perf_counter() - t_phase
        log(f"[dashboard] phase 10 took {wall_s:.1f} s (budget "
            f"{DASHBOARD_PHASE_S:.0f} s, {deadline - time.perf_counter():.0f}"
            f" s left of the script's); launches {json.dumps(launches)}; "
            f"card {smi_line()}")
        return {"launches": launches, "per_query": per_query, "kill": k1,
                "shapes": rec.seen, "wall_s": wall_s, "load_s": load_s,
                "files": files}
    finally:
        ex.SLICE_THRESHOLD_ROWS = slice_rows
        os.environ["OGT_RESULT_CACHE"] = "0"
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        probe.__exit__()
        rec.__exit__()
        if svc is not None:
            stop_server(svc, engine)


def kill_panel(port: int, q: str, cc) -> dict:
    """K1: `q` with the result cache off on a second connection; poll
    SHOW QUERIES on this one until it is listed, let it scan, KILL it,
    and time the KILL to its answer. The device memory it held goes back
    (less what the device tier keeps), and /debug/queries drops it."""
    import torch

    os.environ["OGT_RESULT_CACHE"] = "0"
    torch.cuda.synchronize()
    mem0, dev0 = torch.cuda.memory_allocated(), cc.counters()["device_bytes"]
    out = {}

    def victim():
        conn = HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("GET", "/query?" + urllib.parse.urlencode(
            {"db": "benchmark", "q": q, "epoch": "ns"}))
        out["doc"] = json.loads(conn.getresponse().read())
        out["t"] = time.perf_counter()
        conn.close()

    t = threading.Thread(target=victim, daemon=True)
    t0 = time.perf_counter()
    t.start()
    qid = None
    while qid is None and time.perf_counter() - t0 < 60:
        res = query(port, "SHOW QUERIES")
        for row in res["series"][0]["values"]:
            if row[1] == q:
                qid = row[0]
        time.sleep(0.05)
    check(qid is not None, "K1: R0 never listed in SHOW QUERIES")
    time.sleep(1.0)  # into its scan
    check(t.is_alive(), "K1: R0 ended before the KILL")
    t_kill = time.perf_counter()
    res, _req, _ms = query_timed(port, f"KILL QUERY {qid}", "POST")
    t.join(timeout=120)
    check(not t.is_alive(), "K1: R0 did not answer after the KILL")
    want = {"results": [{"statement_id": 0, "error": f"query {qid} killed"}]}
    check(out["doc"] == want, f"K1 answered {out['doc']}")
    kill_ms = (out["t"] - t_kill) * 1e3
    status, doc = http(port, "GET", "/debug/queries", {})
    check(status == 200 and not [x for x in doc["queries"]
                                 if x["query"] == q],
          f"K1 still in /debug/queries: {doc}")
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    held = cc.counters()["device_bytes"] - dev0
    check(mem1 <= mem0 + held, f"K1: device memory {mem1} B after the KILL, "
          f"{mem0} B before (+{held} B in the device tier)")
    log(f"[dashboard] K1 qid {qid} killed {(t_kill - t0) * 1e3:.1f} ms "
        f"after it was sent; answered '{out['doc']['results'][0]['error']}'"
        f" {kill_ms:.1f} ms after the KILL; /debug/queries no longer lists "
        f"it; device memory {mem0} B before, {mem1} B after")
    return {"qid": qid, "kill_to_answer_ms": kill_ms,
            "run_before_kill_ms": (t_kill - t0) * 1e3,
            "memory_before": mem0, "memory_after": mem1}


# -- main ---------------------------------------------------------------------


# -- phase 11: the data lifecycle at TSBS devops width -------------------------

# phase 11's budget: its loads, the four rewrites, the quarantine and
# the CPU comparison; it is printed beside the phase's wall
LIFECYCLE_PHASE_S = 120.0
# cpu: 1 h at 10 s steps, flushed every 20 min (three files), then 20
# more minutes written after the deletes (the file Q1 quarantines);
# syslog: 30 min, one line per host every 10 s
LIFE_CPU_STEPS = 360
LIFE_LATE_STEPS = 120
LIFE_FLUSH_STEPS = 120
LIFE_SYSLOG_STEPS = 180
# the hosts whose kernel logs "Out of memory: Killed process" (severity
# err); every other host logs sshd and CRON lines at one of these
LIFE_OOM_HOSTS = 40
LIFE_SEVERITIES = ("info", "notice", "warning")
# a kernel OOM line every this many steps on an OOM host
LIFE_OOM_EVERY = 6
LIFE_USERS = ("deploy", "ops", "backup")
LIFE_D1_HOST = 7   # DELETE FROM cpu WHERE hostname = 'host_7'
LIFE_D3_HOST = 9   # DROP SERIES FROM syslog WHERE hostname = 'host_9'
# D2: DELETE FROM cpu WHERE time >= t0 + 30m AND time < t0 + 40m
LIFE_D2_STEPS = (180, 240)
# the syslog lines D4's /write sends after DROP MEASUREMENT syslog
LIFE_D4_HOSTS = 50


def syslog_message(h: int, i: int, oom: bool) -> str:
    """Host h's syslog line at step i (a seeded template set: sshd and
    CRON on every host, the kernel's OOM kill on the OOM hosts)."""
    pid = 1000 + (h * 7 + i) % 5
    if oom and i % LIFE_OOM_EVERY == 3:
        return (f"kernel: Out of memory: Killed process {20000 + h} (java) "
                f"total-vm:{8388608 + 4096 * (i % 4)}kB")
    if i % 3 == 0:
        return f"CRON[{pid}]: (root) CMD (/usr/lib/sa/sa1 1 1)"
    user = LIFE_USERS[(h + i) % len(LIFE_USERS)]
    return (f"sshd[{pid}]: Accepted publickey for {user} from "
            f"10.{h // 256 % 256}.{h % 256}.{1 + i % 3} port {40000 + h}")


def syslog_lines(hosts, sev, oom, lo: int, hi: int, base: int = 0) -> str:
    """Line protocol of syslog steps [lo, hi) of `hosts`."""
    out = []
    for h in hosts:
        key = f"syslog,hostname=host_{h},severity={sev[h]}"
        for i in range(lo, hi):
            msg = syslog_message(h, i, bool(oom[h]))
            out.append(f'{key} message="{msg}" '
                       f"{T0_NS + (base + i) * STEP_NS}")
    return "\n".join(out)


def life_panel_oracle(usage, keep) -> dict:
    """count, mean and max of usage_user per minute over the kept
    samples: (hosts, steps) arrays, 6 steps a window."""
    import numpy as np

    n_h, n_s = usage.shape
    W = n_s // 6
    u = usage[:, :W * 6].reshape(n_h, W, 6)
    k = keep[:, :W * 6].reshape(n_h, W, 6)
    cnt = k.sum(axis=(0, 2))
    tot = np.where(k, u, 0.0).sum(axis=(0, 2))
    mx = np.where(k, u, -np.inf).max(axis=(0, 2))
    return {"count": cnt, "sum": tot, "max": mx}


def verify_life_panel(qn: str, res: dict, usage, keep) -> None:
    """P0's 80 windows against the oracle of the kept samples: counts
    and maxima exact, means within rel 1e-9; windows with no sample
    answer null."""
    import numpy as np

    o = life_panel_oracle(usage, keep)
    (series,) = res.get("series", [None])
    rows = series["values"]
    W = len(o["count"])
    check(len(rows) == W, f"{qn}: {len(rows)} windows, not {W}")
    check([r[0] for r in rows] == [T0_NS + w * 60 * 10**9
                                   for w in range(W)], f"{qn}: times")
    for w, r in enumerate(rows):
        c = int(o["count"][w])
        if c == 0:
            check(r[1] is None and r[2] is None and r[3] in (0, None),
                  f"{qn}: window {w} has no sample but answers {r}")
            continue
        check(r[3] == c, f"{qn}: window {w} count {r[3]}, not {c}")
        check(r[2] == float(o["max"][w]), f"{qn}: window {w} max")
        check(close([r[1]], [o["sum"][w] / c]), f"{qn}: window {w} mean")


class TextLookups:
    """Wraps Shard.text_match_sids to record the series each sidecar
    lookup left (the pruning set a match() query scans)."""

    def __init__(self):
        from opengemini_tpu_torch.storage.shard import Shard

        self.cls = Shard
        self.orig = Shard.text_match_sids
        self.left: list = []

    def __enter__(self):
        orig = self.orig

        def lookup(sh, mst, field, token):
            got = orig(sh, mst, field, token)
            self.left.append(None if got is None else len(got))
            return got
        self.cls.text_match_sids = lookup
        return self

    def __exit__(self, *exc):
        self.cls.text_match_sids = self.orig


def phase_lifecycle(seed: int, deadline: float) -> dict:
    """The data lifecycle at TSBS devops width (4000 hosts) on a root of
    its own: cpu (1 h, the device profile, three flushes) and syslog (30
    min, a string message); T1/T2 match() with the text sidecars; the
    panel P0 with the result cache on; the delete rewrites D1-D3, each
    followed by P0; D4, DROP MEASUREMENT and a write that purges; Q1, a
    bitflip armed on one cpu file through /debug/ctrl: P0 answers the
    quarantine error, the file is marked and listed, P0 again without
    it, a restart keeps it out, the purge removes it; then the root
    reopened with device="cpu" gives the card's answers."""
    import numpy as np
    import torch

    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.storage import colcache, diskfault

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    n_hosts = N_HOSTS
    n_cpu = LIFE_CPU_STEPS + LIFE_LATE_STEPS
    tags = host_tags(n_hosts, rng)
    vals = make_values(n_hosts, n_cpu, rng)
    usage = vals["usage_user"]
    keep = np.zeros((n_hosts, n_cpu), np.bool_)  # the oracle's rows
    oom = np.zeros(n_hosts, np.bool_)
    oom[rng.choice(n_hosts, LIFE_OOM_HOSTS, replace=False)] = True
    sev = {h: ("err" if oom[h] else LIFE_SEVERITIES[int(rng.integers(3))])
           for h in range(n_hosts)}
    t_lo, t_hi = T0_NS, T0_NS + n_cpu * STEP_NS
    q_p0 = panel(t_lo, t_hi)
    q_t1 = ("SELECT count(message) FROM syslog WHERE match(message, "
            "'memory') GROUP BY hostname")
    t2_lo, t2_hi = 30, 150  # steps: t0 + 5m .. t0 + 25m
    q_t2 = ("SELECT hostname, message FROM syslog WHERE match(message, "
            f"'killed') AND severity = 'err' AND time >= "
            f"'{rfc3339(T0_NS + t2_lo * STEP_NS)}' AND time < "
            f"'{rfc3339(T0_NS + t2_hi * STEP_NS)}'")
    q_d4 = "SELECT count(message) FROM syslog GROUP BY hostname"
    root = fresh_root("smoke_lifecycle")
    cc = colcache.GLOBAL
    cc.configure(budget_mb=256, device=False)  # as deployed
    rec = ShapeRecorder().__enter__()
    lookups = TextLookups().__enter__()
    svc = engine = None
    per_query: dict = {}
    steps: dict = {}

    def run(qn: str, q: str, cache: bool = False,
            check_launch: bool = True) -> dict:
        """One timed run of `q`, with its launches, stages, sidecar
        lookups and memory peak printed."""
        os.environ["OGT_RESULT_CACHE"] = "1" if cache else "0"
        l0, st0 = dict(cs.LAUNCHES), stage_ns(svc.port)
        lookups.left.clear()
        rec.now = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, req, ms = query_timed(svc.port, q)
        got = {"result": res, "wall_ms": ms,
               "launches": {k: cs.LAUNCHES[k] - l0[k] for k in l0},
               "sidecar_left": list(lookups.left),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        got["stages_ms"] = stage_split(svc.port, st0, [req], qn,
                                       extra=("inc_cache",))
        got["shapes"] = {k: [shape_json(k, x) for x in sorted(v)]
                         for k, v in rec.now.items()}
        rec.now = None
        launched = {k: v for k, v in got["launches"].items() if v}
        log(f"[lifecycle] {qn} {ms:.1f} ms: launches "
            f"{json.dumps(launched)}, kernels 3-5 "
            f"{[got['launches'][k] for k in COLD_KERNELS[:3]]}, sidecar "
            f"lookups left {got['sidecar_left']} series, device memory "
            f"peak {got['peak_bytes'] / 2**20:.1f} MiB")
        if check_launch:
            check(got["launches"]["grid_window_agg"] > 0,
                  f"{qn}: kernel 3 not launched")
        per_query[qn] = {k: v for k, v in got.items() if k != "result"}
        return got

    def files():
        return sorted(r.path for sh in engine.all_shards()
                      for r in sh._files)

    def rewrite(dn: str, q: str) -> dict:
        """One delete statement by POST, timed, with the files before
        and after, the rows the rewrite kept and the memory peak."""
        before = files()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        status, doc = http(svc.port, "POST", "/query",
                           {"db": "benchmark", "q": q})
        wall = (time.perf_counter() - t0) * 1e3
        check(status == 200 and "error" not in doc["results"][0],
              f"{dn}: {status} {doc}")
        after = files()
        kept = sum(sh.approx_rows(m)[0] for sh in engine.all_shards()
                   for m in ("cpu", "syslog"))
        peak = torch.cuda.max_memory_allocated()
        log(f"[lifecycle] {dn} ({q}) {wall:.1f} ms: files {len(before)} "
            f"-> {len(after)}, {kept} rows kept (cpu and syslog, by the "
            f"chunk metadata), device memory peak {peak / 2**20:.1f} MiB")
        steps[dn] = {"wall_ms": wall, "files_before": len(before),
                     "files_after": len(after), "rows_kept": kept,
                     "peak_bytes": peak}
        return steps[dn]

    def t1_oracle():
        return {f"host_{h}": sum(1 for i in range(LIFE_SYSLOG_STEPS)
                                 if i % LIFE_OOM_EVERY == 3)
                for h in range(n_hosts) if oom[h]}

    try:
        torch.cuda.synchronize()
        cs.reset_launches()
        engine, svc = serve(root)
        disarm_planner(svc.port)
        status, _ = http(svc.port, "POST", "/query",
                         {"q": "CREATE DATABASE benchmark"})
        check(status == 200, f"CREATE DATABASE status {status}")
        # (a) cpu under the device profile, a flush every 20 min; syslog
        os.environ["OGT_DEVICE_PROFILE"] = "1"
        t_load = time.perf_counter()
        for lo in range(0, LIFE_CPU_STEPS, LIFE_FLUSH_STEPS):
            hi = lo + LIFE_FLUSH_STEPS
            n = convert.load_columnar(engine, "benchmark", {
                "cpu": cpu_table(tags, vals, lo, hi, n_hosts, 0)})
            check(n == n_hosts * (hi - lo), f"cpu {lo}-{hi}: wrote {n}")
            keep[:, lo:hi] = True
            engine.flush_all()
        cpu_s = time.perf_counter() - t_load
        t_load = time.perf_counter()
        per = 500  # hosts a /write
        for h0 in range(0, n_hosts, per):
            body = syslog_lines(range(h0, min(h0 + per, n_hosts)), sev,
                                oom, 0, LIFE_SYSLOG_STEPS).encode()
            status, _ = http(svc.port, "POST", "/write",
                             {"db": "benchmark", "precision": "ns"}, body)
            check(status == 204, f"syslog /write status {status}")
        engine.flush_all()
        syslog_s = time.perf_counter() - t_load
        n_files = len(files())
        check(n_files >= 3, f"{n_files} TSF files after the load")
        log(f"[lifecycle] loaded {n_hosts * LIFE_CPU_STEPS} cpu rows in "
            f"{cpu_s:.1f} s (three flushes) and "
            f"{n_hosts * LIFE_SYSLOG_STEPS} syslog rows by /write in "
            f"{syslog_s:.1f} s; {n_files} TSF files")
        steps["load"] = {"cpu_s": cpu_s, "syslog_s": syslog_s,
                         "files": n_files}

        # (b) T1 and T2: match() pruned by the text sidecars
        t1 = run("T1", q_t1, check_launch=False)
        got = {s["tags"]["hostname"]: s["values"][0][1]
               for s in t1["result"]["series"]}
        check(got == t1_oracle(), f"T1: {len(got)} hosts, not the oracle's")
        left = t1["sidecar_left"]
        check(left and all(x is not None for x in left)
              and sum(left) == LIFE_OOM_HOSTS,
              f"T1: the sidecars left {left} series")
        log(f"[lifecycle] T1: the sidecars left {sum(left)} of "
            f"{n_hosts} syslog series")
        t2 = run("T2", q_t2, check_launch=False)
        want = sorted(
            [T0_NS + i * STEP_NS, f"host_{h}", syslog_message(h, i, True)]
            for h in range(n_hosts) if oom[h]
            for i in range(t2_lo, t2_hi) if i % LIFE_OOM_EVERY == 3)
        rows = sorted(r for s in t2["result"].get("series", [])
                      for r in s["values"])
        check(rows == want, f"T2: {len(rows)} rows, not {len(want)}")

        # (c) P0 with the result cache on, then D1-D3, each followed by
        # P0: no deleted row from the cache, kernel 3 on the card
        p0 = run("P0", q_p0, cache=True)
        verify_life_panel("P0", p0["result"], usage, keep)
        rewrite("D1", "DELETE FROM cpu WHERE hostname = "
                f"'host_{LIFE_D1_HOST}'")
        keep[LIFE_D1_HOST] = False
        got = run("P0 after D1", q_p0, cache=True)
        verify_life_panel("P0 after D1", got["result"], usage, keep)
        d2_lo, d2_hi = (T0_NS + s * STEP_NS for s in LIFE_D2_STEPS)
        rewrite("D2", f"DELETE FROM cpu WHERE time >= '{rfc3339(d2_lo)}' "
                f"AND time < '{rfc3339(d2_hi)}'")
        keep[:, LIFE_D2_STEPS[0]:LIFE_D2_STEPS[1]] = False
        # the windows D2 touched hold no row now: the cached panel
        # rescans them alone, with nothing to launch
        got = run("P0 after D2", q_p0, cache=True, check_launch=False)
        verify_life_panel("P0 after D2", got["result"], usage, keep)
        off = run("P0 after D2, cache off", q_p0)
        check(same_answer(off["result"], got["result"]),
              "P0 after D2 differs from its cache-off run")
        rewrite("D3", "DROP SERIES FROM syslog WHERE hostname = "
                f"'host_{LIFE_D3_HOST}'")
        got = run("P0 after D3", q_p0, cache=True)
        verify_life_panel("P0 after D3", got["result"], usage, keep)
        status, doc = http(svc.port, "GET", "/query", {
            "db": "benchmark",
            "q": f"SHOW SERIES FROM syslog WHERE hostname = "
                 f"'host_{LIFE_D3_HOST}'"})
        check(status == 200 and not doc["results"][0].get("series"),
              f"D3: host_{LIFE_D3_HOST} still listed: {doc}")

        # (d) D4: DROP MEASUREMENT syslog, then a /write that purges
        status, doc = http(svc.port, "POST", "/query", {
            "db": "benchmark", "q": "DROP MEASUREMENT syslog"})
        check(status == 200 and "error" not in doc["results"][0],
              f"DROP MEASUREMENT: {doc}")
        d4_hosts = range(LIFE_D4_HOSTS)
        body = syslog_lines(d4_hosts, {h: "err" for h in d4_hosts},
                            np.ones(n_hosts, np.bool_), 0, 12,
                            base=LIFE_CPU_STEPS).encode()
        before = files()
        t0 = time.perf_counter()
        status, _ = http(svc.port, "POST", "/write",
                         {"db": "benchmark", "precision": "ns"}, body)
        wall = (time.perf_counter() - t0) * 1e3
        check(status == 204, f"D4 /write status {status}")
        steps["D4"] = {"wall_ms": wall, "files_before": len(before),
                       "files_after": len(files())}
        log(f"[lifecycle] D4: DROP MEASUREMENT syslog, then a /write of "
            f"{LIFE_D4_HOSTS * 12} lines purged it and was accepted in "
            f"{wall:.1f} ms; files {len(before)} -> {len(files())}")
        d4 = run("D4 read-back", q_d4, check_launch=False)
        got = {s["tags"]["hostname"]: s["values"][0][1]
               for s in d4["result"]["series"]}
        check(got == {f"host_{h}": 12 for h in d4_hosts},
              f"D4 read-back: {len(got)} hosts")
        engine.flush_all()  # D4's lines in a file of their own

        # (e) Q1: 20 more minutes of cpu in a file of their own, a
        # bitflip armed on its reads: the quarantine, the retry, a
        # restart, the purge
        n = convert.load_columnar(engine, "benchmark", {
            "cpu": cpu_table(tags, vals, LIFE_CPU_STEPS, n_cpu, n_hosts, 0)})
        check(n == n_hosts * LIFE_LATE_STEPS, f"late cpu: wrote {n}")
        engine.flush_all()
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        victim = max(files())  # the newest: the late 20 minutes
        # a restart: the scan must read the file from disk, not from a
        # cache tier of the process
        stop_server(svc, engine)
        engine, svc = serve(root)
        status, doc = http(svc.port, "POST", "/debug/ctrl", {
            "mod": "diskfault", "path": victim, "action": "bitflip"})
        check(status == 200 and doc["rules"] == [
            {"path": victim, "action": "bitflip"}], f"arming: {doc}")
        os.environ["OGT_RESULT_CACHE"] = "0"
        t0 = time.perf_counter()
        status, _h, body = http_raw(svc.port, "GET", "/query", {
            "db": "benchmark", "q": q_p0, "epoch": "ns"})
        q1_ms = (time.perf_counter() - t0) * 1e3
        doc = json.loads(body)
        err = doc["results"][0].get("error", "")
        check(status == 200 and err.startswith(
            f"file quarantined after media fault: {victim}: "),
            f"Q1: {status} {body[:300]!r}")
        check(os.path.exists(victim + ".quar"), "Q1: no .quar marker")
        status, vars_doc = http(svc.port, "GET", "/debug/vars", {})
        listed = [f for f in vars_doc["quarantined_files"]
                  if f["path"] == victim]
        check(listed and vars_doc["quarantine"]["files_current"] == 1,
              f"Q1: /debug/vars lists {vars_doc['quarantined_files']}")
        status, doc = http(svc.port, "POST", "/debug/ctrl",
                           {"mod": "diskfault", "clear": "1"})
        check(status == 200 and doc["rules"] == [], f"healing: {doc}")
        log(f"[lifecycle] Q1: {q1_ms:.1f} ms, HTTP {status}, "
            f"{err!r}; marker written, /debug/vars lists "
            f"{listed[0]['why']!r}")
        keep_q1 = keep.copy()  # the late file's rows stay out
        got = run("P0 after Q1", q_p0)
        verify_life_panel("P0 after Q1", got["result"], usage, keep_q1)
        stop_server(svc, engine)
        engine, svc = serve(root)
        q = engine.quarantine_snapshot()
        check([f["path"] for f in q["files"]] == [victim],
              f"after the restart: {q}")
        got = run("P0 after the restart", q_p0)
        verify_life_panel("P0 after the restart", got["result"], usage,
                          keep_q1)
        check(engine.purge_quarantined() == 1, "the purge removed nothing")
        for p in (victim, victim + ".quar", victim[:-4] + ".tidx"):
            check(not os.path.exists(p), f"the purge left {p}")
        steps["Q1"] = {"error": err, "wall_ms": q1_ms}

        # (f) the card's answers, then the same root on the CPU
        card = {qn: run(qn + " (card)", q, check_launch=False)["result"]
                for qn, q in (("T1", q_t1), ("T2", q_t2), ("P0", q_p0),
                              ("D4", q_d4))}
        check(card["T1"]["series"], "T1 at the end: no series")
        launches = dict(cs.LAUNCHES)
        stop_server(svc, engine)
        svc = engine = None
        t_cpu = time.perf_counter()
        from opengemini_tpu_torch.query.executor import Executor
        from opengemini_tpu_torch.storage.engine import Engine

        cpu_engine = Engine(root, device="cpu")
        try:
            ex = Executor(cpu_engine)
            for qn, q in (("T1", q_t1), ("T2", q_t2), ("P0", q_p0),
                          ("D4", q_d4)):
                res = ex.execute(q, db="benchmark")["results"][0]
                res.pop("statement_id", None)
                want = dict(card[qn])
                want.pop("statement_id", None)
                check(same_answer(res, want),
                      f"{qn}: the CPU's answer differs from the card's")
        finally:
            cpu_engine.close()
        cpu_s = time.perf_counter() - t_cpu
        wall_s = time.perf_counter() - t_phase
        log(f"[lifecycle] the CPU reopen gave the card's T1, T2, P0 and D4 "
            f"answers in {cpu_s:.1f} s; phase 11 took {wall_s:.1f} s "
            f"(budget {LIFECYCLE_PHASE_S:.0f} s, "
            f"{deadline - time.perf_counter():.0f} s left of the script's);"
            f" launches {json.dumps(launches)}; card {smi_line()}")
        return {"launches": launches, "per_query": per_query,
                "steps": steps, "shapes": rec.seen, "wall_s": wall_s}
    finally:
        os.environ["OGT_RESULT_CACHE"] = "0"
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        diskfault.clear_all()
        lookups.__exit__()
        rec.__exit__()
        if svc is not None:
            stop_server(svc, engine)


# -- phase 12: the offload planner on the card ---------------------------------

# phase 12's budget (s): C3 five times under the planner (cut from 8
# for phase 16: the five decisions still reach both routes and the four
# reasons the eight reached, amortize, prewarm, prior and model), forced
# once each way, one run with the device tier on and a profiler capture
PLANNER_PHASE_S = 90.0
PLANNER_RUNS = 5
# the planner's knobs at the reference's defaults (query/offload.py)
PLANNER_KNOBS = {"min_samples": 2, "explore_after": 3, "amortize": 4.0}
P12_LINES = 100


def disarm_planner(port: int) -> None:
    """Phases 3-11 count their launches exactly, so the offload planner is
    off there (the reference's switch): every route is the static gate's,
    as before the planner. Only phase 12 arms it."""
    status, doc = http(port, "POST", "/debug/ctrl",
                       {"mod": "offload", "arm": "0"})
    check(status == 200 and doc["enabled"] is False,
          f"the planner did not disarm: {status}")


def planner_expected(static: str, cands, uses: int, counts: dict,
                     est: dict, comp_s: float, warm: bool,
                     k: dict = PLANNER_KNOBS) -> tuple[str, str]:
    """(route, reason) that the reference's decision ladder
    (opengemini_tpu/query/offload.py Planner.decide, unfrozen, no forced
    route, no mesh) gives for one decision, written out from its rules:
    amortize/prewarm for a static device route that never ran here while
    compiles have measured walls; prior while the static route has fewer
    than min_samples samples; one explore of an under-sampled candidate
    once the geometry recurred past explore_after (gated by the
    amortization of the candidate's compile); else the argmin of the
    estimates (ties to the static route); an explore or model choice that
    flips to a device route that never ran here is held on the host for
    the pre-warmer ("prewarm"). `est` is in
    seconds (None: not estimable), `comp_s` the family's mean measured
    first-run wall."""
    if (static != "host" and "host" in cands and counts.get(static, 0) < 1
            and comp_s > 0.0 and not warm):
        per_use = est.get("host")
        per_use = 1e-3 if per_use is None else per_use
        if comp_s > k["amortize"] * max(per_use, 1e-9) * uses:
            return "host", "amortize"
        return "host", "prewarm"
    if counts.get(static, 0) < k["min_samples"]:
        return static, "prior"
    route = reason = None
    if uses > k["explore_after"] and est.get(static) is not None:
        under = sorted((c for c in cands if c != static
                        and counts.get(c, 0) < k["min_samples"]),
                       key=lambda c: counts.get(c, 0))
        if under:
            first = 0.0 if under[0] == "host" else comp_s
            if first <= k["amortize"] * max(est[static], 1e-9) * uses:
                route, reason = under[0], "explore"
    if route is None:
        route, reason = static, "model"
        for c in cands:
            if est.get(c) is not None and est[c] < est[route]:
                route = c
    if (route != "host" and route != static and counts.get(route, 0) == 0
            and not warm and comp_s > 0.0):
        return "host", "prewarm"
    return route, reason


def parse_metrics(text: str) -> dict:
    """The Prometheus text format 0.0.4, checked: each TYPE once and
    before its samples, samples of a family together, well-formed names,
    labels and values, histogram buckets cumulative up to +Inf and equal
    to _count. Returns {family: {"type", "samples": [(name, {labels},
    value)]}}."""
    import re

    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    sample_re = re.compile(
        r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?P<labels>.*)\})? '
        r'(?P<value>\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    fams: dict = {}
    cur = None
    for ln, line in enumerate(text.splitlines(), 1):
        if not line or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            check(len(parts) == 4 and name_re.match(parts[2])
                  and parts[3] in ("counter", "gauge", "histogram")
                  and parts[2] not in fams,
                  f"/metrics line {ln}: bad TYPE {line!r}")
            fams[parts[2]] = {"type": parts[3], "samples": []}
            cur = parts[2]
            continue
        m = sample_re.match(line)
        check(m is not None, f"/metrics line {ln}: bad sample {line!r}")
        name = m.group("name")
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and fams.get(base, {}).get("type") == "histogram":
                fam = base
        check(fam == cur, f"/metrics line {ln}: {name} outside its family")
        labels = dict(label_re.findall(m.group("labels") or ""))
        fams[fam]["samples"].append(
            (name, labels, float(m.group("value").replace("Inf", "inf"))))
    for fam, doc in fams.items():
        if doc["type"] != "histogram":
            continue
        series: dict = {}
        for name, labels, v in doc["samples"]:
            key = tuple(sorted((a, b) for a, b in labels.items()
                               if a != "le"))
            series.setdefault(key, {"b": [], "count": None})
            if name.endswith("_bucket"):
                series[key]["b"].append(v)
            elif name.endswith("_count"):
                series[key]["count"] = v
        for key, s in series.items():
            check(s["b"] == sorted(s["b"]) and s["b"][-1] == s["count"],
                  f"/metrics: histogram {fam}{key} not cumulative")
    return fams


def phase_planner(cold: dict) -> dict:
    """The offload planner on the card, on phase 7's compacted root with
    the decoded-column cache off (every run scans, and the route is the
    planner's alone): the planner cleared and armed and devobs armed
    through /debug/ctrl; C3 PLANNER_RUNS times, each decision checked
    against the reference's rules (planner_expected), each answer against
    the oracle, and each run's launches against its route (a device run
    launches kernel 4 once, a host run neither 4 nor 5); C3 forced to the
    host and to the device; both routes' walls; /debug/device (the
    inventory, the six kernel builds, the probe, the ledger against the
    allocator, the device tier's owner); a pre-warm sweep; a profiler
    capture during one run (a second answers 409); /metrics parsed, with
    its request and planner counters; /api/v2/write; and the readonly,
    disableread and flush switches."""
    import torch

    from opengemini_tpu_torch.models.grid import GridBatch
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.query import offload
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.utils import devobs
    from opengemini_tpu_torch.utils.querytracker import GLOBAL as TRACKER

    t_phase = time.perf_counter()
    o = cold["oracle"]
    q = cold["queries"]["C3"]
    colcache.GLOBAL.configure(budget_mb=0, device=False)
    os.environ["OGT_DEVICE_PROFILE"] = "1"
    rec = ShapeRecorder().__enter__()
    cs.reset_launches()
    engine, svc = serve(cold["root"])
    # a minute the WAL replayed (phase 5's check, phase 10's /write) goes
    # to a file: a memtable part in C3's scan would keep it off the
    # encoded path, and the route would not be the planner's
    engine.flush_all()
    port = svc.port
    gets = {"query": 0}
    decisions: list = []
    profiling: dict = {}
    prof_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "smoke_trace", "planner_profile")
    noted: list = []
    real_decide = offload.GLOBAL.decide
    real_note_route = TRACKER.note_route

    def note_spy(qid, stage, route):
        """The routes the planner hands the query tracker (what
        /debug/queries shows while the query runs)."""
        if qid is not None:
            noted.append((stage, route))
        return real_note_route(qid, stage, route)

    def spy(kernel, geometry, candidates, static, stage=None,
            bytes_hint=None):
        """The inputs of each decision as the planner holds them just
        before it: the static route, the geometry's samples and uses,
        the family's measured first-run walls and the pre-warm state."""
        geo = offload.geo_key(geometry)
        snap = next((m for m in offload.GLOBAL.model_snapshot(10**6)
                     if m["kernel"] == kernel and m["geometry"] == geo),
                    {"uses": 0, "routes": {}})
        walls = [g["wall_ms"] for kname, d in devobs.inventory().items()
                 if kname.startswith(kernel) for g in d["geometries"]
                 if g["wall_ms"] > 0]
        decisions.append({
            "static": static, "cands": tuple(candidates),
            "uses": snap["uses"],
            "counts": {r: d["count"] for r, d in snap["routes"].items()},
            "comp_s": (sum(walls) / len(walls) / 1e3) if walls else 0.0,
            "warm": offload.geometry_warm(kernel, geometry)})
        return real_decide(kernel, geometry, candidates, static,
                           stage=stage, bytes_hint=bytes_hint)

    real_launch = GridBatch._launch

    def launch_spy(self, kind):
        """Armed for one run: a 1 s profiler capture starts where the
        routed decode's device work does (the grid's first launch; the
        seconds before it are the scan and the plan on the host), and a
        second capture is asked for meanwhile."""
        if profiling.pop("at_launch", None):
            for params in ({"seconds": "1", "dir": prof_dir},
                           {"seconds": "1"}):
                st, _h, b = http_raw(port, "POST", "/debug/ctrl", dict(
                    params, mod="devobs", op="profile"))
                profiling.setdefault("answers", []).append((st, b[:200]))
        return real_launch(self, kind)

    def ctrl(params: dict) -> dict:
        status, doc = http(port, "POST", "/debug/ctrl", params)
        check(status == 200, f"/debug/ctrl {params}: {status}")
        return doc

    def run_c3(label: str) -> dict:
        """One C3 run: the answer against the oracle, its wall, launches,
        the newest decision and the routes /debug/queries showed."""
        seen_routes: list = []
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                _s, doc = http(port, "GET", "/debug/queries", {})
                for qd in doc.get("queries", []):
                    if qd.get("routes"):
                        seen_routes.append(dict(qd["routes"]))
                stop.wait(0.05)

        poller = threading.Thread(target=poll, daemon=True)
        n_dec = len(decisions)
        n_noted = len(noted)
        l0 = dict(cs.LAUNCHES)
        c0 = decode_counters()
        st0 = stage_ns(port)
        poller.start()
        try:
            res, _req_ms, wall = query_timed(port, q)
        finally:
            stop.set()
            poller.join()
        gets["query"] += 1
        verify_cold("C3", res, o["vals"], o["counters"], o["tags"],
                    o["n_hosts"], o["n_t"])
        got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
        st1 = stage_ns(port)
        stages = {k: (st1.get(f"{k}_ns", 0) - st0.get(f"{k}_ns", 0)) / 1e6
                  for k in ("scan", "device_compute")}
        c1 = decode_counters()
        fused = c1["executor/grid_decode_fused"] - c0[
            "executor/grid_decode_fused"]
        # the fused decode's blocks by codec: kernel 4 takes the FOR-delta
        # blocks (one launch for all of them), kernel 5 the gorilla ones
        blocks = {k.split("_")[2]: v - c0.get(k, 0) for k, v in c1.items()
                  if k.startswith("device/decode_blocks_")
                  and v > c0.get(k, 0)}
        ring = offload.GLOBAL.decisions()
        return {"label": label, "wall_ms": wall, "launches": got,
                "fused": fused, "blocks": blocks, "stages_ms": stages,
                "answer": res, "decided": len(decisions) - n_dec,
                "record": ring[0] if ring else None,
                "noted": noted[n_noted:],
                "routes": seen_routes[-1] if seen_routes else None}

    offload.GLOBAL.decide = spy
    TRACKER.note_route = note_spy
    try:
        disarm_planner(port)
        ctrl({"mod": "offload", "clear": "1", "arm": "1"})
        ctrl({"mod": "devobs", "arm": "1"})
        ok, why = devobs.cuda_kernels_supported()
        check(ok, f"the kernel probe failed: {why}")

        def fused_hits() -> dict:
            return {g["geometry"]: g["hits"] for g in devobs.inventory().get(
                "grid_decode_fused", {}).get("geometries", [])}

        hits0 = fused_hits()
        m0 = parse_metrics(http_raw(port, "GET", "/metrics", {})[2].decode())

        def qcount(fams) -> float:
            return next((v for n, lab, v in
                         fams["ogt_http_request_seconds"]["samples"]
                         if n.endswith("_count") and lab.get("route") ==
                         "query" and lab.get("method") == "GET"), 0.0)

        def check_decision(r: dict) -> tuple[dict, dict]:
            """The run's one decision against the reference's rules, and
            its samples: the route it ran before counts one more."""
            check(r["decided"] == 1, f"C3 {r['label']}: {r['decided']} "
                  "planner decisions, not one")
            d, rc = decisions[-1], r["record"]
            est = {c: (None if v is None else v / 1e3)
                   for c, v in rc["est_ms"].items()}
            want = planner_expected(d["static"], d["cands"], d["uses"] + 1,
                                    d["counts"], est, d["comp_s"], d["warm"])
            check(rc["uses"] == d["uses"] + 1,
                  f"C3 {r['label']}: uses {rc['uses']} after {d['uses']}")
            check((rc["route"], rc["reason"]) == want,
                  f"C3 {r['label']}: the planner chose {rc['route']} "
                  f"({rc['reason']}), the reference's rules {want} from "
                  f"static {d['static']}, samples {d['counts']}, uses "
                  f"{rc['uses']}, est {rc['est_ms']}, compile "
                  f"{d['comp_s']:.4f} s, warm {d['warm']}")
            for m in offload.GLOBAL.model_snapshot(10**6):
                if m["geometry"] == rc["geometry"]:
                    n = m["routes"].get(rc["route"], {}).get("count", 0)
                    check(n == d["counts"].get(rc["route"], 0) + 1,
                          f"C3 {r['label']}: {n} {rc['route']} samples "
                          f"after {d['counts']}")
            return d, rc

        runs = []
        decided = set()
        for i in range(PLANNER_RUNS):
            r = run_c3(f"run {i + 1}")
            d, rc = check_decision(r)
            dec_route = rc["route"]
            decided.add((dec_route, rc["reason"]))
            k4, k5 = r["launches"]["widen_packed"], r["launches"]["unpack_bits"]
            check(r["fused"] == (dec_route == "device"),
                  f"C3 run {i + 1} on the {dec_route}: fused decodes "
                  f"+{r['fused']}")
            # on the device, kernel 4 once if the plan holds FOR-delta
            # blocks (a compacted root of COLD_HOURS 6 holds none of
            # read_bytes: varint only) and kernel 5 never (no gorilla)
            if dec_route == "device":
                check(r["blocks"] and "gorilla" not in r["blocks"]
                      and k4 == int("delta" in r["blocks"]) and k5 == 0,
                      f"C3 run {i + 1} on the device: blocks by codec "
                      f"{r['blocks']}, kernels 4 and 5 launched {k4} and "
                      f"{k5} times")
            else:
                check(k4 == 0 and k5 == 0, f"C3 run {i + 1} on the host: "
                      f"kernels 4 and 5 launched {k4} and {k5} times")
            check(r["launches"]["grid_window_agg"] == 1,
                  f"C3 run {i + 1}: kernel 3 launched "
                  f"{r['launches']['grid_window_agg']} times")
            check(r["noted"] == [("grid_decode", dec_route)]
                  and r["routes"] in (None, {"grid_decode": dec_route}),
                  f"C3 run {i + 1}: the tracker noted {r['noted']}, "
                  f"/debug/queries showed routes {r['routes']}")
            runs.append(r)
            log(f"[planner] C3 {r['label']}: {dec_route} ({rc['reason']}, "
                f"static {d['static']}), uses {rc['uses']}, est_ms "
                f"{json.dumps(rc['est_ms'])}; /debug/queries routes "
                f"{json.dumps(r['routes'])}; wall {r['wall_ms']:.1f} ms "
                f"(scan {r['stages_ms']['scan']:.1f}, device_compute "
                f"{r['stages_ms']['device_compute']:.1f}); blocks by codec "
                f"{json.dumps(r['blocks'])}, kernel 4 x{k4}, kernel 5 x{k5}")
        check(any(r["routes"] for r in runs),
              "/debug/queries never showed a C3 run's routes")
        # PLANNER_RUNS was cut from 8 on this condition: the runs reach
        # both routes and every reason the eight reached
        check({rt for rt, _r in decided} == {"host", "device"}
              and {rs for _rt, rs in decided} >= {"amortize", "prewarm",
                                                  "prior", "model"},
              f"C3's {PLANNER_RUNS} decisions reached only {sorted(decided)}")
        geo = runs[0]["record"]["geometry"]
        forced = {}
        for route in ("host", "device"):
            ctrl({"mod": "offload", "force": route})
            r = run_c3(f"forced {route}")
            k4 = r["launches"]["widen_packed"]
            on_dev = route == "device"
            check(k4 == int(on_dev and "delta" in r["blocks"])
                  and r["fused"] == on_dev
                  and r["launches"]["unpack_bits"] == 0,
                  f"C3 forced to the {route}: launches {r['launches']}")
            forced[route] = r
            log(f"[planner] C3 forced {route}: wall {r['wall_ms']:.1f} ms "
                f"(scan {r['stages_ms']['scan']:.1f}, device_compute "
                f"{r['stages_ms']['device_compute']:.1f}), kernel 4 x{k4}")
        ctrl({"mod": "offload", "force": "none"})
        check(forced["host"]["answer"] == forced["device"]["answer"],
              "C3: the forced routes answer differently")
        model = next(m for m in offload.GLOBAL.model_snapshot(10**6)
                     if m["geometry"] == geo)
        log(f"[planner] C3's grid {geo}: walls by route (ms) "
            f"{json.dumps(model['routes'])} after {model['uses']} uses")
        by_route = {}
        for r in runs:
            by_route.setdefault(r["record"]["route"], []).append(r["wall_ms"])

        # the device tier on for one run, with a profiler capture in it
        colcache.GLOBAL.configure(budget_mb=CC_HOST_MB, device=True,
                                  device_budget_mb=CC_DEVICE_MB)
        profiling["at_launch"] = True
        GridBatch._launch = launch_spy
        try:
            tier = run_c3("device tier on")
        finally:
            GridBatch._launch = real_launch
        check_decision(tier)
        answers = profiling.get("answers", [])
        check([a[0] for a in answers] == [200, 409],
              f"profile answers {answers}")
        st2 = answers[1][0]
        _s, dev_doc = http(port, "GET", "/debug/device", {})
        owners = dev_doc["ledger"]["by_owner"]
        check("colcache_device" in owners,
              f"the device tier's owner is not in the ledger: {owners}")
        ledger_b = devobs.LEDGER.total_bytes()
        alloc_b = torch.cuda.memory_allocated()
        check(ledger_b <= alloc_b, f"ledger {ledger_b} B > allocated "
              f"{alloc_b} B")
        log(f"[planner] device tier on: C3 {tier['wall_ms']:.1f} ms on the "
            f"{tier['record']['route']} route; ledger {json.dumps(owners)}, "
            f"{ledger_b} B of {alloc_b} B allocated")
        colcache.GLOBAL.configure(budget_mb=0, device=False)
        colcache.GLOBAL.clear()
        deadline = time.perf_counter() + 30
        while True:
            prof = ctrl({"mod": "devobs"})["profile"]
            if not prof["active"] or time.perf_counter() > deadline:
                break
            time.sleep(0.1)
        trace = os.path.join(prof_dir, "trace.json")
        check(not prof["active"] and prof["last"]["ok"]
              and os.path.getsize(trace) > 0,
              f"the profiler capture did not finish: {prof}")
        with open(trace, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"[planner] profile: 1 s capture from that run's first grid "
            f"launch, "
            f"{os.path.getsize(trace)} B of trace, {len(events)} events, "
            f"{kernels} device kernels; a second capture meanwhile "
            f"answered {st2}")

        # /debug/device: the fused site's uses at C3's plan, the builds,
        # the probe
        _s, dev_doc = http(port, "GET", "/debug/device", {})
        inv = devobs.inventory()
        n_dev = sum(r["fused"] for r in runs + [forced["device"], tier])
        grew = {g: n - hits0.get(g, 0) for g, n in fused_hits().items()
                if n != hits0.get(g, 0)}
        check(len(grew) == 1 and sum(grew.values()) == n_dev,
              f"grid_decode_fused's uses at C3's plan: {grew}, not the "
              f"phase's {n_dev} fused decodes at one geometry")
        fused = [g for g in inv["grid_decode_fused"]["geometries"]
                 if g["geometry"] in grew]
        builds = sorted(k for k in dev_doc["jit_cache"]
                        if k.startswith("build:"))
        check(len(builds) == 6, f"kernel builds in the inventory: {builds}")
        check(dev_doc["capabilities"]["cuda_kernels"]["supported"] is True,
              f"capabilities: {dev_doc['capabilities']}")
        log(f"[planner] /debug/device: grid_decode_fused at C3's grid "
            f"{json.dumps(fused)}; builds {builds} (walls ms "
            f"{[inv[b]['geometries'][0]['wall_ms'] for b in builds]}); "
            f"probe {json.dumps(dev_doc['capabilities']['cuda_kernels'])}; "
            f"compiles since start {dev_doc['counters'].get('compiles_total')}")
        pw = ctrl({"mod": "offload", "op": "prewarm"})["prewarmed"]
        check(all(r["ok"] for r in pw), f"prewarm: {pw}")
        log(f"[planner] prewarm: {json.dumps(pw)}")

        # /api/v2/write and the switches
        body = "\n".join(
            f"p12,host=host_{k % 10} v={k}i {T0_NS + k * STEP_NS}"
            for k in range(P12_LINES)).encode()
        st, _h, b = http_raw(port, "POST", "/api/v2/write",
                             {"bucket": "benchmark/autogen",
                              "precision": "ns"}, body)
        check(st == 204, f"/api/v2/write: {st} {b[:200]!r}")

        def p12_count() -> int:
            gets["query"] += 1
            res, _r, _w = query_timed(port, "SELECT count(v) FROM p12")
            return res["series"][0]["values"][0][1]

        check(p12_count() == P12_LINES, "/api/v2/write: rows not read back")
        ctrl({"mod": "readonly", "switchon": "true"})
        st, hdr, b = http_raw(port, "POST", "/write", {"db": "benchmark"},
                              f"p12,host=x v=1i {T0_NS}".encode())
        check(st == 403 and hdr.get("X-Ogt-Errno") == "2003",
              f"readonly /write: {st} {hdr.get('X-Ogt-Errno')} {b!r}")
        check(p12_count() == P12_LINES, "readonly: the count changed")
        ctrl({"mod": "readonly", "switchon": "false"})
        ctrl({"mod": "disableread", "switchon": "true"})
        for stmt in ("SELECT count(v) FROM p12",
                     "EXPLAIN SELECT count(v) FROM p12"):
            gets["query"] += 1
            st, _h, b = http_raw(port, "GET", "/query",
                                 {"db": "benchmark", "q": stmt})
            err = json.loads(b)["results"][0].get("error")
            check(st == 200 and err == "reads are disabled (syscontrol)",
                  f"disableread {stmt!r}: {st} {err}")
        gets["query"] += 1
        st, _h, b = http_raw(port, "GET", "/query",
                             {"db": "benchmark", "q": "SHOW MEASUREMENTS"})
        check(st == 200 and "error" not in json.loads(b)["results"][0],
              f"disableread SHOW: {st} {b[:200]!r}")
        ctrl({"mod": "disableread", "switchon": "false"})
        (sh,) = engine.shards_for_range("benchmark", None, T0_NS, T0_NS + 1)
        files0 = sh.file_count()
        ctrl({"mod": "flush"})
        files1 = sh.file_count()
        check(files1 == files0 + 1, f"flush: files {files0} -> {files1}")
        log(f"[planner] /api/v2/write of {P12_LINES} lines read back; "
            f"readonly: 403 errno 2003, count unchanged; disableread: SELECT "
            f"and EXPLAIN refused, SHOW answered; flush: files {files0} -> "
            f"{files1}")

        # /metrics: parsed, the query requests and the planner counters
        m1 = parse_metrics(http_raw(port, "GET", "/metrics", {})[2].decode())
        rose = qcount(m1) - qcount(m0)
        check(rose == gets["query"], f"ogt_http_request_seconds_count "
              f"(query, GET) rose {rose}, the phase sent {gets['query']}")
        ring = offload.GLOBAL.decisions()
        ctr = {n[len("ogt_offload_"):]: s[0][2]
               for n, s in ((n, d["samples"]) for n, d in m1.items()
                            if n.startswith("ogt_offload_"))}
        reasons = {}
        for rc in ring:
            reasons[rc["reason"]] = reasons.get(rc["reason"], 0) + 1
        check(ctr.get("decisions_total") == len(ring)
              and all(ctr.get(r + "_total") == n for r, n in reasons.items())
              and ctr.get("route_host_total", 0)
              + ctr.get("route_device_total", 0) == len(ring),
              f"planner counters {ctr} against the ring's {len(ring)} "
              f"decisions {reasons}")
        log(f"[planner] /metrics: {len(m1)} families parsed; query GETs "
            f"+{rose:.0f}; planner counters {json.dumps(ctr)}")
        launches = dict(cs.LAUNCHES)
        wall_s = time.perf_counter() - t_phase
        log(f"[planner] phase 12 took {wall_s:.1f} s (budget "
            f"{PLANNER_PHASE_S:.0f} s); walls by route (ms) "
            f"{json.dumps(by_route)}; launches {json.dumps(launches)}; card "
            f"{smi_line()}")
        per_query = {"C3": {"launches": launches}}
        return {"launches": launches, "per_query": per_query,
                "shapes": rec.seen, "runs": [
                    {k: r[k] for k in ("label", "wall_ms", "launches",
                                       "record", "routes", "stages_ms")}
                    for r in runs + list(forced.values()) + [tier]],
                "model": model, "wall_s": wall_s}
    finally:
        if "decide" in vars(offload.GLOBAL):
            del offload.GLOBAL.decide
        if "note_route" in vars(TRACKER):
            del TRACKER.note_route
        offload.set_force(None)
        offload.set_enabled(False)
        devobs.set_enabled(False)
        colcache.GLOBAL.configure(budget_mb=0, device=False)
        engine.read_disabled = engine.write_disabled = False
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        rec.__exit__()
        stop_server(svc, engine)


# -- phase 13: PromQL on the card ---------------------------------------------

# the span of phase 13's data (h), cut from 6 h: the phase took 194.3 s
# at 6 h and 118.7 s at 3 h on an H100, over its 100 s budget (the cuts
# are listed in PERF.md)
PROM_HOURS = 2
PROM_OTLP_HOSTS = 100
# runs of each PQ; a PQ whose first run passes PROM_SLOW_MS runs twice.
# PROM_SHORT_RUNS when fewer than PROM_ROOM_S seconds are left before the
# phase's deadline as the PQs start (a slow machine: the script's 1200 s
# comes first)
# cut from 5 to 3 for phase 16, to 2 for the 1200 s limit, to 1 for
# phase 18
PROM_RUNS = 1
PROM_SHORT_RUNS = 1
PROM_ROOM_S = 90.0
PROM_SLOW_MS = 5000.0
# the remote-written minute: samples per series
PROM_MINUTE = 6
PROM_DB = "prom"
# averages, rates and quantiles across devices and routes (summation
# order): rel PROM_RTOL, or PROM_ATOL absolute where a mean of the
# [0, 100] walk falls near 0 (a window's difference of prefix sums over
# the whole span carries ~1e-11 absolute); maxima, instant values and topk
# compare exactly
PROM_RTOL = 1e-9
PROM_ATOL = 1e-9
# the PromQL stages: the engine's (promql/engine.py) and the answer's
# JSON and write (server/http.py)
PROM_STAGES = ("prom_collect", "prom_prepare", "prom_kernel", "render",
               "encode")


def _pb_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb(fnum: int, payload: bytes) -> bytes:
    return _pb_varint((fnum << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_fixed64(fnum: int, raw8: bytes) -> bytes:
    return _pb_varint((fnum << 3) | 1) + raw8


def snappy_literal(data: bytes) -> bytes:
    """Snappy block framing with literals only (the compressed body a
    remote-write client may send): the length, then literal elements of
    at most 64 KiB."""
    out = bytearray(_pb_varint(len(data)))
    for off in range(0, len(data), 65536):
        chunk = data[off:off + 65536]
        n = len(chunk) - 1
        if n < 60:
            out.append(n << 2)
        elif n < 256:
            out += bytes([60 << 2, n])
        else:
            out += bytes([61 << 2]) + n.to_bytes(2, "little")
        out += chunk
    return bytes(out)


def prompb_write(series) -> bytes:
    """A prompb WriteRequest: series is [(labels [(name, value)], times
    in ms, values)]."""
    import struct

    out = []
    for labels, t_ms, vals in series:
        ts = b"".join(_pb(1, _pb(1, n.encode()) + _pb(2, v.encode()))
                      for n, v in labels)
        ts += b"".join(
            _pb(2, _pb_fixed64(1, struct.pack("<d", float(v)))
                + _pb_varint(2 << 3) + _pb_varint(int(t)))
            for t, v in zip(t_ms, vals))
        out.append(_pb(1, ts))
    return b"".join(out)


def prompb_read(start_ms: int, end_ms: int, matchers) -> bytes:
    """A prompb ReadRequest of one query; matchers are (type, name,
    value), type 0 = EQ."""
    q = (_pb_varint(1 << 3) + _pb_varint(start_ms)
         + _pb_varint(2 << 3) + _pb_varint(end_ms))
    for mtype, name, value in matchers:
        q += _pb(3, _pb_varint(1 << 3) + _pb_varint(mtype)
                 + _pb(2, name.encode()) + _pb(3, value.encode()))
    return _pb(1, q)


def otlp_body(hosts, t_ns: int, gauge, counter) -> bytes:
    """An OTLP ExportMetricsServiceRequest: a gauge (system_cpu_load)
    and a sum (system_net_bytes), one point per host, the hostname as a
    point attribute and service.name as the resource's."""
    import struct

    def kv(key: str, value: str) -> bytes:
        return _pb(1, key.encode()) + _pb(2, _pb(1, value.encode()))

    def points(vals) -> bytes:
        return b"".join(
            _pb(1, _pb(7, kv("hostname", f"host_{h}"))
                + _pb_fixed64(3, struct.pack("<Q", t_ns))
                + _pb_fixed64(4, struct.pack("<d", float(v))))
            for h, v in zip(hosts, vals))

    metrics = (_pb(2, _pb(1, b"system_cpu_load") + _pb(5, points(gauge)))
               + _pb(2, _pb(1, b"system_net_bytes") + _pb(7, points(counter))))
    resource = _pb(1, kv("service.name", "tsbs"))
    return _pb(1, _pb(1, resource) + _pb(2, metrics))


def prom_get(port: int, path: str, params: dict) -> tuple:
    """(data, request ms, wall ms) of one Prometheus API GET on the
    kept-alive connection; the answer must be a success."""
    import torch

    conn = _CONNS.get(port)
    if conn is None:
        conn = _CONNS[port] = HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("GET", path + "?" + urllib.parse.urlencode(params))
    r = conn.getresponse()
    status, body = r.status, r.read()
    t1 = time.perf_counter()
    check(status == 200, f"{path} {params.get('query', '')}: status "
          f"{status} {body[:300]!r}")
    doc = json.loads(body)
    check(doc.get("status") == "success", f"{path}: {doc}")
    torch.cuda.synchronize()
    return doc["data"], (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3


def prom_queries(t_end: float, t_last: float) -> dict:
    """PQ1-PQ7: (path, params, kind); the range queries end at the last
    loaded sample (t_end, s), PQ6 asks at the last written one."""
    def rng_q(q, span_s, step_s):
        return ("/api/v1/query_range",
                {"query": q, "start": repr(t_end - span_s),
                 "end": repr(t_end), "step": str(step_s), "db": PROM_DB})

    six_h = PROM_HOURS * 3600
    return {
        "PQ1": rng_q('max by (hostname) (max_over_time(cpu_usage_user'
                     '{hostname="host_1"}[1m]))', 3600, 60),
        "PQ2": rng_q("avg by (hostname) (avg_over_time(cpu_usage_user"
                     "[1h]))", six_h - 3600, 3600),
        "PQ3": rng_q("avg by (hostname) (avg_over_time(cpu_usage_user"
                     "[1m]))", six_h - 60, 60),
        "PQ4": rng_q("sum by (region) (rate(diskio_read_bytes[5m]))",
                     six_h - 60, 60),
        "PQ5": rng_q("quantile_over_time(0.99, cpu_usage_user[5m])", 3600,
                     300),
        "PQ6": ("/api/v1/query", {"query": "cpu_usage_user",
                                  "time": repr(t_last), "db": PROM_DB}),
        "PQ7": ("/api/v1/query", {
            "query": "topk(10, max_over_time(cpu_usage_user[10m]))",
            "time": repr(t_end), "db": PROM_DB}),
    }


def prom_series(data: dict) -> dict:
    """An answer's series by their sorted labels: a list of (t, value
    string) pairs, or one pair for an instant vector."""
    out = {}
    for r in data["result"]:
        key = tuple(sorted(r["metric"].items()))
        out[key] = ([tuple(p) for p in r["values"]] if "values" in r
                    else [tuple(r["value"])])
    return out


def prom_same(qn: str, got: dict, want: dict, exact: bool) -> float:
    """Equal PromQL answers: the same series and timestamps, the values
    equal (exact) or within PROM_RTOL or PROM_ATOL (special values
    equal); returns the largest relative difference."""
    import numpy as np

    g, w = prom_series(got), prom_series(want)
    check(g.keys() == w.keys(), f"{qn}: {len(g)} series against "
          f"{len(w)}, or other labels")
    worst = 0.0
    for key, pts in w.items():
        mine = g[key]
        if mine == pts:
            continue
        check([p[0] for p in mine] == [p[0] for p in pts],
              f"{qn} {key}: other timestamps")
        check(not exact, f"{qn} {key}: the values differ")
        a = np.array([p[1] for p in mine], dtype=np.float64)
        b = np.array([p[1] for p in pts], dtype=np.float64)
        ok = np.isclose(a, b, rtol=PROM_RTOL, atol=PROM_ATOL,
                        equal_nan=True)
        bad = np.flatnonzero(~ok)
        check(not bad.size, f"{qn} {key}: {mine[bad[0]] if bad.size else ''}"
              f" against {pts[bad[0]] if bad.size else ''}")
        fin = np.isfinite(b) & (b != 0)
        if fin.any():
            worst = max(worst, float((np.abs(a - b)[fin]
                                      / np.abs(b[fin])).max()))
    return worst


# which PQs compare exactly across routes and devices: max, the instant
# selector and topk's members and maxima
PROM_EXACT = {"PQ1": True, "PQ2": False, "PQ3": False, "PQ4": False,
              "PQ5": False, "PQ6": True, "PQ7": True}


def prom_oracle(qn: str, data: dict, usage, t0_s: float, t_end: float,
                n_hosts: int) -> None:
    """PQ1 and PQ3 against numpy: the max (exactly) and the mean (within
    PROM_RTOL, PROM_ATOL) of each 1 min window (t - 60 s, t] of the
    generated random walk."""
    import numpy as np

    got = prom_series(data)
    span = 3600 if qn == "PQ1" else PROM_HOURS * 3600 - 60
    steps = t_end - span + 60.0 * np.arange(span // 60 + 1)
    hosts = [1] if qn == "PQ1" else list(range(n_hosts))
    check(len(got) == len(hosts), f"{qn}: {len(got)} series")
    hi = np.rint((steps - t0_s) / 10.0).astype(np.int64)  # (te - 60, te]
    win = usage[:, hi[:, None] + np.arange(-5, 1)[None, :]]  # (H, K, 6)
    for h in hosts:
        pts = got[(("hostname", f"host_{h}"),)]
        check([p[0] for p in pts] == steps.tolist(),
              f"{qn} host_{h}: other steps")
        v = np.array([p[1] for p in pts], dtype=np.float64)
        if qn == "PQ1":
            want = win[h].max(axis=1)
            check(np.array_equal(v, want), f"PQ1: {v} against {want}")
        else:
            want = win[h].mean(axis=1)
            err = np.abs(v - want)
            check(bool((err <= np.maximum(PROM_RTOL * np.abs(want),
                                          PROM_ATOL)).all()),
                  f"PQ3 host_{h}: off by up to {err.max()!r}")


def phase_prom(seed: int, deadline: float, n_hosts: int = N_HOSTS) -> dict:
    """PromQL on the card, on a root of its own (fresh_root("prom")): TSBS
    devops as its victoriametrics target loads it (cpu usage_user and
    diskio read_bytes as the Prometheus metrics cpu_usage_user and
    diskio_read_bytes, the ten host tags as labels; 4000 hosts at 10 s
    over PROM_HOURS h from 2016-01-01) through convert.load_columnar under
    the device profile, flushed to one file (and compacted: a no-op at
    one file); one more minute of all 8000 series through POST
    /api/v1/prom/write (snappy, the script's own prompb encoder) into a
    file of its own, and one POST /api/v1/otlp/metrics (a gauge and a sum
    for PROM_OTLP_HOSTS hosts). PQ1-PQ7 on the device route (host
    kernels off, the planner off): first PQ2-PQ4 with the route forced
    to the device (the cost gate of the encoded decode passes): the rows
    matrix decodes on the card (kernel 5 must launch), and
    decode_rows_matrix equals materialize_enc bit for bit at PQ3's
    geometry; then each PQ PROM_RUNS times (twice past PROM_SLOW_MS,
    PROM_SHORT_RUNS when the deadline leaves under PROM_ROOM_S)
    with its stage split and launches, the forced answers equal to
    these; PQ1 and PQ3 against numpy; each PQ once on the host route
    (host kernels on), the same answers; PQ3 and PQ4 traced (the
    device's busy share); /api/v1/labels, /label/hostname/values,
    /series, /prom/read and an InfluxQL /query read the written minute
    and the OTLP points back exactly; then the root reopened with
    device="cpu" gives the card's answers."""
    import numpy as np
    import torch

    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ingest import protowire as pw
    from opengemini_tpu_torch.ingest.line_protocol import series_key
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.ops import device_decode as dd
    from opengemini_tpu_torch.query import offload
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.utils import devobs

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 13)
    n_t = PROM_HOURS * 360
    n_all = n_t + PROM_MINUTE
    tags = host_tags(n_hosts, rng)
    start = rng.random((n_hosts, 1)) * 100.0
    walk = rng.normal(0.0, 1.0, (n_hosts, n_all))
    walk[:, 0] = 0.0
    usage = np.clip(start + np.cumsum(walk, axis=1), 0.0, 100.0)
    reads = np.cumsum(np.abs(np.rint(rng.normal(100.0, 1.0,
                                                (n_hosts, n_all)))),
                      axis=1)  # the TSBS read_bytes counter, as floats
    t0_s = T0_NS / 1e9
    t_end = t0_s + (n_t - 1) * 10.0  # the last loaded sample
    t_last = t0_s + (n_all - 1) * 10.0  # the last written one
    queries = prom_queries(t_end, t_last)
    root = fresh_root("prom")
    colcache.GLOBAL.configure(budget_mb=0, device=False)
    rec = ShapeRecorder().__enter__()
    svc = engine = None
    per_query: dict = {}
    steps: dict = {}
    try:
        torch.cuda.synchronize()
        cs.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        devobs.reset_probe()
        engine = Engine(root, flush_threshold_bytes=1 << 40)
        check(engine.device.type == "cuda", f"engine on {engine.device}")
        svc = HttpService(engine, port=0, prom_db=PROM_DB)
        svc.start()
        port = svc.port
        disarm_planner(port)
        status, _ = http(port, "POST", "/query",
                         {"q": f"CREATE DATABASE {PROM_DB}"})
        check(status == 200, f"CREATE DATABASE status {status}")

        # the load: one columnar batch per metric, one file, compacted
        os.environ["OGT_DEVICE_PROFILE"] = "1"
        times = T0_NS + np.arange(n_t, dtype=np.int64) * STEP_NS
        ones = np.ones(n_hosts * n_t, np.bool_)
        common = {"series": np.repeat(np.arange(n_hosts, dtype=np.int64),
                                      n_t),
                  "times": np.tile(times, n_hosts)}
        t_load = time.perf_counter()
        n = convert.load_columnar(engine, PROM_DB, {
            metric: {"series_keys": [series_key(metric, t) for t in tags],
                     "fields": {"value": (np.ascontiguousarray(
                         src[:, :n_t]).reshape(-1), ones)}, **common}
            for metric, src in (("cpu_usage_user", usage),
                                ("diskio_read_bytes", reads))})
        load_s = time.perf_counter() - t_load
        check(n == 2 * n_hosts * n_t, f"the load wrote {n} samples")
        t_flush = time.perf_counter()
        engine.flush_all()
        for sh in engine.all_shards():
            while sh.compact_level():
                pass
            sh.compact()
        flush_s = time.perf_counter() - t_flush
        n_files = sum(len(sh._files) for sh in engine.all_shards())
        check(n_files == 1, f"{n_files} TSF files after the compaction")
        log(f"[prom] loaded {n} samples ({n_hosts} hosts x 2 metrics x "
            f"{PROM_HOURS} h) in {load_s:.1f} s ({n / load_s:.0f} "
            f"samples/s), flushed and compacted to {n_files} file in "
            f"{flush_s:.1f} s"
            + ("; the load passed 60 s: cut the span to 3 h"
               if load_s > 60 else ""))
        steps["load"] = {"samples": n, "load_s": load_s,
                         "flush_s": flush_s}

        # one more minute through remote write, in a file of its own
        t_ms = (T0_NS // 10**6
                + np.arange(n_t, n_all, dtype=np.int64) * (STEP_NS // 10**6))
        series = [([("__name__", metric), *tags[h]], t_ms, src[h, n_t:])
                  for metric, src in (("cpu_usage_user", usage),
                                      ("diskio_read_bytes", reads))
                  for h in range(n_hosts)]
        body = snappy_literal(prompb_write(series))
        t_rw = time.perf_counter()
        status, _h, resp = http_raw(port, "POST", "/api/v1/prom/write",
                                    {"db": PROM_DB}, body)
        rw_s = time.perf_counter() - t_rw
        check(status == 204, f"remote write status {status} {resp[:200]!r}")
        n_rw = len(series) * PROM_MINUTE
        log(f"[prom] remote write: {n_rw} samples ({len(body)} B snappy) "
            f"in {rw_s * 1e3:.1f} ms, {n_rw / rw_s:.0f} samples/s")
        steps["remote_write"] = {"samples": n_rw, "bytes": len(body),
                                 "ms": rw_s * 1e3}
        engine.flush_all()
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        otlp_hosts = range(PROM_OTLP_HOSTS)
        t_otlp = T0_NS + (n_all - 1) * STEP_NS
        gauge = usage[:PROM_OTLP_HOSTS, -1] / 100.0
        counter = reads[:PROM_OTLP_HOSTS, -1] * 8
        status, _h, resp = http_raw(port, "POST", "/api/v1/otlp/metrics",
                                    {"db": PROM_DB},
                                    otlp_body(otlp_hosts, t_otlp, gauge,
                                              counter))
        check(status == 200, f"OTLP status {status} {resp[:200]!r}")

        # the device route (host kernels off) from here on
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "host_kernels": "0"})
        check(status == 200, "host_kernels=0 refused")

        # the encoded decode, the cost gate passed by forcing the device,
        # first: a host read of the same columns (the instant selector,
        # the read-backs, the host route) leaves them decoded in the file
        # reader's cache, and a decoded column takes no device decode
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "devobs", "arm": "1"})
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "force": "device"})
        check(status == 200, "force=device refused")
        seen_rows = []
        real_rows = dd.decode_rows_matrix

        def rows_spy(enc, shape, dtype, device):
            out = real_rows(enc, shape, dtype, device)
            seen_rows.append((enc, shape, out is not None))
            return out

        dd.decode_rows_matrix = rows_spy
        decoded = {}
        enc = shape = None
        try:
            for qn in ("PQ2", "PQ3", "PQ4"):  # PQ5 takes the dense kernels
                path, params = queries[qn]
                seen_rows.clear()
                l0, c0 = dict(cs.LAUNCHES), decode_counters()
                rec.now = {}
                data, _r, wall_ms = prom_get(port, path, params)
                d = {k2: v - c0.get(k2, 0)
                     for k2, v in decode_counters().items()}
                got = {k2: cs.LAUNCHES[k2] - l0[k2] for k2 in l0}
                mat = [s[0] * s[1] * 8 for _e, s, ok in seen_rows if ok]
                if qn == "PQ3" and seen_rows:
                    enc, shape, _ok = seen_rows[0]
                decoded[qn] = {
                    "data": data,
                    "wall_ms": wall_ms, "launches": got, "counters": d,
                    "matrix_bytes": sum(mat),
                    "h2d_bytes": d[H2D_DECODE],
                    "shapes": {k2: [shape_json(k2, x) for x in sorted(v)]
                               for k2, v in rec.now.items()}}
                rec.now = None
                blocks = {k2.split("_")[2]: v for k2, v in d.items()
                          if k2.startswith("device/decode_blocks_") and v}
                log(f"[prom] {qn} forced to the device: {wall_ms:.1f} ms, "
                    f"{len(mat)} rows matrices decoded on the card, blocks "
                    f"by codec {json.dumps(blocks)}, device-decode H2D "
                    f"{d[H2D_DECODE]} B against the padded (S, N) f64 "
                    f"matrix's {sum(mat)} B; launches "
                    f"{json.dumps({a: b for a, b in got.items() if b})}")
            check(sum(r["launches"]["unpack_bits"]
                      for r in decoded.values()) > 0,
                  "phase 13: kernel 5 never launched")
        finally:
            dd.decode_rows_matrix = real_rows
        # decode_rows_matrix against the host decode at PQ3's geometry
        check(enc is not None, "PQ3 built no rows matrix")
        l_chk = dict(cs.LAUNCHES)
        dev_mat = dd.decode_rows_matrix(enc, shape, np.float64, "cuda")
        check(dev_mat is not None, "decode_rows_matrix declined PQ3's rows")
        host = dd.materialize_enc(enc)  # the series' slices, concatenated
        mat = np.zeros(shape)
        off = 0
        for i, (a, b) in enumerate(enc[3]):
            mat[i, :b - a] = host[off:off + b - a]
            off += b - a
        check(dev_mat.cpu().numpy().tobytes() == mat.tobytes(),
              "decode_rows_matrix differs from materialize_enc")
        for k2 in l_chk:  # the check's launches are no main path's
            cs.LAUNCHES[k2] = l_chk[k2]
        log(f"[prom] decode_rows_matrix on the card equals materialize_enc "
            f"bit for bit at PQ3's {shape} ({len(enc[1])} blocks)")
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "force": "none"})
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "devobs", "arm": "0"})
        # PQ1-PQ7 on the device route
        answers = {}
        pq_runs = PROM_RUNS
        room = deadline - time.perf_counter()
        if room < PROM_ROOM_S and PROM_SHORT_RUNS < PROM_RUNS:
            pq_runs = PROM_SHORT_RUNS
            log(f"[prom] {room:.0f} s left of the phase's deadline, under "
                f"{PROM_ROOM_S:.0f}: each PQ runs {pq_runs} times, not "
                f"{PROM_RUNS}")
        for qn, (path, params) in queries.items():
            l0, c0, st0 = dict(cs.LAUNCHES), decode_counters(), \
                stage_ns(port)
            rec.now = {}
            lat, reqs = [], []
            runs = pq_runs
            k = 0
            while k < runs:
                data, req_ms, wall_ms = prom_get(port, path, params)
                lat.append(wall_ms)
                reqs.append(req_ms)
                if k == 0 and wall_ms > PROM_SLOW_MS:
                    runs = 2
                if k:
                    check(data == answers[qn],
                          f"{qn}: run {k + 1} answers otherwise")
                else:
                    answers[qn] = data
                k += 1
            after = stage_ns(port)
            wall = sum(reqs)
            ms = {st: (after.get(f"{st}_ns", 0) - st0.get(f"{st}_ns", 0))
                  / 1e6 for st in PROM_STAGES}
            ms["other"] = wall - sum(ms[st] for st in PROM_STAGES)
            d = {k2: v - c0.get(k2, 0) for k2, v in decode_counters().items()}
            got = {k2: cs.LAUNCHES[k2] - l0[k2] for k2 in l0}
            per_query[qn] = {
                "runs_ms": lat, "p50_ms": p50_of(lat), "launches": got,
                "stages_ms": ms, "counters": d,
                "series": len(data["result"]) if isinstance(
                    data.get("result"), list) else 1,
                "shapes": {k2: [shape_json(k2, x) for x in sorted(v)]
                           for k2, v in rec.now.items()}}
            rec.now = None
            log(f"[prom] {qn} p50={p50_of(lat):.1f} ms (runs "
                f"{', '.join(f'{x:.1f}' for x in lat)}), "
                f"{per_query[qn]['series']} series; stages over {len(reqs)} "
                f"requests ({wall:.1f} ms): "
                + ", ".join(f"{st} {ms[st]:.1f}" for st in
                            (*PROM_STAGES, "other"))
                + f" ms; launches {json.dumps({a: b for a, b in got.items() if b})}"
                f"; decode fallbacks +{d['device/decode_fallbacks_total']}")
        prom_oracle("PQ1", answers["PQ1"], usage, t0_s, t_end, n_hosts)
        prom_oracle("PQ3", answers["PQ3"], usage, t0_s, t_end, n_hosts)
        log("[prom] PQ1 (max, exactly) and PQ3 (mean, rel 1e-9) equal the "
            "numpy oracle")
        for qn, d in decoded.items():
            prom_same(qn + " decoded", d.pop("data"), answers[qn], False)
        log(f"[prom] {', '.join(decoded)} decoded on the card answer as "
            "their device-route runs")

        # the written minute and the OTLP points, read back
        pq6 = prom_series(answers["PQ6"])
        check(len(pq6) == n_hosts, f"PQ6: {len(pq6)} series")
        for h in range(n_hosts):
            key = tuple(sorted((*tags[h], ("__name__", "cpu_usage_user"))))
            check(pq6[key] == [(t_last, repr(float(usage[h, -1])))],
                  f"PQ6 {key[0]}: {pq6[key]}")
        rd = prompb_read(int((t_last - 3600) * 1000), int(t_last * 1000),
                         [(0, "__name__", "diskio_read_bytes"),
                          (0, "hostname", "host_7")])
        status, hdr, resp = http_raw(port, "POST", "/api/v1/prom/read",
                                     {"db": PROM_DB}, snappy_literal(rd))
        check(status == 200 and hdr.get("Content-Encoding") == "snappy",
              f"remote read status {status}")
        samples = []
        for _f, _w, qres in pw.fields(pw.snappy_uncompress(resp)):
            for _f2, _w2, ts in pw.fields(qres):
                for f3, w3, v3 in pw.fields(ts):
                    if f3 == 2:
                        kv = {a: (b, c) for a, b, c in pw.fields(v3)}
                        samples.append((pw.as_int64(kv[2][1]),
                                        pw.as_double(*kv[1])))
        lo = n_all - 361  # (t_last - 1 h, t_last], both ends read
        want = [(int(T0_NS // 10**6 + i * 10_000), float(reads[7, i]))
                for i in range(lo, n_all)]
        check(samples == want, f"remote read: {len(samples)} samples, "
              f"not the {len(want)} written")
        q_minute = ("SELECT value FROM cpu_usage_user WHERE hostname = "
                    f"'host_7' AND time >= {T0_NS + n_t * STEP_NS}")
        status, doc = http(port, "GET", "/query", {
            "db": PROM_DB, "q": q_minute, "epoch": "ns"})
        rows = doc["results"][0]["series"][0]["values"]
        check(rows == [[T0_NS + i * STEP_NS, float(usage[7, i])]
                       for i in range(n_t, n_all)],
              f"InfluxQL read of the written minute: {rows[:2]}")
        status, doc = http(port, "GET", "/query", {
            "db": PROM_DB, "epoch": "ns",
            "q": "SELECT gauge FROM system_cpu_load GROUP BY hostname"})
        got_otlp = {s["tags"]["hostname"]: s["values"]
                    for s in doc["results"][0]["series"]}
        check(got_otlp == {f"host_{h}": [[t_otlp, float(gauge[h])]]
                           for h in otlp_hosts},
              "OTLP gauge read-back differs")
        status, doc = http(port, "GET", "/query", {
            "db": PROM_DB, "epoch": "ns",
            "q": "SELECT sum(counter) FROM system_net_bytes"})
        check(doc["results"][0]["series"][0]["values"][0][1]
              == float(counter.sum()), "OTLP sum read-back differs")
        labels, _r, _w = prom_get(port, "/api/v1/labels", {"db": PROM_DB})
        check(set(labels) == {"__name__", "hostname", "service.name",
                              *(k for k, _v in tags[0])},
              f"/api/v1/labels: {labels}")
        hv, _r, lv_ms = prom_get(port, "/api/v1/label/hostname/values",
                                 {"db": PROM_DB})
        check(hv == sorted(f"host_{h}" for h in range(n_hosts)),
              f"/label/hostname/values: {len(hv)}")
        sel, _r, se_ms = prom_get(port, "/api/v1/series", {
            "db": PROM_DB, "match[]": 'cpu_usage_user{region="us-west-1"}'})
        want_sel = sum(1 for t in tags if ("region", "us-west-1") in t)
        check(len(sel) == want_sel, f"/series: {len(sel)} not {want_sel}")
        log(f"[prom] read back exactly: PQ6's {n_hosts} written samples, "
            f"host_7's last hour by /api/v1/prom/read ({len(samples)} "
            f"samples), the written minute by InfluxQL, the OTLP gauge "
            f"and sum ({PROM_OTLP_HOSTS} hosts); /labels {len(labels)}, "
            f"/label/hostname/values {len(hv)} in {lv_ms:.1f} ms, /series "
            f"{len(sel)} in {se_ms:.1f} ms")

        # each PQ on the host route
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "host_kernels": "1"})
        check(status == 200, "host_kernels=1 refused")
        routes = {}
        for qn, (path, params) in queries.items():
            l0 = dict(cs.LAUNCHES)
            data, _r, wall_ms = prom_get(port, path, params)
            prom_same(qn + " host route", data, answers[qn], PROM_EXACT[qn])
            routes[qn] = {"host_ms": wall_ms,
                          "device_ms": per_query[qn]["p50_ms"],
                          "host_launches": sum(cs.LAUNCHES[k2] - l0[k2]
                                               for k2 in l0)}
        log("[prom] host route (host kernels on) against the device "
            "route: the same answers; walls (ms) "
            + ", ".join(f"{qn} host {r['host_ms']:.1f} / device "
                        f"{r['device_ms']:.1f}" for qn, r in routes.items()))
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "host_kernels": "0"})

        # PQ3 and PQ4 traced: the device's busy share
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "smoke_trace")
        os.makedirs(trace_dir, exist_ok=True)
        traced = traced_queries(
            port, {qn: queries[qn] for qn in ("PQ3", "PQ4")},
            os.path.join(trace_dir, "prom.json"),
            run=lambda p, q: prom_get(p, *q)[0])
        for qn, tr in traced.items():
            dv = tr.get("device") or {}
            check(dv.get("kernels", 0) > 0, f"{qn}: no kernel in the trace")
            log(f"[trace] {qn} wall {tr['wall_ms']:.1f} ms, device busy "
                f"{dv['busy_ms']:.3f} ms ({100 * dv['busy_ms'] / tr['wall_ms']:.3f}%"
                f" of the wall, idle {100 - 100 * dv['busy_ms'] / tr['wall_ms']:.3f}%)"
                f", {dv['kernels']} kernels {dv['kernel_ms']:.3f} ms, "
                f"host-to-device {dv['h2d_bytes']} B in {dv['h2d_ms']:.3f}"
                f" ms, missing {dv['missing']}")
            per_query[qn]["traced"] = {k2: v for k2, v in tr.items()
                                       if k2 != "result"}

        launches = dict(cs.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        stop_server(svc, engine)
        svc = engine = None

        # the same root on the CPU: the card's answers
        t_cpu = time.perf_counter()
        offload.set_prom_host_kernels_mode("")
        from opengemini_tpu_torch.promql.engine import PromEngine

        cpu_engine = Engine(root, device="cpu")
        try:
            pe = PromEngine(cpu_engine)
            worst = {}
            for qn, (path, params) in queries.items():
                if path.endswith("query_range"):
                    data = pe.query_range(
                        params["query"], float(params["start"]),
                        float(params["end"]), float(params["step"]), PROM_DB)
                else:
                    data = pe.query_instant(params["query"],
                                            float(params["time"]), PROM_DB)
                worst[qn] = prom_same(qn + " on the CPU", data, answers[qn],
                                      PROM_EXACT[qn])
        finally:
            cpu_engine.close()
        cpu_s = time.perf_counter() - t_cpu
        wall_s = time.perf_counter() - t_phase
        log(f"[prom] the CPU reopen gave the card's answers in {cpu_s:.1f} "
            f"s (largest relative difference {json.dumps(worst)}); phase "
            f"13 took {wall_s:.1f} s (budget {PROM_PHASE_S:.0f} s, "
            f"{deadline - time.perf_counter():.0f} s left of the "
            f"script's); launches {json.dumps(launches)}; device memory "
            f"peak {peak / 2**20:.1f} MiB; card {smi_line()}")
        for qn, d in decoded.items():
            per_query[qn + " decoded"] = d
        return {"launches": launches, "per_query": per_query,
                "routes": routes, "steps": steps, "shapes": rec.seen,
                "peak_bytes": peak, "wall_s": wall_s, "cpu_s": cpu_s,
                "root": root, "queries": queries,
                "data": {"tags": tags, "usage": usage, "reads": reads,
                         "n_hosts": n_hosts, "n_all": n_all}}
    finally:
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        offload.set_force(None)
        offload.set_prom_host_kernels_mode("")
        devobs.set_enabled(False)
        rec.__exit__()
        if svc is not None:
            stop_server(svc, engine)


# -- phase 14: the continuous tier on the card --------------------------------

CONT_PHASE_S = 60.0
CONT_HOURS = 2
# the rollup's first tick folds up to here: the last 15 minutes of the
# span stay a raw tail through the grid
CONT_WM_MIN = 105
CONT_BODY_STEPS = 60  # samples of every host in one /write body (10 min)
CONT_DASH_RUNS = 2  # cut from 3 for phase 18
CONT_CONCURRENT = 8
CONT_LATE = 1000.0  # the late point's value, above every walk's range


def _cont_lines(tags, vals, lo: int, hi: int, n_hosts: int) -> bytes:
    """Line protocol of cpu samples [lo, hi) of every host, time-major,
    formatted by the port's native line writer."""
    import numpy as np

    from opengemini_tpu_torch.ingest.line_protocol import series_key
    from opengemini_tpu_torch.ingest.native_lp import ColumnarBatch, LineWriter
    from opengemini_tpu_torch.record import FieldType

    n = hi - lo
    ts = np.repeat(T0_NS + np.arange(lo, hi, dtype=np.int64) * STEP_NS,
                   n_hosts)
    ref = np.tile(np.arange(n_hosts, dtype=np.int64), n)
    ones = np.ones(n * n_hosts, np.bool_)
    cols = [(0, f, FieldType.FLOAT,
             np.ascontiguousarray(vals[f][:, lo:hi].T).reshape(-1), ones)
            for f in FIELDS]
    batch = ColumnarBatch(ts, ref, [series_key("cpu", t) for t in tags],
                          np.zeros(n_hosts, np.int64), ["cpu"], cols)
    return LineWriter(batch).lines(np.arange(len(ts), dtype=np.int64))


def _cont_dashboard(lo_min: int, hi_min: int) -> str:
    return (f"SELECT mean(usage_user), max(usage_user) FROM cpu WHERE "
            f"time >= {T0_NS + lo_min * 60 * 10**9} AND "
            f"time < {T0_NS + hi_min * 60 * 10**9} "
            f"GROUP BY time(5m), hostname")


def _cont_verify(qn: str, res: dict, usage, lo_min: int, hi_min: int,
                 n_hosts: int, late=None) -> None:
    """A dashboard's rows against the oracle: per host and 5-minute
    window, mean (rel MEAN_RTOL) and max (exact) of `usage`, with
    `late` = (host, window, value) added where a late point went."""
    import numpy as np

    per = 30  # samples of a 5-minute window
    w0, w1 = lo_min // 5, hi_min // 5
    series = res.get("series", [])
    check(len(series) == n_hosts, f"{qn}: {len(series)} series")
    for s in series:
        h = int(s["tags"]["hostname"].split("_")[1])
        check(len(s["values"]) == w1 - w0, f"{qn}: host {h} rows")
        for t, mean, mx in s["values"]:
            w = (t - T0_NS) // (300 * 10**9)
            win = usage[h, w * per:(w + 1) * per]
            want_sum, want_n, want_max = win.sum(), per, win.max()
            if late is not None and (h, w) == late[:2]:
                want_sum += late[2]
                want_n += 1
                want_max = max(want_max, late[2])
            check(close(mean, want_sum / want_n),
                  f"{qn}: host {h} window {w} mean {mean}")
            check(mx == float(want_max), f"{qn}: host {h} window {w} max")


def _cont_vars(port: int) -> dict:
    return http(port, "GET", "/debug/vars", {})[1]


def _cont_rollup_span(port: int, q: str) -> dict:
    """The `rollup` span's fields (windows_spliced, rollup_rows) from an
    EXPLAIN ANALYZE of `q`."""
    status, doc = http(port, "GET", "/query", {
        "db": "benchmark", "q": "EXPLAIN ANALYZE " + q})
    check(status == 200 and "error" not in doc["results"][0],
          f"EXPLAIN ANALYZE: {status} {doc}")
    lines = [row[0] for row in doc["results"][0]["series"][0]["values"]]
    out: dict = {}
    depth = None
    for line in lines:
        ind = len(line) - len(line.lstrip())
        if line.strip().startswith("rollup: "):
            depth = ind
        elif depth is not None and ind > depth:
            key, _, val = line.strip().partition(": ")
            out[key] = int(val)
        elif depth is not None:
            break
    return out


def phase_continuous(seed: int, deadline: float,
                     n_hosts: int = N_HOSTS) -> dict:
    """The data's life over time on the card, on a root of its own
    (fresh_root("smoke_continuous")): TSBS devops cpu at its full width
    (n_hosts hosts, 10 float fields, 10 s steps) over CONT_HOURS h in
    database `benchmark` under an RP of 1 h shards, loaded through
    /write; the rollup cpu_1m (usage_user, 1 minute, with its sketches)
    declared through /debug/ctrl?mod=rollup and folded by one governed
    service tick at an explicit now (watermark CONT_WM_MIN minutes in);
    the dashboard (mean and max of usage_user by 5 minutes and host over
    the span) spliced from the rollup rows plus a raw tail through the
    grid on the card, against the oracle and the unspliced answer; a
    late write into a spliced window (re-dirtied, answered with the late
    point); a continuous query (mean(*) INTO cpu_5m GROUP BY time(5m), *
    RESAMPLE FOR 15m) ticked at an explicit now and read back; a stream
    (mean, max, count by region, 1 minute) over one more written minute,
    flushed; a downsample policy rewriting the aged first shard on the
    card (the query before and after it: no stale cache hit); the RP cut
    to 1 h and one retention tick dropping that shard; the governor
    (mod=governor: 2 slots, a queue of 1) under CONT_CONCURRENT
    concurrent dashboards (200s, 503s with Retry-After, its /debug/vars
    section); and the slow log (mod=obs, /debug/slow). Each step's wall,
    the launches of every kernel per step and the memory peak are
    printed; kernel 3 (or 1-2 where the grid declines) is held to its
    plain version at the raw tail's shape."""
    import threading

    import numpy as np
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.services.continuous import (
        ContinuousQueryService,
    )
    from opengemini_tpu_torch.services.downsample import DownsampleService
    from opengemini_tpu_torch.services.retention import RetentionService
    from opengemini_tpu_torch.services.rollup import RollupService
    from opengemini_tpu_torch.services.stream import StreamService
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.utils.governor import GOVERNOR

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 14)
    n_t = CONT_HOURS * 360
    tags = host_tags(n_hosts, rng)
    vals = make_values(n_hosts, n_t + 6, rng)  # the span and one minute
    usage = vals["usage_user"]
    minute = T0_NS + n_t * STEP_NS  # the stream's minute
    root = fresh_root("smoke_continuous")
    cc_prev = colcache.GLOBAL.config()
    colcache.GLOBAL.configure(budget_mb=CC_HOST_MB, device=False)
    rec = ShapeRecorder().__enter__()
    svc = engine = None
    steps: dict = {}
    per_query: dict = {}
    walls: dict = {}
    lap = [time.perf_counter()]

    def step(name: str) -> None:
        now = time.perf_counter()
        walls[name] = round(now - lap[-1], 3)
        lap.append(now)

    def launched(l0: dict) -> dict:
        return {k: cs.LAUNCHES[k] - l0[k] for k in l0}

    try:
        torch.cuda.synchronize()
        cs.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        engine, svc = serve(root)
        port = svc.port
        disarm_planner(port)
        status, doc = http(port, "POST", "/query", {
            "q": "CREATE DATABASE benchmark WITH DURATION 2d "
                 "SHARD DURATION 1h NAME rp1h"})
        check(status == 200 and "error" not in doc["results"][0],
              f"CREATE DATABASE: {doc}")

        # 1. the load through /write
        n_rows = 0
        for lo in range(0, n_t, CONT_BODY_STEPS):
            hi = min(n_t, lo + CONT_BODY_STEPS)
            body = _cont_lines(tags, vals, lo, hi, n_hosts)
            status, _ = http(port, "POST", "/write",
                             {"db": "benchmark", "precision": "ns"}, body)
            check(status == 204, f"/write status {status}")
            n_rows += (hi - lo) * n_hosts
        step("load")
        check(len(engine.all_shards()) == CONT_HOURS,
              f"{len(engine.all_shards())} shards for {CONT_HOURS} h")
        log(f"[continuous] loaded {n_rows} rows ({n_hosts} hosts x "
            f"{len(FIELDS)} fields x {CONT_HOURS} h) through /write in "
            f"{walls['load']:.1f} s ({n_rows / walls['load']:.0f} rows/s) "
            f"into {len(engine.all_shards())} shards of 1 h")

        # 2. the rollup: declared over HTTP, folded by one service tick
        status, doc = http(port, "POST", "/debug/ctrl", {
            "mod": "rollup", "op": "declare", "db": "benchmark",
            "name": "cpu_1m", "measurement": "cpu", "every_s": "60",
            "fields": "usage_user"})
        check(status == 200 and "benchmark.cpu_1m" in doc["specs"],
              f"rollup declare: {status} {doc}")
        v0 = _cont_vars(port).get("rollup", {})
        wm_ns = T0_NS + CONT_WM_MIN * 60 * 10**9
        folded = RollupService(engine, interval_s=3600).handle(
            now_ns=wm_ns + 60 * 10**9)
        step("fold")
        v1 = _cont_vars(port)["rollup"]
        status, doc = http(port, "POST", "/debug/ctrl",
                           {"mod": "rollup", "op": "status"})
        st = doc["specs"]["benchmark.cpu_1m"]
        check(folded == CONT_WM_MIN and st["watermark_ns"] == wm_ns
              and st["dirty_windows"] == 0 and st["sketch"],
              f"the fold: {folded} windows, status {st}")
        rows_out = v1["rows_folded_out"] - v0.get("rows_folded_out", 0)
        check(rows_out == n_hosts * CONT_WM_MIN,
              f"the fold wrote {rows_out} rollup rows")
        log(f"[continuous] rollup cpu_1m folded {folded} windows in "
            f"{walls['fold']:.2f} s: {v1['rows_folded_in'] - v0.get('rows_folded_in', 0)}"
            f" rows in, {rows_out} rollup rows out, watermark "
            f"{CONT_WM_MIN} min into the span")

        # 3. the dashboard: spliced, a raw tail on the card
        q = _cont_dashboard(0, CONT_HOURS * 60)

        def dashboard(qn: str, late=None, runs: int = CONT_DASH_RUNS):
            b = _cont_vars(port)
            l0 = dict(cs.LAUNCHES)
            rec.now = {}
            wall_list = []
            for _ in range(runs):
                res, _req, wall = query_timed(port, q)
                wall_list.append(wall)
            shapes, rec.now = rec.now, None
            a = _cont_vars(port)
            _cont_verify(qn, res, usage, 0, CONT_HOURS * 60, n_hosts, late)
            got = {
                "walls_ms": [round(w, 1) for w in wall_list],
                "p50_ms": p50_of(wall_list),
                "windows_spliced": (a["rollup"]["splice_windows"]
                                    - b["rollup"].get("splice_windows", 0))
                // runs,
                "raw_windows": (a["rollup"]["splice_raw_windows"]
                                - b["rollup"].get("splice_raw_windows", 0))
                // runs,
                "rollup_rows": None,
                "raw_rows": (a["executor"]["rows_scanned"]
                             - b["executor"].get("rows_scanned", 0))
                // runs,
                "launches": launched(l0),
                "shapes": {k: sorted(shape_json(k, s) for s in v)
                           for k, v in shapes.items()},
                "rollup_ms": (a["query_stages"].get("rollup_ns", 0)
                              - b["query_stages"].get("rollup_ns", 0))
                / 1e6 / runs,
            }
            return res, got, shapes

        res, got, tail_shapes = dashboard("D1")
        step("dashboard")
        # the unspliced answer: the same query with the splice off
        engine.rollup_mgr.read_enabled = False
        raw = query(port, q)
        engine.rollup_mgr.read_enabled = True
        check(same_answer(res, raw), "D1: the spliced answer differs "
              "from the unspliced one")
        n_w = CONT_HOURS * 12
        check(got["windows_spliced"] == CONT_WM_MIN // 5
              and got["raw_windows"] == n_w - CONT_WM_MIN // 5,
              f"D1 spliced {got['windows_spliced']} raw "
              f"{got['raw_windows']} windows")
        check(got["raw_rows"] == n_hosts * (CONT_HOURS * 60 - CONT_WM_MIN)
              * 6, f"D1 raw tail {got['raw_rows']} rows")
        kern = {k: v for k, v in got["launches"].items() if v}
        check(kern, "D1: the raw tail launched no kernel")
        span = _cont_rollup_span(port, q)
        got["rollup_rows"] = span.get("rollup_rows")
        check(span.get("windows_spliced") == got["windows_spliced"]
              and got["rollup_rows"] == n_hosts * CONT_WM_MIN,
              f"D1's rollup span {span}")
        per_query["D1"] = got
        log(f"[continuous] D1 ok p50={got['p50_ms']:.1f} ms "
            f"(walls {got['walls_ms']}), windows_spliced "
            f"{got['windows_spliced']} of {n_w}, rollup rows "
            f"{got['rollup_rows']}, raw-tail rows {got['raw_rows']}, "
            f"rollup stage {got['rollup_ms']:.1f} ms, launches "
            f"{json.dumps(kern)} (route: "
            f"{'grid' if kern.get('grid_window_agg') else 'bucketed'}), "
            f"raw-tail shapes {json.dumps(got['shapes'])}; the unspliced "
            "answer equal")
        steps["tail_checks"] = []
        l_chk = dict(cs.LAUNCHES)
        for name, shapes in tail_shapes.items():
            for j, shape in enumerate(sorted(shapes)[:2]):
                r = kernel_case(name, shape, seed + 14000 + j,
                                torch.cuda.get_device_name(0), timed=True)
                steps["tail_checks"].append({"name": name, **r})
                log(f"[continuous] raw-tail kernel {name}"
                    f"{shape_label(name, shape)} ok max_abs_err "
                    f"{r['max_abs_err']} ms={r['ms']:.4f} device_ms="
                    f"{r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                    f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
        for k2 in l_chk:  # the checks' launches are no main path's
            cs.LAUNCHES[k2] = l_chk[k2]
        step("tail kernels")

        # 4. a late write into a spliced window
        late_t = T0_NS + 605 * 10**9  # window 2 (10-15 min), between samples
        status, _ = http(port, "POST", "/write", {"db": "benchmark"},
                         f"cpu,{','.join(f'{k}={v}' for k, v in tags[0])} "
                         f"usage_user={CONT_LATE} {late_t}".encode())
        check(status == 204, f"late /write status {status}")
        status, doc = http(port, "POST", "/debug/ctrl",
                           {"mod": "rollup", "op": "status"})
        check(doc["specs"]["benchmark.cpu_1m"]["dirty_windows"] == 1,
              f"the late write dirtied {doc['specs']}")
        res2, got2, _s = dashboard("D2", late=(0, 2, CONT_LATE), runs=1)
        check(got2["windows_spliced"] == CONT_WM_MIN // 5 - 1,
              f"D2 spliced {got2['windows_spliced']} windows")
        per_query["D2 late"] = got2
        step("late write")
        log(f"[continuous] D2 (a late point at 10:05 of host_0) ok: "
            f"window 2 re-dirtied, windows_spliced "
            f"{got2['windows_spliced']}, raw-tail rows {got2['raw_rows']}, "
            f"launches {json.dumps({k: v for k, v in got2['launches'].items() if v})}")

        # 5. a continuous query, one tick at an explicit now
        status, doc = http(port, "POST", "/query", {
            "db": "benchmark",
            "q": "CREATE CONTINUOUS QUERY cq5 ON benchmark RESAMPLE FOR 15m "
                 "BEGIN SELECT mean(*) INTO cpu_5m FROM cpu "
                 "GROUP BY time(5m), * END"})
        check(status == 200 and "error" not in doc["results"][0],
              f"CREATE CONTINUOUS QUERY: {doc}")
        l0 = dict(cs.LAUNCHES)
        ran = ContinuousQueryService(engine, svc.executor,
                                     interval_s=3600).handle(
            now_ns=T0_NS + n_t * STEP_NS)
        cq_launch = launched(l0)
        check(ran == 1, f"the CQ tick ran {ran} queries")
        back = query(port, "SELECT mean_usage_user, mean_usage_idle FROM "
                           "cpu_5m GROUP BY hostname")
        check(len(back.get("series", [])) == n_hosts,
              f"cpu_5m: {len(back.get('series', []))} series")
        for s in back["series"]:
            h = int(s["tags"]["hostname"].split("_")[1])
            check(len(s["values"]) == 3, f"cpu_5m host {h} rows")
            for t, mu, mi in s["values"]:
                w = (t - T0_NS) // (300 * 10**9)
                sl = slice(w * 30, (w + 1) * 30)
                check(close(mu, usage[h, sl].mean())
                      and close(mi, vals["usage_idle"][h, sl].mean()),
                      f"cpu_5m host {h} window {w}")
        kern = {k: v for k, v in cq_launch.items() if v}
        check(kern, "the CQ launched no kernel")
        per_query["CQ"] = {"launches": cq_launch}
        step("cq")
        log(f"[continuous] CQ cq5 ok: one tick wrote {3 * n_hosts} rows of "
            f"cpu_5m (3 windows x {n_hosts} hosts x {len(FIELDS)} means), "
            f"read back against the oracle; launches {json.dumps(kern)} "
            f"(route: {'grid' if kern.get('grid_window_agg') else 'bucketed'})")

        # 6. a stream over one more written minute
        streams = StreamService(engine, interval_s=3600)
        status, doc = http(port, "POST", "/query", {
            "db": "benchmark",
            "q": "CREATE STREAM s1 ON SELECT mean(usage_user), "
                 "max(usage_user), count(usage_user) INTO cpu_s FROM cpu "
                 "GROUP BY time(1m), region"})
        check(status == 200 and "error" not in doc["results"][0],
              f"CREATE STREAM: {doc}")
        status, _ = http(port, "POST", "/write",
                         {"db": "benchmark", "precision": "ns"},
                         _cont_lines(tags, vals, n_t, n_t + 6, n_hosts))
        check(status == 204, f"the stream minute's /write status {status}")
        flushed = streams.handle(now_ns=minute + 60 * 10**9)
        region = np.array([dict(t)["region"] for t in tags])
        regions = sorted(set(region.tolist()))
        check(flushed == len(regions), f"the stream flushed {flushed}")
        cells = query(port, "SELECT * FROM cpu_s GROUP BY region")
        for s in cells["series"]:
            sel = usage[region == s["tags"]["region"], n_t:n_t + 6]
            [[t, count, mx, mean]] = s["values"]
            check(t == minute and count == sel.size
                  and mx == float(sel.max()) and close(mean, sel.mean()),
                  f"cpu_s {s['tags']}: {s['values']}")
        step("stream")
        log(f"[continuous] stream s1 ok: {6 * n_hosts} rows folded at "
            f"ingest into {flushed} cells (one minute x {len(regions)} "
            "regions), flushed and read back against the oracle")

        # 7. downsample: the aged first shard rewritten on the card
        status, doc = http(port, "POST", "/query", {
            "db": "benchmark",
            "q": "CREATE DOWNSAMPLE ON benchmark.rp1h (float(mean)) WITH "
                 "TTL 2d SAMPLEINTERVAL 1h TIMEINTERVAL 5m"})
        check(status == 200 and "error" not in doc["results"][0],
              f"CREATE DOWNSAMPLE: {doc}")
        # usage_system: no rollup covers it, so the answer is the raw rows
        # (a rollup outlives its source's rewrites by design)
        qd = (f"SELECT count(usage_system), mean(usage_system) FROM cpu "
              f"WHERE time >= {T0_NS} AND time < {T0_NS + 3600 * 10**9} "
              f"GROUP BY time(5m)")
        before = query(port, qd)
        query(port, qd)  # the host tier holds the columns now
        cc0 = colcache.GLOBAL.counters()
        l0 = dict(cs.LAUNCHES)
        n_ds = DownsampleService(engine, interval_s=3600).handle(
            now_ns=T0_NS + n_t * STEP_NS)
        ds_launch = launched(l0)
        check(n_ds == 1, f"{n_ds} shards downsampled")
        after = query(port, qd)
        cc1 = colcache.GLOBAL.counters()
        system = vals["usage_system"]
        for w, (b_row, a_row) in enumerate(zip(before["series"][0]["values"],
                                               after["series"][0]["values"])):
            sl = system[:, w * 30:(w + 1) * 30]
            per_host = sl.mean(axis=1)
            check(b_row[1] == sl.size and close(b_row[2], sl.mean()),
                  f"before the downsample, window {w}: {b_row}")
            check(a_row[1] == n_hosts and close(a_row[2], per_host.mean()),
                  f"after the downsample, window {w}: {a_row} (a stale "
                  "cache hit?)")
        check(cc1["invalidations"] > cc0["invalidations"],
              "the rewrite invalidated no cached column")
        per_query["downsample"] = {"launches": ds_launch}
        step("downsample")
        log(f"[continuous] downsample ok: the first shard rewritten at 5 "
            f"min ({n_hosts * 12} rows from {n_hosts * 360}), the query "
            f"before and after against the oracle, "
            f"{cc1['invalidations'] - cc0['invalidations']} cached columns "
            f"invalidated; the rewrite's device batches on "
            f"{engine.device}")

        # 8. retention: the RP cut to 1 h drops the first shard
        status, doc = http(port, "POST", "/query", {
            "db": "benchmark",
            "q": "ALTER RETENTION POLICY rp1h ON benchmark DURATION 1h"})
        check(status == 200 and "error" not in doc["results"][0],
              f"ALTER RETENTION POLICY: {doc}")
        n_before = len(engine.all_shards())
        RetentionService(engine, interval_s=3600).handle(
            now_ns=T0_NS + n_t * STEP_NS + 1800 * 10**9)
        left = sorted(sh.tmin for (db, rp, _g), sh in engine.shard_items()
                      if rp == "rp1h")
        check(T0_NS not in left and len(left) == CONT_HOURS,
              f"retention left shards {left}")
        cnt = query(port, f"SELECT count(usage_user) FROM cpu WHERE "
                          f"time >= {T0_NS} AND time < {minute + 60 * 10**9}")
        want = n_hosts * (n_t - 360 + 6)
        check(cnt["series"][0]["values"][0][1] == want,
              f"after retention {cnt['series'][0]['values']} rows, want "
              f"{want}")
        step("retention")
        log(f"[continuous] retention ok: {n_before} -> "
            f"{len(engine.all_shards())} shards (the first hour dropped), "
            f"{want} rows left")

        # 9. the governor: 2 slots and a queue of 1 under 8 dashboards
        status, doc = http(port, "POST", "/debug/ctrl", {
            "mod": "governor", "budget_mb": str(1 << 16),
            "max_concurrent": "2", "queue": "1", "timeout_ms": "60000"})
        check(status == 200 and doc["governor"]["enabled"],
              f"mod=governor: {doc}")
        qg = _cont_dashboard(60, CONT_HOURS * 60)
        go = threading.Barrier(CONT_CONCURRENT)
        answers: list = []

        def fire():
            go.wait(30)
            answers.append(http_raw(port, "GET", "/query", {
                "db": "benchmark", "q": qg, "epoch": "ns"}))

        threads = [threading.Thread(target=fire)
                   for _ in range(CONT_CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        gsec = _cont_vars(port).get("governor", {})
        codes = sorted(a[0] for a in answers)
        n_ok, n_shed = codes.count(200), codes.count(503)
        check(n_ok + n_shed == CONT_CONCURRENT and n_shed >= 1
              and n_ok >= 2, f"governed dashboards answered {codes}")
        check(all(int(a[1]["Retry-After"]) >= 1 for a in answers
                  if a[0] == 503), "a 503 without Retry-After")
        check(gsec.get("sheds_queue_full", 0) + gsec.get("sheds_timeout", 0)
              == n_shed, f"the governor's sheds {gsec}")
        ok_body = next(json.loads(a[2]) for a in answers if a[0] == 200)
        _cont_verify("G1", ok_body["results"][0], usage, 60,
                     CONT_HOURS * 60, n_hosts)
        status, doc = http(port, "POST", "/debug/ctrl",
                           {"mod": "governor", "budget_mb": "0"})
        GOVERNOR.reset()
        step("governor")
        gkeys = ("admitted", "queued", "sheds_queue_full", "sheds_timeout",
                 "ledger_memtable_bytes", "ledger_colcache_host_bytes",
                 "ledger_total_bytes")
        log(f"[continuous] governor ok: {CONT_CONCURRENT} concurrent "
            f"dashboards, {n_ok} x 200, {n_shed} x 503 with Retry-After; "
            f"/debug/vars governor {json.dumps({k: gsec.get(k) for k in gkeys})}")
        steps["governor"] = {"ok": n_ok, "shed": n_shed,
                             "vars": {k: gsec.get(k) for k in gkeys}}

        # 10. the slow log
        status, doc = http(port, "POST", "/debug/ctrl",
                           {"mod": "obs", "slow_ms": "0", "clear": "1"})
        check(status == 200 and doc["slow_ms"] == 0.0, f"mod=obs: {doc}")
        query(port, qg)
        slow = http(port, "GET", "/debug/slow", {})[1]
        http(port, "POST", "/debug/ctrl",
             {"mod": "obs", "slow_ms": "off", "clear": "1"})
        check(any(r["statement"] == qg for r in slow["records"]),
              f"/debug/slow: {slow}")
        srec = next(r for r in slow["records"] if r["statement"] == qg)
        step("slow log")
        log(f"[continuous] slow log ok: {slow['captured']} captured, the "
            f"dashboard at {srec['duration_ms']} ms, stages "
            f"{json.dumps(srec['stages_ms'])}")

        launches = dict(cs.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        wall_s = time.perf_counter() - t_phase
        log(f"[continuous] step walls (s) {json.dumps(walls)}; phase 14 "
            f"took {wall_s:.1f} s (budget {CONT_PHASE_S:.0f} s, "
            f"{deadline - time.perf_counter():.0f} s left of the "
            f"script's); launches {json.dumps(launches)}; device memory "
            f"peak {peak / 2**20:.1f} MiB; card {smi_line()}")
        steps["walls_s"] = walls
        return {"launches": launches, "per_query": per_query,
                "steps": steps, "shapes": rec.seen, "peak_bytes": peak,
                "wall_s": wall_s}
    finally:
        rec.__exit__()
        colcache.GLOBAL.configure(**cc_prev)
        if GOVERNOR.enabled():
            GOVERNOR.configure(budget_mb=0)
            GOVERNOR.reset()
        if svc is not None:
            stop_server(svc, engine)


# -- phase 15: the rule tier on the card ---------------------------------------

RULES_PHASE_S = 60.0
RULES_GROUP = "fleet"
# incremental ticks after the cold one, a minute apart; the cold tick's
# eval time (minutes after T0) lies inside phase 13's span. The fallback
# rule ticks alone a minute before it, first after the engine opens: its
# window reads the compacted file alone, as one still-encoded column (a
# host read would leave it decoded), so the forced device decode
# launches kernel 5
RULES_TICKS = 10
RULES_TE0_MIN = 119
# the tick before which a late sample lands in an already folded tile
RULES_LATE_TICK = 6
RULES_LATE_HOST = 5
RULES_RTOL = 1e-9
RULES_CPU_RTOL = 1e-12
# the ticks whose recorded R1, R2 and F1 are also held to their
# expressions evaluated anew (every tick's to its own results): the cold
# tick and the late one, so that the phase fits its budget
RULES_EXPR_TICKS = (0, RULES_LATE_TICK)
# the ticks verified against a from-scratch evaluation on the card: the
# cold one, the late one, the last before the restart and the first after
# it (cut from every tick for phase 16; the CPU tests verify every tick)
RULES_VERIFY_TICKS = (0, RULES_LATE_TICK, RULES_TICKS, RULES_TICKS + 1)
# detect()'s threshold in the castor step: low enough that host_7's
# walk has rows beyond it
RULES_DETECT_THR = 1.5
# (short name, kind, rule name, expression, for_s)
RULES = (
    ("R1", "record", "region:diskio_read_bytes:increase1h",
     "sum by (region) (increase(diskio_read_bytes[1h]))", 0),
    ("R2", "record", "hostname:cpu_usage_user:avg5m",
     "avg by (hostname) (avg_over_time(cpu_usage_user[5m]))", 0),
    ("A1", "alert", "CpuHot", "max_over_time(cpu_usage_user[5m]) > 90", 120),
    ("F1", "record", "diskio_read_bytes:rate5m:top10",
     "topk(10, rate(diskio_read_bytes[5m]))", 0),
)
# the tiles the windows cover per tick: R1's 60 on diskio, the 5 that
# R2 and A1 share on cpu (one selector)
RULES_COVERED = 65


class CollectProbe:
    """Counts the rows a rule manager's collections return (the storage
    scans of its tile folds and of its verify leg)."""

    def __init__(self, mgr):
        self.rows = 0
        real = mgr._collect

        def counted(*args):
            got = real(*args)
            self.rows += int(len(got[1]))
            return got

        mgr._collect = counted


def _rule_series(data: dict) -> dict:
    """An instant vector's {labels without __name__: value}."""
    return {tuple(sorted((k, v) for k, v in r["metric"].items()
                         if k != "__name__")): float(r["value"][1])
            for r in data["result"]}


def _rules_same(what: str, got: dict, want: dict, rtol: float) -> float:
    import math

    check(got.keys() == want.keys(), f"{what}: {len(got)} series against "
          f"{len(want)}, or other labels")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        check(math.isclose(g, w, rel_tol=rtol, abs_tol=0)
              or (math.isnan(g) and math.isnan(w)),
              f"{what} {k[:1]}: {g!r} against {w!r}")
        if w:
            worst = max(worst, abs(g - w) / abs(w))
    return worst


def phase_rules(prom: dict, seed: int, deadline: float) -> dict:
    """The PromQL rule tier on the card, on phase 13's root reopened
    (build/prom: TSBS devops cpu_usage_user and diskio_read_bytes, 4000
    hosts at 10 s): one rule group of a 60 s interval declared through
    /debug/ctrl?mod=rules (RULES: F1 a topk of rates, the fallback leg
    through the port's PromEngine, declared first and ticked alone with
    the route forced to the device, so that its decode launches kernel
    5; then R1 a regional sum of increase over 1 h, R2 the per-host mean
    over 5 min, 4000 series written back, A1 an alert on max_over_time
    > 90 for 120 s, all three tiled); a cold tick at an explicit now
    inside the loaded span, then RULES_TICKS ticks a minute apart past
    the span's end with
    the next minute of all 8000 series remote-written before each, and
    a late sample into an already folded tile before RULES_LATE_TICK.
    The ticks of RULES_VERIFY_TICKS verify bit for bit against a
    from-scratch evaluation (verify_last_tick, outside the timed tick);
    each tick folds only its new tile
    (and the re-dirtied one) per selector, and is read back: R1, R2 and
    F1 by name against the tick's results exactly, and at
    RULES_EXPR_TICKS against their expressions (rel RULES_RTOL), A1's
    series against numpy's max exactly, its alerts (pending, then firing
    after for_s) against a numpy run of the state machine,
    /api/v1/rules.
    Then a restart (the group, watermark and alert state reload; the
    next tick fires only what numpy says and verifies); castor (CREATE
    MODEL on host_7's per-minute mean, an InfluxQL aggregate on the
    card, and detect() with it and with 'mad', against numpy); a
    subscription forwarding one minute of cpu for every host to a sink
    on localhost; the scrub (a full pass, then a bitflip rule
    quarantining exactly the subscription's flushed file); a monitor
    tick read back from _internal; /debug/ctrl?mod=durability; and the
    root on the CPU recomputing the card's last tick from scratch (tiled
    rules bit for bit, F1 within RULES_CPU_RTOL)."""
    import math
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.promql.rules import RuleManager
    from opengemini_tpu_torch.query import offload
    from opengemini_tpu_torch.server.http import HttpService
    from opengemini_tpu_torch.services.monitor import MonitorService
    from opengemini_tpu_torch.services.subscriber import SubscriberManager
    from opengemini_tpu_torch.storage import colcache, diskfault
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.utils.stats import GLOBAL as STATS

    t_phase = time.perf_counter()
    root = prom["root"]
    d = prom["data"]
    tags, n_hosts, n_all = d["tags"], d["n_hosts"], d["n_all"]
    rng = np.random.default_rng(seed + 15)
    n_more = 6 * RULES_TICKS
    walk = np.clip(d["usage"][:, -1:] + np.cumsum(
        rng.normal(0.0, 1.0, (n_hosts, n_more)), axis=1), 0.0, 100.0)
    usage = np.concatenate([d["usage"], walk], axis=1)
    reads = np.concatenate([d["reads"], d["reads"][:, -1:] + np.cumsum(
        np.abs(np.rint(rng.normal(100.0, 1.0, (n_hosts, n_more)))),
        axis=1)], axis=1)
    t0_s = T0_NS / 1e9
    names = {short: name for short, _k, name, _e, _f in RULES}
    exprs = {short: expr for short, _k, _n, expr, _f in RULES}
    te0 = t0_s + RULES_TE0_MIN * 60.0
    tes = [te0 + 60.0 * k for k in range(RULES_TICKS + 3)]
    hostnames = [dict(t)["hostname"] for t in tags]
    # the late sample: host RULES_LATE_HOST, 25 s before the eval time
    # of the tick before (in the tile it folded last), above every walk.
    # A write marks its samples' tiles and the next one dirty, and the
    # next is the new tile of RULES_LATE_TICK
    late_t = tes[RULES_LATE_TICK - 1] - 25.0
    i_late = int((late_t - t0_s) // 10)
    late_cpu = 99.5
    late_read = float((reads[RULES_LATE_HOST, i_late]
                       + reads[RULES_LATE_HOST, i_late + 1]) / 2)
    written = {"n": n_all, "late": False}

    def cpu_window(te: float) -> dict:
        """numpy's max_over_time(cpu_usage_user[5m]) > 90 at te over the
        samples written so far: {hostname: max}."""
        lo = int(math.floor((te - 300.0 - t0_s) / 10.0)) + 1
        hi = min(int(math.floor((te - t0_s) / 10.0)), written["n"] - 1)
        win = usage[:, lo:hi + 1].max(axis=1)
        if written["late"] and te - 300.0 < late_t <= te:
            win[RULES_LATE_HOST] = max(win[RULES_LATE_HOST], late_cpu)
        return {hostnames[h]: float(win[h]) for h in np.flatnonzero(win > 90)}

    sim = {"alerts": {}, "fires": 0}

    def sim_advance(te: float, active: dict) -> int:
        """The alert state machine over numpy's active set; returns the
        fires of this tick."""
        fired = 0
        for h in active:
            ent = sim["alerts"].setdefault(h, [te, None])
            if ent[1] is None and te - ent[0] >= 120.0:
                ent[1] = te
                fired += 1
        for h in [h for h in sim["alerts"] if h not in active]:
            del sim["alerts"][h]
        sim["fires"] += fired
        return fired

    # the minute's remote-write body, as prompb_write encodes it, with
    # each series' labels encoded once for every minute
    metrics = (("cpu_usage_user", usage), ("diskio_read_bytes", reads))
    label_bytes = [b"".join(_pb(1, _pb(1, n.encode()) + _pb(2, v.encode()))
                            for n, v in (("__name__", metric), *tags[h]))
                   for metric, _src in metrics for h in range(n_hosts)]

    def minute_body(k: int) -> bytes:
        lo = n_all + 6 * (k - 1)
        t_ms = (T0_NS // 10**6
                + np.arange(lo, lo + 6, dtype=np.int64) * (STEP_NS // 10**6))
        heads = []  # (Sample field header, value tag) and the timestamp
        for t in t_ms.tolist():
            tail = _pb_varint(2 << 3) + _pb_varint(t)
            heads.append((_pb_varint((2 << 3) | 2) + _pb_varint(9 + len(tail))
                          + _pb_varint((1 << 3) | 1), tail))
        out = []
        for (_metric, src), base in zip(metrics, range(0, 2 * n_hosts,
                                                       n_hosts)):
            raw = np.ascontiguousarray(src[:, lo:lo + 6],
                                       dtype="<f8").tobytes()
            for h in range(n_hosts):
                off = 48 * h
                out.append(_pb(1, label_bytes[base + h] + b"".join(
                    head + raw[off + 8 * j:off + 8 * j + 8] + tail
                    for j, (head, tail) in enumerate(heads))))
        return snappy_literal(b"".join(out))

    cc_prev = colcache.GLOBAL.config()
    rc_prev = os.environ.get("OGT_RESULT_CACHE")
    os.environ["OGT_RESULT_CACHE"] = "0"
    os.environ.pop("OGT_RULES_VERIFY", None)  # verified outside the tick
    # the decoded-column cache's host tier at its deployed default: the
    # verify leg and the read-backs re-read the hour the folds read
    colcache.GLOBAL.configure(budget_mb=256, device=False)
    rec = ShapeRecorder().__enter__()
    svc = engine = mgr = subs = sink = None
    per_query: dict = {}
    steps: dict = {}
    walls: dict = {}
    laps = [time.perf_counter()]

    def step(what: str) -> None:
        now = time.perf_counter()
        walls[what] = now - laps[-1]
        laps.append(now)

    try:
        torch.cuda.synchronize()
        cs.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        engine = Engine(root)
        check(engine.device.type == "cuda", f"engine on {engine.device}")
        svc = HttpService(engine, port=0, prom_db=PROM_DB)
        svc.start()
        port = svc.port
        disarm_planner(port)
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "host_kernels": "0"})
        check(status == 200, "host_kernels=0 refused")
        step("open")

        def declare(shorts) -> dict:
            for short, kind, name, expr, for_s in RULES:
                if short not in shorts:
                    continue
                params = {"mod": "rules", "op": "declare", "db": PROM_DB,
                          "group": RULES_GROUP, "interval_s": "60",
                          ("record" if kind == "record" else "alert"): name,
                          "expr": expr}
                if for_s:
                    params["for_s"] = str(for_s)
                status, doc = http(port, "POST", "/debug/ctrl", params)
                check(status == 200, f"declare {short}: {status} {doc}")
            return doc["groups"][f"{PROM_DB}.{RULES_GROUP}"]

        # (a) the group, declared through /debug/ctrl: the fallback
        # rule first
        declare(("F1",))
        mgr = engine.rules_hook
        check(mgr is not None and svc.rules_manager is mgr,
              "no rule manager after the declare")
        probe = CollectProbe(mgr)
        ticks = []
        covered = {"n": 0}

        def do_tick(k: int, te: float, tag: str) -> dict:
            g = mgr.groups_for(PROM_DB)[0]
            c0 = dict(STATS.counters("rules"))
            l0 = dict(cs.LAUNCHES)
            r0 = probe.rows
            rec.now = {}
            t_a = time.perf_counter()
            status, doc = http(port, "POST", "/debug/ctrl", {
                "mod": "rules", "op": "tick", "db": PROM_DB,
                "now_ns": str(int(round(te * 1e9)) + 30 * 10**9)})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_a) * 1e3
            check(status == 200 and doc["ticked"] == 1,
                  f"tick {k}: {status} {doc}")
            c1 = STATS.counters("rules")
            launches = {n: cs.LAUNCHES[n] - l0[n] for n in l0}
            rows = probe.rows - r0
            folded = c1.get("tiles_folded", 0) - c0.get("tiles_folded", 0)
            fallbacks = (c1.get("fallback_evals", 0)
                         - c0.get("fallback_evals", 0))
            shapes = rec.now
            rec.now = None
            verify_ms = None
            if k in RULES_VERIFY_TICKS:
                t_v = time.perf_counter()
                check(mgr.verify_last_tick(g),
                      f"tick {k}: nothing to verify")
                verify_ms = (time.perf_counter() - t_v) * 1e3
            check(g.last_eval_ns == int(round(te * 1e9)),
                  f"tick {k}: watermark {g.last_eval_ns}")
            out = {"te": te, "wall_ms": wall_ms,
                   "tick_ms": g.last_tick_ms, "verify_ms": verify_ms,
                   "tiles_folded": folded, "tiles_covered": covered["n"],
                   "rows": rows, "fallback_evals": fallbacks,
                   "launches": launches,
                   "shapes": {n: [shape_json(n, x) for x in sorted(v)]
                              for n, v in shapes.items()}}
            log(f"[rules] tick {k}{tag} at T0+{(te - t0_s) / 60:.0f} min: "
                f"{wall_ms:.1f} ms ({g.last_tick_ms:.1f} ms in the "
                f"manager), tiles folded {folded} of the {covered['n']} "
                f"the windows cover, {rows} rows collected, {fallbacks} "
                f"fallback evaluation(s), "
                + (f"verified bit for bit against a from-scratch evaluation "
                   f"in {verify_ms:.1f} ms" if verify_ms is not None
                   else "not verified (RULES_VERIFY_TICKS)")
                + "; launches "
                f"{json.dumps({a: b for a, b in launches.items() if b})}")
            return out

        def read_back(k: int, te: float, shorts=("R1", "R2", "F1")) -> dict:
            """R1, R2 and F1 by name against the tick's results exactly
            (and at RULES_EXPR_TICKS against their expressions), A1
            against numpy, the alerts against the state machine."""
            g = mgr.groups_for(PROM_DB)[0]
            worst = {}
            t_r = time.perf_counter()
            for short in shorts:
                # by name over the last second: the rule's write at te
                # alone (F1's top ten of earlier ticks stay within the
                # instant selector's 5 min lookback)
                mine, _r, _w = prom_get(port, "/api/v1/query", {
                    "query": f"last_over_time({names[short]}[1s])",
                    "time": repr(te), "db": PROM_DB})
                got = _rule_series(mine)
                check(len(got) == {"R1": len(set(
                    dict(t)["region"] for t in tags)), "R2": n_hosts,
                    "F1": 10}[short], f"tick {k} {short}: {len(got)} series")
                _rules_same(f"tick {k} {short}", got,
                            g.last_results[names[short]], 0.0)
                if k in RULES_EXPR_TICKS or k < 0:
                    want, _r, _w = prom_get(port, "/api/v1/query", {
                        "query": exprs[short], "time": repr(te),
                        "db": PROM_DB})
                    worst[short] = _rules_same(
                        f"tick {k} {short}", got, _rule_series(want),
                        RULES_RTOL)
            read_ms = (time.perf_counter() - t_r) * 1e3
            if "R1" not in shorts:
                return {"worst_rel": worst, "read_ms": read_ms}
            active = cpu_window(te)
            a1 = {dict(key)["hostname"]: v
                  for key, v in g.last_results[names["A1"]].items()}
            check(a1 == active, f"tick {k} A1: {len(a1)} series against "
                  f"numpy's {len(active)}, or other maxima")
            fired = sim_advance(te, active)
            alerts = http(port, "GET", "/api/v1/alerts", {})[1]["data"]
            states = {a["labels"]["hostname"]: (a["state"], a["activeAt"])
                      for a in alerts["alerts"]}
            want_states = {h: ("firing" if e[1] is not None else "pending",
                               e[0]) for h, e in sim["alerts"].items()}
            check(states == want_states, f"tick {k}: alerts differ from "
                  "the state machine's")
            check(g.fires.get(names["A1"], 0) == sim["fires"],
                  f"tick {k}: {g.fires} fires against {sim['fires']}")
            n_fire = sum(1 for s_, _a in states.values() if s_ == "firing")
            return {"worst_rel": worst, "read_ms": read_ms,
                    "a1_series": len(a1), "pending": len(states) - n_fire,
                    "firing": n_fire, "fired": fired}

        # (c) the fallback alone, the route forced to the device
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "force": "device"})
        check(status == 200, "force=device refused")
        t = do_tick(-1, tes[0] - 60.0, " (the fallback alone, forced to "
                    "the device)")
        http(port, "POST", "/debug/ctrl", {"mod": "offload", "force": "none"})
        check(t["tiles_folded"] == 0 and t["fallback_evals"] == 1,
              f"the fallback tick: {t}")
        check(t["launches"]["unpack_bits"] > 0,
              "phase 15: kernel 5 never launched in the forced fallback")
        t.update(read_back(-1, tes[0] - 60.0, ("F1",)))
        ticks.append(t)
        step("fallback tick")

        # (a) the tiled rules join the group
        gst = declare(("R1", "R2", "A1"))
        tiled = {r["name"]: r["tiled"] for r in gst["rules"]}
        check(tiled == {names["R1"]: True, names["R2"]: True,
                        names["A1"]: True, names["F1"]: False},
              f"tiled shapes {tiled}")
        check(gst["g_ms"] == 60_000, f"lattice {gst['g_ms']} ms")
        covered["n"] = RULES_COVERED
        step("declare")
        log(f"[rules] declared {PROM_DB}.{RULES_GROUP} (60 s, lattice "
            f"{gst['g_ms']} ms): " + ", ".join(
                f"{s} {n} ({'tiled' if tiled[n] else 'fallback'})"
                for s, n in names.items()))

        # (b) the cold tick
        t = do_tick(0, tes[0], " (cold)")
        check(t["tiles_folded"] == RULES_COVERED,
              f"the cold tick folded {t['tiles_folded']} tiles")
        check(t["fallback_evals"] == 1, "the cold tick: no fallback leg")
        t.update(read_back(0, tes[0]))
        check(t["firing"] == 0 and t["pending"] == t["a1_series"] > 0,
              f"the cold tick's alerts: {t['pending']} pending, "
              f"{t['firing']} firing")
        ticks.append(t)
        step("cold tick")

        for k in range(1, RULES_TICKS + 1):
            body = minute_body(k)
            t_w = time.perf_counter()
            status, _h, resp = http_raw(port, "POST", "/api/v1/prom/write",
                                        {"db": PROM_DB}, body)
            check(status == 204, f"minute {k}: status {status} {resp[:200]!r}")
            written["n"] += 6
            write_ms = (time.perf_counter() - t_w) * 1e3
            redirty = 0
            if k == RULES_LATE_TICK:
                t_ms = int(round(late_t * 1000))
                body = snappy_literal(prompb_write([
                    ([("__name__", "cpu_usage_user"), *tags[RULES_LATE_HOST]],
                     [t_ms], [late_cpu]),
                    ([("__name__", "diskio_read_bytes"),
                      *tags[RULES_LATE_HOST]], [t_ms], [late_read])]))
                status, _h, _resp = http_raw(port, "POST",
                                             "/api/v1/prom/write",
                                             {"db": PROM_DB}, body)
                check(status == 204, f"the late sample: {status}")
                written["late"] = True
                redirty = 2
            t = do_tick(k, tes[k], " (a late sample re-dirtied a folded "
                        "tile)" if redirty else "")
            t["write_ms"] = write_ms
            check(t["tiles_folded"] == 2 + redirty,
                  f"tick {k} folded {t['tiles_folded']} tiles, not the new "
                  f"one{' and the re-dirtied one' if redirty else ''} of "
                  "each selector")
            check(t["fallback_evals"] == 1, f"tick {k}: no fallback leg")
            t.update(read_back(k, tes[k]))
            ticks.append(t)
        check(any(t.get("firing") for t in ticks), "A1 never reached firing")
        first_fire = next(k for k, t in enumerate(ticks[1:]) if t["firing"])
        check(first_fire >= 2, f"A1 fired at tick {first_fire}, before its "
              "for_s")
        rules_doc = http(port, "GET", "/api/v1/rules", {})[1]["data"]
        [grp] = rules_doc["groups"]
        check([r["name"] for r in grp["rules"]] == [
            names[x] for x in ("F1", "R1", "R2", "A1")]
              and all(r["health"] == "ok" for r in grp["rules"])
              and grp["lastEvaluation"] == tes[RULES_TICKS],
              f"/api/v1/rules: {json.dumps(grp)[:300]}")
        step("ticks")
        incr = [t["wall_ms"] for t in ticks[2:]]
        verified = [t["verify_ms"] for t in ticks[2:]
                    if t["verify_ms"] is not None]
        log(f"[rules] {RULES_TICKS} incremental ticks: p50 "
            f"{p50_of(incr):.1f} ms against the cold tick's "
            f"{ticks[1]['wall_ms']:.1f} ms (the minute's remote write p50 "
            f"{p50_of([t['write_ms'] for t in ticks[2:]]):.1f} ms, the "
            f"verify p50 {p50_of(verified):.1f}"
            f" ms, the read-backs p50 "
            f"{p50_of([t['read_ms'] for t in ticks[2:]]):.1f} ms); R1, R2 "
            f"and F1 read back by name equal each tick's results exactly, "
            f"and their expressions at ticks {list(RULES_EXPR_TICKS)} "
            f"(largest relative difference "
            f"{max(max(t['worst_rel'].values(), default=0.0) for t in ticks):.3g}), A1 "
            f"equals numpy's max exactly at every tick, pending at tick 0 "
            f"and firing from tick {first_fire} ({sim['fires']} fires); "
            f"/api/v1/rules lists the four rules, health ok, last "
            f"evaluation T0+{(tes[RULES_TICKS] - t0_s) / 60:.0f} min")

        # (e) a flush, then a restart on the same root
        status, _ = http(port, "POST", "/debug/ctrl", {"mod": "flush"})
        check(status == 200, "mod=flush refused")
        g = mgr.groups_for(PROM_DB)[0]
        before = {"last_eval_ns": g.last_eval_ns, "alerts": json.loads(
            json.dumps(g.alerts)), "fires": dict(g.fires)}
        mgr.close()
        stop_server(svc, engine)
        svc = engine = mgr = None
        engine = Engine(root)
        svc = HttpService(engine, port=0, prom_db=PROM_DB)
        svc.start()
        port = svc.port
        # the rule service's builder builds the manager at start, as
        # the server does beside its services
        mgr = svc.rules_manager = RuleManager(engine, prom=svc.prom)
        probe = CollectProbe(mgr)
        g = mgr.groups_for(PROM_DB)[0]
        check(g.last_eval_ns == before["last_eval_ns"]
              and g.alerts == before["alerts"]
              and g.fires == before["fires"],
              "the group, watermark or alert state did not reload")
        http(port, "POST", "/debug/ctrl", {"mod": "offload",
                                           "host_kernels": "0"})
        k = RULES_TICKS + 1
        firing_before = {h: e[1] for h, e in sim["alerts"].items()
                         if e[1] is not None}
        t = do_tick(k, tes[k], " (after the restart: tiles refold)")
        check(t["tiles_folded"] == RULES_COVERED,
              f"the first tick after the restart folded {t['tiles_folded']}")
        t.update(read_back(k, tes[k]))
        for key, ent in g.alerts.get(names["A1"], {}).items():
            h = ent["labels"]["hostname"]
            if h in firing_before:
                check(ent["fired_at_ns"] == int(round(
                    firing_before[h] * 1e9)), f"{h} re-fired")
        ticks.append(t)
        card_last = {"e_tile": g.last_e_tile, "te": tes[k],
                     "results": {n: dict(v) for n, v in
                                 g.last_results.items()}}
        step("restart")
        log(f"[rules] restart: the group, watermark and {len(before['alerts'].get(names['A1'], {}))} "
            f"alert states reloaded; tick {k} refolded {t['tiles_folded']} "
            f"tiles, verified, fired {t['fired']} (numpy's count; no "
            f"re-fire of the {len(firing_before)} firing)")

        # (f) castor: a model fitted on host_7's per-minute means
        span = (f"time >= {T0_NS} AND time < "
                f"{T0_NS + (n_all - 6) * STEP_NS}")
        l0 = dict(cs.LAUNCHES)
        rec.now = {}
        status, doc = http(port, "POST", "/query", {
            "db": PROM_DB, "q": "CREATE MODEL host7 WITH ALGORITHM 'mad' "
            "FROM (SELECT mean(value) FROM cpu_usage_user WHERE hostname = "
            f"'host_7' AND {span} GROUP BY time(1m))"})
        check(status == 200 and "error" not in doc["results"][0],
              f"CREATE MODEL: {doc}")
        fit_launches = {n: cs.LAUNCHES[n] - l0[n] for n in l0}
        fit_shapes = rec.now
        rec.now = None
        check(sum(fit_launches[n] for n in E2E_KERNELS) > 0,
              f"the model's aggregate launched {fit_launches}")
        model = engine.models.get("host7")
        means = usage[7, :n_all - 6].reshape(-1, 6).mean(axis=1)
        med = float(np.median(means))
        mad = float(np.median(np.abs(means - med)))
        check(model["trained_rows"] == len(means)
              and math.isclose(model["params"]["median"], med,
                               rel_tol=RULES_RTOL)
              and math.isclose(model["params"]["mad"], mad,
                               rel_tol=RULES_RTOL),
              f"the model {model['params']} against numpy's {med}, {mad}")
        raw = usage[7, :n_all - 6]
        raw_t = T0_NS + np.arange(n_all - 6, dtype=np.int64) * STEP_NS
        p = model["params"]
        want = {"host7": raw_t[np.abs(raw - p["median"])
                               / (1.4826 * p["mad"]) > RULES_DETECT_THR]}
        m_raw = float(np.median(raw))
        mad_raw = float(np.median(np.abs(raw - m_raw)))
        want["mad"] = raw_t[np.abs(raw - m_raw) / (1.4826 * mad_raw)
                            > RULES_DETECT_THR]
        detected = {}
        for alg in ("host7", "mad"):
            status, doc = http(port, "GET", "/query", {
                "db": PROM_DB, "epoch": "ns",
                "q": f"SELECT detect(value, '{alg}', {RULES_DETECT_THR}) "
                f"FROM cpu_usage_user WHERE hostname = 'host_7' AND {span}"})
            series = doc["results"][0].get("series", [])
            got = [r[0] for r in series[0]["values"]] if series else []
            check(got == want[alg].tolist() and got,
                  f"detect(value, '{alg}'): {len(got)} rows against "
                  f"numpy's {len(want[alg])}")
            detected[alg] = len(got)
        per_query["castor"] = {"launches": fit_launches, "shapes": {
            n: [shape_json(n, x) for x in sorted(v)]
            for n, v in fit_shapes.items()}}
        step("castor")
        log(f"[rules] castor: CREATE MODEL host7 (mad) on host_7's "
            f"{len(means)} per-minute means (launches "
            f"{json.dumps({a: b for a, b in fit_launches.items() if b})}), "
            f"median and MAD equal numpy's; detect() flagged "
            f"{detected['host7']} rows with the model and {detected['mad']} "
            f"with 'mad' (threshold {RULES_DETECT_THR}), numpy's rows "
            "exactly")

        # (f) a subscription to a sink on localhost
        received = []

        class Sink(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                received.append(self.rfile.read(n))
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        sink = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
        threading.Thread(target=sink.serve_forever, daemon=True).start()
        subs = SubscriberManager(engine)
        status, _ = http(port, "POST", "/query",
                         {"q": "CREATE DATABASE tsbs"})
        status, doc = http(port, "POST", "/query", {
            "db": "tsbs", "q": "CREATE SUBSCRIPTION s1 ON tsbs DESTINATIONS "
            f"ALL 'http://127.0.0.1:{sink.server_address[1]}'"})
        check(status == 200 and "error" not in doc["results"][0],
              f"CREATE SUBSCRIPTION: {doc}")
        vals = make_values(n_hosts, 6, rng)
        base = n_all + n_more + 6
        body = cpu_lines(tags, vals, 0, 6, n_hosts, base)
        t_s = time.perf_counter()
        status, _h, resp = http_raw(port, "POST", "/write", {"db": "tsbs"},
                                    body.encode())
        check(status == 204, f"/write to tsbs: {status} {resp[:200]!r}")

        sent = sorted(body.split("\n"))
        got: list = []
        t_end = time.perf_counter() + 60
        while len(got) < len(sent) and time.perf_counter() < t_end:
            time.sleep(0.05)
            got = sorted(ln for b in list(received)
                         for ln in b.decode().split("\n"))
        sub_ms = (time.perf_counter() - t_s) * 1e3
        check(got == sent, f"the sink received {len(got)} lines of the "
              f"{len(sent)} written, or others")
        status, doc = http(port, "POST", "/query",
                           {"db": "tsbs", "q": "DROP SUBSCRIPTION s1 ON tsbs"})
        check(not engine.databases["tsbs"].subscriptions,
              "the subscription outlived its DROP")
        subs.stop()
        subs = None
        sink.shutdown()
        sink.server_close()
        sink = None
        step("subscriber")
        log(f"[rules] subscription: the sink received exactly the "
            f"{len(sent)} written lines ({len(received)} POSTs, "
            f"{sum(len(b) for b in received)} B) {sub_ms:.0f} ms after the "
            f"/write; dropped")

        # (f) the scrub: a full pass, then a bitflip quarantines one file
        status, _ = http(port, "POST", "/debug/ctrl", {"mod": "flush"})
        files = [r for sh in engine.all_shards() for r in sh._files]
        total = sum(loc[1] for r in files for loc in r.data_locs())
        t_s = time.perf_counter()
        status, doc = http(port, "POST", "/debug/ctrl", {
            "mod": "scrub", "op": "tick", "mb": "1000000"})
        scrub_ms = (time.perf_counter() - t_s) * 1e3
        check(status == 200 and doc["verified_bytes"] == total
              and doc["quarantine"]["total"] == 0
              and doc["scrub"]["passes"] == 1,
              f"the scrub pass verified {doc.get('verified_bytes')} B of "
              f"{total}: {doc.get('quarantine')}")
        [victim] = [r.path for sh in engine.shards_for_range(
            "tsbs", None, 0, 2**62) for r in sh._files]
        status, _ = http(port, "POST", "/debug/ctrl", {
            "mod": "diskfault", "path": victim, "action": "bitflip:9"})
        check(status == 200, "the bitflip rule was refused")
        status, doc2 = http(port, "POST", "/debug/ctrl", {
            "mod": "scrub", "op": "tick"})
        http(port, "POST", "/debug/ctrl", {"mod": "diskfault", "clear": "1"})
        quar = [f["path"] for f in doc2["quarantine"]["files"]]
        check(quar == [victim], f"the scrub quarantined {quar}, not "
              f"{victim}")
        step("scrub")
        log(f"[rules] scrub: one pass verified {total} B in {len(files)} "
            f"files ({scrub_ms:.0f} ms), nothing quarantined; with a "
            f"bitflip rule on the subscription's file the next pass "
            f"quarantined exactly {os.path.relpath(victim, root)}")

        # (f) the monitor and the durability ledger
        mon = MonitorService(engine, interval_s=3600, hostname="smoke")
        mon.handle()
        want_ticks = STATS.counters("rules")["ticks"]
        status, doc = http(port, "GET", "/query", {
            "db": "_internal", "q": "SELECT last(ticks) FROM rules"})
        got_ticks = doc["results"][0]["series"][0]["values"][0][1]
        check(got_ticks == want_ticks, f"_internal rules.ticks {got_ticks} "
              f"against {want_ticks}")
        status, doc = http(port, "GET", "/query", {
            "db": "_internal", "q": "SHOW MEASUREMENTS"})
        msts = {r[0] for r in doc["results"][0]["series"][0]["values"]}
        check({"rules", "durability", "scrub"} <= msts,
              f"_internal measurements {sorted(msts)}")
        status, dur = http(port, "POST", "/debug/ctrl",
                           {"mod": "durability"})
        tot = dur["durability"]["totals"]
        check(dur["status"] == "ok" and tot["missing"] == 0
              and not dur["violations"], f"durability {dur['status']} "
              f"{tot}")
        step("monitor and durability")
        log(f"[rules] monitor: {len(msts)} _internal measurements, "
            f"rules.ticks {got_ticks}; durability ok: "
            f"{json.dumps(tot)}")

        launches = dict(cs.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        mgr.close()
        stop_server(svc, engine)
        svc = engine = mgr = None

        # (g) the same root on the CPU
        cpu_engine = Engine(root, device="cpu")
        cmgr = None
        try:
            cmgr = RuleManager(cpu_engine)
            g = cmgr.groups_for(PROM_DB)[0]
            check(g.last_eval_ns == int(round(card_last["te"] * 1e9)),
                  "the CPU reopen lost the watermark")
            cmgr._verify(g, card_last["e_tile"], card_last["results"])
            f1 = next(r for r in g.rules if r.name == names["F1"])
            f1_cpu = cmgr._eval_fallback(g, f1, int(round(
                card_last["te"] * 1e9)))
            worst_f1 = _rules_same("F1 on the CPU", f1_cpu,
                                   card_last["results"][names["F1"]],
                                   RULES_CPU_RTOL)
        finally:
            if cmgr is not None:
                cmgr.close()
            cpu_engine.close()
        step("cpu reopen")
        wall_s = time.perf_counter() - t_phase
        log(f"[rules] the CPU reopen recomputed the card's last tick from "
            f"scratch: R1, R2 and A1 bit for bit, F1 within {worst_f1:.3g}"
            f"; step walls (s) "
            f"{json.dumps({a: round(b, 3) for a, b in walls.items()})}; "
            f"phase 15 took {wall_s:.1f} s (budget {RULES_PHASE_S:.0f} s, "
            f"{deadline - time.perf_counter():.0f} s left of the script's); "
            f"launches {json.dumps(launches)}; device memory peak "
            f"{peak / 2**20:.1f} MiB; card {smi_line()}")
        for k, t in enumerate(ticks):
            per_query[f"T{k - 1}"] = t
        steps["walls_s"] = walls
        steps["fires"] = sim["fires"]
        return {"launches": launches, "per_query": per_query,
                "steps": steps, "shapes": rec.seen, "peak_bytes": peak,
                "wall_s": wall_s}
    finally:
        rec.__exit__()
        offload.set_force(None)
        offload.set_prom_host_kernels_mode("")
        diskfault.clear_all()
        colcache.GLOBAL.configure(**cc_prev)
        if rc_prev is None:
            os.environ.pop("OGT_RESULT_CACHE", None)
        else:
            os.environ["OGT_RESULT_CACHE"] = rc_prev
        if subs is not None:
            subs.stop()
        if sink is not None:
            sink.shutdown()
            sink.server_close()
        if mgr is not None:
            mgr.close()
        if svc is not None:
            stop_server(svc, engine)


# -- phase 16: a three-node cluster on the card -------------------------------

# phase 16's budget (s): bring-up, the load and flush, K1-K4, EXPLAIN
# ANALYZE, the failover, the recovery, the cluster operations and the
# CPU reopen
CLUSTER_PHASE_S = 100.0
# the span loaded (h): 2 h of TSBS cpu at rf 2 is 2.88 M rows stored twice
CLUSTER_HOURS = 2
CLUSTER_NODES = ("n1", "n2", "n3")
CLUSTER_RF = 2
CLUSTER_CONSISTENCY = "one"
CLUSTER_TOKEN = "chip-smoke-cluster"
CLUSTER_ADMIN = ("admin", "admin-secret")
CLUSTER_READER = ("reader", "reader-secret")
CLUSTER_RUNS = 1  # cut from 3 for phase 18
# K4's samples: the ten minutes around the end of hour 0
CLUSTER_RAW_STEPS = (330, 390)
# the reference's owners() over these ids, database `benchmark` and its
# default RP at 1 h shard groups (hour 2 is the minute written in (d));
# the phase asserts the router agrees
CLUSTER_PLACEMENT = {0: ["n2", "n1"], 1: ["n3", "n2"], 2: ["n3", "n1"]}
# what the steps after (c) take (s): 27.5 in a slow call of the H100's
# host for (d)-(f), and 23-37 for the operations (g)-(k) on that host;
# the repeated K runs end before CLUSTER_PHASE_S less this
CLUSTER_AFTER_QUERIES_S = 70.0
# the wait for a meta leader and for replicated state (s)
CLUSTER_WAIT_S = 15.0
# kernel launches a serving peer makes for one run of a K query (its
# partials, query/partials.py; the coordinator, where it is a primary,
# reduces its own groups by the batch its data picks). K1's grid (1 min
# windows, 6 samples each) takes one launch of kernel 3 a peer; K2's
# declines the grid on a peer (it holds one of the coordinator's two 1 h
# windows, so the padded grid is over the grid's 8x expansion cap,
# models/grid.py) and takes the bucketed batch, kernel 1 once per field;
# K3 kernels 1 and 2 once each
CLUSTER_PEER_LAUNCHES = {
    "K1": {"grid_window_agg": 1},
    "K2": {"bucket_stats_basic": 5},
    "K3": {"bucket_stats_basic": 1, "bucket_stats_selectors": 1},
    "K4": {},
}


def cluster_queries(n_t: int) -> dict:
    """K1-K4 over the first n_t samples of the span: K1 is Q1's shape,
    K2 Q2's, K3 Q4's; K4 a raw select of host_7's usage_user over the ten
    minutes around the first hour's end (CLUSTER_RAW_STEPS), so that both
    loaded groups serve it (a raw select ships every series of the
    measurement in its range over /internal/scan)."""
    end = T0_NS + n_t * STEP_NS
    where = f"time >= {T0_NS} AND time < {end}"
    lo, hi = CLUSTER_RAW_STEPS
    f5 = FIELDS[:5]
    return {
        "K1": "SELECT mean(usage_user), max(usage_user), count(usage_user) "
              f"FROM cpu WHERE {where} GROUP BY time(1m)",
        "K2": "SELECT " + ", ".join(f"mean({f})" for f in f5)
              + f" FROM cpu WHERE {where} GROUP BY time(1h), hostname",
        "K3": "SELECT first(usage_user), last(usage_user), min(usage_user), "
              "max(usage_user), mean(usage_user), stddev(usage_user), "
              f"spread(usage_user) FROM cpu WHERE {where} GROUP BY hostname",
        "K4": f"SELECT usage_user FROM cpu WHERE hostname = 'host_7' AND "
              f"time >= {T0_NS + lo * STEP_NS} AND "
              f"time < {T0_NS + hi * STEP_NS}",
    }


def verify_cluster(qn: str, res: dict, vals, tags, n_hosts: int,
                   n_t: int) -> None:
    """K1-K3 as phase 3's Q1, Q2 and Q4 (verify); K4 host_7's rows."""
    sub = {f: v[:, :n_t] for f, v in vals.items()}
    if qn != "K4":
        verify({"K1": "Q1", "K2": "Q2", "K3": "Q4"}[qn], res, sub, tags,
               n_hosts, n_t)
        return
    series = res.get("series", [])
    check(len(series) == 1, f"K4: {len(series)} series")
    want = [[T0_NS + i * STEP_NS, float(vals["usage_user"][7, i])]
            for i in range(*CLUSTER_RAW_STEPS)]
    check(series[0]["values"] == want, "K4: host_7's rows")


def card_equals_cpu(qn: str, card: dict, cpu: dict) -> None:
    """The CPU's answer against the card's: counts, min, max, first,
    last and spread bit for bit, means and stddev within rel 1e-12."""
    import math

    exact = {"K1": (0, 2, 3), "K3": (0, 1, 2, 3, 4, 7)}[qn.split()[0]]
    sa, sb = card.get("series", []), cpu.get("series", [])
    check(len(sa) == len(sb), f"{qn}: {len(sa)} series on the card, "
          f"{len(sb)} on the CPU")
    for a, b in zip(sa, sb):
        check(a.get("tags") == b.get("tags")
              and len(a["values"]) == len(b["values"]),
              f"{qn}: the series differ")
        for ra, rb in zip(a["values"], b["values"]):
            for j, (x, y) in enumerate(zip(ra, rb)):
                ok = (x == y if j in exact
                      else math.isclose(x, y, rel_tol=1e-12, abs_tol=0))
                check(ok, f"{qn}: column {j} {x!r} on the card, {y!r} on "
                      "the CPU")


class ClusterNode:
    """One node of phase 16, wired as the JAX package's server/app.py
    wires a clustered one: an Engine and an HttpService with auth on, a
    MetaStore over HttpTransport (attach_engine, attach_users) with the
    cluster's token, a DataRouter and a HintReplayService."""

    def __init__(self, nid: str, root: str, port: int = 0,
                 device: str | None = None):
        from opengemini_tpu_torch.server.http import HttpService
        from opengemini_tpu_torch.storage.engine import Engine

        self.nid, self.root = nid, root
        self.engine = (Engine(root) if device is None
                       else Engine(root, device=device))
        self.svc = HttpService(self.engine, port=port, auth_enabled=True)
        self.port = self.svc.port
        self.addr = f"127.0.0.1:{self.port}"
        self.ms = self.router = self.hints = None

    def wire(self, addrs: dict, learner: bool = False) -> None:
        """With `learner`, the node joins a running meta group: passive
        until the leader's conf-add (/raft/join) commits."""
        from opengemini_tpu_torch.meta.service import HttpTransport, MetaStore
        from opengemini_tpu_torch.parallel.cluster import DataRouter
        from opengemini_tpu_torch.services.hintreplay import (
            HintReplayService,
        )

        transport = HttpTransport(dict(addrs), token=CLUSTER_TOKEN,
                                  self_addr=self.addr)
        self.ms = MetaStore(self.nid, sorted(addrs), transport,
                            storage_path=os.path.join(self.root,
                                                      "meta.raftlog"))
        self.ms.token = CLUSTER_TOKEN
        self.ms.attach_engine(self.engine)
        self.ms.attach_users(self.svc.users)
        self.svc.meta_store = self.svc.executor.meta_store = self.ms
        self.router = DataRouter(
            self.engine, self.ms, self.nid, self.addr, token=CLUSTER_TOKEN,
            rf=CLUSTER_RF, write_consistency=CLUSTER_CONSISTENCY)
        self.svc.router = self.svc.executor.router = self.router
        # its ticks are driven by the phase (handle()): one probe round
        # and one replay at the step that needs them
        self.hints = HintReplayService(self.router, 3600.0)
        self.ms.node.learner = learner
        self.ms.start()
        self.svc.start()

    def stop(self) -> None:
        conn = _CONNS.pop(("auth", self.port), None)
        if conn is not None:
            conn.close()
        self.svc.stop()
        self.ms.stop()
        self.engine.close()


def cluster_http(port: int, method: str, path: str, params: dict,
                 body: bytes = b"", user=CLUSTER_ADMIN):
    """(status, decoded JSON or None) of one request with Basic auth on
    the node's kept-alive connection; error answers included."""
    import base64

    key = ("auth", port)
    conn = _CONNS.get(key)
    if conn is None:
        conn = _CONNS[key] = HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {}
    if user is not None:
        headers["Authorization"] = "Basic " + base64.b64encode(
            f"{user[0]}:{user[1]}".encode()).decode()
    conn.request(method, f"{path}?{urllib.parse.urlencode(params)}",
                 body=body if method == "POST" else None, headers=headers)
    r = conn.getresponse()
    data = r.read()
    try:
        doc = json.loads(data) if data else None
    except ValueError:
        doc = None
    return r.status, doc


def cluster_query(port: int, q: str, user=CLUSTER_ADMIN, method="GET",
                  db: str = "benchmark") -> tuple[dict, float, float]:
    """(result, request ms, wall ms) of one /query with auth."""
    import torch

    t0 = time.perf_counter()
    status, doc = cluster_http(port, method, "/query",
                               {"db": db, "q": q, "epoch": "ns"},
                               user=user)
    t1 = time.perf_counter()
    check(status == 200, f"/query status {status}: {doc}")
    res = doc["results"][0]
    check("error" not in res, f"query error: {res.get('error')}")
    torch.cuda.synchronize()
    return res, (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3


def in_parallel(fn, args: list) -> None:
    """fn(arg) for every arg on threads of its own; the first error
    raises once all have ended."""
    errors: list = []

    def run(a):
        try:
            fn(a)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(a,)) for a in args]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def wait_for(what: str, cond, timeout: float = CLUSTER_WAIT_S) -> float:
    """Poll `cond` until true; its wall (s), or a failure after
    `timeout`."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout,
              f"{what}: not within {timeout:.0f} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


class NodeLaunches:
    """The kernel 1-3 calls of phase 16 by the node whose work made them,
    while entered: a peer's while it computes its partials (the port's
    query/partials.compute_partials, on that peer's HTTP thread), the
    coordinator's otherwise. A call on non-empty inputs launches its
    kernel once on the card (the wrapper's CUDA branch), so the counts
    add up to the launch counters' deltas."""

    def __init__(self):
        from opengemini_tpu_torch.ops import cuda_segment as cs
        from opengemini_tpu_torch.query import partials

        self.cs, self.partials = cs, partials
        self.local = threading.local()
        self.lock = threading.Lock()
        self.counts: dict = {}
        self.orig = {k: getattr(cs, k) for k in E2E_KERNELS}
        self.orig_compute = partials.compute_partials
        self.coord = ""

    def __enter__(self):
        def counted(name, fn):
            def call(*args):
                if args[0].numel():
                    nid = getattr(self.local, "nid", None) or self.coord
                    with self.lock:
                        got = self.counts.setdefault(nid, {})
                        got[name] = got.get(name, 0) + 1
                return fn(*args)
            return call

        def compute(engine, router, req):
            self.local.nid = router.self_id
            try:
                return self.orig_compute(engine, router, req)
            finally:
                self.local.nid = None

        for k, fn in self.orig.items():
            setattr(self.cs, k, counted(k, fn))
        self.partials.compute_partials = compute
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.cs, k, fn)
        self.partials.compute_partials = self.orig_compute

    def take(self) -> dict:
        """The counts since the last take, by node."""
        with self.lock:
            out, self.counts = self.counts, {}
        return out


class RpcBytes:
    """Counts the bytes each peer's answers carry to one router, by path,
    while entered (a wrapper of its _post_raw)."""

    def __init__(self, router):
        self.router, self.orig = router, router._post_raw
        self.got: dict = {}

    def __enter__(self):
        def spy(addr, path, body, timeout=None):
            data, ctype = self.orig(addr, path, body, timeout=timeout)
            key = (addr, path)
            self.got[key] = self.got.get(key, 0) + len(data)
            return data, ctype

        self.router._post_raw = spy
        return self

    def __exit__(self, *exc):
        self.router._post_raw = self.orig

    def by_node(self, nodes: dict) -> dict:
        name = {n.addr: nid for nid, n in nodes.items()}
        out: dict = {}
        for (addr, path), n in sorted(self.got.items()):
            out.setdefault(name.get(addr, addr), {})[path] = n
        return out


# phase 16's steps (g)-(k), the cluster operations, move a database of
# its own: `ops`, 1 h shard groups, one TSBS minute of every host in one
# group (24 000 points and 240 000 values at 4000 hosts). The migration's
# wire is one JSON point at a time (the reference's), so a benchmark hour
# (1.44 M points) would take minutes: the moved group is cut from an hour
# to a minute by the phase's budget
OPS_DB = "ops"
OPS_NODE = "n4"
OPS_NODES = CLUSTER_NODES + (OPS_NODE,)
# the anti-entropy step overwrites usage_user of this many hosts at the
# minute's first sample in one owner's copy alone (full rows, the other
# fields unchanged), at 1000 + host: above every TSBS value, so K1's max
# shows whose copy answered
OPS_DIVERGED = 100


def ops_hours(owners) -> tuple[int, int]:
    """The first two hours after the benchmark span whose ops group the
    reference's owners() over n1-n4 at rf 2 places on n1 and one of n2
    and n3: the first takes the moved minute (n4 gets it only by the
    forced move, and n1's routed /write keeps one copy local), the second
    the strict minute (n1, the coordinator, is a member of its replica
    group)."""
    found = []
    h = CLUSTER_HOURS + 1
    while len(found) < 2:
        got = owners(list(OPS_NODES), OPS_DB, "autogen",
                     T0_NS + h * 3600 * 10**9, CLUSTER_RF)
        if "n1" in got and OPS_NODE not in got:
            found.append(h)
        h += 1
    return found[0], found[1]


def verify_ops(res: dict, u, t0: int) -> None:
    """K1's shape over ops against numpy: one window a minute of
    count, max (exact) and mean (rel 1e-9) of usage_user `u` (hosts,
    6 x minutes) from t0."""
    import numpy as np

    series = res.get("series", [])
    check(len(series) == 1, f"K1 over ops: {len(series)} series")
    rows = series[0]["values"]
    n_min = u.shape[1] // 6
    v = u.reshape(u.shape[0], n_min, 6)
    check([r[0] for r in rows] == [t0 + m * 60 * 10**9
                                   for m in range(n_min)],
          "K1 over ops: window times")
    check([r[3] for r in rows] == [u.shape[0] * 6] * n_min,
          "K1 over ops: counts")
    check(np.array_equal(np.array([r[2] for r in rows]),
                         v.max(axis=(0, 2))), "K1 over ops: max")
    check(close([r[1] for r in rows], v.sum(axis=(0, 2)) / (u.shape[0] * 6)),
          "K1 over ops: mean")


def cluster_operations(nodes: dict, base: str, leader, step, by_node, rec,
                       keys: list, n_hosts: int, seed: int,
                       bench_groups: list, per_query: dict,
                       walls: dict) -> dict:
    """Phase 16's steps (g)-(k) on the running three-node cluster, on the
    card. (g) The benchmark groups are pinned to their owners (placement
    overrides through the meta leader); CREATE DATABASE ops through the
    leader; a minute of every host through n1's /write into a group owned
    by n1 and one of n2 and n3 (ops_hours); n4 starts on build/cluster/n4,
    joins the meta group (/raft/join on the leader) and op=add registers
    it: SHOW CLUSTER on n1 lists four data nodes. (h) op=move&db=ops&
    dest=n4 on the owner that is not n1, then op=migrate there: the group
    stages on n4, commits (n4 writes its committed marker; n1, the
    retained owner, holds the source's digest and takes no push) and
    drops at its source; the owners before and after, the nodes that
    committed, the staging left on every node (none) and the migration's
    wall and points/s print; the meta leader then names n4 the group's primary (a placement
    override: both owners hold the rows, nothing moves), and K1's shape
    over the minute through n1 equals numpy with n4's partials (kernel 3
    on n4). (i) OPS_DIVERGED rows rewritten in n1's engine alone make the
    two copies' content digests differ; op=antientropy on n4 repairs one
    (group, measurement) pair, the digests are then equal and K1 through
    n1 (n4's copy) shows the rewritten values. (j) With DataReplication
    on every node's router, the next minute, into the second hour's group
    (n1 and one of n2 and n3), through n1's /write answers 204 once the
    owners' raft group committed it (a majority of two: both logged it,
    the leader applied it). Read at the answer: the owner set's group on
    both owners with one leader, the write's entry in the leader's log,
    committed and applied there, in the follower's log at the same term
    and in the leader's match index for it, and the leader's engine
    holding all the rows (counted directly); the follower's engine holds
    them within a heartbeat (its apply waits for the next append, as the
    reference's). The group's raft status and the wall print, then the
    replication stops. (k) op=decommission on n4: an
    anti-entropy round, drain passes moving its group back to owners
    among n1-n3, the roster and meta removal, its decommission_state at
    "done"; SHOW CLUSTER on n1 lists three nodes, K1 over the minute
    equals numpy, n4 stops. No migrate_round moves a benchmark group
    (checked after each). Returns the steps' numbers and K1's answer for
    the CPU reopen."""
    import numpy as np

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.parallel.cluster import owners
    from opengemini_tpu_torch.meta.raft import LEADER
    from opengemini_tpu_torch.parallel.datarep import (
        DataReplication, gid_of,
    )
    from opengemini_tpu_torch.storage.engine import shard_group_start

    out: dict = {}
    rng = np.random.default_rng(seed + 16)
    ops_vals = make_values(n_hosts, 12, rng)  # two minutes
    hour, hour2 = ops_hours(owners)
    gs = shard_group_start(T0_NS + hour * 3600 * 10**9, 3600 * 10**9)
    gs2 = shard_group_start(T0_NS + hour2 * 3600 * 10**9, 3600 * 10**9)
    t_ops = gs  # each minute starts at its group's start
    key = f"{OPS_DB}|autogen|{gs}"
    r1 = nodes["n1"].router

    def minute_body(m: int, t0: int, first=None) -> bytes:
        """Ops minute m of every host from t0; with `first` (host ->
        usage_user), only the minute's first sample of hosts
        0..OPS_DIVERGED-1, their usage_user replaced."""
        lines = []
        for h in range(n_hosts if first is None else OPS_DIVERGED):
            for i in (range(6 * m, 6 * m + 6) if first is None
                      else (6 * m,)):
                fv = {f: float(ops_vals[f][h, i]) for f in FIELDS}
                if first is not None:
                    fv["usage_user"] = first(h)
                lines.append(f"{keys[h]} "
                             + ",".join(f"{f}={v!r}" for f, v in fv.items())
                             + f" {t0 + (i - 6 * m) * STEP_NS}")
        return "\n".join(lines).encode()

    def ctrl(nid: str, **params) -> dict:
        status, doc = cluster_http(nodes[nid].port, "POST", "/debug/ctrl",
                                   {"mod": "cluster", **params}, user=None)
        check(status == 200, f"{params.get('op')} on {nid}: {status} {doc}")
        return doc

    def held_bench() -> dict:
        """The benchmark groups by the nodes that hold any."""
        got = {nid: sorted(k for k in n.engine._shards
                           if k[0] == "benchmark")
               for nid, n in sorted(nodes.items())}
        return {nid: v for nid, v in got.items() if v}

    def ops_owners() -> list:
        return r1.group_owners(OPS_DB, "autogen", gs)

    def placed(want: list) -> None:
        wait_for(f"the ops group's owners {want} on every node", lambda: all(
            n.router.group_owners(OPS_DB, "autogen", gs) == want
            for n in nodes.values()))

    def staging_left() -> dict:
        return {nid: n.engine.staging_ids()
                for nid, n in sorted(nodes.items())}

    def committed_markers() -> dict:
        """The committed markers in each node's staging directory."""
        out = {}
        for nid, n in sorted(nodes.items()):
            d = os.path.join(n.engine.root, "staging")
            out[nid] = sorted(f for f in (os.listdir(d) if os.path.isdir(d)
                                          else ()) if f.endswith(".committed"))
        return out

    def count_on(nid: str, g: int) -> int:
        """Rows of the ops minute at group g in one node's engine, read
        directly."""
        sh = nodes[nid].engine._shards.get((OPS_DB, "autogen", g))
        if sh is None:
            return 0
        sids = np.array(sorted(sh.index.series_ids("cpu")), np.int64)
        _sid, got = sh.read_series_bulk("cpu", sids, g, g + 6 * STEP_NS,
                                        ["usage_user"])
        return len(got)

    def k1_ops(label: str, u, n_min: int):
        """K1's shape over the first n_min ops minutes through n1, against
        numpy; the group's primary launches its partials' kernel 3 once,
        no other node anything."""
        q = ("SELECT mean(usage_user), max(usage_user), count(usage_user) "
             f"FROM cpu WHERE time >= {t_ops} AND time < "
             f"{t_ops + n_min * 60 * 10**9} GROUP BY time(1m)")
        l0 = dict(cs.LAUNCHES)
        rec.now = {}
        by_node.coord = "n1"
        by_node.take()
        res, _req_ms, ms = cluster_query(nodes["n1"].port, q, db=OPS_DB)
        verify_ops(res, u[:, :6 * n_min], t_ops)
        got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
        mine = by_node.take()
        srv = r1.group_owners(OPS_DB, "autogen", gs, rf=1,
                              nodes=sorted(nodes))[0]
        for nid in nodes:
            have = {k: v for k, v in mine.get(nid, {}).items() if v}
            if nid == srv == "n1":  # the coordinator's own reduction
                check(sum(have.values()) >= 1, f"K1 over ops ({label}): "
                      f"n1, its primary, launched {have}")
                continue
            want = CLUSTER_PEER_LAUNCHES["K1"] if nid == srv else {}
            check(have == want, f"K1 over ops ({label}): {nid} launched "
                  f"{have}, not {want}")
        check(all(got[k] == sum(m.get(k, 0) for m in mine.values())
                  for k in E2E_KERNELS),
              f"K1 over ops ({label}): launches {got}, by node {mine}")
        log(f"[cluster] K1 over ops ({label}) through n1 ok in {ms:.1f} ms, "
            f"served by {srv}: launches by node {json.dumps(mine)} at "
            f"{json.dumps({k: sorted(v) for k, v in rec.now.items()})}")
        rec.now = None
        per_query[f"K1 ops {label}"] = {
            "runs_ms": [ms], "p50_ms": ms, "launches": got,
            "launches_by_node": mine, "served_by": [srv]}
        return res

    # (g) ops, a minute through n1, n4 added
    lead = leader(CLUSTER_NODES)
    for gkey, own in bench_groups:
        check(lead.ms.propose_and_wait({"op": "set_placement", "key": gkey,
                                        "owners": own}),
              f"pin {gkey} to {own}")
    status, doc = cluster_http(lead.port, "POST", "/query", {
        "q": f"CREATE DATABASE {OPS_DB} WITH SHARD DURATION 1h"})
    check(status == 200 and "error" not in doc["results"][0],
          f"CREATE DATABASE {OPS_DB}: {status} {doc}")

    def ops_ready(n) -> bool:
        d = n.engine.databases.get(OPS_DB)
        rp = d.rps.get(d.default_rp) if d is not None else None
        return (rp is not None and rp.shard_duration_ns == 3600 * 10**9
                and all(n.ms.fsm.placement.get(k) == o
                        for k, o in bench_groups))

    wait_for("the ops database and the pinned groups on every node",
             lambda: all(ops_ready(n) for n in nodes.values()))
    bench0 = held_bench()
    body = minute_body(0, gs)
    t_w = time.perf_counter()
    status, doc = cluster_http(nodes["n1"].port, "POST", "/write",
                               {"db": OPS_DB, "precision": "ns"}, body)
    t_w = time.perf_counter() - t_w
    check(status == 204, f"the ops minute's /write: {status} {doc}")
    before = ops_owners()
    check(all(count_on(nid, gs) == n_hosts * 6 for nid in before),
          f"the ops minute on its owners {before}")
    log(f"[cluster] ops (1 h groups): hour {hour}'s group on {before}; "
        f"{n_hosts * 6} points through n1's /write in {t_w * 1e3:.1f} ms")
    nodes[OPS_NODE] = ClusterNode(OPS_NODE, os.path.join(base, OPS_NODE))
    n4 = nodes[OPS_NODE]
    n4.wire({nid: n.addr for nid, n in nodes.items()}, learner=True)
    status, doc = cluster_http(lead.port, "POST", "/raft/join", {},
                               json.dumps({"id": OPS_NODE, "addr": n4.addr,
                                           "token": CLUSTER_TOKEN}).encode(),
                               user=None)
    check(status == 200, f"/raft/join {OPS_NODE}: {status} {doc}")
    add = ctrl("n1", op="add", id=OPS_NODE, addr=n4.addr)["add"]
    check(add["ok"], f"op=add: {add}")

    def joined() -> bool:
        return all(OPS_NODE in n.ms.fsm.nodes for n in nodes.values()) \
            and ops_ready(n4) and len(n4.svc.users) == 2 \
            and "benchmark" in n4.engine.databases

    wait_for("n4 in every roster, with the databases, users and pins",
             joined)
    for n in nodes.values():
        n.hints.handle()  # a probe round: n4 up in every failure view
    res = cluster_query(nodes["n1"].port, "SHOW CLUSTER", method="POST")[0]
    rows = [r for r in res["series"][0]["values"] if r[2] == "data"]
    check(sorted(r[0] for r in rows) == list(OPS_NODES)
          and all(r[3] == "up" for r in rows),
          f"SHOW CLUSTER on n1 after op=add: {rows}")
    check(ops_owners() == before and OPS_NODE not in before,
          f"ops owners {ops_owners()} after the add")
    # the balancer's input, every node's /internal/load (balance_round is
    # not driven: it could move a 1.44 M-point benchmark hour)
    loads = r1.collect_loads()
    check(sorted(loads) == list(OPS_NODES), f"collect_loads: {loads}")
    out["loads"] = {nid: d["total"] for nid, d in loads.items()}
    step("ops and add")
    log(f"[cluster] n4 joined the meta group and op=add registered it: "
        f"SHOW CLUSTER on n1 {json.dumps(rows)}; ops owners {before}; "
        f"bytes by node (collect_loads) {json.dumps(out['loads'])}")

    # (h) the forced move onto n4 and the two-phase migration: from the
    # owner that is not n1, to n4 (n1 keeps its copy, whose digest is the
    # source's, and takes no push)
    src = next(n for n in before if n != "n1")
    kept = "n1"
    move = ctrl(src, op="move", db=OPS_DB, dest=OPS_NODE)["move"]
    check(move is not None and move["group"] == key
          and move["owners"] == [kept, OPS_NODE],
          f"op=move on {src}: {move}")
    placed([kept, OPS_NODE])
    marks0 = committed_markers()
    t_m = time.perf_counter()
    doc = ctrl(src, op="migrate")
    t_m = time.perf_counter() - t_m
    check(doc["moved"] == 1, f"op=migrate on {src}: {doc}")
    marks1 = committed_markers()
    committed = sorted(nid for nid in nodes
                       if len(marks1[nid]) > len(marks0[nid]))
    check(committed == [OPS_NODE],
          f"the migration committed on {committed}: markers {marks1}")
    held = {nid: (OPS_DB, "autogen", gs) in n.engine._shards
            for nid, n in sorted(nodes.items())}
    check(held == {nid: nid in (kept, OPS_NODE) for nid in nodes},
          f"the ops group held by {held}")
    left = staging_left()
    check(not any(left.values()) and doc["staging"] == [],
          f"staging left {left}")
    check(held_bench() == bench0, "a migrate_round moved a benchmark group")
    pts = n_hosts * 6 * len(committed)  # the minute, to n4
    out["migration"] = {"s": t_m, "points": pts, "points_per_s": pts / t_m,
                        "from": src, "owners_before": before,
                        "owners_after": [kept, OPS_NODE],
                        "committed_on": committed}
    status, doc = cluster_http(
        leader(OPS_NODES).port, "POST", "/cluster/placement", {},
        json.dumps({"key": key, "owners": [OPS_NODE, kept],
                    "token": CLUSTER_TOKEN}).encode(), user=None)
    check(status == 200, f"/cluster/placement: {status} {doc}")
    placed([OPS_NODE, kept])
    step("move and migrate")
    log(f"[cluster] op=move on {src}: ops owners {before} -> "
        f"{move['owners']}; op=migrate on {src}: staged, committed on "
        f"{committed} (its marker; {kept} held the same digest and took no "
        f"push) and dropped at {src} in "
        f"{t_m * 1e3:.1f} ms ({pts} points pushed, {pts / t_m:.0f} "
        f"points/s); staging left "
        f"{json.dumps(left)}; no benchmark group moved; the meta leader "
        f"names {OPS_NODE} primary: owners {[OPS_NODE, kept]}")
    u = ops_vals["usage_user"].copy()
    k1_ops("after the move", u, 1)

    # (i) anti-entropy: the retained owner's copy alone rewritten
    nodes[kept].engine.write_lines(OPS_DB, minute_body(
        0, gs, first=lambda h: 1000.0 + h))
    u[:OPS_DIVERGED, 0] = 1000.0 + np.arange(OPS_DIVERGED)
    shard = {nid: nodes[nid].engine._shards[(OPS_DB, "autogen", gs)]
             for nid in (kept, OPS_NODE)}
    d0 = {nid: sh.content_digest() for nid, sh in shard.items()}
    check(d0[kept] != d0[OPS_NODE], f"the digests agree: {d0}")
    t_a = time.perf_counter()
    repaired = ctrl(OPS_NODE, op="antientropy")["repaired"]
    t_a = time.perf_counter() - t_a
    check(repaired == 1, f"op=antientropy on n4 repaired {repaired}")
    d1 = {nid: sh.content_digest() for nid, sh in shard.items()}
    check(d1[kept] == d1[OPS_NODE], f"the digests differ: {d1}")
    out["antientropy"] = {"repaired": repaired, "s": t_a,
                          "digests_before": d0, "digest_after": d1[kept]}
    step("anti-entropy")
    log(f"[cluster] anti-entropy: {OPS_DIVERGED} rows rewritten in "
        f"{kept}'s copy alone, digests {json.dumps(d0)}; op=antientropy on "
        f"n4 repaired {repaired} (group, measurement) pair in "
        f"{t_a * 1e3:.1f} ms; digests now {json.dumps(d1[kept])} on both")
    k1_ops("after anti-entropy", u, 1)

    # (j) strict replication: the next minute, into hour2's group (n1
    # and one of n2 and n3), commits through raft
    owners2 = r1.group_owners(OPS_DB, "autogen", gs2)
    gid = gid_of(tuple(sorted(owners2)))
    for n in nodes.values():
        n.router.datarep = DataReplication(n.router, token=CLUSTER_TOKEN)
    try:
        check(not any(gid in nodes[nid].router.datarep.groups
                      for nid in owners2), f"{gid} before the write")
        body = minute_body(1, gs2)
        t_s = time.perf_counter()
        status, doc = cluster_http(nodes["n1"].port, "POST", "/write",
                                   {"db": OPS_DB, "precision": "ns"}, body)
        t_s = time.perf_counter() - t_s
        check(status == 204, f"the strict minute's /write: {status} {doc}")
        # at the answer: the owners' raft group, then their engines
        raft = {}
        for nid in owners2:
            g = nodes[nid].router.datarep.groups.get(gid)
            check(g is not None, f"no replica group {gid} on {nid}")
            with g.node._lock:
                log_ = [(g.node.snap_index + i + 1, e.term, e.cmd.get("op"))
                        for i, e in enumerate(g.node.log)]
                raft[nid] = {
                    "state": g.node.state, "leader": g.node.leader_id,
                    "term": g.node.current_term,
                    "last": g.node.snap_index + len(g.node.log),
                    "commit": g.node.commit_index,
                    "applied": g.node.last_applied,
                    "match": dict(g.node.match_index),
                    "writes": [(i, t) for i, t, op in log_ if op == "write"]}
        at_ack = {nid: count_on(nid, gs2) for nid in owners2}
        # the owner that committed the write (its leader then; a
        # follower whose election timer ran out during the 17 MB append
        # may be campaigning already, which raft allows) and the other
        lead_id = max(owners2, key=lambda nid: raft[nid]["commit"])
        fol_id = next(nid for nid in owners2 if nid != lead_id)
        lr, fr = raft[lead_id], raft[fol_id]
        check(len(lr["writes"]) >= 1, f"{gid}'s writes on {lead_id}: {lr}")
        w_idx, w_term = lr["writes"][-1]
        check(lr["commit"] >= w_idx and lr["applied"] >= w_idx,
              f"the write's entry {w_idx} not committed and applied on "
              f"{lead_id} at the answer: {raft}")
        check(lr["state"] != LEADER or lr["term"] != w_term
              or lr["match"].get(fol_id, 0) >= w_idx,
              f"{lead_id} leads without {fol_id}'s match: {raft}")
        # a majority of two: the follower logged the entry before the
        # commit, so before the answer
        check((w_idx, w_term) in fr["writes"],
              f"the write's entry {w_idx} not in {fol_id}'s log at the "
              f"answer: {raft}")
        check(at_ack[lead_id] == n_hosts * 6,
              f"{lead_id} holds {at_ack} at the answer")
        lag = {nid: wait_for(f"the strict minute on {nid}",
                             lambda nid=nid: count_on(nid, gs2)
                             == n_hosts * 6, 10.0)
               for nid in owners2}
        # the group keeps (or has re-elected) a leader among its owners
        groups = []

        def led() -> bool:
            groups[:] = nodes["n1"].router.datarep.group_status()
            return any(r[0] == gid and r[3] in owners2 for r in groups)

        wait_for(f"n1's group status listing {gid} with a leader", led, 10.0)
        check(not any(count_on(nid, gs2) for nid in nodes
                      if nid not in owners2), "the strict minute off its "
              f"owners {owners2}")
    finally:
        for n in nodes.values():
            n.router.datarep.stop()
            n.router.datarep = None
    out["strict"] = {"s": t_s, "points": n_hosts * 6, "owners": owners2,
                     "at_ack": at_ack, "follower_lag_s": lag,
                     "raft_at_ack": raft, "entry": [w_idx, w_term],
                     "groups": groups}
    step("strict minute")
    log(f"[cluster] strict replication: the next minute ({n_hosts * 6} "
        f"points, hour {hour2}'s group on {owners2}) through n1's /write: "
        f"204 in {t_s * 1e3:.1f} ms; at the answer the write's entry "
        f"{w_idx} (term {w_term}) was committed and applied by "
        f"{lead_id} ({lr['state']}, term {lr['term']}, commit "
        f"{lr['commit']}, match of {fol_id} {lr['match'].get(fol_id)}) and "
        f"logged by {fol_id} ({fr['state']}, term {fr['term']}, last "
        f"{fr['last']}, commit {fr['commit']}); rows at the answer "
        f"{json.dumps(at_ack)}, each owner's all within "
        f"{json.dumps({k: round(v, 3) for k, v in lag.items()})} s; raft "
        f"group [id, owners, state, leader, log, applied] "
        f"{json.dumps(groups)}")

    # (k) n4 decommissions itself
    t_d = time.perf_counter()
    st = ctrl(OPS_NODE, op="decommission", deadline_s=60)["decommission"]
    t_d = time.perf_counter() - t_d
    check(st["phase"] == "done" and st["roster_removed"]
          and st["conf_removed"], f"op=decommission on n4: {st}")
    wait_for("n4 out of every roster", lambda: all(
        OPS_NODE not in n.ms.fsm.nodes for nid, n in nodes.items()
        if nid != OPS_NODE))
    n4_state = nodes[OPS_NODE].router.decommission_state
    check(n4_state.get("phase") == "done", f"n4's state {n4_state}")
    nodes.pop(OPS_NODE).stop()
    after = ops_owners()
    placed(after)
    check(OPS_NODE not in after and all(
        (OPS_DB, "autogen", gs) in nodes[nid].engine._shards
        for nid in after), f"ops owners {after} after the decommission")
    check(all(count_on(nid, gs) == n_hosts * 6 for nid in after),
          f"the minute on {after}")
    check(held_bench() == bench0, "a migrate_round moved a benchmark group")
    left = staging_left()
    check(not any(left.values()), f"staging left {left}")
    res = cluster_query(nodes["n1"].port, "SHOW CLUSTER", method="POST")[0]
    rows = [r for r in res["series"][0]["values"] if r[2] == "data"]
    check(sorted(r[0] for r in rows) == list(CLUSTER_NODES),
          f"SHOW CLUSTER on n1 after the decommission: {rows}")
    out["decommission"] = {"s": t_d, "state": st, "owners_after": after,
                           "roster": sorted(r[0] for r in rows)}
    step("decommission")
    log(f"[cluster] op=decommission on n4 in {t_d * 1e3:.1f} ms: phase "
        f"{st['phase']}, {st['rounds']} drain round(s), "
        f"{st['migrated']} group(s) migrated, {st.get('repaired')} "
        f"repaired first; ops owners {after}; SHOW CLUSTER on n1 "
        f"{json.dumps(rows)}; staging left {json.dumps(left)}; no "
        "benchmark group moved in any round")
    out["k1"] = k1_ops("after the decommission", u, 1)
    out["u"] = u[:, :6]
    out["t_ops"] = t_ops
    return out


def phase_cluster(seed: int, deadline: float,
                  n_hosts: int = N_HOSTS) -> dict:
    """A three-node cluster in this process on the one card (fresh roots
    build/cluster/n1-n3): openGemini's cluster mode with every node meta
    and data, rf 2, write consistency "one". (a) The nodes start, each
    with auth on; a meta leader is elected (its wall and every node's
    /raft/status print); the data nodes register; the admin (the
    bootstrap) and `reader` (READ ON benchmark) are created through the
    leader and listed by SHOW USERS on every node; CREATE DATABASE
    benchmark WITH SHARD DURATION 1h reaches every engine. (b) TSBS
    devops cpu, CLUSTER_HOURS h: the first minute through n1's routed
    /write (its points/s), the rest through convert.load_columnar into
    each owner of each hour's group; every node flushes; the placement
    is CLUSTER_PLACEMENT and n1 primary of no loaded group. (c) On n1,
    with the admin's credentials on one kept-alive connection, K1-K4
    once each, then up to CLUSTER_RUNS runs each while the budget lasts,
    against the oracle, each with its p50, its
    stage split beside the remote_partials span, the bytes each peer's
    answers carried, and its launches against the placement's; EXPLAIN
    ANALYZE of K1 with each serving peer's grafted select_partials
    subtree; `reader` gets 403 on /write and 200 on /query. (d) n3
    stops (a new leader when it led: the wall); after one probe round
    SHOW CLUSTER on n1 shows it down and K1 equals the oracle; the next
    minute of every host through n1's /write with consistency=one
    answers 204, n3's copy hinted (the hint file and counters print);
    K1 over the span and the minute equals the oracle. (e) n3 restarts
    on its root and address and rejoins; n1's replay drains its hints
    (rows and wall); n3's engine holds the minute; K1 and K3 through n3
    equal the oracle. (f) The three nodes flush, stop and reopen with
    device="cpu" on the same roots and addresses: K1 and K3 on n1 give
    the card's answers. Each step's wall and the device memory peak print."""
    import shutil

    import numpy as np
    import torch

    from opengemini_tpu_torch import convert
    from opengemini_tpu_torch.ingest.line_protocol import series_key
    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.query.executor import Executor
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.storage.engine import shard_group_start

    t_phase = time.perf_counter()
    # the repeated K runs stop early where the steps after them would no
    # longer fit the phase's budget (or the script's deadline)
    q_deadline = min(deadline, t_phase + CLUSTER_PHASE_S
                     - CLUSTER_AFTER_QUERIES_S)
    rng = np.random.default_rng(seed)
    n_t = CLUSTER_HOURS * 360
    tags = host_tags(n_hosts, rng)
    vals = make_values(n_hosts, n_t + 6, rng)  # the span and one minute
    keys = [series_key("cpu", t) for t in tags]
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "cluster")
    shutil.rmtree(base, ignore_errors=True)
    roots = {nid: os.path.join(base, nid) for nid in CLUSTER_NODES}
    nodes: dict = {}
    walls: dict = {}
    steps: dict = {}
    per_query: dict = {}
    lap = [time.perf_counter()]
    # the decoded-column cache's host tier at its deployed 256 MiB, the
    # device tier off (earlier phases leave it configured otherwise)
    cc_prev = colcache.GLOBAL.config()
    colcache.GLOBAL.configure(budget_mb=256, device=False)
    rec = ShapeRecorder().__enter__()
    by_node = NodeLaunches().__enter__()

    def step(name: str) -> None:
        now = time.perf_counter()
        walls[name] = round(now - lap[-1], 3)
        lap.append(now)

    def leader(among) -> "ClusterNode":
        for nid in among:
            if nodes[nid].ms.is_leader():
                return nodes[nid]
        return None

    def start_nodes(ports: dict, device=None) -> None:
        def start(nid: str) -> None:
            nodes[nid] = ClusterNode(nid, roots[nid], ports.get(nid, 0),
                                     device)

        in_parallel(start, list(CLUSTER_NODES))
        addrs = {nid: nodes[nid].addr for nid in CLUSTER_NODES}
        for n in nodes.values():
            n.wire(addrs)

    def group_start(h: int) -> int:
        return shard_group_start(T0_NS + h * 3600 * 10**9, 3600 * 10**9)

    def serving(live, hours) -> set:
        """The nodes that serve these hours' groups: each group's primary
        among the live nodes."""
        r = nodes["n1"].router
        return {r.group_owners("benchmark", "autogen", group_start(h),
                               rf=1, nodes=sorted(live))[0]
                for h in hours}

    def k_query(qn: str, q: str, coord: str, n_rows_t: int, live, hours,
                runs: int, keep: bool = False):
        """K query `qn` on `coord`, `runs` times (fewer, with a line
        saying so, when the phase's budget runs short), checked; its
        launches against those the placement implies. With `keep`, also
        the answer."""
        node = nodes[coord]
        st0 = stage_ns(node.port)
        l0 = dict(cs.LAUNCHES)
        rec.now = {}
        by_node.coord = coord
        by_node.take()
        lat, requests = [], []
        with RpcBytes(node.router) as rb:
            for i in range(runs):
                if i and time.perf_counter() + lat[-1] / 1e3 > q_deadline:
                    log(f"[cluster] {qn}: {i} of {runs} run(s) in this "
                        "round: the phase's budget is running short")
                    break
                res, req_ms, wall_ms = cluster_query(node.port, q)
                verify_cluster(qn, res, vals, tags, n_hosts, n_rows_t)
                lat.append(wall_ms)
                requests.append(req_ms)
        got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
        mine = by_node.take()
        srv = serving(live, hours)
        # each serving peer launches what its partials take, the
        # coordinator (when a primary) its own reduction, no one else
        for nid in nodes:
            have = {k: v for k, v in mine.get(nid, {}).items() if v}
            if nid in srv and nid != coord:
                want = {k: n * len(lat)
                        for k, n in CLUSTER_PEER_LAUNCHES[qn].items()}
                check(have == want, f"{qn} on {coord}: {nid} launched "
                      f"{have}, its partials take {want}")
            elif nid == coord and nid in srv and qn != "K4":
                check(sum(have.values()) >= len(lat), f"{qn} on {coord}: "
                      f"the coordinator's own groups launched {have}")
            else:
                check(not have, f"{qn} on {coord}: {nid} serves nothing "
                      f"and launched {have}")
        check(all(got[k] == sum(m.get(k, 0) for m in mine.values())
                  for k in E2E_KERNELS) and not any(
                      got[k] for k in got if k not in E2E_KERNELS),
              f"{qn} on {coord}: launches {got}, by node {mine}")
        stages = stage_split(node.port, st0, requests, f"{qn} on {coord}",
                             extra=("remote_partials",))
        wire = rb.by_node(nodes)
        log(f"[cluster] {qn} on {coord} ok p50={p50_of(lat):.1f} ms (runs "
            f"{', '.join(f'{x:.1f}' for x in lat)}); served by "
            f"{sorted(srv)}; bytes received {json.dumps(wire)}; launches "
            f"by node {json.dumps(mine)} at "
            f"{json.dumps({k: sorted(v) for k, v in rec.now.items()})}")
        rec.now = None
        out = {"runs_ms": lat, "p50_ms": p50_of(lat), "launches": got,
               "launches_by_node": mine, "stages_ms": stages,
               "bytes": wire, "served_by": sorted(srv)}
        return (out, res) if keep else out

    try:
        torch.cuda.synchronize()
        cs.reset_launches()
        torch.cuda.reset_peak_memory_stats()

        # (a) bring-up
        start_nodes({})
        t_el = time.perf_counter()
        wait_for("a meta leader", lambda: leader(CLUSTER_NODES) is not None)
        lead = leader(CLUSTER_NODES)
        walls["election"] = round(time.perf_counter() - t_el, 3)
        disarm_planner(lead.port)
        for nid, n in nodes.items():
            status, st = cluster_http(n.port, "GET", "/raft/status", {},
                                      user=None)
            check(status == 200, f"{nid} /raft/status {status}")
            log(f"[cluster] {nid} at {n.addr}: /raft/status state "
                f"{st['state']} term {st['term']} leader {st['leader']} "
                f"commit {st['commit_index']}")
        log(f"[cluster] meta leader {lead.nid} elected in "
            f"{walls['election']:.3f} s")
        for nid, n in nodes.items():
            status, doc = cluster_http(
                lead.port, "POST", "/cluster/register", {}, json.dumps(
                    {"id": nid, "addr": n.addr, "role": "data",
                     "token": CLUSTER_TOKEN}).encode(), user=None)
            check(status == 200 and doc == {"ok": True},
                  f"register {nid}: {status} {doc}")
        admin, reader = CLUSTER_ADMIN, CLUSTER_READER
        for q, user in (
                (f"CREATE USER {admin[0]} WITH PASSWORD '{admin[1]}' "
                 "WITH ALL PRIVILEGES", None),
                (f"CREATE USER {reader[0]} WITH PASSWORD '{reader[1]}'",
                 admin),
                (f"GRANT READ ON benchmark TO {reader[0]}", admin),
                ("CREATE DATABASE benchmark WITH SHARD DURATION 1h", admin)):
            status, doc = cluster_http(lead.port, "POST", "/query",
                                       {"q": q}, user=user)
            check(status == 200 and "error" not in doc["results"][0],
                  f"{q}: {status} {doc}")

        def replicated() -> bool:
            for n in nodes.values():
                d = n.engine.databases.get("benchmark")
                rp = d.rps.get(d.default_rp) if d is not None else None
                if (rp is None or rp.shard_duration_ns != 3600 * 10**9
                        or len(n.ms.fsm.nodes) != len(CLUSTER_NODES)
                        or len(n.svc.users) != 2):
                    return False
            return True

        wait_for("the replicated users, roster and database", replicated)
        for nid, n in nodes.items():
            res = cluster_query(n.port, "SHOW USERS")[0]
            users = sorted(r[0] for r in res["series"][0]["values"])
            check(users == sorted([admin[0], reader[0]]),
                  f"SHOW USERS on {nid}: {users}")
            res = cluster_query(n.port, "SHOW DATABASES")[0]
            check(["benchmark"] in res["series"][0]["values"],
                  f"SHOW DATABASES on {nid}: {res}")
        step("bring-up")
        log(f"[cluster] {len(nodes)} nodes up in {walls['bring-up']:.2f} s: "
            "data nodes registered, users admin and reader and database "
            "benchmark (1 h shard groups) on every node")

        # (b) the load: the first minute routed, the rest per owner
        r1 = nodes["n1"].router
        for h, want in CLUSTER_PLACEMENT.items():
            got = r1.group_owners("benchmark", "autogen", group_start(h))
            check(got == want, f"hour {h}: owners {got}, not {want}")
        check(not serving(CLUSTER_NODES, range(CLUSTER_HOURS)) & {"n1"},
              "n1 is the primary of a loaded group")
        log(f"[cluster] placement (owners, primary first) "
            f"{json.dumps(CLUSTER_PLACEMENT)}; n1 is the primary of no "
            "loaded group")
        first = 6
        body = "\n".join(
                f"{keys[h]} "
                + ",".join(f"{f}={float(vals[f][h, i])!r}" for f in FIELDS)
                + f" {T0_NS + i * STEP_NS}"
                for h in range(n_hosts) for i in range(first)).encode()
        t_w = time.perf_counter()
        status, doc = cluster_http(nodes["n1"].port, "POST", "/write",
                                   {"db": "benchmark", "precision": "ns"},
                                   body)
        t_w = time.perf_counter() - t_w
        check(status == 204, f"routed /write: {status} {doc}")
        steps["routed_write"] = {"points": n_hosts * first, "s": t_w,
                                 "points_per_s": n_hosts * first / t_w}
        log(f"[cluster] routed /write on n1: {n_hosts * first} points "
            f"({len(body)} B) in {t_w * 1e3:.1f} ms, "
            f"{n_hosts * first / t_w:.0f} points/s (split by owner: "
            "hour 0 on n1 and forwarded to n2's /internal/write)")
        del body
        tables = {}
        for h in range(CLUSTER_HOURS):
            lo, hi = max(h * 360, first), (h + 1) * 360
            times = T0_NS + np.arange(lo, hi, dtype=np.int64) * STEP_NS
            tables[h] = {
                "series_keys": keys,
                "series": np.repeat(np.arange(n_hosts, dtype=np.int64),
                                    hi - lo),
                "times": np.tile(times, n_hosts),
                "fields": {f: (np.ascontiguousarray(vals[f][:, lo:hi])
                               .reshape(-1),
                               np.ones(n_hosts * (hi - lo), np.bool_))
                           for f in FIELDS}}
        loaded = {nid: 0 for nid in nodes}
        loaded_lock = threading.Lock()
        copies = [(nid, h) for h in tables
                  for nid in r1.group_owners("benchmark", "autogen",
                                             group_start(h))]

        def load_copy(copy) -> None:
            """One owner's copy of one hour (the copies in parallel, as
            separate servers and shard groups load)."""
            nid, h = copy
            n = convert.load_columnar(nodes[nid].engine, "benchmark",
                                      {"cpu": tables[h]})
            with loaded_lock:
                loaded[nid] += n

        in_parallel(load_copy, copies)
        in_parallel(lambda n: n.engine.flush_all(), list(nodes.values()))
        del tables
        n_bulk = sum(loaded.values())
        check(n_bulk == CLUSTER_RF * n_hosts * (n_t - first),
              f"bulk load wrote {n_bulk} rows")
        step("load and flush")
        held = {nid: sorted((s - T0_NS) // (3600 * 10**9)
                            for (_db, _rp, s) in n.engine._shards)
                for nid, n in nodes.items()}
        log(f"[cluster] loaded {n_hosts * n_t} rows x {CLUSTER_RF} copies "
            f"({n_bulk} through convert.load_columnar, {json.dumps(loaded)} "
            f"by node) and flushed in {walls['load and flush']:.1f} s; "
            f"hours held {json.dumps(held)}")

        # (c) K1-K4 on n1, the coordinator: each once, then again up to
        # CLUSTER_RUNS runs while the phase's budget lasts (the steps
        # after the queries need CLUSTER_AFTER_QUERIES_S of it)
        queries = cluster_queries(n_t)
        live = list(CLUSTER_NODES)
        for qn, q in queries.items():
            per_query[qn] = k_query(qn, q, "n1", n_t, live,
                                    range(CLUSTER_HOURS), 1)
        for qn, q in (queries.items() if CLUSTER_RUNS > 1 else ()):
            first = per_query[qn]
            if time.perf_counter() + first["runs_ms"][0] / 1e3 > q_deadline:
                log(f"[cluster] {qn}: 1 run, not {CLUSTER_RUNS}: the "
                    "phase's budget is running short")
                continue
            more = k_query(qn, q, "n1", n_t, live, range(CLUSTER_HOURS),
                           CLUSTER_RUNS - 1)
            runs_ms = first["runs_ms"] + more["runs_ms"]
            per_query[qn] = {
                "runs_ms": runs_ms, "p50_ms": p50_of(runs_ms),
                "launches": {k: first["launches"][k] + more["launches"][k]
                             for k in first["launches"]},
                "served_by": first["served_by"], "bytes": first["bytes"],
                "first": first, "repeats": more}
            log(f"[cluster] {qn} on n1: p50 {p50_of(runs_ms):.1f} ms over "
                f"{len(runs_ms)} runs")
        wire4 = per_query["K4"]["bytes"]
        check(all("/internal/scan" in v for v in wire4.values())
              and not any("/internal/select_partials" in v
                          for v in wire4.values()),
              f"K4 went over {wire4}")
        step("queries")
        lines = []
        status, doc = cluster_http(nodes["n1"].port, "GET", "/query", {
            "db": "benchmark", "q": "EXPLAIN ANALYZE " + queries["K1"]})
        check(status == 200, f"EXPLAIN ANALYZE K1: {status}")
        lines = [r[0] for r in doc["results"][0]["series"][0]["values"]]
        for line in lines:
            log(f"[explain] K1 {line}")
        names = {ln.strip().rsplit(": ", 1)[0] for ln in lines}
        for nid in serving(live, range(CLUSTER_HOURS)):
            for sp in ("select_partials", "scan", "decode", "partial_merge"):
                check(f"{sp} [{nid}]" in names,
                      f"EXPLAIN ANALYZE K1: no grafted {sp} [{nid}]")
        check("remote_partials" in names, "EXPLAIN ANALYZE K1: no "
              "remote_partials span")
        status, _ = cluster_http(nodes["n1"].port, "POST", "/write",
                                 {"db": "benchmark"},
                                 b"cpu,hostname=r usage_user=1 1",
                                 user=reader)
        check(status == 403, f"reader's /write: {status}")
        status, doc = cluster_http(nodes["n1"].port, "GET", "/query",
                                   {"db": "benchmark",
                                    "q": "SHOW MEASUREMENTS"}, user=reader)
        check(status == 200 and doc["results"][0]["series"][0]["values"]
              == [["cpu"]], f"reader's /query: {status} {doc}")
        step("explain and auth")
        log("[cluster] EXPLAIN ANALYZE K1 shows each serving peer's "
            "select_partials subtree; reader: 403 on /write, 200 on /query")

        # (d) failover: n3 stops
        n3_port = nodes["n3"].port
        was_leader = nodes["n3"].ms.is_leader()
        nodes["n3"].stop()
        t_f = time.perf_counter()
        if was_leader:
            wait_for("a new meta leader", lambda: leader(("n1", "n2")))
            walls["reelection"] = round(time.perf_counter() - t_f, 3)
            log(f"[cluster] n3 led the meta plane: {leader(('n1', 'n2')).nid}"
                f" elected in {walls['reelection']:.3f} s")
        nodes["n1"].hints.handle()  # one probe round (and a no-op replay)
        res = cluster_query(nodes["n1"].port, "SHOW CLUSTER",
                            method="POST")[0]
        rows = {r[0]: r for r in res["series"][0]["values"]
                if r[2] == "data"}
        check(rows["n3"][3] == "down" and rows["n2"][3] == "up",
              f"SHOW CLUSTER on n1: {res['series'][0]['values']}")
        log(f"[cluster] SHOW CLUSTER on n1 after one probe round: "
            f"{json.dumps(res['series'][0]['values'])}")
        live = ["n1", "n2"]
        per_query["K1 n3 down"] = k_query(
            "K1", queries["K1"], "n1", n_t, live, range(CLUSTER_HOURS), 1)
        check(per_query["K1 n3 down"]["served_by"] == ["n2"],
              "K1 with n3 down: hour 1 not from n2")
        minute = "\n".join(
            f"{keys[h]} "
            + ",".join(f"{f}={float(vals[f][h, n_t + i])!r}" for f in FIELDS)
            + f" {T0_NS + (n_t + i) * STEP_NS}"
            for h in range(n_hosts) for i in range(6)).encode()
        t_w = time.perf_counter()
        status, doc = cluster_http(nodes["n1"].port, "POST", "/write", {
            "db": "benchmark", "precision": "ns", "consistency": "one"},
            minute)
        t_w = time.perf_counter() - t_w
        check(status == 204, f"the minute's /write: {status} {doc}")
        hint_dir = os.path.join(roots["n1"], "hints")
        hinted = {f: sum(len(json.loads(ln)["points"])
                         for ln in open(os.path.join(hint_dir, f)))
                  for f in sorted(os.listdir(hint_dir))}
        check(hinted == {"n3.jsonl": n_hosts * 6},
              f"hints after the minute: {hinted}")
        status, ctl = cluster_http(nodes["n1"].port, "POST", "/debug/ctrl",
                                   {"mod": "cluster"}, user=None)
        check(ctl["pending_hints"] == ["n3"], f"pending hints {ctl}")
        cl_vars = cluster_http(nodes["n1"].port, "GET", "/debug/vars",
                               {})[1].get("cluster", {})
        log(f"[cluster] the minute ({n_hosts * 6} points, hour 2: owners "
            f"n3, n1) through n1's /write with consistency=one: 204 in "
            f"{t_w * 1e3:.1f} ms; hint files {json.dumps(hinted)} "
            f"({os.path.getsize(os.path.join(hint_dir, 'n3.jsonl'))} B); "
            f"pending {ctl['pending_hints']}; /debug/vars cluster "
            f"{json.dumps(cl_vars)}")
        q_min = cluster_queries(n_t + 6)
        per_query["K1 n3 down, the minute"] = k_query(
            "K1", q_min["K1"], "n1", n_t + 6, live,
            range(CLUSTER_HOURS + 1), 1)
        step("failover")

        # (e) recovery: n3 back on its root and address
        nodes["n3"] = ClusterNode("n3", roots["n3"], n3_port)
        nodes["n3"].wire({nid: n.addr for nid, n in nodes.items()})
        wait_for("n3's meta log", lambda: len(nodes["n3"].ms.fsm.nodes)
                 == len(CLUSTER_NODES))
        step("n3 restart")
        replayed = nodes["n1"].router.replay_hints()
        step("hint replay")
        check(replayed == n_hosts * 6
              and not nodes["n1"].router.pending_hint_nodes(),
              f"replayed {replayed}, pending "
              f"{nodes['n1'].router.pending_hint_nodes()}")
        for n in nodes.values():
            n.hints.handle()
        local = Executor(nodes["n3"].engine).execute(
            f"SELECT count(usage_user) FROM cpu WHERE time >= "
            f"{T0_NS + n_t * STEP_NS} AND time < "
            f"{T0_NS + (n_t + 6) * STEP_NS}", db="benchmark")
        cnt = local["results"][0]["series"][0]["values"][0][1]
        check(cnt == n_hosts * 6, f"n3 holds {cnt} rows of the minute")
        log(f"[cluster] n3 back on {nodes['n3'].addr}; n1 replayed "
            f"{replayed} hinted points in {walls['hint replay']:.3f} s, none "
            f"pending; n3's engine counts {cnt} rows in the minute")
        live = list(CLUSTER_NODES)
        card = {}
        for qn in ("K1", "K3"):
            per_query[f"{qn} on n3"], card[qn] = k_query(
                qn, q_min[qn], "n3", n_t + 6, live,
                range(CLUSTER_HOURS + 1), 1, keep=True)
        step("queries on n3")

        # (g)-(k) the cluster operations, on the card. The four nodes
        # share this process: their heaps, built by the load, go to the
        # cyclic collector's permanent generation once, as a server's
        # would after its engines open, so that the operations' JSON
        # conversions set off collections over new objects only
        gc.freeze()
        try:
            ops = cluster_operations(
                nodes, base, leader, step, by_node, rec, keys, n_hosts,
                seed, [(f"benchmark|autogen|{group_start(h)}", own)
                       for h, own in CLUSTER_PLACEMENT.items()],
                per_query, walls)
        finally:
            gc.unfreeze()
        steps["operations"] = {k: v for k, v in ops.items()
                               if k not in ("k1", "u")}
        peak = torch.cuda.max_memory_allocated()
        launches = dict(cs.LAUNCHES)

        # (f) the three nodes reopened on the CPU
        ports = {nid: n.port for nid, n in nodes.items()}
        # the minute's rows go to files first, so the engines reopen
        # without replaying them from the WAL (the line parser takes
        # about 5 s for 24 000 points there)
        in_parallel(lambda n: n.engine.flush_all(), list(nodes.values()))
        in_parallel(lambda n: n.stop(), list(nodes.values()))
        nodes.clear()
        step("card nodes flush and stop")
        start_nodes(ports, device="cpu")
        step("cpu nodes start")
        wait_for("the CPU cluster's meta plane",
                 lambda: leader(CLUSTER_NODES) is not None and all(
                     len(n.ms.fsm.nodes) == len(CLUSTER_NODES)
                     for n in nodes.values()))
        step("cpu meta plane")
        cpu_ms = {}
        for qn in ("K1", "K3"):
            res, _req, ms = cluster_query(nodes["n1"].port, q_min[qn])
            card_equals_cpu(qn, card[qn], res)
            verify_cluster(qn, res, vals, tags, n_hosts, n_t + 6)
            cpu_ms[qn] = round(ms, 1)
        t0_ops = ops["t_ops"]
        res, _req, ms = cluster_query(
            nodes["n1"].port, "SELECT mean(usage_user), max(usage_user), "
            f"count(usage_user) FROM cpu WHERE time >= {t0_ops} AND time < "
            f"{t0_ops + 60 * 10**9} GROUP BY time(1m)", db=OPS_DB)
        card_equals_cpu("K1 over ops", ops["k1"], res)
        verify_ops(res, ops["u"], t0_ops)
        cpu_ms["K1 over ops"] = round(ms, 1)
        step("cpu queries")
        log(f"[cluster] reopened with device=\"cpu\": K1 and K3 on n1, and "
            f"K1 over ops, give the card's answers (cpu ms "
            f"{json.dumps(cpu_ms)})")
        wall_s = time.perf_counter() - t_phase
        steps["walls_s"] = walls
        steps["cpu_ms"] = cpu_ms
        log(f"[cluster] step walls (s) {json.dumps(walls)}; phase 16 took "
            f"{wall_s:.1f} s (budget {CLUSTER_PHASE_S:.0f} s, "
            f"{deadline - time.perf_counter():.0f} s left of the script's); "
            f"launches {json.dumps(launches)}; device memory peak "
            f"{peak / 2**20:.1f} MiB; card {smi_line()}")
        return {"launches": launches, "per_query": per_query,
                "steps": steps, "shapes": rec.seen, "peak_bytes": peak,
                "wall_s": wall_s}
    finally:
        by_node.__exit__()
        rec.__exit__()
        colcache.GLOBAL.configure(**cc_prev)
        for n in nodes.values():
            try:
                n.stop()
            except Exception:  # noqa: BLE001 — stopped already
                pass


# -- phase 17: the device mesh through the ts-server main ----------------------

# phase 17's budget (s), taken from the reserve after phase 16
MESH_PHASE_S = 60.0
# the shards of step (b), laid over the one card
MESH_SHARDS = 4
# the ts-server config of step (a): the [device] section switches the
# mesh on (a mesh of every visible card: one on an H100)
MESH_TOML = """[data]
dir = "{root}"
[http]
bind-address = "127.0.0.1:0"
[services]
store-monitor = false
[device]
mesh-axes = ["shard"]
"""


def mesh_queries(cold: dict) -> dict:
    """C1 and C3 of the cold phase, and B1: Q4's selectors by host over
    the span's second hour (phase 6's host_extra row lies in its first),
    the bucketed layout that launches kernels 1 and 2."""
    lo, hi = T0_NS + 3600 * 10**9, T0_NS + 7200 * 10**9
    return {
        "C1": cold["queries"]["C1"], "C3": cold["queries"]["C3"],
        "B1": "SELECT first(usage_user), last(usage_user), "
              "min(usage_user), max(usage_user), mean(usage_user), "
              "stddev(usage_user), spread(usage_user) FROM cpu "
              f"WHERE time >= {lo} AND time < {hi} GROUP BY hostname",
    }


def verify_mesh(qn: str, res: dict, o: dict) -> None:
    if qn == "B1":
        vals = {"usage_user": o["vals"]["usage_user"][:, 360:720]}
        verify("Q4", res, vals, o["tags"], o["n_hosts"], 360)
        return
    verify_cold(qn, res, o["vals"], o["counters"], o["tags"], o["n_hosts"],
                o["n_t"], extra=EXTRA_VALUE if qn == "C1" else None)


def mesh_same(qn: str, a: dict, b: dict, what: str | None = None) -> None:
    """Equal answers: exact, but means within MEAN_RTOL."""
    import math

    def same(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return math.isclose(x, y, rel_tol=MEAN_RTOL, abs_tol=0)
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list) and isinstance(y, list):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y

    check(same(a, b), what or f"{qn}: the answer at {MESH_SHARDS} shards "
          "differs from one device's")


class MeshProbe:
    """Records the mesh decode plans a run executes and the walls of the
    colcache reshards: each shard plan's blocks give the launches of
    kernels 4 and 5 its shard must make."""

    def __init__(self):
        from opengemini_tpu_torch.ops import device_decode as dd
        from opengemini_tpu_torch.parallel import distributed

        self.dd, self.dist = dd, distributed
        self.plans: list = []
        self.reshard_ms: list = []
        self._run, self._reshard = dd.run_mesh_grid_plan, \
            distributed.donate_reshard

    def __enter__(self):
        import torch

        def run(plan):
            self.plans.append(plan)
            return self._run(plan)

        def reshard(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._reshard(*args)
            torch.cuda.synchronize()
            self.reshard_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.dd.run_mesh_grid_plan = run
        self.dist.donate_reshard = reshard
        return self

    def __exit__(self, *exc):
        self.dd.run_mesh_grid_plan = self._run
        self.dist.donate_reshard = self._reshard

    def decode_launches(self, plans) -> dict:
        """Per shard of each plan: kernel 5 once per gorilla chunk that
        carries bytes, kernel 4 once when a width-1/2 FOR-delta or
        strdict block carries values."""
        per, data = [], 0
        for mplan in plans:
            for p in mplan.shards:
                data += p.n > 0
                sig = p.geom[0]
                gor = [(0, w, bn, 0, 0) for kind, bn, w in sig
                       if kind == "gorilla" and bn]
                k5 = sum(1 for ch in self.dd._gorilla_chunks(gor)
                         if sum(r[1] for r in ch))
                k4 = int(any(
                    (kind == "delta" and w in (1, 2) and bn > 1)
                    or (kind == "strdict" and w in (1, 2) and bn)
                    for kind, bn, w in sig))
                per.append((k5, k4))
        return {"unpack_bits": sum(k for k, _ in per),
                "widen_packed": sum(k for _, k in per),
                "shards": len(per), "data_shards": data, "per_shard": per}


def mesh_counters() -> dict:
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.utils import stats

    snap = stats.GLOBAL.snapshot()
    dev = snap.get("device", {})
    cc = colcache.GLOBAL.counters()
    return {"mesh_h2d_bytes": dev.get("mesh_h2d_bytes", 0),
            "h2d_bytes_total": dev.get("h2d_bytes_total", 0),
            "fused": snap.get("executor", {}).get("grid_decode_fused", 0),
            "device_hits": cc["device_hits"],
            "device_reshards": cc["device_reshards"],
            "ledger_bytes": colcache.GLOBAL.device_ledger_bytes()}


def phase_mesh(cold: dict, prom: dict | None, deadline: float) -> dict:
    """The device mesh (ROADMAP A8.3) on the card, through the port's
    ts-server main, on phase 7's compacted root (no load of its own).
    (a) server/app.build() from a TOML whose [device] section asks for a
    mesh over the visible cards (one shard on an H100); C1, C3 and B1
    over HTTP, each against the oracle, the grid queries through the
    mesh's fused decode; then PQ3 on phase 13's root through a second
    server built from the same TOML, with the mesh off and on, the two
    answers equal (rel 1e-9). (b) runtime.set_mesh(make_mesh(4,
    devices=[cuda:0] * 4)) with the decoded-column cache's device tier
    on: C1 and C3 cold (each shard decodes its rows: kernel 5 per
    gorilla chunk, kernel 4 where FOR-delta blocks, kernel 3 once per
    shard, as the shard plans say), then warm (kernel 3 once per shard,
    no kernel 4 or 5 and no mesh_h2d_bytes), B1 (kernels 1 and 2 once
    per shard), every answer equal to step (a)'s; the cold runs with the
    planner's force=device (a shard's cost gate alone vetoes C1's). (c) _apply_mesh_config
    from 4 shards to 1, to off and back to 4, C1 after each: the
    retained entry reshards in place, the device tier's resident bytes
    do not grow and the answer stays equal. (d) The kernels at the
    shard shapes come back in `shapes` for main()'s checks. C2 is not
    run here: 20 s a run on the card would take the phase past its
    budget, and after phase 6's row it has a 4001st series."""
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.parallel import distributed, runtime
    from opengemini_tpu_torch.query import offload
    from opengemini_tpu_torch.server import app
    from opengemini_tpu_torch.storage import colcache

    t_phase = time.perf_counter()
    o = cold["oracle"]
    queries = mesh_queries(cold)
    cc = colcache.GLOBAL
    cc.clear()
    cc.configure(budget_mb=0)  # step (a) decodes on every run
    os.environ["OGT_DEVICE_PROFILE"] = "1"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launches()
    toml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "mesh.toml")
    with open(toml, "w", encoding="utf-8") as f:
        f.write(MESH_TOML.format(root=cold["root"]))
    per_query: dict = {}
    p50 = {1: {}, MESH_SHARDS: {}}
    answers = {}
    svc = None
    rec = ShapeRecorder().__enter__()
    probe = MeshProbe().__enter__()

    def run(qn: str, label: str, port: int, shards: int):
        rec.now = {}
        l0, c0 = dict(cs.LAUNCHES), mesh_counters()
        n_plans = len(probe.plans)
        res, _req, ms = query_timed(port, queries[qn])
        verify_mesh(qn, res, o)
        got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
        d = {k: v - c0[k] for k, v in mesh_counters().items()}
        entry = {"runs_ms": [ms], "p50_ms": ms, "launches": got,
                 "counters": d, "shards": shards,
                 "shard_shapes": {k: sorted(map(str, v))
                                  for k, v in rec.now.items()},
                 "decode": probe.decode_launches(probe.plans[n_plans:])}
        per_query[f"{qn} {label}"] = entry
        rec.now = None
        log(f"[mesh] {qn} {label} ok {ms:.1f} ms; launches "
            f"{json.dumps({k: v for k, v in got.items() if v})}; "
            f"mesh_h2d_bytes +{d['mesh_h2d_bytes']}, h2d_bytes_total "
            f"+{d['h2d_bytes_total']}, fused +{d['fused']}, device-tier "
            f"hits +{d['device_hits']}, reshards +{d['device_reshards']}; "
            f"shard shapes {json.dumps(entry['shard_shapes'])}")
        return res, entry

    try:
        # (a) through the main: a one-card mesh from the [device] section
        cfg = app.load_config(toml)
        svc = app.build(cfg)
        mesh1 = runtime.get_mesh()
        check(mesh1 is not None and mesh1.size == torch.cuda.device_count()
              and svc.engine.device.type == "cuda",
              f"the [device] section built mesh {mesh1!r} on "
              f"{svc.engine.device}")
        svc.start()
        disarm_planner(svc.port)
        if mesh1.size > 1:
            # a mesh of several cards: each card's shard plan meets the
            # decode's cost gate alone, as step (b)'s shards do
            status, _ = http(svc.port, "POST", "/debug/ctrl",
                             {"mod": "offload", "force": "device"})
            check(status == 200, f"force=device: {status}")
        s0 = mesh_counters()
        for qn in queries:
            answers[qn], e = run(qn, "1 shard", svc.port, 1)
            p50[1][qn] = e["p50_ms"]
            if qn != "B1":
                check(e["counters"]["fused"] == 1
                      and e["launches"]["grid_window_agg"]
                      == mesh1.size,
                      f"{qn} at 1 shard: fused +{e['counters']['fused']}, "
                      f"launches {e['launches']}")
        check(mesh_counters()["mesh_h2d_bytes"] > s0["mesh_h2d_bytes"],
              "step (a) moved no byte through the mesh's transfers")
        base = {qn: per_query[f"{qn} 1 shard"]["launches"]
                for qn in queries}

        # (b) four shards on the one card, the device tier on
        cc.configure(budget_mb=CC_HOST_MB, device=True,
                     device_budget_mb=CC_DEVICE_MB)
        cc.clear()
        card = svc.engine.device
        mesh4 = distributed.make_mesh(MESH_SHARDS,
                                      devices=[card] * MESH_SHARDS)
        runtime.set_mesh(mesh4)
        # each shard's plan passes the decode's cost gate on its own: its
        # encoded bytes against its own grid's. At TSBS geometry only the
        # padding rows (5680 for 4001 series) let C1's gorilla bytes pass
        # against a whole grid, so a shard of data rows alone is vetoed
        # and scatters on the host. The planner's force switch, as phase
        # 13 uses it for its decode, puts the cold runs on the card
        status, _ = http(svc.port, "POST", "/debug/ctrl",
                         {"mod": "offload", "force": "device"})
        check(status == 200, f"force=device: {status}")
        for qn in queries:
            for label in (("cold", "warm") if qn != "B1" else ("cold",)):
                res, e = run(qn, f"{MESH_SHARDS} shards {label}", svc.port,
                             MESH_SHARDS)
                mesh_same(qn, res, answers[qn])
                got, dec = e["launches"], e["decode"]
                if qn == "B1":
                    for k in ("bucket_stats_basic",
                              "bucket_stats_selectors"):
                        check(got[k] * mesh1.size
                              == MESH_SHARDS * base[qn][k],
                              f"B1 at {MESH_SHARDS} shards: {k} "
                              f"{got[k]}, one shard {base[qn][k]}")
                    continue
                check(got["grid_window_agg"] == MESH_SHARDS,
                      f"{qn} {label}: kernel 3 launched "
                      f"{got['grid_window_agg']} times")
                if label == "cold":
                    # C1's gorilla column: kernel 5 on every shard that
                    # holds rows (the grid's padding rows, 5680 for 4001
                    # series, leave the last of 4 shards none); C3's
                    # compacted read_bytes at 6 h is varint only, which
                    # decodes with no kernel of its own (kernel 4 takes
                    # FOR-delta blocks where a plan has them)
                    check(e["counters"]["fused"] == 1
                          and dec["shards"] == MESH_SHARDS
                          and got["unpack_bits"] == dec["unpack_bits"]
                          and got["widen_packed"] == dec["widen_packed"]
                          and (qn != "C1" or got["unpack_bits"]
                               >= dec["data_shards"] > 1),
                          f"{qn} cold: launches {got} against the shard "
                          f"plans' {dec}")
                    p50[MESH_SHARDS][qn] = e["p50_ms"]
                else:
                    check(got["unpack_bits"] == 0
                          and got["widen_packed"] == 0
                          and e["counters"]["mesh_h2d_bytes"] == 0
                          and e["counters"]["device_hits"] >= 1,
                          f"{qn} warm: launches {got}, counters "
                          f"{e['counters']}")
                    p50[MESH_SHARDS][qn + " warm"] = e["p50_ms"]
            if qn == "B1":
                p50[MESH_SHARDS][qn] = per_query[
                    f"B1 {MESH_SHARDS} shards cold"]["p50_ms"]
        http(svc.port, "POST", "/debug/ctrl", {"mod": "offload",
                                               "force": "none"})
        resident = cc.device_ledger_bytes()
        check(resident > 0, "the device tier retained nothing")

        # (c) hot reload: 4 -> 1 -> off -> 4, C1 after each
        steps = (({"mesh-axes": ["shard"], "mesh-devices": 1}, None),
                 ({}, None),
                 ({"mesh-axes": ["shard"], "mesh-devices": MESH_SHARDS},
                  [card] * MESH_SHARDS))
        reloads = []
        for dev_cfg, devices in steps:
            n_resh = len(probe.reshard_ms)
            changed = app._apply_mesh_config(dev_cfg, devices=devices)
            check(bool(changed), f"reload {dev_cfg}: no change")
            mesh = runtime.get_mesh()
            shards = 1 if mesh is None else mesh.size
            label = ("off" if mesh is None
                     else f"{shards} shard" + ("s" if shards > 1 else ""))
            res, e = run("C1", f"reloaded to {label}", svc.port, shards)
            mesh_same("C1", res, answers["C1"])
            check(e["counters"]["device_reshards"] == 1
                  and e["counters"]["device_hits"] >= 1
                  and e["launches"]["unpack_bits"] == 0
                  and e["counters"]["mesh_h2d_bytes"] == 0
                  and e["launches"]["grid_window_agg"] == shards,
                  f"C1 after the reload to {label}: {e['counters']}, "
                  f"launches {e['launches']}")
            ledger = cc.device_ledger_bytes()
            check(ledger <= resident, f"the device tier grew to {ledger} B "
                  f"from {resident} B at the reload to {label}")
            walls = probe.reshard_ms[n_resh:]
            reloads.append({"to": label, "changed": changed,
                            "reshard_ms": walls, "ledger_bytes": ledger,
                            "query_ms": e["p50_ms"]})
            log(f"[mesh] reload to {label} ({', '.join(changed)}): reshard "
                f"{', '.join(f'{w:.3f}' for w in walls)} ms, device-tier "
                f"ledger {ledger} B (after step (b): {resident} B)")
        stop_app(svc)
        svc = None

        # (a), PromQL: PQ3 on phase 13's root with the mesh off and on
        prom_ms = {}
        if prom is not None:
            cc.configure(budget_mb=0)
            cfg = dict(app.load_config(toml), data={"dir": prom["root"]})
            svc = app.build(cfg)
            svc.start()
            disarm_planner(svc.port)
            path, params = prom["queries"]["PQ3"]
            got = {}
            for label, dev_cfg in (("off", {}),
                                   ("1 shard", {"mesh-axes": ["shard"]})):
                app._apply_mesh_config(dev_cfg)
                l0 = dict(cs.LAUNCHES)
                k0 = prom_mesh_kernels()
                got[label], _req, ms = prom_get(svc.port, path, params)
                prom_ms[label] = ms
                k1 = prom_mesh_kernels()
                log(f"[mesh] PQ3 mesh {label}: {ms:.1f} ms; tiled mesh "
                    f"kernels +{k1 - k0}; launches "
                    f"{json.dumps({k: cs.LAUNCHES[k] - l0[k] for k in l0 if cs.LAUNCHES[k] - l0[k]})}")
                if label == "1 shard":
                    check(k1 > k0, "PQ3 did not take the mesh route")
            worst = prom_same("PQ3 on the mesh", got["1 shard"], got["off"],
                              PROM_EXACT["PQ3"])
            log(f"[mesh] PQ3 on the mesh equals it off (largest relative "
                f"difference {worst!r})")
            stop_app(svc)
            svc = None
        else:
            log("[mesh] PQ3 not run: phase 13 did not run")
        launches = dict(cs.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(peak <= COLD_PEAK_LIMIT, f"phase 17 device memory peak {peak} B")
        wall_s = time.perf_counter() - t_phase
        log(f"[mesh] p50 ms at 1 shard {json.dumps(p50[1])}, at "
            f"{MESH_SHARDS} shards {json.dumps(p50[MESH_SHARDS])}; PQ3 "
            f"{json.dumps(prom_ms)}")
        log(f"[mesh] phase 17 took {wall_s:.1f} s (budget "
            f"{MESH_PHASE_S:.0f} s, {deadline - time.perf_counter():.0f} s "
            f"left of the script's); launches {json.dumps(launches)}; "
            f"device memory peak {peak / 2**20:.1f} MiB; card {smi_line()}")
        return {"launches": launches, "per_query": per_query,
                "shapes": rec.seen, "p50_ms": p50, "reloads": reloads,
                "prom_ms": prom_ms, "wall_s": wall_s, "peak_bytes": peak,
                "answers": answers}
    finally:
        probe.__exit__()
        rec.__exit__()
        offload.set_force(None)
        runtime.set_mesh(None)
        cc.clear()
        cc.configure(budget_mb=0)
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        if svc is not None:
            stop_app(svc)


# -- phase 18: the edges --------------------------------------------------

# phase 18's budget (s): the log load, L1-L6, the offload and hydration,
# the tag arrays with a restart, SHOW STATS/DIAGNOSTICS, the backup,
# restore and export, and a consume page
EDGES_PHASE_S = 45.0
# the log fleet: every TSBS host logs one line each EDGE_STEP_S from T0,
# EDGE_LINES_PER_HOST lines (cut from 120, an hour: the upload's
# structured writes ran at 11880 lines/s on the H100's host, 40.4 s for
# the hour; the lines per host are the span's to cut, never hosts)
EDGE_STEP_S = 30
EDGE_LINES_PER_HOST = 30
EDGE_BODY_LINES = 10_000
EDGE_SERVICES = tuple(f"svc{i}" for i in range(10))
EDGE_LEVELS = ("info", "warn", "error")
EDGE_LEVEL_P = (0.90, 0.08, 0.02)
# the message templates of each level; "error AND timeout" matches the
# first error template only
EDGE_TEMPLATES = {
    "info": ("GET /api/{svc}/items 200 in {ms} ms",
             "user {n} signed in from 10.0.{a}.{b}",
             "cache hit key k{n} on {svc}"),
    "warn": ("slow query on {svc} took {ms} ms",
             "upstream {svc} timeout budget low, retry {n}"),
    "error": ("error upstream {svc} timeout after {ms} ms",
              "error writing block {n} to disk",
              "error parsing request {n} on {svc}",
              "error closing session {n}",
              "error reading config {n} of {svc}",
              "error in handler {svc} code {n}"),
}
# the tag-array lines of step (c): each expands into EDGE_TAG_VALUES
EDGE_TAG_LINES = 4000
EDGE_TAG_VALUES = ("a", "b", "c")
EDGE_TOML = """[data]
dir = "{root}"
enable-tag-array = true
[http]
bind-address = "127.0.0.1:0"
[services]
store-monitor = false
obs-dir = "{obs}"
"""


def edge_logs(n_hosts: int, seed: int) -> dict:
    """The fleet's log lines (time-major, host-minor) and the columns a
    numpy oracle reads."""
    import numpy as np

    rng = np.random.default_rng(seed + 18)
    names = [f"host_{h}" for h in range(n_hosts)]
    n_k = EDGE_LINES_PER_HOST
    host = np.tile(np.arange(n_hosts), n_k)
    k = np.repeat(np.arange(n_k), n_hosts)
    svc = host % len(EDGE_SERVICES)
    level = rng.choice(3, size=host.size, p=EDGE_LEVEL_P)
    pick = rng.integers(0, 6, size=host.size)
    tmpl = np.array([pick[i] % len(EDGE_TEMPLATES[EDGE_LEVELS[lv]])
                     for i, lv in enumerate(level.tolist())])
    lat = np.round(rng.lognormal(3.0, 0.8, size=host.size), 3)
    status = np.where(level == 2, 500, 200)
    nums = rng.integers(0, 10_000, size=host.size)
    t_ms = T0_NS // 10**6 + k * EDGE_STEP_S * 1000
    content = []
    for i in range(host.size):
        lv = EDGE_LEVELS[level[i]]
        content.append(EDGE_TEMPLATES[lv][tmpl[i]].format(
            svc=EDGE_SERVICES[svc[i]], ms=f"{lat[i]:.3f}", n=int(nums[i]),
            a=int(nums[i]) % 256, b=int(nums[i]) // 256 % 256))
    lines = [json.dumps({"time": int(t_ms[i]), "host": names[host[i]],
                         "service": EDGE_SERVICES[svc[i]],
                         "level": EDGE_LEVELS[level[i]],
                         "content": content[i], "latency_ms": float(lat[i]),
                         "status": int(status[i])})
             for i in range(host.size)]
    return {"names": names, "host": host, "k": k, "svc": svc,
            "level": level, "tmpl": tmpl, "lat": lat, "status": status,
            "content": content, "t_ms": t_ms, "lines": lines}


def edge_row(lg: dict, i: int) -> dict:
    """Oracle row i as the log store answers it (timestamp in ms)."""
    return {"host": lg["names"][lg["host"][i]],
            "service": EDGE_SERVICES[lg["svc"][i]],
            "level": EDGE_LEVELS[lg["level"][i]],
            "content": lg["content"][i],
            "latency_ms": float(lg["lat"][i]),
            "status": float(lg["status"][i]),
            "timestamp": int(lg["t_ms"][i])}


def _row_key(r: dict) -> str:
    return json.dumps(r, sort_keys=True)


def phase_edges(cold: dict, seed: int, deadline: float,
                n_hosts: int = N_HOSTS) -> dict:
    """The edges (ROADMAP A9) on the card, through the port's ts-server
    main on phase 7's compacted root. (a) Log mode at fleet width: a
    repository, a logstream with a TTL, n_hosts hosts' ndjson over
    EDGE_LINES_PER_HOST steps, flushed; L1-L6 against a numpy oracle,
    each twice; then the logstream's and the repository's DELETE and
    DELETE /query's 404.
    (b) The object store: one group of benchmark offloaded, C1 and C3
    over its first hour hydrate and cold-decode it on the card, equal to
    their answers before. (c) Tag arrays through /write, GROUP BY host
    against the expanded oracle before and after a restart that
    replays the WAL. (d) SHOW STATS and SHOW DIAGNOSTICS. (e) The
    repository backed up before its DELETE, restored into a fresh root
    that Engine() reopens on the card (L2 equal), and the tag-array
    measurement exported where pyarrow exists. (f) /api/v1/consume over
    one minute of benchmark (cpu's first minute again, as edge_cpu)."""
    import re
    import shutil

    import numpy as np
    import torch

    from opengemini_tpu_torch.ops import cuda_segment as cs
    from opengemini_tpu_torch.query import offload
    from opengemini_tpu_torch.server import app
    from opengemini_tpu_torch.storage import colcache
    from opengemini_tpu_torch.storage.engine import Engine
    from opengemini_tpu_torch.tools import backup as bk

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    obs_dir = fresh_root("edges_bucket")
    backup_dir = fresh_root("edges_backup")
    restored = fresh_root("edges_restored")
    try:
        import pyarrow.flight as fl
    except ImportError:
        fl = None
    toml = os.path.join(here, "build", "edges.toml")
    with open(toml, "w", encoding="utf-8") as f:
        f.write(EDGE_TOML.format(root=cold["root"], obs=obs_dir))
        if fl is not None:
            f.write('[flight]\nbind-address = "127.0.0.1:0"\n')
    cfg = app.load_config(toml)
    cc = colcache.GLOBAL
    cc.clear()
    cc.configure(budget_mb=0)  # every run decodes
    # the logs flush in the default profile: a device-profile packed
    # chunk read one series at a time with the cache off decodes whole
    # for each series (a consume page of 12000 series took over 600 s)
    os.environ.pop("OGT_DEVICE_PROFILE", None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launches()
    per_query: dict = {}
    walls: dict = {}
    svc = None
    rec = ShapeRecorder().__enter__()

    def lap(what: str, t0: float) -> float:
        walls[what] = time.perf_counter() - t0
        return time.perf_counter()

    def repo_get(port, path, params, runs=2, qn=None):
        """One log-store read `runs` times: the answer, p50, stage split
        and launches."""
        l0 = dict(cs.LAUNCHES)
        before = stage_ns(port)
        ms = []
        out = None
        for _ in range(runs):
            t0 = time.perf_counter()
            status, doc = http(port, "GET", path, params)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"{qn}: {status} {doc}")
            check(out is None or doc == out or "took_ms" in doc,
                  f"{qn}: the second run's answer differs")
            out = doc
        got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
        if qn is not None:
            split = stage_split(port, before, ms, qn)
            per_query[qn] = {"runs_ms": ms, "p50_ms": p50_of(ms),
                             "launches": got, "stages_ms": split}
            log(f"[edges] {qn} ok p50 {p50_of(ms):.1f} ms over {runs}; "
                f"launches {json.dumps({k: v for k, v in got.items() if v})}")
        return out, got

    try:
        svc = app.build(cfg)
        check(svc.engine.device.type == "cuda" and svc.engine.tag_arrays
              and svc.engine.obs_store is not None,
              f"the edges' config built an engine on {svc.engine.device}, "
              f"tag arrays {svc.engine.tag_arrays}, store "
              f"{svc.engine.obs_store!r}")
        svc.start()
        if svc.flight is not None:
            svc.flight.start()
        port = svc.port
        disarm_planner(port)

        # (a) log mode at fleet width
        t0 = time.perf_counter()
        lg = edge_logs(n_hosts, seed)
        t0 = lap("log lines made", t0)
        status, doc = http(port, "POST", "/repo/fleet", {})
        check(status == 200, f"POST /repo/fleet: {status} {doc}")
        status, doc = http(port, "POST", "/repo/fleet/logstreams/app", {},
                           json.dumps({"ttl": 36500}).encode())
        check(status == 200, f"POST the logstream: {status} {doc}")
        mapping = json.dumps({"timestamp": "time",
                              "tags": ["host", "service", "level"]})
        written = 0
        for off in range(0, len(lg["lines"]), EDGE_BODY_LINES):
            body = "\n".join(lg["lines"][off:off + EDGE_BODY_LINES])
            status, doc = http(port, "POST",
                               "/repo/fleet/logstreams/app/upload",
                               {"mapping": mapping}, body.encode())
            check(status == 200 and doc["failed"] == 0,
                  f"upload at line {off}: {status} {doc}")
            written += doc["written"]
        check(written == len(lg["lines"]), f"uploaded {written} of "
              f"{len(lg['lines'])} lines")
        t0 = lap("log upload", t0)
        status, _ = http(port, "POST", "/debug/ctrl", {"mod": "flush"})
        check(status == 200, f"flush: {status}")
        tidx = [os.path.join(d, f) for d, _s, fs in os.walk(
            os.path.join(cold["root"], "data", "fleet")) for f in fs
            if f.endswith(".tidx")]
        check(bool(tidx), "the flush wrote no .tidx sidecar")
        t0 = lap("log flush", t0)
        log(f"[edges] {len(lg['lines'])} log lines of {n_hosts} hosts in "
            f"{len(lg['lines']) // EDGE_BODY_LINES} bodies: upload "
            f"{walls['log upload']:.2f} s "
            f"({len(lg['lines']) / walls['log upload']:.0f} lines/s), "
            f"flush {walls['log flush']:.2f} s, {len(tidx)} .tidx")
        span = {"from": str(T0_NS // 10**6),
                "to": str(T0_NS // 10**6 + EDGE_LINES_PER_HOST
                          * EDGE_STEP_S * 1000)}
        base = "/repo/fleet/logstreams/app/"
        levels = lg["level"]
        # L1: full text with a scroll cursor, every page
        want = [i for i in np.nonzero((levels == 2) & (lg["tmpl"] == 0))[0]]
        l0 = dict(cs.LAUNCHES)
        before = stage_ns(port)
        ms, got_rows, scroll, pages = [], [], "", 0
        for _run in range(2):
            got_rows, scroll, pages = [], "", 0
            t_run = time.perf_counter()
            while True:
                params = dict(span, q="error AND timeout", limit="500")
                if scroll:
                    params["scroll_id"] = scroll
                status, doc = http(port, "GET", base + "logs", params)
                check(status == 200, f"L1 page {pages}: {status} {doc}")
                got_rows += doc["logs"]
                pages += 1
                scroll = doc["scroll_id"]
                if not scroll:
                    break
                check(pages < 50, "L1 did not end")
            ms.append((time.perf_counter() - t_run) * 1e3)
        ts = [r["timestamp"] for r in got_rows]
        check(ts == sorted(ts, reverse=True), "L1 is not newest first")
        check(sorted(map(_row_key, got_rows))
              == sorted(_row_key(edge_row(lg, i)) for i in want),
              f"L1: {len(got_rows)} rows, the oracle {len(want)}")
        got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
        per_query["L1"] = {"runs_ms": ms, "p50_ms": p50_of(ms),
                           "launches": got, "pages": pages,
                           "rows": len(got_rows),
                           "stages_ms": stage_split(port, before, ms, "L1")}
        log(f"[edges] L1 ok {len(got_rows)} rows in {pages} pages, p50 "
            f"{p50_of(ms):.1f} ms over 2; launches "
            f"{json.dumps({k: v for k, v in got.items() if v})}")
        # L2: the histogram at 1 m
        l2, _ = repo_get(port, base + "histogram",
                         dict(span, q="*", interval="1m"), qn="L2")
        per_min = np.bincount(lg["k"] // 2, minlength=EDGE_LINES_PER_HOST
                              // 2)
        check(l2["count"] == len(lg["lines"])
              and [b["count"] for b in l2["histograms"]] == per_min.tolist()
              and l2["histograms"][0]["from"] == T0_NS // 10**6,
              f"L2: {l2['count']} in {len(l2['histograms'])} buckets")
        # L3: mean latency by service per 5 minutes
        l3, _ = repo_get(port, base + "analytics", dict(
            span, q="*", agg="mean", field="latency_ms", group_by="service",
            interval="5m"), qn="L3")
        bucket = lg["k"] // 10
        n_b = EDGE_LINES_PER_HOST // 10
        key = lg["svc"] * n_b + bucket
        sums = np.bincount(key, weights=lg["lat"],
                           minlength=len(EDGE_SERVICES) * n_b)
        cnts = np.bincount(key, minlength=len(EDGE_SERVICES) * n_b)
        bad = []
        for r in l3["analytics"]:
            s = EDGE_SERVICES.index(r["service"])
            b = (r["from"] - T0_NS // 10**6) // 300_000
            ref = sums[s * n_b + b] / cnts[s * n_b + b]
            if not abs(r["mean"] - ref) <= MEAN_RTOL * abs(ref):
                bad.append((r, ref))
        check(len(l3["analytics"]) == len(EDGE_SERVICES) * n_b and not bad,
              f"L3: {len(l3['analytics'])} rows, {bad[:3]}")
        # L4: max latency by host
        l4, _ = repo_get(port, base + "analytics", dict(
            span, q="*", agg="max", field="latency_ms", group_by="host"),
            qn="L4")
        mx = np.full(n_hosts, -np.inf)
        np.maximum.at(mx, lg["host"], lg["lat"])
        check(sorted((r["host"], r["max"]) for r in l4["analytics"])
              == sorted((lg["names"][h], float(mx[h]))
                        for h in range(n_hosts)),
              f"L4: {len(l4['analytics'])} rows")
        for qn in ("L3", "L4"):
            got = per_query[qn]["launches"]
            check(got["grid_window_agg"] + got["bucket_stats_basic"] >= 2,
                  f"{qn} launched neither kernel 3 nor kernel 1: {got}")
        # L5: the context of one host's row mid-hour
        h5, k5 = 17 % n_hosts, EDGE_LINES_PER_HOST // 2
        ts5 = T0_NS // 10**6 + k5 * EDGE_STEP_S * 1000
        l5, _ = repo_get(port, base + "context", dict(
            span, q=f"host: {lg['names'][h5]}", timestamp=str(ts5),
            backward="5", forward="5"), qn="L5")
        idx = [h5 + kk * n_hosts for kk in range(k5 - 5, k5 + 5)]
        check(l5["logs"] == [edge_row(lg, i) for i in idx],
              f"L5: {[r['timestamp'] for r in l5['logs']]}")
        # L6: a consume cursor at T0 and the first minute's page
        c6, _ = repo_get(port, base + "consume/cursor-time",
                         {"from": span["from"]}, runs=1)
        check(c6["cursor"] == f"{T0_NS}:0", f"L6 cursor {c6}")
        n6 = 2 * n_hosts
        l6, _ = repo_get(port, base + "consume/logs",
                         {"cursor": c6["cursor"], "limit": str(n6)},
                         qn="L6")
        first = [i for i in range(len(lg["lines"])) if lg["k"][i] < 2]
        want6 = sorted(
            _row_key(dict(time=int(lg["t_ms"][i]) * 10**6, tags={
                "host": lg["names"][lg["host"][i]],
                "service": EDGE_SERVICES[lg["svc"][i]],
                "level": EDGE_LEVELS[lg["level"][i]]}, fields={
                "content": lg["content"][i],
                "latency_ms": float(lg["lat"][i]),
                "status": float(lg["status"][i])})) for i in first)
        got6 = sorted(_row_key(r) for r in l6["rows"])
        check(got6 == want6 and not l6["exhausted"]
              and l6["cursor"] == f"{T0_NS + 30 * 10**9}:{n_hosts}",
              f"L6: {len(l6['rows'])} rows, cursor {l6['cursor']}")
        t0 = lap("L1-L6", t0)

        # (e) the backup of the repository, before its DELETE
        bk_manifest = bk.backup(cold["root"], backup_dir)
        n_restored = bk.restore(backup_dir, restored)
        t0 = lap("backup and restore", t0)
        # the repository's DELETEs, and DELETE off /repo
        for path in ("/repo/fleet/logstreams/app", "/repo/fleet"):
            status, doc = http_raw(port, "DELETE", path, {})[::2]
            check(status == 200, f"DELETE {path}: {status} {doc!r}")
        status, _h, body = http_raw(port, "DELETE", "/query", {})
        check(status == 404 and json.loads(body) == {"error": "not found"},
              f"DELETE /query: {status} {body!r}")
        status, doc = http(port, "GET", "/repo", {})
        check("fleet" not in doc["repositories"],
              f"the repository survived its DELETE: {doc}")

        # (b) the object store: one group of benchmark offloaded, C1 and
        # C3 over its first hour hydrate it
        hour = (f"time >= {T0_NS} AND time < {T0_NS + 3600 * 10**9}")
        hq = {qn: re.sub(r"time >= \d+ AND time < \d+", hour,
                         cold["queries"][qn]) for qn in ("C1", "C3")}
        status, _ = http(port, "POST", "/debug/ctrl",
                         {"mod": "offload", "force": "device"})
        check(status == 200, f"force=device: {status}")
        os.environ["OGT_DEVICE_PROFILE"] = "1"  # phase 5's files' profile
        local = {}
        for qn, q in hq.items():
            local[qn] = query_timed(port, q)[0]
        eng = svc.engine
        key = next(k for k in sorted(eng._shards)
                   if k[0] == "benchmark"
                   and eng._shards[k].tmin <= T0_NS < eng._shards[k].tmax)
        t_off = time.perf_counter()
        check(eng.offload_shard(*key), f"offload_shard{key} refused")
        off_s = time.perf_counter() - t_off
        off_bytes = sum(os.path.getsize(os.path.join(d, f))
                        for d, _s, fs in os.walk(obs_dir) for f in fs)
        check(key in eng.obs_shards and not os.path.exists(
            eng._shard_dir(*key)), f"{key} is not offloaded")
        log(f"[edges] offloaded {key} in {off_s:.3f} s: {off_bytes} B "
            f"({off_bytes / off_s / 2**20:.1f} MiB/s) into {obs_dir}")
        t_hyd = time.perf_counter()
        orig_dl = eng._download_group
        hyd_s = []

        def timed_download(*args):
            t = time.perf_counter()
            orig_dl(*args)
            hyd_s.append(time.perf_counter() - t)

        eng._download_group = timed_download
        try:
            for qn, q in hq.items():
                l0 = dict(cs.LAUNCHES)
                res, _req_ms, ms = query_timed(port, q)
                got = {k: cs.LAUNCHES[k] - l0[k] for k in l0}
                check(res == local[qn], f"{qn} over the hydrated hour "
                      "differs from its answer before the offload")
                per_query[qn + " hydrated"] = {"runs_ms": [ms],
                                               "p50_ms": ms, "launches": got}
                log(f"[edges] {qn} over the hydrated hour ok {ms:.1f} ms; "
                    f"launches {json.dumps({k: v for k, v in got.items() if v})}")
        finally:
            del eng._download_group
        check(len(hyd_s) == 1 and key not in eng.obs_shards
              and key in eng._shards,
              f"hydration: {len(hyd_s)} downloads, registry "
              f"{sorted(eng.obs_shards)}")
        log(f"[edges] the hydration took {hyd_s[0]:.3f} s (of the first "
            f"query's {time.perf_counter() - t_hyd:.3f} s for both)")
        c1, c3 = (per_query[f"{qn} hydrated"]["launches"]
                  for qn in ("C1", "C3"))
        check(c1["unpack_bits"] >= 1 and c1["grid_window_agg"] == 1
              and c3["grid_window_agg"] == 1,
              f"the hydrated decode: C1 {c1}, C3 {c3}")
        http(port, "POST", "/debug/ctrl", {"mod": "offload", "force": "none"})
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        t0 = lap("offload and hydration", t0)

        # (c) tag arrays through /write, and a restart's WAL replay
        status, doc = http(port, "POST", "/query",
                           {"q": "CREATE DATABASE tags"})
        check(status == 200, f"CREATE DATABASE tags: {status} {doc}")
        tv = np.round(np.random.default_rng(seed + 180).uniform(
            0, 100, EDGE_TAG_LINES), 2)
        tag_lines = "\n".join(
            f"edge,host=[{','.join(EDGE_TAG_VALUES)}],rack=r{i % 10} "
            f"v={tv[i]} {T0_NS + i * 10**9}" for i in range(EDGE_TAG_LINES))
        status, _ = http(port, "POST", "/write", {"db": "tags"},
                         tag_lines.encode())
        check(status == 204, f"the tag-array /write: {status}")
        tq = "SELECT count(v), max(v), sum(v) FROM edge GROUP BY host"

        def tag_check(label):
            status, doc = http(port, "GET", "/query",
                               {"db": "tags", "q": tq})
            series = doc["results"][0]["series"]
            got = {s["tags"]["host"]: s["values"][0][1:] for s in series}
            ok = (set(got) == set(EDGE_TAG_VALUES) and all(
                v[0] == EDGE_TAG_LINES and v[1] == float(tv.max())
                and abs(v[2] - float(tv.sum())) <= MEAN_RTOL
                * float(tv.sum()) for v in got.values()))
            check(ok, f"tag arrays {label}: {got}")
            return sum(v[0] for v in got.values())

        n_pts = tag_check("after /write")
        if svc.flight is not None:
            # Arrow Flight: every host's value by DoPut, read back by DoGet
            import pyarrow as pa

            t_fl = time.perf_counter()
            client = fl.connect(f"grpc://127.0.0.1:{svc.flight.port}")
            try:
                fv = np.round(np.random.default_rng(seed + 181).uniform(
                    0, 100, n_hosts), 2)
                table = pa.table({
                    "time": pa.array([T0_NS] * n_hosts, pa.int64()),
                    "host": pa.array([f"host_{h}" for h in range(n_hosts)]),
                    "v": pa.array(fv)})
                writer, _ = client.do_put(
                    fl.FlightDescriptor.for_command(json.dumps(
                        {"db": "tags", "measurement": "flight",
                         "tag_columns": ["host"]}).encode()), table.schema)
                writer.write_table(table)
                writer.close()
                got = client.do_get(fl.Ticket(json.dumps(
                    {"db": "tags", "q": "SELECT count(v), max(v), sum(v) "
                     "FROM flight"}).encode())).read_all().to_pydict()
            finally:
                client.close()
            check(got["count"] == [n_hosts] and got["max"] == [fv.max()]
                  and abs(got["sum"][0] - fv.sum()) <= MEAN_RTOL * fv.sum(),
                  f"Arrow Flight: {got}")
            log(f"[edges] Arrow Flight: {n_hosts} rows by DoPut and their "
                f"count, max and sum by DoGet in "
                f"{(time.perf_counter() - t_fl) * 1e3:.1f} ms")
            svc.flight.stop()
        stop_app(svc)
        # the restart serves no Flight: its port was the first run's
        cfg = {k: v for k, v in cfg.items() if k != "flight"}
        svc = app.build(cfg)
        svc.start()
        port = svc.port
        disarm_planner(port)
        check(tag_check("after the restart's WAL replay") == n_pts,
              "the replay lost points")
        log(f"[edges] tag arrays: {EDGE_TAG_LINES} lines -> {n_pts} points "
            f"in {len(EDGE_TAG_VALUES)} series, equal after the restart")
        t0 = lap("tag arrays and the restart", t0)

        # (d) SHOW STATS and SHOW DIAGNOSTICS
        sections = {}
        for q in ("SHOW STATS", "SHOW DIAGNOSTICS"):
            status, doc = http(port, "GET", "/query", {"q": q})
            res = doc["results"][0]
            check(status == 200 and "error" not in res and res["series"],
                  f"{q}: {status} {res}")
            sections[q] = [s["name"] for s in res["series"]]
            log(f"[edges] {q}: {', '.join(sections[q])}")
        diag = dict(doc["results"][0]["series"][0]["values"])
        check(diag["backend"] == "cuda", f"SHOW DIAGNOSTICS: {diag}")

        # (e) the restored root on the card: L2 equal; the export
        e2 = Engine(restored)
        try:
            check(e2.device.type == "cuda", f"Engine() on {e2.device}")
            from opengemini_tpu_torch.server.http import HttpService

            s2 = HttpService(e2, port=0)
            s2.start()
            try:
                l2b, _ = repo_get(s2.port, base + "histogram",
                                  dict(span, q="*", interval="1m"), runs=1)
            finally:
                s2.stop()
        finally:
            e2.close()
        check(l2b == l2, "L2 on the restored root differs")
        try:
            import pyarrow  # noqa: F401
            has_arrow = True
        except ImportError:
            has_arrow = False
        if has_arrow:
            from opengemini_tpu_torch.tools import export as texp

            n_exp = texp.export_measurement(
                svc.engine, "tags", "edge",
                os.path.join(backup_dir, "edge.parquet"))
            check(n_exp == n_pts, f"export wrote {n_exp} rows of {n_pts}")
            log(f"[edges] export: {n_exp} rows of edge")
        else:
            log("[edges] export not driven: pyarrow is not installed "
                "here (the parquet writer needs it)")
        log(f"[edges] backup: {len(bk_manifest['files'])} files, restored "
            f"{n_restored} into {restored}; L2 equal on Engine() there")
        t0 = lap("restore check and export", t0)

        # (f) /api/v1/consume over one minute of benchmark: the span's
        # first minute of cpu again, as edge_cpu in the memtable (a
        # consume page decodes every series' rows from its cursor on, and
        # the compacted file's packed chunks hold every series' whole
        # span: the 6 h of cpu would cost minutes on the host)
        o = cold["oracle"]
        minute = "\n".join(
            "edge_" + ln for ln in lp_lines(o["tags"], o["vals"],
                                            o["counters"], 0, 6,
                                            o["n_hosts"]).split("\n")
            if ln.startswith("cpu,"))
        status, _ = http(port, "POST", "/write", {"db": "benchmark"},
                         minute.encode())
        check(status == 204, f"the edge_cpu minute: {status}")
        n_f = min(10_000, 6 * o["n_hosts"])
        t_f = time.perf_counter()
        status, doc = http(port, "GET", "/api/v1/consume", {
            "db": "benchmark", "measurement": "edge_cpu",
            "cursor": f"{T0_NS}:0", "limit": str(n_f)})
        ms_f = (time.perf_counter() - t_f) * 1e3
        rows = doc.get("rows", [])
        times = [r["time"] for r in rows]
        host_of = {tg["hostname"]: h for h, tg in enumerate(
            dict(t) for t in o["tags"])}
        bad = [r for r in rows if any(
            r["fields"][f] != float(o["vals"][f][
                host_of[r["tags"]["hostname"]],
                (r["time"] - T0_NS) // STEP_NS]) for f in FIELDS)]
        check(status == 200 and len(rows) == n_f and times == sorted(times)
              and T0_NS <= times[0] and times[-1] < T0_NS + 60 * 10**9
              and not bad
              and doc["exhausted"] == (n_f == 6 * o["n_hosts"]),
              f"consume: {status} {len(rows)} rows of {n_f}, "
              f"{len(bad)} unequal")
        per_query["F1"] = {"runs_ms": [ms_f], "p50_ms": ms_f,
                           "launches": {k: 0 for k in cs.LAUNCHES}}
        log(f"[edges] /api/v1/consume: {n_f} rows of benchmark's first "
            f"minute (edge_cpu) in {ms_f:.1f} ms, cursor {doc['cursor']}")
        status, _ = http(port, "POST", "/query", {"q": "DROP DATABASE tags"})
        check(status == 200, f"DROP DATABASE tags: {status}")
        t0 = lap("consume", t0)
        if fl is None:
            log("[edges] Arrow Flight is not driven: pyarrow.flight is not "
                "installed on this machine")
        launches = dict(cs.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(peak <= COLD_PEAK_LIMIT, f"phase 18 device memory peak {peak} B")
        wall_s = time.perf_counter() - t_phase
        log(f"[edges] steps {json.dumps({k: round(v, 3) for k, v in walls.items()})}")
        log(f"[edges] phase 18 took {wall_s:.1f} s (budget "
            f"{EDGES_PHASE_S:.0f} s, {deadline - time.perf_counter():.0f} s "
            f"left of the script's); launches {json.dumps(launches)}; "
            f"device memory peak {peak / 2**20:.1f} MiB; card {smi_line()}")
        return {"launches": launches, "per_query": per_query,
                "shapes": rec.seen, "walls": walls, "wall_s": wall_s,
                "sections": sections, "peak_bytes": peak,
                "offload": {"s": off_s, "bytes": off_bytes,
                            "hydrate_s": hyd_s[0]}}
    finally:
        rec.__exit__()
        offload.set_force(None)
        cc.clear()
        os.environ.pop("OGT_DEVICE_PROFILE", None)
        if svc is not None:
            if svc.flight is not None:
                svc.flight.stop()
            stop_app(svc)
        for d in (backup_dir, restored, obs_dir):
            shutil.rmtree(d, ignore_errors=True)


# -- phase 19: the mesh across processes and cards ---------------------------

# phase 19's budget (s): the ranks' start (the process group's init, the
# engine's open on the root), C1, C3 and B1 on every rank at once, and
# the ranks' stop
MESHX_PHASE_S = 45.0
# the longest a rank may take from its start to listening
MESHX_START_S = 40.0
# the process group's timeout (OGT_DIST_TIMEOUT_S): a rank out of step
# raises after it
MESHX_DIST_TIMEOUT_S = 60
# the ranks' device and number: None for one rank per visible card over
# NCCL (a CPU rehearsal sets "cpu" and a number: gloo, one shard a rank)
MESHX_DEVICE = None
MESHX_WORLD = None
# a rank's ts-server config: the [device] keys of the reference
MESHX_TOML = """[data]
dir = "{root}"
[http]
bind-address = "127.0.0.1:{port}"
[services]
store-monitor = false
[device]
mesh-axes = ["shard"]
coordinator-address = "127.0.0.1:{coord}"
num-processes = {world}
process-id = {rank}
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_mesh(port: int) -> dict:
    """A rank's /debug/device mesh section: its place in the world, its
    shards, its collectives and its kernels' launches."""
    status, doc = http(port, "GET", "/debug/device", {})
    check(status == 200, f"/debug/device on port {port}: {status}")
    return doc["mesh"]


def start_ranks(roots: list, base: str, deadline: float) -> list:
    """One process of the port's ts-server main per root, rank r on the
    r-th visible card (CUDA_VISIBLE_DEVICES), each with the [device]
    keys; returns [(process, port, log path)] once every rank listens."""
    repo = os.path.dirname(os.path.abspath(__file__))
    world = len(roots)
    coord = free_port()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible
             else [str(i) for i in range(world)])
    env = dict(os.environ, OGT_RESULT_CACHE="0", OGT_DEVICE_PROFILE="1",
               OGT_DIST_TIMEOUT_S=str(MESHX_DIST_TIMEOUT_S),
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    ranks = []
    for r, root in enumerate(roots):
        port = free_port()
        toml = os.path.join(base, f"rank{r}.toml")
        with open(toml, "w", encoding="utf-8") as f:
            f.write(MESHX_TOML.format(root=root, port=port, coord=coord,
                                      world=world, rank=r))
        cmd = [sys.executable, "-m", "opengemini_tpu_torch.server.app",
               "-config", toml]
        rank_env = dict(env)
        if MESHX_DEVICE is None:
            rank_env["CUDA_VISIBLE_DEVICES"] = cards[r]
        else:
            cmd += ["-device", MESHX_DEVICE]
        path = os.path.join(base, f"rank{r}.log")
        with open(path, "w", encoding="utf-8") as log_f:
            proc = subprocess.Popen(cmd, cwd=repo, env=rank_env,
                                    stdout=log_f, stderr=subprocess.STDOUT)
        ranks.append((proc, port, path))
    pending = set(range(world))
    while pending:
        for r in sorted(pending):
            proc, _port, path = ranks[r]
            with open(path, encoding="utf-8", errors="replace") as f:
                text = f.read()
            if "listening on" in text:
                pending.discard(r)
            elif proc.poll() is not None or time.perf_counter() > deadline:
                check(False, f"rank {r} of {world} did not start "
                      f"(exit {proc.poll()}): ...{text[-2000:]}")
        time.sleep(0.2)
    return ranks


def stop_ranks(ranks: list) -> None:
    """SIGTERM every rank (its main stops its server and closes its
    engine), then kill what is left after 20 s."""
    for proc, _port, _path in ranks:
        if proc.poll() is None:
            proc.terminate()
    end = time.perf_counter() + 20
    for proc, port, _path in ranks:
        conn = _CONNS.pop(port, None)
        if conn is not None:
            conn.close()
        try:
            proc.wait(timeout=max(0.1, end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def phase_meshx(cold: dict, meshed: dict, deadline: float) -> dict:
    """The mesh across processes and cards (ROADMAP A8.4) through the
    port's ts-server main, last, on phase 7's compacted root (a copy per
    rank after the first). One process per visible card, each started as
    `python -m opengemini_tpu_torch.server.app -config rank<r>.toml` with
    CUDA_VISIBLE_DEVICES set to its card and the [device] keys
    coordinator-address, num-processes and process-id, so that the ranks
    join one NCCL process group and lay one global mesh, one shard a
    card. Every rank disarms its planner and forces the device decode
    (each rank's shard plan meets the cost gate alone, as phase 17's
    shards do). C1, C3 and B1 go to every rank at once, one query after
    the other (multi-controller SPMD: every rank runs the same mesh
    programs in the same order); every rank's answer must equal the
    oracle and phase 17's one-process answer. Each rank's /debug/device
    mesh section gives its place (process_id, num_processes, backend,
    local_shards), its kernels' launches (its counts start at 0 with the
    process: its startup probe and these queries) and its collectives'
    calls, bytes and wall, read around each query. On one card that is a
    world of one process over NCCL: no byte crosses a card, and init,
    the global mesh and every collective call still run. The kernels'
    shapes are phase 17's (one shard a card: its step (a) shapes at one
    rank, its step (b) shapes at four)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    t_phase = time.perf_counter()
    o = cold["oracle"]
    queries = mesh_queries(cold)
    world = MESHX_WORLD or torch.cuda.device_count()
    backend = "gloo" if MESHX_DEVICE == "cpu" else "nccl"
    log(f"[meshx] world size {world} ({backend}, one process a "
        + ("card" if MESHX_DEVICE is None else "CPU shard") + ")"
        + (": one process on the one card, so no byte crosses a card; "
           "the process group's init, the global mesh and every "
           "collective call still run" if world == 1 else ""))
    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, "build", "meshx")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    roots = [cold["root"]] + [os.path.join(base, f"root{r}")
                              for r in range(1, world)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(world - 1, 1)) as pool:
        list(pool.map(lambda d: shutil.copytree(cold["root"], d),
                      roots[1:]))
    copy_s = time.perf_counter() - t0
    ranks = []
    per_query: dict = {}
    walls: dict = {}
    try:
        ranks = start_ranks(roots, base,
                            time.perf_counter() + MESHX_START_S)
        start_s = time.perf_counter() - t0 - copy_s
        ports = [port for _p, port, _l in ranks]
        for r, port in enumerate(ports):
            disarm_planner(port)
            status, _ = http(port, "POST", "/debug/ctrl",
                             {"mod": "offload", "force": "device"})
            check(status == 200, f"rank {r}: force=device: {status}")
            doc = rank_mesh(port)
            check(doc.get("process_id") == r
                  and doc.get("num_processes") == world
                  and doc.get("backend") == backend
                  and doc.get("size") == world
                  and doc.get("local_shards") == [r],
                  f"rank {r}: the mesh section {doc}")
        log(f"[meshx] {world} rank(s) listening in {start_s:.1f} s (root "
            f"copies {copy_s:.1f} s); ports {ports}")
        first = [rank_mesh(p) for p in ports]
        with ThreadPoolExecutor(world) as pool:
            for qn, q in queries.items():
                before = [rank_mesh(p) for p in ports]
                t1 = time.perf_counter()
                got = list(pool.map(lambda p: query_timed(p, q), ports))
                walls[qn] = (time.perf_counter() - t1) * 1e3
                after = [rank_mesh(p) for p in ports]
                ranks_q = []
                for r, (res, _req, ms) in enumerate(got):
                    verify_mesh(qn, res, o)
                    if meshed is not None:
                        mesh_same(qn, res, meshed["answers"][qn],
                                  f"{qn} on rank {r} of {world} differs "
                                  "from phase 17's one-process answer")
                    a, b = after[r], before[r]
                    launched = {k: a["launches"][k] - b["launches"][k]
                                for k in a["launches"]}
                    coll = {k: a["collectives"][k] - b["collectives"][k]
                            for k in a["collectives"]}
                    check(coll["calls"] > 0,
                          f"{qn} on rank {r}: no collective ran")
                    ranks_q.append({"ms": ms, "launches": launched,
                                    "collectives": coll})
                    log(f"[meshx] {qn} rank {r}/{world} ok {ms:.1f} ms; "
                        f"launches {json.dumps({k: v for k, v in launched.items() if v})}; "
                        f"collectives {coll['calls']} calls, "
                        f"{coll['bytes']} B, {coll['wall_ms']:.3f} ms")
                calls = {rq["collectives"]["calls"] for rq in ranks_q}
                check(len(calls) == 1, f"{qn}: the ranks issued "
                      f"{[rq['collectives']['calls'] for rq in ranks_q]} "
                      "collectives")
                total = {k: sum(rq["launches"][k] for rq in ranks_q)
                         for k in ranks_q[0]["launches"]}
                per_query[qn] = {"launches": total, "ranks": ranks_q,
                                 "wall_ms": walls[qn]}
        last = [rank_mesh(p) for p in ports]
        for r in range(world):
            a, b = last[r], first[r]
            ql = {k: a["launches"][k] - b["launches"][k]
                  for k in a["launches"]}
            coll = {k: a["collectives"][k] - b["collectives"][k]
                    for k in a["collectives"]}
            log(f"[meshx] rank {r}/{world}: local shards "
                f"{a['local_shards']} of {a['size']}; launches since its "
                f"start {json.dumps(a['launches'])} (C1, C3, B1: "
                f"{json.dumps(ql)}); collectives {coll['calls']} calls, "
                f"{coll['bytes']} B sent, {coll['wall_ms']:.3f} ms")
            # kernel 6 probes the card at the process's first device
            # decode: once on a rank whose shard decodes C1's rows
            check(ql["grid_window_agg"] >= 2
                  and ql["bucket_stats_basic"] >= 1
                  and ql["bucket_stats_selectors"] >= 1
                  and a["launches"]["probe_count"]
                  == (1 if per_query["C1"]["ranks"][r]["launches"][
                      "unpack_bits"] else a["launches"]["probe_count"])
                  and a["launches"]["probe_count"] <= 1,
                  f"rank {r}: launches {a['launches']}, in the queries "
                  f"{ql}")
        c1 = per_query["C1"]["launches"]["unpack_bits"]
        check(c1 >= 1, f"C1 launched kernel 5 {c1} times over the ranks")
        launches = {k: sum(last[r]["launches"][k] for r in range(world))
                    for k in last[0]["launches"]}
    finally:
        stop_ranks(ranks)
        for r in range(1, world):
            shutil.rmtree(os.path.join(base, f"root{r}"), ignore_errors=True)
    wall_s = time.perf_counter() - t_phase
    log(f"[meshx] walls ms (every rank at once) {json.dumps(walls)}")
    log(f"[meshx] phase 19 took {wall_s:.1f} s (budget "
        f"{MESHX_PHASE_S:.0f} s, {deadline - time.perf_counter():.0f} s "
        f"left of the script's); launches over the ranks "
        f"{json.dumps(launches)}; card {smi_line()}")
    return {"launches": launches, "per_query": per_query, "world": world,
            "walls_ms": walls, "wall_s": wall_s, "start_s": start_s,
            "copy_s": copy_s}


def stop_app(svc) -> None:
    """Stop a server app.build() made (its services never started)."""
    svc.subscriber.stop()
    if svc.rules_manager is not None:
        svc.rules_manager.close()
    stop_server(svc, svc.engine)


def prom_mesh_kernels() -> int:
    from opengemini_tpu_torch.utils import stats

    return stats.GLOBAL.snapshot().get("prom", {}).get("tiled_mesh_kernels",
                                                       0)


def build_all(verbose: bool = True) -> float:
    """nvcc for the six kernels and g++ for the six host libraries, all
    at once; returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    from opengemini_tpu_torch import native
    from opengemini_tpu_torch.ops import cuda_segment as cs

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=7) as pool:
        jobs = [pool.submit(cs.build, verbose=verbose),
                pool.submit(native.build_shared, "codecs.cpp"),
                pool.submit(native.build_shared, "seriesindex.cpp"),
                pool.submit(native.build_shared, "lpformat.cpp"),
                pool.submit(native.build_shared, "lineproto.cpp"),
                pool.submit(native.build_shared, "textindex.cpp"),
                pool.submit(native.build_shared, "gorillascan.cpp")]
        for job in jobs:
            job.result()
    return time.perf_counter() - t0


def main_path_kernels(name: str, shapes, seed: int, dev_name: str,
                      limit: int = 6) -> list:
    """Check every kernel at (up to `limit` of) the shapes a main path
    gave it, largest bound first, and time them."""
    ordered = sorted(shapes, key=lambda sh: -bound(name, sh, 0, dev_name)[0])
    recs = []
    for j, shape in enumerate(ordered[:limit]):
        rec = kernel_case(name, shape, seed + j, dev_name, timed=True)
        recs.append(rec)
        log(f"[main-path kernel] {name}{shape_label(name, shape)} ok "
            f"ms={rec['ms']:.4f} device_ms={rec['device_ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
            f"(device_ms/bound "
            f"{rec['device_ms'] / max(rec['bound_ms'], 1e-9):.2f})"
            + (f" library_ms={rec['library_ms']:.4f}"
               if rec.get("library_ms") is not None else ""))
    if len(ordered) > limit:
        log(f"[main-path kernel] {name}: {len(ordered)} shapes, the "
            f"{limit} largest checked and timed")
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # phase 3's span, cut from 12 h: with phase 13 the script took 987.7
    # and 1079.4 s on an H100 at 12 h, and 1100.2 and 1004.3 s at 6 h
    # with phase 14; 4 h with phase 15
    ap.add_argument("--hours", type=int, default=4,
                    help="span of the end-to-end data (cut only to fit a "
                         "time limit, never below 3)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--phases", default="all",
                    help="the phases after 2 to run, comma separated "
                         "(3-19; 6-10 and 12 need 5, 15 needs 13, 17, 18 "
                         "and 19 need 5, 6 and 7), for a short call that "
                         "checks one path; default all")
    args = ap.parse_args()
    if args.hours < 3:
        ap.error("--hours may not be cut below 3")
    wanted = (set(range(3, 20)) if args.phases == "all"
              else {int(x) for x in args.phases.split(",")})
    if wanted & {6, 7, 8, 9, 10, 12} and 5 not in wanted:
        ap.error("phases 6-10 and 12 run on phase 5's root")
    if 15 in wanted and 13 not in wanted:
        ap.error("phase 15 runs on phase 13's root")
    if 17 in wanted and not {5, 6, 7} <= wanted:
        ap.error("phase 17 runs on phase 7's compacted root (with phase "
                 "6's row)")
    if 18 in wanted and not {5, 6, 7} <= wanted:
        ap.error("phase 18 runs on phase 7's compacted root")
    if 19 in wanted and not {5, 6, 7} <= wanted:
        ap.error("phase 19 runs on phase 7's compacted root")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from opengemini_tpu_torch.ops import cuda_segment as cs

    # phases 3-9 measure every execution: the incremental result cache
    # (the reference's switch, read at query time) is off there, and
    # phases 10 and 11 turn it on for their panels
    os.environ["OGT_RESULT_CACHE"] = "0"

    t_start = time.perf_counter()
    dev_name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {dev_name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[build] 6 kernels and 6 host libraries built in "
        f"{build_all():.1f} s into {cs.BUILD_DIR} and build/native")

    laps = [t_start]

    def lap(what: str) -> None:
        """Print the wall of the step that just ended."""
        now = time.perf_counter()
        log(f"[time] {what} took {now - laps[-1]:.1f} s "
            f"({now - t_start:.1f} s in all)")
        laps.append(now)

    lap("build")
    checked = phase_kernels(dev_name, args.seed)
    lap("phase 2")
    recs = {name: [] for name in cs.LAUNCHES}
    # (phase, its result, the tag its queries carry in the output)
    ran: list = []
    seen = {k: set() for k in cs.LAUNCHES}
    q1_h2d = None
    if 3 in wanted:
        e2e = phase_e2e(args.hours, args.seed)
        lap("phase 3")
        for i, name in enumerate(E2E_KERNELS):
            recs[name] += main_path_kernels(
                name, e2e["shapes"][name], args.seed + 1000 + 10 * i,
                dev_name)
        lap("phase 4")
        ran.append(("3", e2e, ""))
        q1_h2d = (e2e["traced"]["Q1"].get("device") or {}).get("h2d_bytes")
        for k in seen:
            seen[k] |= e2e["shapes"].get(k, set())
    if 5 in wanted:
        cold = phase_cold(COLD_HOURS, args.seed, q1_h2d)
        for i, name in enumerate(COLD_KERNELS):
            recs[name] += main_path_kernels(
                name, cold["shapes"][name] - seen[name],
                args.seed + 2000 + 10 * i, dev_name)
        lap("phase 5 and its kernels")
        ran.append(("5", cold, ""))
        for k in seen:
            seen[k] |= cold["shapes"].get(k, set())
    later = []
    life = None
    if 6 in wanted:
        ran.append(("6", phase_colcache(cold), " cached"))
        lap("phase 6")
    if 7 in wanted:
        ran.append(("7", phase_compact(cold), " compacted"))
        lap("phase 7")
    if 8 in wanted:
        hosted = phase_host(cold)
        ran.append(("8", hosted, ""))
        later.append(hosted)
        lap("phase 8")
    if 9 in wanted:
        nested = phase_subquery(
            cold, t_start + SCRIPT_LIMIT_S - AFTER_PHASE9_S)
        ran.append(("9", nested, ""))
        later.append(nested)
        lap("phase 9")
    if 10 in wanted:
        dash = phase_dashboard(cold, args.seed,
                               t_start + SCRIPT_LIMIT_S - AFTER_PHASE10_S)
        ran.append(("10", dash, ""))
        later.append(dash)
        lap("phase 10")
    if 11 in wanted:
        life = phase_lifecycle(args.seed,
                               t_start + SCRIPT_LIMIT_S - AFTER_PHASE11_S)
        ran.append(("11", life, ""))
        later.append(life)
        lap("phase 11")
    planned = None
    if 12 in wanted:
        planned = phase_planner(cold)
        ran.append(("12", planned, " planner"))
        later.append(planned)
        lap("phase 12")
    prom = None
    if 13 in wanted:
        prom = phase_prom(args.seed, t_start + SCRIPT_LIMIT_S
                          - AFTER_PHASE13_S)
        ran.append(("13", prom, " prom"))
        later.append(prom)
        lap("phase 13")
    cont = None
    if 14 in wanted:
        cont = phase_continuous(args.seed, t_start + SCRIPT_LIMIT_S
                                - AFTER_PHASE14_S)
        ran.append(("14", cont, " continuous"))
        later.append(cont)
        lap("phase 14")
    ruled = None
    if 15 in wanted:
        ruled = phase_rules(prom, args.seed, t_start + SCRIPT_LIMIT_S
                            - AFTER_PHASE15_S)
        ran.append(("15", ruled, " rules"))
        later.append(ruled)
        lap("phase 15")
    if 16 in wanted:
        clustered = phase_cluster(args.seed, t_start + SCRIPT_LIMIT_S
                                  - AFTER_PHASE16_S)
        ran.append(("16", clustered, " cluster"))
        later.append(clustered)
        lap("phase 16")
    meshed = None
    if 17 in wanted:
        meshed = phase_mesh(cold, prom, t_start + SCRIPT_LIMIT_S
                            - AFTER_PHASE17_S)
        ran.append(("17", meshed, " mesh"))
        later.append(meshed)
        lap("phase 17")
    edged = None
    if 18 in wanted:
        edged = phase_edges(cold, args.seed, t_start + SCRIPT_LIMIT_S
                            - AFTER_PHASE18_S)
        ran.append(("18", edged, " edges"))
        later.append(edged)
        lap("phase 18")
    if 19 in wanted:
        # its ranks' kernels run at phase 17's shard shapes, in processes
        # of their own: their shapes are checked with phase 17's
        ran.append(("19", phase_meshx(cold, meshed, t_start + SCRIPT_LIMIT_S
                                      - AFTER_PHASE19_S), " meshx"))
        lap("phase 19")
    # kernels 1-3 at the later phases' new shapes, and kernels 4-6 too
    # at phase 11's, 12's, 13's, 14's, 15's, 17's and 18's (the decode of
    # rewritten, compacted and hydrated files, PromQL's rows matrices and
    # the mesh shards' chunks)
    for i, name in enumerate(E2E_KERNELS + COLD_KERNELS[1:]):
        for j, phase in enumerate(later):
            if name not in E2E_KERNELS and not any(
                    phase is x for x in (life, planned, prom, cont, ruled,
                                         meshed, edged)):
                continue
            new = {sh for sh in phase["shapes"][name] - seen[name]
                   if all(d > 0 for d in shape_json(name, sh)
                          if isinstance(d, int))}
            recs[name] += main_path_kernels(
                name, new, args.seed + 3000 + 1000 * j + 10 * i, dev_name,
                limit=3)
            seen[name] |= phase["shapes"][name]
    lap("the kernels at the later phases' shapes")

    kernels = []
    hosted = next((p for ph, p, _t in ran if ph == "8"), None)
    for name in cs.LAUNCHES:
        # a kernel no main path of this run gave a shape: its phase 2
        # checks stand in
        top = max(recs[name] or checked[name], key=lambda r: r["bound_ms"])
        paths = [(tag, p) for _ph, p, tag in ran
                 if p["launches"].get(name)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(cs.source_path(name),
                                      os.path.dirname(os.path.abspath(__file__))),
            "replaces": REPLACES[name],
            "launches": sum(p["launches"][name] for _t, p in paths),
            "launches_per_phase": {ph: p["launches"].get(name, 0)
                                   for ph, p, _t in ran},
            "launches_per_query": {qn + tag: pq["launches"][name]
                                   for tag, p in paths
                                   for qn, pq in p["per_query"].items()},
            "launches_parity_on_card": (
                hosted["parity"]["launches"][name] if hosted else None),
            "max_abs_err": max(r["max_abs_err"]
                               for r in recs[name] + checked[name]),
            "ms": top["ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top.get("library_ms"),
            "shape": top["shape"],
            "main_path_shapes": recs[name],
            "checked_shapes": checked[name],
        })
        cold_run = next((p for ph, p, _t in ran if ph == "5"), None)
        if name in ENTRIES and cold_run is not None:
            kernels[-1]["launches_per_run"] = {
                qn: pq["per_run"][name]
                for qn, pq in cold_run["per_query"].items()}
        if name == "widen_packed":
            kernels[-1]["library_comparison"] = checked["widen_host"]
        if name == "probe_count":
            kernels[-1]["host_stages_us"] = checked["probe_host"]
            kernels[-1]["launch_floor"] = checked["probe_floor"]
        buffers = {k: r for k, r in checked["one_buffer"].items()
                   if k.startswith(name)}
        if buffers:
            kernels[-1]["one_buffer_comparison"] = buffers
    short = {qn + tag: pq["stages_ms"]["covered"]
             for ph, p, tag in ran if ph in ("3", "5", "6", "7")
             for qn, pq in p["per_query"].items()
             if pq["stages_ms"]["covered"] < STAGE_COVER}
    check(not short, f"the stages cover less than {STAGE_COVER:.0%} of "
          f"these queries' walls: {short}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
