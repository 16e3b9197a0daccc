#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py   # 2^24 keys, the paged path, llama3.2-1b, the
                            # cached directory store, the four baselines,
                            # the transport model, the (1, 1) mesh, the
                            # replicated store through a crash, the
                            # telemetry plane, a 4-CN cluster, chaos, the
                            # front door, session parking, rwkv6,
                            # llama3.2-1b trained, llava, mixtral,
                            # deepseek, jamba and whisper served, and
                            # qwen2.5-14b and mixtral served and llama
                            # trained by two ranks at tp = 2, jamba
                            # decoding a 524,288-token cache over two
                            # ranks, and llama3.2-1b decoding its
                            # decode_32k share of a production rank over
                            # sixteen ranks at tp = 16; one card

Phases; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``), build the five
   CUDA libraries of ``src/repro_torch/kernels/csrc`` (``ludo_lookup``,
   ``slot_unpack``, ``paged_attention`` with both paged kernels,
   ``fused_norm_matmul`` and its backward ``fused_norm_matmul_bwd``) with
   one ``nvcc`` each, all at once, for sm_90a;
2. hold each index kernel bit for bit against its plain PyTorch version on
   the card: ``ludo_lookup`` over a real shard's CN arrays (whose size it
   prints) at the edges of its plan (``ops.ludo_lookup_plan``, printed at
   B = 1, 1024 and 2^20: a warp, the serve window, each block width's
   last batch and the next, 2^20), each on lanes 0-3 elements past a
   16-byte boundary; ``slot_unpack`` over 2^22 random slot words with
   all-ones words among them (batch sizes 1, 1023, 1024, 1025 and 2^22).
   Time both with CUDA events and ``torch.profiler`` (``ludo_lookup`` at
   B = 1, 1024 and 2^20, ``slot_unpack`` at 1024 and 2^20) beside their
   bounds (the operations counted, ``LUDO_OPS``, printed beside the built
   kernels' SASS opcodes by pipe), and print the two wrappers' host time
   at B=1024 piece by piece (:func:`wrapper_breakdown`);
3. check that a small store on the card answers and meters exactly as the
   same store on the CPU (the plain versions), then serve through
   ``open_store(StoreSpec("outback", load_factor=0.95))`` at 2^24 keys of
   8 bytes with 8-byte values: YCSB-C (2^20 zipf(0.99) Gets), YCSB-A
   (2^18 ops, half reads, half updates), then 2^14 inserts of new keys and
   2^14 deletes, all through ``submit``/``flush`` at window 1024, every
   answer checked against a host oracle of the latest values.  The kernel
   launch counters are zeroed just before this phase and read just after;
4. hold ``paged_attention`` and ``cuckoo_paged_attention`` against their
   plain version on the card, within the tests' tolerance: the test shapes
   (float32 and bf16, ragged ``seq_len``), the edges of their split-KV
   design (runs of 16 pages: L=1, a last run of one page, ``seq_len`` in
   the first page of the last run, whole runs past ``seq_len``, float32
   and d=128 at L in the hundreds, a group of 5 queries; every cuckoo run
   starting on the unselected candidate), then the serve shape
   (llama3.2-1b's attention width: 8 KV heads of 4 queries, d=64, pages of
   16 bf16 tokens, L=1954) over a 2^17-page bf16 pool.  Each kernel is
   bound by the bytes of its pages: a split pass over KV heads x runs of
   pages keeps several pages' copies in flight in each block, and a
   combine pass merges the runs.  Time each with CUDA events and
   ``torch.profiler`` (device time a call: both launches, summed) beside
   its byte bound, its plain version and a gather +
   ``scaled_dot_product_attention`` yardstick;
5. drive the Ludo-paged decode path: ``LudoPageTable`` and
   ``CuckooPageTable`` of 2^17 pages on the card, 8 sequences of 3908 to
   31264 tokens appended page by page, then 4 decode steps each through
   ``lookup_batch`` -> ``ops.paged_attention`` and ``lookup2_batch`` ->
   ``ops.cuckoo_paged_attention``, every matched page-map entry checked
   against the allocator, the cuckoo output against a dense oracle over the
   true pages, the Ludo output against the cuckoo one wherever its map
   matched whole; then 4 sequences released.  The launch counters are
   zeroed just before this phase and read just after, and each of the four
   index and paged kernels must have launched at least once a decode step;
6. hold ``fused_norm_matmul`` against its plain version on the card at the
   shapes of ``tests/test_kernels.py``, a ragged shape (S=7, d=2048,
   F=1000), llama3.2-1b's serve entries (S=8, d=2048, F=2048, 512, 8192,
   bf16), a prefill shape (S=256, F=8192, both types), the edges of the
   kernel's regimes (S = 1, 7, 8, 9, 31, 32, 33, 64; d = 1000; F = 1, 100,
   131, 512, 8192; both types) and of the wgmma regime's plan
   (``FNM_WGMMA_EDGE_SHAPES``), with TF32 off and the tests' tolerances,
   each call twice and bit for bit alike, logging each shape's plan
   (``ops.fused_norm_matmul_plan``: regime, tile, splits); time the serve
   and prefill shapes with CUDA events and ``torch.profiler`` (device time
   a call: every CUDA kernel of the call, each kernel's share logged)
   beside the bound, the plain version and an ``F.rms_norm`` +
   ``torch.matmul`` yardstick (at the prefill shape also by device time),
   each launch on weights outside L2;
7. serve llama3.2-1b at full width: ``Engine(LM(llama3.2-1b), lanes=8,
   max_seq=256)`` with random bf16 weights drawn on the card from the seed
   takes 8 requests (16-64 prompt tokens, 32 greedy new tokens) and runs
   them to the end.  Every request must finish with in-range tokens,
   ``prefill_tokens`` must be the sum of the prompt lengths, and
   ``fused_norm_matmul`` must have launched exactly 5 x 16 times a
   ``decode_step`` call (counters zeroed just before, read just after).
   Then 16 decode steps under ``torch.profiler`` (device busy share, the
   share of device time of all the fused entry's CUDA kernels,
   ``ops.FNM_KERNELS``), and the float32 twin: the same
   weights as float32 on the card and on the CPU, 4 teacher-forced steps of
   the 8 lanes, logits within 1e-3 and the same argmax on every lane;
8. the cached, resizable store: first a 2^14-key
   ``StoreSpec("outback-dir", initial_depth=1)`` store with a 64 KiB CN
   cache, on the card and on the CPU, takes the same stream (zipf Gets with
   repeated absent keys, updates and deletes of hot keys, inserts until a
   table splits on its own, a forced ``begin_split`` with Gets, inserts and
   deletes inside its window): answers, ``meter_total().snapshot()``,
   resize events (less their wall-clock seconds), directory, depths, every
   table's MN image and the cache's whole state must agree exactly.  Then
   ``open_store(StoreSpec("outback-dir", load_factor=0.85,
   cache_budget_bytes=8 * 2^20, params={"initial_depth": 1}))`` over the
   first 2^20 keys of phase 3 serves YCSB-C (2^19 zipf(0.99) Gets) and YCSB-A
   (2^15 ops) through ``submit``/``flush`` at window 1024, every answer
   checked against the host oracle, printing the hit and negative-hit
   rates, Gets/s, window p50/p99, the host µs of the cache's
   ``probe_batch`` and ``observe_batch`` a window and its
   ``memory_bytes()``; both index kernels must launch in every window with
   a cache miss or a write (counters zeroed just before, read just after).
   Then table 0 (about 2^19 live keys) splits: 2^16 Gets before,
   ``begin_split``, 2^16 Gets and 2^12 inserts of new keys in the window
   (those routed to the frozen table come back ``"frozen"``), ``build()``
   (timed), ``finish()``, 2^16 Gets after and a read-back of every insert;
   every cached entry must equal the oracle and no negative entry may hold
   a live key;
9. the comparison baselines and the transport model (``repro_torch.net``):
   (a) for each of ``race``, ``mica``, ``cluster`` and ``dummy`` a 2^14-key
   store at load factor 0.5 on the card and one on the CPU, each with its
   own ``Transport``, through ``open_store(..., batch=BatchPolicy(window=
   1024))``, take the same stream of Gets, updates, inserts and deletes:
   every answer, ``meter_totals().snapshot()``, the traces (doorbell marks
   included) as tuples, the final host images, the device arrays copied
   back and ``simulate(trace, clients=8)`` must be equal; (b) each baseline
   over the first 2^23 of phase 3's keys at the reference's default load
   factors (RACE at 0.69: at 0.7 its build cannot place 2^24 keys), one
   store at a time: YCSB-C (2^19 zipf(0.99) Gets) and YCSB-A
   (2^14 ops, half updates) at window 1024, then 2^12 deletes and Gets of
   the deleted keys, every answer checked (for dummy, which verifies no
   key, against the value at index ``key % n``), printing the build's host
   seconds, Gets/s, window p50/p99, YCSB-A ops/s, the device busy share over
   32 profiled windows, ``max_memory_allocated`` and the meter; (c) each
   scheme's MN step at B = 2^16 over its full-size store, by CUDA events and
   ``torch.profiler`` device time, in µs per op: ``mn_get_batch`` for
   ``mica``, ``cluster`` and ``dummy``, the CN's selection
   (``RaceKVS.cn_select``) for ``race``, and for ``outback`` the MN decode
   (slot gather, ``slot_unpack``, heap gather) over phase 3's store, timed
   before that store is freed; (d) the five kinds at 2^20 keys, each
   recording 2^14 YCSB-C Gets through a window of 1024, replayed with
   ``simulate`` on ``CX6`` at 1, 8 and 64 clients and one MN thread:
   p50/p99 and Mops printed, the replay checked to be deterministic and to
   hold every Get.  The launch counters are zeroed just before this phase
   and read just after; the index kernels must launch once a window of the
   Outback trace;
10. Outback over the mesh (``repro_torch.core.sharded_kvs``) at (1, 1):
   one process is a world of one rank whose group serves card tensors with
   NCCL and CPU ones with gloo.  (a) A 2^14-key ``StoreSpec("sharded",
   params={"num_shards": 1})`` store on the card and one on the CPU, each
   with its own transport, take the same stream of Gets, updates, inserts
   and deletes: answers, meter totals, traces and the re-installed mesh
   state must be equal; then each state's mesh Get (``make_get_fn``) for
   both variants, plain and with a warmed one-replica CN cache, each with
   a transport: every lane, the hit mask, the meter and the trace must be
   equal.  (b) The first 2^20 of phase 3's keys in one ``sharded`` store
   (load factor 0.85, one shard) with a transport: YCSB-C (2^17 zipf(0.99)
   Gets, a window of 1024 a submit) through the adapter, then
   ``mesh_state()`` -> ``place_state`` -> ``make_get_fn`` for each variant
   over the same 2^17 Gets in calls of 1024 and 2^16 lanes, plain and with
   a 128 MiB CN cache warmed on the first 2^15 Gets.  Every answer is
   checked: a lane misses only where its key is an overflow resident (the
   mesh runs no Makeup-Get) and no cache hit answered it, no lane is
   dropped; each call launches ``ludo_lookup`` and ``slot_unpack``; the
   meter counts every Get (two round trips a miss for ``race``).  Printed
   a run: Gets/s, call p50/p99 (host clock, each call synced), ms a call
   by CUDA events, device time, device ops, device busy share and NCCL's
   share of device time a call (``torch.profiler``), the hit rate; and the
   build's host seconds and ``max_memory_allocated``.  The launch counters
   are zeroed just before (b) and read just after;
11. replication, the fault plane and the retry stage
   (``repro_torch.api.replication``, ``repro_torch.net.faults``,
   ``RetryLayer``).  (a) 2^14-key stores on the card and on the CPU, each
   with its own transport, take one stream of 4096 Gets, updates, inserts
   and deletes (window 1024) through five specs: K=2 with a crash of the
   primary (leases at 128), K=1 under the same crash, a generated
   schedule (crash, delay, drop), a partition of CN 0 and MN 1, and
   ``outback-dir`` with ``replicas=3``, ``placement="hrw"``,
   ``placement_k=2`` and a crash of MN 1 before its inserts split tables:
   answers, statuses, each OpResult's attribution, meter snapshots, the
   pipeline's stats, traces, the plane's state and every replica's final
   MN image must be equal.  (b) ``StoreSpec("outback", load_factor=0.85,
   replicas=2)`` over the first 2^20 of phase 3's keys, its primary
   crashing at op
   2^18 + 2^14 for 2^14 ops of the op clock (leases at 4096): 2^18
   zipf(0.99) Gets, then YCSB-A (2^15 ops, half updates) with 2^13 inserts of fresh
   keys spread through it and the crash inside it, then 2^18 recovery
   Gets, all at window 1024 in submission order.  Every Get is checked
   against the latest acknowledged value, every acknowledged update and
   insert is read back after recovery (0 lost), both replicas' MN arrays
   are compared on the card, and the failovers, resyncs, retries and
   backoffs must each be at least 1.  Printed: the two replicas' build
   seconds, Gets/s and window p50/p99/p999 before and after the window,
   YCSB-A ops/s and its chunks of 1024 ops before, through and after the
   window, each resync's seconds and bytes, the recovery counters and
   ``fault_wait_us``, the device busy share over 32 profiled windows and
   ``max_memory_allocated``.  The launch counters are zeroed just before
   (b)'s traffic and read just after.  (c) The reference ``faults``
   suite's stream shape (10 warm Get calls of 64, 40 rounds of 8 inserts
   and a Get, a crash at op 800 for 400 ops, a recovery tail) over 2^20
   keys with a transport, replayed with ``simulate(trace, clients=4,
   replicas=2)``: p50/p99/p999 and the availability curve's fault windows
   (the reference's model of the fabric, not a measurement of the card).
   (d) The same crash at K=1 over 2^18 keys: lanes degrade to
   ``"unavailable"`` with ``found=False``, and after the window every key
   is served.  (e) ``replicas=1`` with the dormant
   ``FaultSchedule(lease_term_ops=0)`` meters and traces byte for byte as
   the plain spec;
12. the telemetry plane (``repro_torch.obs``), the multi-CN cluster
   (``repro_torch.cluster``) and the chaos harness
   (``repro_torch.net.chaos``).  (a) At 2^14 keys, four telemetry-on
   stores (``outback``, a cached ``outback-dir``, ``sharded`` and a K=2
   ``outback`` through a crash) take one stream on the card and on the
   CPU: ``telemetry_rows`` must be equal JSON for JSON, and the same specs
   without telemetry on the card must give the same answers, meters,
   traces, MN images and launch counts; an N=1 ``cluster_of`` must answer,
   meter, trace and end in the MN state of ``open_store``; ``run_chaos``
   at its defaults for seeds 1-3 must pass with the CPU's report.  (b)
   The reference ``obs`` suite's overhead procedure over the first 2^20
   of phase 3's keys: one engine, a stack with
   ``TelemetryHub(TelemetryConfig(window_ops=4096))`` and one without, a
   warm-up rep each, 3 interleaved reps of 2^18 zipf(0.99) Gets (one
   ``submit`` each) with GC outside the clock, the minimum a side:
   Gets/s on and off, ``overhead_frac`` (the suite's criterion < 0.05,
   printed, not gated), ``ops{op=get}`` checked exact, each side's device
   busy share.  (c) ``cluster_of`` the ``cluster`` suite's spec
   (``outback-dir``, load factor 0.85, a 256 KiB cache a CN, initial
   depth 3, telemetry on) over the first 2^20 of phase 3's keys, 4 CNs over
   a 4-MN
   pool: CNs 0-2 start, CN 3 joins at op 2^18, every live CN drives
   zipf(0.9) Gets in batches of 256 (2^17 lanes), each CN updates 2^14/4
   keys other CNs own, CN 1 leaves, and every acknowledged update reads
   back through the survivors (0 lost); every answer checked.  Printed:
   Gets/s in all and per CN, batch p50/p99, hit rates, forward RPCs,
   fenced writes, each handoff's shards and bytes, each CN hub's
   counters, busy share, build seconds, peak memory and
   ``simulate_cluster``'s modelled Mops and p50/p99 (a model, not the
   card).  The launch counters are zeroed just before (c)'s traffic and
   read just after, and both index kernels must have launched.  (d)
   ``run_chaos(seed=3, n_keys=2^16, n_ops=2^16, batch=256,
   telemetry=True)`` on the card must pass;
13. the serving plane (``repro_torch.serve``): (a) card against CPU: one
   generated two-tenant schedule through four front-door policies (the dormant
   pass-through, singleflight, admission with a token bucket and telemetry, a
   K=1 crash that degrades lanes) over an 8000-key store with a transport:
   records, stats, lane arrivals, meters, traces, MN images, hub counters and
   the ``simulate_open`` replay must be equal, and direct submits on the card
   must meter, trace and leave the MN images as the pass-through door did; a
   ``KVSessionStore`` park/get/shrink/delete stream: answers, meters, MN images
   and the cache's state equal; the reduced rwkv6 in float32: 6 decode steps
   and a prefill within 1e-5.  (b) The slo suite's timing store (``outback``,
   load factor 0.85, window 512, a transport) over the first 2^20 of phase 3's
   keys: the knee from the suite's capacity probe, then 2^17 offers of its
   singleflight, isolation and acked-writes streams through ``FrontDoor.run``:
   every answer held against a host oracle of the latest acknowledged values,
   every acknowledged write read back (0 lost), no refused update applied;
   printed: offers/s (host clock), outcome counts, the share of Gets
   singleflight saved, windows, device ops a window and busy share over a
   profiled stretch, and the modelled answered Mops and p50/p99/p999 from
   ``simulate_open`` (the reference's model of the fabric, not the card).  The
   launch counters are zeroed just before the three streams and read just
   after.  (c) llama3.2-1b at its published widths with random bf16 weights in
   ``Engine(lanes=4, max_seq=8,
   session_store=KVSessionStore(cn_cache_budget_bytes=256 KiB))``: a few steps,
   then a lane parks, resumes, parks and resumes again (each timed), its state
   equal bit for bit to the parked state each time, its length kept, CN cache
   hits rising on the second resume; every request finishes and the blob is
   reclaimed; printed: park and resume ms, chunk keys a park, §4.4 splits,
   launches (counters zeroed before the steps).  (d) rwkv6-1.6b at its
   published widths with random bf16 weights: 8 requests through
   ``Engine(lanes=8)`` with a lane parked and resumed in process; tokens/s,
   engine-step p50/p99, the device busy share over profiled decode steps; a
   lane's 12,779,524 B blob refused by ``KVSessionStore.put``.

14. the training path.  (a) ``fused_norm_matmul_bwd`` against its plain
   version at the test shapes, the edges, a ragged S = 7 x d = 2048 and
   llama3.2-1b's training entries (S = 2048, d = 2048, F = 2048, 512 and
   8192, bf16 and float32), two calls bit for bit alike; each training
   entry timed (events, device by kernel, with dN's product) beside its
   bound, the plain version and the library's backward (``F.rms_norm`` +
   ``torch.matmul`` through ``torch.autograd.grad``); then row 5 at the
   same bf16 entries (``FNM_TRAIN_SHAPES``, the forward of (c)), checked
   and timed beside the library's ``rms_norm`` + ``matmul`` like for like
   by device time.  (b) One float32
   ``make_train_step`` step of llama3.2-1b at full width with 2 layers and
   of the reduced rwkv6-1.6b, llava-next-mistral-7b, mixtral-8x22b and
   deepseek-v3-671b (row 6 and the MoE aux loss), card against CPU (loss,
   gnorm, every first moment and parameter); a checkpoint restart on the
   card at llama's size, replayed bit for bit.  (c) llama3.2-1b at its
   published widths with random bf16 weights: one functional and one
   in-place step (``make_train_step(..., inplace=True)``, the reference's
   donated state) from fresh states of the seed, each one's peak
   ``max_memory_allocated`` above the memory allocated before it, the
   in-place peak below the functional one by at least the state's m and v
   bytes, the two states after the step equal bit for bit; then 8
   in-place steps of 4 x 512 ``SyntheticLM`` tokens from the seed: the
   loss finite and below its first value, gnorm finite; printed: step
   p50/p99, tokens/s, ``max_memory_allocated``, the device busy share over
   2 profiled steps, and the launches of both fused kernels a step (the
   counters zeroed just before the 8 steps and read just after).  (d)
   qwen3-4b at its published widths and depth (36 layers, d 2560, vocab
   151,936) with random bf16 weights: rows 5 and 6 against their plain
   versions at its training entries (S = 2048, d = 2560, F = 4096, 1024
   and 9728), timed beside their bounds and the library's forward and
   backward, like for like by device time; then 4 in-place steps of 4 x 512
   ``SyntheticLM`` tokens with ``remat="block"`` and one profiled step: the
   state's bytes and ``max_memory_allocated`` beside the card's memory,
   the first step and the p50 of the rest, tokens/s, the busy share, the
   launches of rows 5 and 6 a step (exactly the program's), every loss
   finite.

15. the vlm, MoE and MLA families.  ``fused_norm_matmul`` against its plain
   version at the (d, F) pairs these configs launch (``FAMILY_FNM_PAIRS``:
   d = 4096, 6144, 7168 and 1536), S = 8 and 256, two calls bit for bit,
   and timed at S = 8.  Then (a) llava-next-mistral-7b at its published
   widths and 32 layers, (b) mixtral-8x22b at its published widths cut to
   8 layers, (c) deepseek-v3-671b at its published widths cut to its 3
   dense layers and its first MoE layer, with the MTP block, each with
   random bf16 weights drawn on the card in slices: parameters, bytes,
   init seconds and peak memory; 4 requests through ``Engine(lanes=4)``
   (the launch counters zeroed just before the run and read just after,
   ``fused_norm_matmul`` launched as often a decode_step call as the
   program implies: 5 a llava layer, 3 a mixtral layer, 5 a deepseek
   layer), decode-step p50/p99, tokens/s; 8 profiled decode steps (busy
   share, device ops a step); llava's ``LM.prefill`` of a prompt behind
   576 seeded patch embeddings; a float32 card-vs-CPU twin (llava at full
   width with 2 layers, the others reduced: decode steps and a prefill,
   with patches for llava).  Last, a bf16 checkpoint restart of the
   reduced deepseek on the card replays bit for bit.
16. the hybrid and encdec families.  ``fused_norm_matmul`` against its
   plain version at the (d, F) pairs these configs add
   (``HYBRID_FNM_PAIRS``: jamba's mamba ``w_in``, whisper's q / k / v /
   cq and its MLP), S = 8 and 256, and whisper's encoder rows (S = 4 x
   1500, no multiple of any tile), two calls bit for bit; timed at S = 8.
   Then (a) jamba-v0.1-52b at its published widths cut to HYBRID_LAYERS of
   its 32 layers and (b) whisper-large-v3 whole (32 encoder and 32
   decoder layers), random bf16 weights drawn on the card: 4 requests
   through ``Engine(lanes=4)`` (``fused_norm_matmul`` launched as often a
   decode_step call as the program implies: 18 a jamba period, 6 a
   whisper decoder layer; whisper on the zero encoder stub, as the
   reference's engine), decode-step p50/p99, tokens/s, 8 profiled steps;
   jamba's ``LM.prefill`` of 16 tokens (the mamba scan on the card);
   whisper's ``LM.prefill`` over frames of (2, 1500, 1280) (its encoder:
   5 fused launches a layer), its encoder timed alone, then 4
   teacher-forced decode steps on that encoder output (real
   cross-attention); a float32 card-vs-CPU twin of each (jamba reduced;
   whisper at full width with 2 + 2 layers and 1500 frames, decode given
   its encoder output).  The reduced jamba and whisper also take phase 14
   (b)'s float32 training step.
17. tensor parallelism over a mesh of ranks (``launch/mesh.py``): two rank
   processes (``tools/tp_rank.py``) in one world on the one card, whose
   process group serves card tensors with gloo (NCCL refuses two ranks on
   one device; the mesh says so and takes ``ppermute`` through
   ``all_gather``, gloo's ``send`` of a card tensor aborting).
   ``fused_norm_matmul`` against its plain version at the tp = 2 shard
   shapes (``TP_FNM_PAIRS``, S = 4 and 8; whisper's prefill rows,
   ``TP_PREFILL_SHAPES``), timed at S = 4.  (a) The probe:
   ``all_reduce``, ``all_gather``, ``send``/``recv`` of bf16, float32 and
   int8 card tensors (the first two must work) and a 40 KB
   ``all_reduce``'s host µs.  (b) qwen2.5-14b at tp = 2, 24 of its 48
   layers (about 7.7 GB of bf16 shards a rank, drawn on the card from the
   seed): 4 requests
   of 1-3 prompt tokens and 8 new ones (one wave)
   through ``Engine(lanes=4, max_seq=64)``, both ranks' tokens equal, row
   5 at exactly the shard shapes, decode-step p50/p99, tokens/s, 8
   profiled steps, the mesh's collectives a call (calls, bytes, host
   time), peak memory; (c) its float32 twin at 2 layers, tp = 2 against
   tp = 1 within 1e-4 and the same argmax; (d) mixtral-8x22b cut to 4
   layers through ``moe_spmd``, served likewise, and its float32 twin at 2
   layers (the same routing and the same bins, so the same dropped picks);
   then deepseek-v3-671b (its 3 dense layers and one MoE layer: MLA by
   heads, ``moe_spmd`` with sigmoid scores and a shared expert),
   jamba-v0.1-52b (one 8-layer period: mamba by channels, ``w_in``'s
   halves exchanged), rwkv6-1.6b (12 of 24 layers) and whisper-large-v3
   (16 of 32 decoder layers, its cross-attention by heads; then a prefill
   over (2, 1500, 1280) frames through the sharded encoder, all 32
   layers), served likewise, each with a float32
   twin (2 layers; the MoE twins with 16 experts, jamba's one "ma"
   period); mixtral again with ``moe_gather_decode`` and its twin;
   llama3.2-1b whole over a (2, 1) mesh (8 lanes, 4 a rank; no
   collective) and its float32 twin on the same lanes; every served
   config's row-5 launches a call exactly the program's, at shapes checked
   here; (e) llama3.2-1b at its published widths trained 2 in-place steps
   (``make_train_step(..., inplace=True)``, each rank's peak memory over
   its mesh's steps recorded) of 2 x 512 tokens a rank over (1, 2) (tp,
   vocab-parallel cross entropy; its first
   step held to the plain step on the same batch: the loss within 1e-2,
   the embedding's, a wq's and a wo's gradient and update, gathered
   whole, at cosines of at least 0.99 and above 0.8), (2, 1) (ZeRO-1, 8
   of the 16 layers: the moments' halves, the parameters equal on both
   ranks after the gather) and (2, 1, 1) (the int8 pod exchange, 8 of the
   16 layers: its loss within 1e-3 of the plain step's on the global batch,
   wq's update cosine to the plain step's above 0.8, ``ef`` nonzero, int8
   bytes counted on ``pod``; and at the reference's own test's size, its
   first leaf's update cosine above 0.8), and a float32 twin at 2
   layers: the (2, 1) step equals the plain step within 1e-5, in place
   and functional bit for bit.  Rows 5
   and 6 are held to their plain versions at the steps' shapes
   (``TP_TRAIN_SHAPES``, S = 1024), which the steps must run at; each
   mesh's launches are counted over its own steps alone and must be the
   program's (5 entries a layer: row 5 twice, for the remat, row 6
   once).  (f) One float32 (1, 2) train step of each of the reduced
   deepseek, jamba, rwkv6 and whisper against the plain step on rank 0
   (loss, gradients and updates within 1e-5), as many row-5 and row-6
   launches as the plain step; rows 5 and 6 are then held to their plain
   versions at the shapes those steps recorded.  The path's launches of
   both ranks are summed.
18. the sequence splits of the decode cache: the world of two ranks again
   (``tools/tp_rank.py seq``).  (a) jamba-v0.1-52b at its published
   widths, one 8-layer period (mamba, MoE and its attention layer, about
   25 GB of bf16 a rank), over ``(2, 1)``: a batch-1 cache of 524,288
   tokens (``long_500k``), the attention layer's sequence split over
   ``data`` (1.07 GB of k and v a rank), filled from the seed to 524,272
   and taken in by ``Engine.resume``, then 8 tokens decoded through
   ``Engine(lanes=1, max_seq=524288)``, both ranks' tokens equal;
   (b) llama3.2-1b whole at ``(1, 2)`` under ``cache_seq_shard``: 4 lanes
   of 32,768 (2.15 GB of cache a rank) filled to 32760, 20000, 9000 and
   100 (no live position on rank 1), decoded likewise.  Each prints
   decode-step p50/p99, tokens/s, profiled steps with the busy share, the
   collectives a call (calls, bytes, host time), the peak memory a rank
   and row 5's launches a call, which must be the program's; row 5 is
   then held to its plain version at every (S, d, F) the two runs
   recorded.  (c) float32 twins at 2 layers, each split decode against
   the same model and seeded cache unsplit on rank 0 within 1e-4 and with
   the same argmax: (a) and (b), mixtral-8x22b at batch 1 over ``(2, 1)``
   with its 4096-slot rolling window filled to 524,280 (the decode
   crosses from rank 1's slots to rank 0's), and deepseek-v3-671b's MLA
   under ``cache_seq_shard`` at ``(1, 2)`` (the MoE twins at 16 experts).
19. the compile-time tools (``launch/{dryrun,hlo_analysis,roofline}.py``).
   (a) On the host, the dry run of six cells at the ``(16, 16)``
   production mesh, one rank's program traced on ``meta`` (with its
   neighbours along each axis, whose collectives must agree), in a pool
   of ``DRYRUN_JOBS`` processes started before phase 1 (:class:`Background`)
   and read here: llama3.2-1b ``train_4k``, jamba-v0.1-52b
   ``long_500k``, llama3.2-1b ``decode_32k`` under ``seqcache``,
   mixtral-8x22b ``decode_32k`` under ``moegather``, and qwen2.5-14b
   ``long_500k``, which must be skipped (full attention); each prints its
   argument bytes, roofline terms on the H100's constants and kernel
   calls.  (b) One llama3.2-1b train step at phase 14 (c)'s shape (B = 4
   x 512, bf16, published widths) and one decode step at phase 7's (8
   lanes, max_seq 256), each built by the dry run's builders at mesh
   ``(1, 1)``: counted once live on the card (a world of this one
   process) and once traced on ``meta``.  Their FLOPs, bytes,
   bytes_upper and kernel calls must be equal, and the kernel calls must
   equal the launch counters' delta on the card.  Each prints the
   roofline step time and ``model_flops`` beside the steady-state step
   time on the card (CUDA events over ``COUNT_TIMED_STEPS`` steps after a
   warm one, and the profiled busy time) and the model-FLOPs share of the
   peak.  (c) The examples' counterparts on the card
   (``examples/quickstart_torch.py`` and ``examples/serve_kvs_torch.py``
   with ``--device cuda``, in process): their launches (``ludo_lookup``
   and ``slot_unpack``; ``fused_norm_matmul``, ``paged_attention`` and
   ``cuckoo_paged_attention``) are counted, and serve_kvs's paged outputs
   must match.  The dry run's cells add qwen2.5-14b ``decode_32k``: its
   gqa cache splits ``head_dim`` over ``model`` (3,221,225,472 B a rank)
   and its serve step writes the cache in place.
20. the gqa decode cache split over ``head_dim``: a world of sixteen
   ranks on the one card over gloo at ``(1, 16)`` (``tools/tp_rank.py
   hd``).  llama3.2-1b at its published widths and depth in bf16: 8 kv
   heads do not split over 16, so each rank holds head_dim 64 / 16 = 4
   columns of every kv head, the reference's spec, and ``decode_32k``'s
   share of one rank of the ``(16, 16)`` production mesh: 8 lanes of
   32,768 positions from the seed (536,870,912 B of cache a rank), at
   lengths spread over the range.  It decodes ``HD_STEPS`` greedy steps
   in place (``decode_step(inplace=True)``), each summing the partial
   scores over ``model`` (a psum of 8 x 32 x 32768 float32 a layer), and
   prints the first call apart, then the step p50/p99, tokens/s, the
   cache's bytes and the peak memory a rank, and the collectives a call
   (calls, bytes by op, host ms); every rank's tokens must be equal and
   row 5's launches the program's.  Row 5 is then held to its plain
   version at the (S, d, F) the ranks recorded.  The float32 twin: the
   same world at 2 layers and a cut cache (``HD_TWIN_*`` of
   ``tools/tp_rank.py``),
   whose rank 0 logits of each teacher-forced step must equal, within
   1e-4 and with the same argmax, the same model and seeded cache whole at
   ``(1, 1)``, run here in the parent.  The old layout could not hold this
   world on one card (16 x 8.59 GB of cache).  The sixteen ranks start at
   the beginning of phase 19 and import there, gated: they touch neither
   the card nor the world until phase 20 releases them.

The line before the last is the kernels' JSON record (all six kernels);
the last line is ``{"ok": true, "device": {...}}``.  Without a card the
script exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The sizes of the run: 2^24 keys of 8 bytes with 8-byte values, 2^20
# YCSB-C Gets, 2^18 YCSB-A ops, 2^14 inserts and 2^14 deletes; data from SEED.
N_KEYS_LOG2 = 24
# The later phases' full-size stores (8, 10, 11 (b), 12 (b), 12 (c) and
# 13 (b); phase 9 takes BASE_KEYS_LOG2) take the first 2^LATER_KEYS_LOG2 of
# these keys, to keep the whole run inside its 1200 s on a slow host: on
# one H100 (NVIDIA H100 80GB HBM3, 700 W) each of them spent 40-125 s in
# its host build at 2^24 keys, and the same tree at 2^23 took 990.0 s on
# one host and 1306.7 s on another (the host's Python, not the card, sets
# the time).  Cut from 2^22 to 2^20 when phase 17 came: at 2^22 these
# builds took about 131 s of a 1066.0 s run, and at 2^21 the whole script
# with phase 17 ran past 1200 s on a slow host.
LATER_KEYS_LOG2 = 20
# and the later stores' YCSB-A streams are a quarter of phase 3's: at
# 4700-18000 ops/s a 2^18-op stream took 15-56 s a store on that machine's
# host, and the whole run with phase 14 took 913.4-1093.7 s at 2^17 ops on
# two hosts, each with one NVIDIA H100 80GB HBM3 at 700 W
LATER_YCSB_A_LOG2 = 14  # 2^16 until phase 17 came, 2^15 until phase 20
# phase 8's YCSB-C Gets (2^N_GETS_LOG2 until phase 17 came: about 19 s at
# the cached store's 56,000 Gets/s; 2^19 until phase 20 came: 14.5 s at
# 36,219.5 Gets/s on a slow host)
DIR_GETS_LOG2 = 18
N_GETS_LOG2 = 20
N_YCSB_A_LOG2 = 18
N_WRITES_LOG2 = 14
SEED = 0
WINDOW = 1024
# At B=2^20 the timed calls cycle over this many input sets, 64 MB or more
# in all, so each launch finds its inputs outside the 50 MB L2 as a fresh
# batch would; the CN arrays (phase 2 prints their size) stay L2-resident,
# as on the serve path.
COLD_SETS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# torch.profiler traces taken for one device time, at most, until one holds
# every kernel named (a trace late in a long run can hold none of them; 3
# until three in a row held none of row 6's kernels in phase 14 (a))
TRACE_TRIES = 6
# H100 SXM peak float32 rate outside the tensor cores (data sheet); the
# paged kernels do their products as float32 FMAs.
F32_FLOPS_PER_S = 67e12
# H100 SXM integer rates: 132 SMs at 1.98 GHz (data sheet boost clock).
# Each SM dispatches one warp instruction a clock from each of its 4
# schedulers, 128 lanes in all, and each integer pipe takes 64 lanes a
# clock: the ALU pipe (LOP3, SHF, IADD3, ISETP, SEL, LEA, ...) and the FMA
# pipe's integer multiplies (IMAD, IMUL) (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0).  An
# instruction counts once against the pipe it runs on.
INT_PIPE_OPS_PER_S = 132 * 64 * 1.98e9
SCHEDULER_OPS_PER_S = 132 * 128 * 1.98e9
# Integer operations a key (a slot) that the function needs, each counted
# once against the pipe it issues on: the ALU pipe (LOP3, SHF, SEL) or the
# FMA pipe's integer multiplies (IMAD and its WIDE and HI forms).  Moves,
# the thread index, the i < n guard and the addresses of the key loads and
# output stores are work of the kernel, not of the function, and are not
# counted; phase 2 prints the built kernels' SASS opcodes beside this.
# ludo_lookup, by part, (ALU, FMA):
LUDO_OPS = {
    # fmix32 is three shift-xors (SHF + LOP3) and two multiplies, hash64
    # three fmix32 and two multiplies more: 18 ALU and 8 FMA.  A hash's
    # first shift-xor folds into one LOP3 with lo ^ lo >> 16, its second
    # into a SHF and a LOP3 with hi ^ hi >> 16 (made once a key: 4 ALU).
    "four seeded hashes": (4 * 17 + 4, 4 * 8),
    # m * a mod 2^64 (IMAD.WIDE.U32 + IMAD), then the high word of its
    # halves times d (IMAD.HI.U32, IMAD.WIDE.U32 adding it)
    "four multiply-high modulos": (0, 4 * 4),
    # ia >> 5, ib >> 5, each word >> its bit, their xor & 1 (one LOP3)
    "two Othello bit probes": (5, 0),
    "bucket select": (1, 0),
    # the two words' and the seed's addresses (IMAD.WIDE.U32 each)
    "gather addressing": (0, 3),
    # seed * C1, hi * C2, their xor with lo, fmix32 (the & 3 folds into
    # its last LOP3)
    "slot hash": (1 + 6, 2 + 2),
}
LUDO_OPS_PER_KEY = dict(alu=sum(a for a, _ in LUDO_OPS.values()),
                        fma=sum(f for _, f in LUDO_OPS.values()))
# slot_unpack: hi >> 31, (hi >> 25) & 0x3F, (hi >> 16) & 0x1FF
UNPACK_OPS_PER_SLOT = dict(alu=5, fma=0)
# SASS opcodes by the pipe they issue on (the rest: memory, uniform
# datapath, control)
SASS_ALU = ("LOP3", "SHF", "IADD3", "ISETP", "SEL", "LEA", "PRMT", "IABS",
            "IMNMX", "FLO", "POPC", "BMSK", "SGXT", "MOV", "ICMP", "PLOP3",
            "P2R", "R2P", "VIADD", "IADDC")
SASS_FMA = ("IMAD", "IMUL", "IDP")
SASS_XU = ("I2F", "F2I", "MUFU", "I2I", "F2F", "FRND")
# ludo_lookup's timed batches: one key, the serve window, a bulk batch
LUDO_TIMED = (1, WINDOW, 1 << 20)

# The paged decode path at the attention width of llama3.2-1b
# (src/repro/configs/llama3_2_1b.py: 32 query heads over 8 KV heads, head
# width 64), with a bf16 page pool of 2^17 pages of 16 tokens: 2 GiB for K
# and 2 GiB for V, one layer's pool for 2M tokens.  N_SEQS sequences of
# SEQ_TOKENS * (i + 1) tokens (3908 to 31264, ragged last pages), about
# 8.8k pages, 6.7% of the pool: under the 36% at which the
# sentinel-seeded index's overflow cache breaches.  Each sequence then
# takes DECODE_STEPS decode steps, and N_RELEASE sequences are released at
# the end.  32 sequences of 977 * (i + 1) tokens (32.2k pages) until phase
# 19 came: the Ludo appends took 77 s of a 1150.2 s run on a slow host
# (NVIDIA H100 80GB HBM3, 700 W); 16 of 1954 * (i + 1) (16.6k pages) until
# phase 20 came: 3006.6 us a page, 50 s, on a slower host; the longest
# sequence, and so the kernels' timed shape, is the same.
PAGE_POOL_LOG2 = 17
N_KV, GROUP, HEAD_DIM, PAGE_SIZE = 8, 4, 64, 16
N_SEQS = 8
SEQ_TOKENS = 3908
DECODE_STEPS = 4
N_RELEASE = 4
# The page-map length of the longest sequence, the kernels' timed shape.
SERVE_PAGES = -(-SEQ_TOKENS * N_SEQS // PAGE_SIZE)  # 1954
# The paged kernels' shapes from tests/test_torch_kernels.py:
# (n_kv, g, d, ps, L, seq_len, dtype), ragged seq_len and bf16 among them.
PAGED_TEST_SHAPES = [(2, 4, 64, 16, 4, 64, "float32"),
                     (2, 4, 64, 16, 4, 49, "float32"),
                     (4, 2, 128, 32, 8, 250, "float32"),
                     (1, 8, 64, 16, 2, 32, "bfloat16")]
# The split pass's edges, in the same layout: the kernels run a block over
# a KV head and a run of pages (ops.paged_split_plan: runs of PAGED_RUN = 16
# pages at these sizes on 132 SMs, which the phase checks).  L = 1 (one
# run); a last run of one page; seq_len in the first page of the last run;
# seq_len in the first run, so that 19 whole runs lie past it; float32, and
# d = 128, at L in the hundreds; a group of 5 queries (two query tiles of
# the kernels' 4); 64-token float32 pages of d = 128, whose ring holds 3
# loop steps, not 4.  Every cuckoo map's first step of a run is the
# unselected candidate.
PAGED_RUN = 16
PAGED_EDGE_SHAPES = [
    (8, 4, 64, 16, 1, 9, "bfloat16"),
    (8, 4, 64, 16, 20 * PAGED_RUN + 1, (20 * PAGED_RUN + 1) * 16 - 3,
     "bfloat16"),
    (8, 4, 64, 16, 20 * PAGED_RUN, 19 * PAGED_RUN * 16 + 5, "bfloat16"),
    (8, 4, 64, 16, 20 * PAGED_RUN, 5, "bfloat16"),
    (8, 4, 64, 16, 400, 400 * 16 - 8, "float32"),
    (8, 4, 128, 16, 257, 257 * 16 - 1, "bfloat16"),
    (4, 2, 128, 32, 300, 300 * 32 - 17, "float32"),
    (2, 5, 64, 16, 33, 33 * 16 - 20, "float32"),
    (1, 4, 128, 64, 40, 40 * 64 - 3, "float32")]
# The tests' tolerance (rtol and atol): both sides compute in float32 from
# the same values and differ only in the order of their sums.
PAGED_TOL = 1e-5

# Phase 6: fused_norm_matmul (S, d, F, dtype), checked against its plain
# version: the shapes of tests/test_kernels.py, a ragged one, the serve
# entries of llama3.2-1b (S = 8 lanes, d = 2048: F = 2048 for q, 512 for k
# and v, 8192 for the SwiGLU gate and up) and a prefill shape (timed, in
# bf16), the prefill shape in float32 (the FMA tile).  Then the edges of the
# kernel's regimes (ops.fused_norm_matmul_plan): S across the decode /
# prefill boundary at 32 and the row groups and n8 tiles of 8, F of one
# column, of ragged column tiles and not whole 16-byte chunks (100 and 131
# columns), and d = 1000, not a multiple of any K-split.
# Tolerances (rtol and atol) of tests/test_kernels.py:138.
FNM_TIMED_SHAPES = [(8, 2048, 2048, "bfloat16"), (8, 2048, 512, "bfloat16"),
                    (8, 2048, 8192, "bfloat16"), (256, 2048, 8192, "bfloat16")]
FNM_EDGE_S = (1, 7, 8, 9, 31, 32, 33, 64)
FNM_EDGE_F = (1, 100, 131, 512, 8192)
FNM_EDGE_D = 1000
FNM_EDGE_SHAPES = [(S, FNM_EDGE_D, F, dt) for dt in ("float32", "bfloat16")
                   for S in FNM_EDGE_S for F in FNM_EDGE_F]
# The edges of the wgmma regime's plan (ops.fused_norm_matmul_plan): both
# tile widths, a cluster whose partner row tile lies wholly (S = 300: three
# row tiles) or almost wholly (S = 2049) past S, a ragged last column tile
# (F = 9736: 8 columns), d off 64 (1000, 2568: A's zero columns and w's
# rows past d), S = 129, two row tiles of one row and 128, and d = 1004,
# whose rows are not whole 16-byte chunks.
FNM_WGMMA_EDGE_SHAPES = [(2049, 1000, 1024, "bfloat16"),
                         (2049, 2568, 9736, "bfloat16"),
                         (129, 2560, 1024, "bfloat16"),
                         (300, 1000, 9736, "bfloat16"),
                         (256, 2568, 2048, "bfloat16"),
                         (300, 1004, 1024, "bfloat16")]
FNM_CHECK_SHAPES = [(256, 512, 1024, "float32"), (512, 256, 512, "float32"),
                    (128, 1024, 512, "bfloat16"), (7, 2048, 1000, "float32"),
                    (7, 2048, 1000, "bfloat16"), *FNM_TIMED_SHAPES,
                    (256, 2048, 8192, "float32"), *FNM_EDGE_SHAPES,
                    *FNM_WGMMA_EDGE_SHAPES]
FNM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# H100 SXM dense bf16 tensor-core peak (data sheet), the operation bound of
# a bf16 product; a float32 product is held to F32_FLOPS_PER_S, since the
# tensor cores' TF32 is another type.
BF16_TC_FLOPS_PER_S = 989e12
# timed launches cycle over weight sets of at least this many bytes in all,
# twice the 50 MB L2, so each launch finds its weights in HBM
COLD_BYTES = 100 << 20

# Phase 7: Engine(LM(llama3.2-1b)) at full width (src/repro_torch/configs/
# llama3_2_1b.py: 16 layers, d_model 2048, 32 query heads over 8 KV heads of
# 64, d_ff 8192, vocab 128256, tied embeddings), random bf16 weights from
# SEED; 8 requests of 16-64 prompt tokens and 32 greedy new tokens
# through 8 lanes of 256 positions.
LANES, MAX_SEQ = 8, 256
N_REQUESTS, MAX_NEW = 8, 32  # 16 requests until phase 17 came
PROMPT_MIN, PROMPT_MAX = 16, 64
D_MODEL = 2048
# the fused entries of one layer: wq, wk, wv, w_gate, w_up
LAYER_ENTRY_FS = (2048, 512, 512, 8192, 8192)
ENTRIES_PER_LAYER = len(LAYER_ENTRY_FS)
PROFILED_STEPS = 16
# The float32 twin: card against CPU, 4 teacher-forced steps.  Both sides
# compute in float32 (TF32 off) and differ in the order of their sums over
# d = 2048 and d_ff = 8192 through 16 layers: about 1e-5 on logits of order
# 1; the tolerance leaves 100x room.
TWIN_STEPS = 4
TWIN_TOL = 1e-3

# Phase 8: the cached, resizable store.  StoreSpec("outback-dir") over the
# phase-3 keys with the reference's own settings: load factor 0.85 (its
# fig17_resize, benchmarks/paper_figs.py) and a CN cache of 8 bytes a key
# (its zipf_cache): 2^23 bytes for the first 2^20 keys (LATER_KEYS_LOG2),
# in two tables (initial_depth 1).  YCSB-C 2^DIR_GETS_LOG2 zipf(0.99) Gets and YCSB-A
# 2^LATER_YCSB_A_LOG2 ops at window 1024, then a split of table 0 (about
# 2^19 live keys)
# with 2^DIR_SPLIT_GETS_LOG2 Gets and 2^DIR_SPLIT_INSERTS_LOG2 inserts of new
# keys inside its window, and as many Gets before and after it.  The
# agreement step runs a 2^14-key store with a 64 KiB cache on the card and
# on the CPU.
DIR_LOAD_FACTOR = 0.85
DIR_CACHE_BYTES_PER_KEY = 8
DIR_SPLIT_GETS_LOG2 = 16
DIR_SPLIT_INSERTS_LOG2 = 12
DIR_AGREE_KEYS_LOG2 = 14
DIR_AGREE_CACHE = 64 << 10
# Phase 9: the four baselines at the reference's default load factors (MICA
# 0.7, Cluster 0.8) over the first 2^BASE_KEYS_LOG2 of phase 3's keys, but
# RACE at 0.69: at its default 0.7 the reference's 2-choice build cannot
# place phase 3's 2^24 keys ("RACE table full"), and 0.69 is the largest
# hundredth at which it can, at 2^24 and 2^23 keys but not at 2^22 (so
# this phase keeps 2^23, where the other later stores take 2^20); a
# 2^14-key agreement store at load factor 0.5 (the stream's inserts stay
# below MICA's displacement bound); the MN step timed at B = 2^16; the
# modelled comparison at 2^20 keys and 2^16 recorded Gets.
BASELINE_KINDS = ("race", "mica", "cluster", "dummy")
BASE_KEYS_LOG2 = 23
BASE_LOAD_FACTOR = {"race": 0.69}
BASE_AGREE_KEYS_LOG2 = 14
BASE_AGREE_LOAD = 0.5
BASE_DELETES_LOG2 = 12
# each baseline's YCSB-C Gets (2^N_GETS_LOG2 until qwen3-4b's training came
# to phase 14, 2^19 until row 5's training entries were timed there), and
# the build keys its count of keys past the batch rules scans (all
# 2^BASE_KEYS_LOG2 until then: 9.8, 14.5 and 5.3 s of host numpy for RACE,
# MICA and Cluster on one host; their counts were 13, 12490 and 552)
BASE_GETS_LOG2 = 18
BASE_SCAN_LOG2 = 20
MN_BATCH = 1 << 16
SIM_KEYS_LOG2 = 20
# 2^16 until phase 20 came, 2^15 until phase 14 (d) came (the replays took
# 9.1 of the comparison's 16.1 s on one host)
SIM_GETS_LOG2 = 14
SIM_CLIENTS = (1, 8, 64)
# Phase 10: the mesh at (1, 1) on the one card.  The agreement store has 2^14
# keys; the full-size store takes the first 2^LATER_KEYS_LOG2 of phase 3's keys
# at the registry's load factor 0.85.  A mesh call takes the serve window or
# the MN step's batch of lanes; MESH_PROFILED of its calls are profiled.  The
# cached runs probe a 128 MiB CN cache (8 bytes a key, phase 8's budget) warmed
# on the stream's first 2^MESH_WARM_LOG2 Gets.
MESH_AGREE_KEYS_LOG2 = 14
MESH_VARIANTS = ("outback", "race")
MESH_RTS = {"outback": 1, "race": 2}
MESH_BATCHES = (WINDOW, MN_BATCH)
MESH_PROFILED = {WINDOW: 32, MN_BATCH: 4}
MESH_CACHE_BYTES = 128 << 20
# the mesh runs' zipf Gets (2^20 until phase 17 came: the 1024-lane calls
# took about 25 s of the phase) and the cache's warm-up
MESH_GETS_LOG2 = 17
MESH_WARM_LOG2 = 15
# phase 11: the failure plane.  The agreement runs 2^14 keys through five
# specs; the full-size run is the reference faults suite's setting (load
# factor 0.85, benchmarks/faults_bench.py:113) over phase 3's keys at K=2,
# a crash of the primary a quarter into a YCSB-A stream on the op clock
# (2^15 ops and 2^13 inserts, cut from 2^19 to keep the run inside its
# limit: it ran at 5400-9000 ops/s), over the first 2^LATER_KEYS_LOG2 of
# phase 3's keys;
# (c)-(e) take 2^FAULT_SMALL_KEYS_LOG2 keys and the suite's own stream shape
# (faults_bench.py:53-58)
FAULT_AGREE_KEYS_LOG2 = 14
FAULT_AGREE_OPS_LOG2 = 12
FAULT_LOAD_FACTOR = 0.85
FAULT_N_GETS_LOG2 = 17  # 2^18 until phase 20 came
FAULT_N_A_LOG2 = 14  # 2^16 until phase 17 came, 2^15 until phase 20
FAULT_N_INS_LOG2 = 12  # 2^13 until phase 20 came
FAULT_CRASH_AT = (1 << FAULT_N_GETS_LOG2) + (1 << (FAULT_N_A_LOG2 - 2))
FAULT_CRASH_OPS = 1 << (FAULT_N_A_LOG2 - 2)
FAULT_LEASE_OPS = 4096
FAULT_SMALL_KEYS_LOG2 = 18  # 2^20 until phase 17 came
FAULT_WARM_CALLS = 10
FAULT_GET_LANES = 64
FAULT_ROUNDS = 40
FAULT_ROUND_LANES = 8
FAULT_TAIL_AT = 800
FAULT_TAIL_OPS = 400
# phase 12: the telemetry plane, the multi-CN cluster and the chaos
# harness.  The agreement runs 2^14 keys; the telemetry cost is the
# reference obs suite's procedure (benchmarks/obs_bench.py:66-131: its
# spec, TelemetryConfig(window_ops=4096), a warm-up rep a side, 5
# interleaved reps, GC outside the clock, the minimum a side) over phase
# 3's first 2^LATER_KEYS_LOG2 keys (cut from 2^24: the build is most of the
# part's time, and the Gets' host path is the same); the cluster is the cluster
# suite's spec (benchmarks/cluster_bench.py:63-65: outback-dir, load
# factor 0.85, a 256 KiB cache a CN, initial depth 3) with its zipf(0.9)
# skew and batch of 256 over the first 2^LATER_KEYS_LOG2 of phase 3's
# keys, 4 CNs over a 4-MN pool, CN
# 3 joining and CN 1 leaving, 2^17 Get lanes (cut from 2^20, to 2^19 and
# then to 2^17 when phase 17 came, to keep the whole run well inside its
# limit); the large chaos run is run_chaos's
# own harness at 2^16 keys and 2^16 ops (cut from 2^18 for the limit)
OBS_AGREE_KEYS_LOG2 = 14
OBS_AGREE_OPS_LOG2 = 11  # 2^12 until phase 17 came
OBS_KEYS_LOG2 = LATER_KEYS_LOG2
OBS_WINDOW_OPS = 4096
OBS_GETS_LOG2 = 18
OBS_REPS = 3  # 5 until phase 17 came
OBS_PROFILED_WINDOWS = 32
CLUSTER_CNS = 4
CLUSTER_MNS = 4
CLUSTER_CACHE_BYTES = 256 << 10
CLUSTER_DEPTH = 3
CLUSTER_THETA = 0.9
CLUSTER_BATCH = 256
CLUSTER_LANES_LOG2 = 17
CLUSTER_JOIN_AT = 1 << 16
CLUSTER_BURST = 1 << 14
CLUSTER_PROFILED_CALLS = 64
CLUSTER_SIM = dict(clients_per_cn=2, window=8, mn_threads=4)
CHAOS_SEEDS = (1, 2, 3)
CHAOS_LARGE = dict(seed=3, n_keys=1 << 16, n_ops=1 << 15, batch=256,
                   telemetry=True)  # 2^16 ops until phase 19 came
# phase 13: the serving ingress, session parking through the KVS and the rwkv6
# family.  The agreement runs the front door's policies over an 8000-key store
# (tests/test_frontdoor.py's size), a session-store stream and the reduced
# rwkv6 in float32, card against CPU.  The front door at scale is the slo
# suite's timing store (benchmarks/slo_bench.py:56-58: outback, load factor
# 0.85, a window of 512, no CN cache, a transport) over the first
# 2^LATER_KEYS_LOG2 of phase 3's keys; its knee is taken at FD_KNEE_FRAC of the
# suite's capacity probe (slo_bench.py:136-147: 4000 zipf Gets posted at t=0
# over 8 QPs), with the knee's p999 from a pass-through run there (the suite
# sweeps ten loads for it); then 2^17 offers from the suite's singleflight,
# isolation (the contended arm) and acked-writes specs and policies
# (slo_bench.py:205-214, 259-370).  Session parking runs llama3.2-1b at its
# published widths through KVSessionStore(cn_cache_budget_bytes=256 KiB)
# (tests/test_train_serve.py: 160-162) with max_seq cut from 128 to 32: a
# first park of the 128-token lane (524,290 chunk keys) took 120.5 s on one
# H100 (tools/session_probe.py --sizing), of the 64-token lane 52.8-72.3 s,
# of the 32-token lane (1,048,580 B, 131,074 chunk keys) 28.2 s.  rwkv6-1.6b at its published widths serves 8 requests in process; its
# 12,779,524 B lane is over the session store's limit, as in the reference.
FD_AGREE_KEYS = 8000
FD_WINDOW = 512
FD_QPS = 8
FD_C = 8
FD_OFFERS = {"singleflight": 1 << 16, "isolation": 1 << 15,
             "acked_writes": 1 << 15}  # halved when phases 17 and 19 came
FD_PROBE_GETS = 4000
FD_KNEE_FRAC = 0.85
FD_PROFILED_OFFERS = 1 << 14
SESSION_LANES = 4
# max_seq 32 until phase 17 came (a first park took 46-60 s), then 16
# with 8 prompt and 6 new tokens until phase 20 came (phase 13 (c) 37.4 s
# on a slow host): a park's time follows the lane's size.  The engine
# takes a prompt in one step, so SESSION_NEW exceeds SESSION_STEPS: the
# parked lane is still serving
SESSION_MAX_SEQ = 8
SESSION_CACHE_BYTES = 256 << 10
SESSION_PROMPT = 2
SESSION_NEW = 5
SESSION_STEPS = 3
RWKV_LANES = 8
RWKV_REQUESTS = 8
RWKV_PROMPT = 8
RWKV_NEW = 16
RWKV_MAX_SEQ = 64
RWKV_PROFILED_STEPS = 8
# tests/test_torch_models.py's float32 tolerance (rtol and atol)
RWKV_TOL = 1e-5
# phase 14: the training path.  (a) fused_norm_matmul_bwd against its plain
# version at the shapes of tests/test_kernels.py and the edges of
# tests/test_torch_kernels.py (d = 200 and 64, F = 100 and 131), a ragged
# S = 7 x d = 2048, and llama3.2-1b's training entries (S = B * seq = 2048
# rows, d = 2048, F = 2048 for q, 512 for k and v, 8192 for the gate and
# up), timed at the training entries; the tolerances of the forward (max
# abs error over the largest value of each gradient).  (b) One float32
# make_train_step step of llama3.2-1b at full width with TWIN_TRAIN_LAYERS
# layers, B = 1 and 128 positions (and of the reduced rwkv6-1.6b) on the
# card and on the CPU from the same weights and batch; then a checkpoint
# restart on the card at that size in bf16: three steps, save, two more,
# restore and replay the two, bit for bit.  (c) llama3.2-1b at its published
# widths, random bf16 weights, one functional and one in-place step from
# fresh states (their peaks), then TRAIN_STEPS in-place steps of B = 4 x
# 512 positions of SyntheticLM batches from the seed (a constant token
# stream until the in-place step came: its loss fell to 0, so "the loss
# falls" said little), learning rate TRAIN_LR after 2 warm-up steps, then
# TRAIN_PROFILED_STEPS profiled.
TRAIN_B, TRAIN_SEQ = 4, 512
TRAIN_ROWS = TRAIN_B * TRAIN_SEQ
FNMB_TIMED_SHAPES = [(TRAIN_ROWS, D_MODEL, F, dt)
                     for dt in ("bfloat16", "float32")
                     for F in (2048, 512, 8192)]
# row 5 at llama3.2-1b's training entries (phase 14 (c)'s forward), checked
# and timed beside the library by device time
FNM_TRAIN_SHAPES = [(TRAIN_ROWS, D_MODEL, F, "bfloat16")
                    for F in (2048, 512, 8192)]
# the bf16 edges of ops.fused_norm_matmul_bwd_dw_plan: d not a multiple of
# 8 (elementwise loads, A's ragged last box), S not a multiple of 64 and F
# not of the tile (the tensor maps' zeros) with splits, the same with the
# 128 x 256 tile (dy boxes wholly past F), d past the row pass's
# registers (reread) in wgmma and in mma, and past 8 dgamma partials in
# shared memory (d = 7000: the warps' turns); with the training entries
# (F = 512: 2 splits), every regime, both wgmma tiles, a split plan and
# both row passes run
FNMB_CHECK_SHAPES = [(256, 512, 1024, "float32"), (512, 256, 512, "float32"),
                     (128, 1024, 512, "bfloat16"), (7, 200, 100, "float32"),
                     (9, 64, 131, "bfloat16"), (7, 2048, 1000, "float32"),
                     (7, 2048, 1000, "bfloat16"), (100, 1004, 256, "bfloat16"),
                     (200, 640, 384, "bfloat16"),
                     (300, 1100, 1800, "bfloat16"), (64, 2304, 256, "bfloat16"),
                     (33, 2304, 131, "bfloat16"), (9, 7000, 64, "bfloat16"),
                     (9, 7000, 64, "float32"), *FNMB_TIMED_SHAPES]
# traces a like-for-like device time of phase 14 (a) takes the median of
FNMB_BUSY_TRACES = 3
TWIN_TRAIN_LAYERS = 2
TWIN_TRAIN_B, TWIN_TRAIN_SEQ = 1, 128
# the twin's update: a float32 gradient within 1e-3 of the CPU's largest
# (sums over 128 rows, d = 2048, d_ff = 8192 and vocab 128256 in another
# order, about 1e-6 apart), read through Adam's first step: each leaf's
# first moment (b1-weighted gradient) and second moment (squared gradient)
# within TWIN_TRAIN_TOL of the CPU's largest.  That step moves a parameter
# by about lr times the sign of its gradient, so a near-zero gradient whose
# sign differs moves it 2 lr apart: parameters within 2 lr + 1e-6, a check
# only of a gross fault (a non-finite or missing update)
TWIN_TRAIN_TOL = 1e-3
TWIN_TRAIN_LR = 1e-3
# the float32 training twins: llama3.2-1b cut to TWIN_TRAIN_LAYERS, the
# rest their reduced configs (the vlm, MoE and MLA families run row 6 and
# the MoE aux loss)
TRAIN_TWIN_ARCHS = ("llama3.2-1b", "rwkv6-1.6b", "llava-next-mistral-7b",
                    "mixtral-8x22b", "deepseek-v3-671b", "jamba-v0.1-52b",
                    "whisper-large-v3")
RESTART_STEPS = (3, 2)
TRAIN_STEPS = 8
TRAIN_PROFILED_STEPS = 2
TRAIN_LR = 1e-3
# (d): qwen3-4b whole (configs/qwen3_4b.py: 36 layers, d 2560, 32 q heads
# and 8 kv heads of 128, d_ff 9728), QWEN_STEPS in-place steps of TRAIN_B x
# TRAIN_SEQ tokens and QWEN_PROFILED_STEPS profiled; its training entries:
# q (F = 4096), k and v (1024), gate and up (9728), S = TRAIN_ROWS rows
QWEN_ARCH = "qwen3-4b"
QWEN_STEPS = 4
QWEN_PROFILED_STEPS = 1
QWEN_D = 2560
QWEN_TRAIN_SHAPES = [(TRAIN_ROWS, QWEN_D, F, "bfloat16")
                     for F in (4096, 1024, 9728)]
# phase 15: the vlm, MoE and MLA families at their published widths
# (src/repro_torch/configs/), random bf16 weights from SEED: llava-next-
# mistral-7b at all 32 layers (7.26e9 parameters), mixtral-8x22b cut to
# 8 of its 56 layers (2.04e10: a layer is 5.0 GB, 16 would not fit the
# 80 GB card), deepseek-v3-671b cut to its 3 dense layers and its first
# MoE layer, with the MTP block (1.58e10).  Each serves FAMILY_REQUESTS
# requests of FAMILY_PROMPT_MIN-MAX prompt tokens and FAMILY_NEW greedy
# new tokens through FAMILY_LANES lanes of FAMILY_MAX_SEQ positions.
FAMILIES = (("llava-next-mistral-7b", None), ("mixtral-8x22b", 8),
            ("deepseek-v3-671b", 4))
FAMILY_LANES, FAMILY_MAX_SEQ = 4, 64
FAMILY_REQUESTS, FAMILY_NEW = 4, 16  # 8 (two waves) until phase 17 served eight configs
FAMILY_PROMPT_MIN, FAMILY_PROMPT_MAX = 6, 12
FAMILY_PROFILED_STEPS = 8
# the prompt behind llava's 576 patches; the twins' prompts
FAMILY_PROMPT = 16
# the twins: llava at full width cut to 2 layers, mixtral and deepseek
# reduced, float32, TWIN_TOL
FAMILY_TWIN_LAYERS = 2
FAMILY_TWIN_STEPS = 4
# fused_norm_matmul entries a layer: GQA's q, k, v; MLA's wq_a, wq_b and
# wkv_a; mamba's w_in; the cross-attention layer's q, k, v and cq; SwiGLU's
# gate and up; a MoE ffn's shared expert's gate and up (counted by
# fused_per_decode_step; its router and routed experts are plain products);
# none in rwkv's mixes
FNM_ENTRIES = {"gqa": 3, "mla": 3, "mamba": 1, "gqa_cross": 4, "mlp": 2,
               "moe": 0, "rwkv": 0, "rwkv_cm": 0}
# row 5's new (d, F) pairs: llava's wq, wk / wv and MLP; mixtral's wq and
# wk / wv; deepseek's wq_a, wkv_a, dense MLP, shared expert and wq_b;
# checked at S = 8 and 256, timed at S = 8
FAMILY_FNM_PAIRS = ((4096, 4096), (4096, 1024), (4096, 14336),
                    (6144, 6144), (6144, 1024),
                    (7168, 1536), (7168, 576), (7168, 18432), (7168, 2048),
                    (1536, 24576))
FAMILY_FNM_SHAPES = [(S, d, F, "bfloat16") for S in (8, 256)
                     for d, F in FAMILY_FNM_PAIRS]
# phase 16: the hybrid and encdec families at their published widths,
# random bf16 weights from SEED, served as phase 15's.  jamba-v0.1-52b
# (src/repro_torch/configs/jamba_v0_1_52b.py) is cut to HYBRID_LAYERS of
# its 32 layers, 3 of its 4 periods: 38,811,955,200 parameters,
# 77,630,103,552 B, where the 32 layers' 103,148,888,064 B do not fit one
# 80 GB card.  whisper-large-v3 runs whole (32 encoder and 32 decoder
# layers, 4,044,119,040 B).  jamba's prefill is HYBRID_PROMPT tokens of one
# row; whisper's is FAMILY_PROMPT tokens of WHISPER_ROWS rows behind frames
# of (WHISPER_ROWS, 1500, 1280), then WHISPER_TF_STEPS teacher-forced decode
# steps on that encoder output.  The twins: jamba reduced; whisper at full
# width cut to WHISPER_TWIN_LAYERS encoder and decoder layers, its 1500
# frames kept.
HYBRID_LAYERS = 24
HYBRID_FAMILIES = (("jamba-v0.1-52b", HYBRID_LAYERS),
                   ("whisper-large-v3", None))
HYBRID_PROMPT = 16
WHISPER_ROWS = 2  # 4 rows and 8 steps until phase 17 came
WHISPER_TF_STEPS = 4
WHISPER_TWIN_LAYERS = 2
# row 5's new (d, F) pairs: jamba's mamba w_in; whisper's q / k / v / o-width
# entries and its MLP; whisper's encoder rows: S = WHISPER_ROWS x 1500
HYBRID_FNM_PAIRS = ((4096, 16384), (1280, 1280), (1280, 5120))
HYBRID_FNM_SHAPES = [(S, d, F, "bfloat16") for S in (8, 256)
                     for d, F in HYBRID_FNM_PAIRS] + [
    (WHISPER_ROWS * 1500, 1280, F, "bfloat16") for F in (1280, 5120)]
# phase 17: tensor parallelism over a world of two ranks on the one card
# (tools/tp_rank.py; gloo for card tensors, NCCL refusing two ranks on one
# device).  Row 5's (d, F) at tp = 2: qwen2.5-14b's q, k / v and gate / up
# shards, mixtral-8x22b's q and k / v shards; deepseek-v3-671b's wq_b and
# dense and shared MLP shards beside its replicated wq_a and wkv_a;
# jamba-v0.1-52b's w_in, q, k / v and MLP shards; whisper-large-v3's
# q / k / v / cq and MLP shards; llama3.2-1b's q, k / v and MLP, whole
# (served over (2, 1)); checked at the engine's 4 rows and at 8, timed at
# 4.  whisper's prefill runs the q / k / v and MLP shards at its encoder's
# rows (WHISPER_ROWS x 1500) and its decoder's (WHISPER_ROWS x 16).
TP_RANKS = 2
TP_FNM_PAIRS = ((5120, 2560), (5120, 512), (5120, 6912), (6144, 3072),
                (6144, 512),
                (7168, 1536), (7168, 576), (1536, 12288), (7168, 9216),
                (7168, 1024),
                (4096, 8192), (4096, 2048), (4096, 512), (4096, 7168),
                (1280, 640), (1280, 2560),
                (2048, 2048), (2048, 512), (2048, 8192))
TP_FNM_SHAPES = [(S, d, F, "bfloat16") for S in (4, 8)
                 for d, F in TP_FNM_PAIRS]
TP_PREFILL_SHAPES = [(S, 1280, F, "bfloat16")
                     for S in (WHISPER_ROWS * 1500, WHISPER_ROWS * 16)
                     for F in (640, 2560)]
# rows 5 and 6 in the tp training steps: llama3.2-1b's 2 x 512 rows a rank
# (S = 1024) at d 2048, F its q, k / v and gate / up columns split at
# tp = 2 over (1, 2) and whole over (2, 1) and (2, 1, 1); the world's
# steps record theirs, which must be these
TP_TRAIN_SHAPES = [(1024, 2048, F, "bfloat16")
                   for F in (1024, 256, 4096, 2048, 512, 8192)]
# the runs of the main world whose records the parent reads (SERVED of
# tools/tp_rank.py, mixtral with moe_gather_decode, llama3.2-1b over (2, 1))
TP_SERVED = ("qwen2.5-14b", "mixtral-8x22b", "deepseek-v3-671b",
             "jamba-v0.1-52b", "rwkv6-1.6b", "whisper-large-v3",
             "mixtral-8x22b/gather", "llama3.2-1b/data")
TP_PROBE_DTYPES = ("bfloat16", "float32", "int8")
TP_PROBE_TIMEOUT = 180
TP_MAIN_TIMEOUT = 600
# phase 18: the world of tools/tp_rank.py seq (its runs' sizes are there)
SEQ_TIMEOUT = 420
# phase 19: the dry run's cells (arch, shape, multi_pod, variant), traced
# by DRYRUN_JOBS processes beside phases 1-18 (8 when they ran in phase 19:
# fewer leave the cores to the store's build); the counted steps' timed
# steps
DRYRUN_CELLS = [("llama3.2-1b", "train_4k", False, None),
                ("jamba-v0.1-52b", "long_500k", False, None),
                ("llama3.2-1b", "decode_32k", False, "seqcache"),
                ("mixtral-8x22b", "decode_32k", False, "moegather"),
                ("qwen2.5-14b", "long_500k", False, None),
                ("qwen2.5-14b", "decode_32k", False, None)]
DRYRUN_JOBS = 3
COUNT_TIMED_STEPS = 5
COUNT_PROFILED_STEPS = 2
# the niceness of the host work started before phase 1 (Background)
BG_NICE = 10
# phase 20: the world of tools/tp_rank.py hd (its sizes are there)
HD_RANKS = 16
HD_TIMEOUT = 420
HD_TWIN_TOL = 1e-4


def log(*a) -> None:
    print(*a, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ timing
def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events
    (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_trace(fn, iters: int, *kernels: str) -> tuple:
    """A ``torch.profiler`` trace of ``iters`` calls of ``fn`` -> (the mean
    time a launch, in ms, of the CUDA kernels whose names hold each name in
    ``kernels`` (each such kernel launches once a call; names the trace does
    not hold are left out), the trace).  The mean a launch and not the
    trace's total over ``iters``: a trace late in a long run can miss
    launches (logged when it does), or all of a kernel's, and then another
    is taken, up to TRACE_TRIES in all, until one holds every name.  A
    caller that needs every kernel checks that the times hold them all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            hit = [k for k in kernels if k in ev.key]
            if hit and ev.count:
                t = getattr(ev, "device_time_total", None)
                t = getattr(ev, "cuda_time_total", 0) if t is None else t
                times[hit[0]] = times.get(hit[0], 0.0) + t / ev.count / 1e3
                if ev.count != iters:
                    log(f"profiler: {ev.key[:60]} seen {ev.count} times in "
                        f"{iters} calls")
        if len(times) == len(kernels):
            break
        log(f"profiler: no launch of {sorted(set(kernels) - set(times))} "
            f"in a trace of {iters} calls")
    return times, prof


def device_times(fn, iters: int, *kernels: str) -> dict:
    """Device time a call of ``fn``, by kernel: the times of
    :func:`device_trace`."""
    return device_trace(fn, iters, *kernels)[0]


def device_ms(fn, iters: int, *kernels: str):
    """Device time a call of ``fn``, which launches each CUDA kernel whose
    name holds one of ``kernels`` once: :func:`device_times` summed over the
    kernels; None when the trace holds none of them."""
    total = sum(device_times(fn, iters, *kernels).values())
    return total if total else None


def device_busy_us(prof) -> tuple:
    """The union of the device intervals of a ``torch.profiler`` trace, in
    us, and the number of device operations in it."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


def cycling(fn, sets):
    """A call of ``fn`` on the next argument tuple of ``sets`` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


# -------------------------------------------------------------- workloads
def zipf_ranks(rng, n: int, size: int, theta: float = 0.99) -> np.ndarray:
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -theta)
    r = np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")
    return np.minimum(r, n - 1)


# ------------------------------------------------------------ phase 2
def ops_bound_ms(per_item: dict, n: int) -> float:
    """The least time of ``n`` items of ``per_item`` integer instructions
    by pipe: the busier pipe at 64 lanes an SM a clock, or all of them at
    the SMs' dispatch rate."""
    return max(max(per_item.values()) / INT_PIPE_OPS_PER_S,
               sum(per_item.values()) / SCHEDULER_OPS_PER_S) * n * 1e3


def ludo_bound(b: int) -> tuple:
    """``ludo_lookup``'s bound at ``b`` keys: each key's lanes read and
    (bucket, slot) written once, 16 B a key (the CN arrays the gathers
    read stay in L2, as phase 2 prints their size), or its integer
    instructions."""
    by_bytes = 16 * b / HBM_BYTES_PER_S * 1e3
    by_ops = ops_bound_ms(LUDO_OPS_PER_KEY, b)
    return max(by_bytes, by_ops), \
        "bytes" if by_bytes >= by_ops else "operations"


def ludo_edge_batches(n_sm: int) -> list:
    """Batch sizes at the edges of ``ops.ludo_lookup_plan`` on a card of
    ``n_sm`` SMs: a warp and one either side, the serve window and one
    either side, each block width's last batch and the next, a ragged
    batch past the widest, and 2^20."""
    return sorted({1, 2, 3, 31, 32, 33, WINDOW - 1, WINDOW, WINDOW + 1,
                   256 * n_sm + 5, 1 << 20}
                  | {t * n_sm + d for t in (32, 64, 128, 256)
                     for d in (0, 1)})


def sass_opcodes(lib) -> dict:
    """kernel -> its SASS opcodes (``cuobjdump -sass`` of the built
    library ``lib``) and their totals by pipe."""
    import re
    from collections import Counter

    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            found[name][m.group(1)] += 1
    out = {}
    for name, ops_ in found.items():
        pipes = Counter()
        for op, c in ops_.items():
            root = op.split(".")[0]
            pipes["alu" if root in SASS_ALU else "fma" if root in SASS_FMA
                  else "xu" if root in SASS_XU else "uniform"
                  if root.startswith("U") else "other"] += c
        out[name] = dict(pipes=dict(pipes), opcodes=dict(ops_.most_common()))
    return out


def host_us(pieces: dict, iters: int = 2000) -> dict:
    """Host us a call of each of ``pieces`` (name -> callable), each alone,
    ``iters`` times back to back by ``time.perf_counter`` (launches end in
    a synchronize)."""
    import torch
    res = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / iters * 1e6
    return res


def wrapper_breakdown(lo, hi, wa, wb, seeds, meta, iters: int = 2000) -> dict:
    """Host us a call of each piece of the CUDA branches of
    ``ops.ludo_lookup`` and ``ops.slot_unpack`` at ``lo``'s batch (the
    lanes stand in for slot words too), by :func:`host_us`, and each
    whole wrapper by CUDA events."""
    import torch
    from repro_torch.kernels import build, ops
    dev, n = lo.device, lo.shape[0]
    scalar_args = tuple(meta[k] for k in ("ma", "mb", "nb", "seed_a",
                                          "seed_b", "seed_ba", "seed_bb"))
    scalars = ops._ludo_scalars(*scalar_args)
    plan = ops._ludo_plan(n, ops._sm_count(dev))
    out2 = torch.empty((2, n), dtype=torch.int32, device=dev)
    out4 = torch.empty((4, n), dtype=torch.int32, device=dev)
    ludo, unpack = build.launcher("ludo_lookup"), build.launcher("slot_unpack")
    stream = ops._stream(dev)
    p2, p4 = out2.data_ptr(), out4.data_ptr()

    def checks():
        for name, t, dt in (("key_lo", lo, torch.int32),
                            ("key_hi", hi, torch.int32),
                            ("words_a", wa, torch.int32),
                            ("words_b", wb, torch.int32),
                            ("seeds", seeds, torch.uint8)):
            ops._check(name, t, dt, dev)

    res = host_us({
        "checks of 5 tensors": checks,
        "launch scalars (cached)": lambda: ops._ludo_scalars(*scalar_args),
        "plan": lambda: ops._ludo_plan(n, ops._sm_count(dev)),
        "device check": lambda: dev.index == torch.cuda.current_device(),
        "stream": lambda: ops._stream(dev),
        "torch.empty (2, n)": lambda: torch.empty((2, n), dtype=torch.int32,
                                                  device=dev),
        "torch.empty (4, n)": lambda: torch.empty((4, n), dtype=torch.int32,
                                                  device=dev),
        "unbind of 2 rows": lambda: out2.unbind(0),
        "unbind of 4 rows": lambda: out4.unbind(0),
        "6 data_ptr": lambda: (lo.data_ptr(), hi.data_ptr(), wa.data_ptr(),
                               wb.data_ptr(), seeds.data_ptr(),
                               out2.data_ptr()),
        "ctypes launch ludo_lookup": lambda: ludo(
            lo.data_ptr(), hi.data_ptr(), wa.data_ptr(), wb.data_ptr(),
            seeds.data_ptr(), p2, p2 + 4 * n, n, *scalars, *plan, stream),
        "ctypes launch slot_unpack": lambda: unpack(
            lo.data_ptr(), hi.data_ptr(), p4, p4 + 4 * n, p4 + 8 * n,
            p4 + 12 * n, n, stream),
    }, iters)
    res["ludo_lookup whole (events)"] = 1e3 * time_ms(
        lambda: ops.ludo_lookup(lo, hi, wa, wb, seeds, meta), iters)
    res["slot_unpack whole (events)"] = 1e3 * time_ms(
        lambda: ops.slot_unpack(lo, hi), iters)
    return res


def check_kernels(engine, keys: np.ndarray, rng) -> dict:
    """Each kernel against its plain version on the card, and timed."""
    import torch
    from repro_torch.core.hashing import lanes, split_u64
    from repro_torch.kernels import build, ops, ref
    dev = engine.device
    oth = engine.cn.othello
    meta = ops.cn_meta_from(engine)
    wa, wb, seeds = oth.words_a, oth.words_b, engine.cn.seeds

    absent = rng.integers(0, 2**64 - 1, 4096, dtype=np.uint64, endpoint=True)
    out = {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"CN arrays: {engine.cn.memory_bytes()} B at {keys.size} keys "
        f"(ma={meta['ma']}, mb={meta['mb']}, nb={meta['nb']})")
    log("ludo_lookup plans: " + "; ".join(
        f"B={b}: {ops.ludo_lookup_plan(b, n_sm)}" for b in LUDO_TIMED))
    log(f"integer operations the bound counts: ludo_lookup "
        f"{LUDO_OPS_PER_KEY} a key ({LUDO_OPS}), slot_unpack "
        f"{UNPACK_OPS_PER_SLOT} a slot")
    for lib in ("ludo_lookup", "slot_unpack"):
        for name, sass in sass_opcodes(build._lib_path(lib)).items():
            log(f"SASS of {name}: {sass['pipes']} {sass['opcodes']}")

    def ludo_inputs(b, offset=0):
        """b keys (present and absent) as lanes on the card, viewed
        ``offset`` elements past a 16-byte boundary."""
        q = np.concatenate([keys[rng.integers(0, keys.size, b)], absent])[:b]
        lo, hi = split_u64(rng.permutation(q))
        pad = np.zeros(offset, np.uint32)
        return (lanes(np.concatenate([pad, lo]), dev)[offset:],
                lanes(np.concatenate([pad, hi]), dev)[offset:])

    err = 0
    edges = ludo_edge_batches(n_sm)
    for b in edges:
        for offset in range(4):
            lo, hi = ludo_inputs(b, offset)
            got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
            want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"ludo_lookup differs from its plain version at B={b}, "
                  f"offset {offset}")
            err = max(err, max_abs_err(got, want))
    log(f"ludo_lookup: bit-identical to its plain version at B = {edges}, "
        f"each on lanes 0-3 elements past a 16-byte boundary")
    timings = {}
    for b in LUDO_TIMED:
        sets = [ludo_inputs(b) + (wa, wb, seeds)
                for _ in range(COLD_SETS if b == 1 << 20 else 1)]
        iters = 200 if b == 1 << 20 else 2000
        kern = cycling(lambda *a: ops.ludo_lookup(*a, meta), sets)
        bound, by = ludo_bound(b)
        timings[b] = dict(
            batch=b, plan=ops.ludo_lookup_plan(b, n_sm),
            ms=time_ms(kern, iters),
            device_ms=device_ms(kern, 50, "ludo_lookup_kernel"),
            plain_ms=time_ms(cycling(
                lambda *a: ref.ludo_lookup_ref(*a, **meta), sets),
                iters // 10),
            bound_ms=bound, bound_by=by)
    out["ludo_lookup"] = dict(
        name="ludo_lookup", route="cuda",
        source="src/repro_torch/kernels/csrc/ludo_lookup.cu",
        replaces="src/repro/kernels/ludo_lookup.py:70", max_abs_err=err,
        library_ms=None, **timings[WINDOW], large=timings[1 << 20],
        single=timings[1])
    lo, hi = ludo_inputs(WINDOW)
    out["ludo_lookup"]["host_breakdown_us"] = wrapper_breakdown(
        lo, hi, wa, wb, seeds, meta)
    log(f"index wrappers at B={WINDOW}, host us a piece: "
        f"{json.dumps(out['ludo_lookup']['host_breakdown_us'])}")

    words = rng.integers(0, 2**32, (2, COLD_SETS << 20),
                         dtype=np.uint64).astype(np.uint32)
    words[:, :64] = 0xFFFFFFFF  # all bits set
    words[:, 64:128] = 0
    s_lo, s_hi = lanes(words[0], dev), lanes(words[1], dev)
    err = 0
    for b in (1, 1023, 1024, 1025, 1 << 22):
        got = ops.slot_unpack(s_lo[:b], s_hi[:b])
        want = ref.slot_unpack_ref(s_lo[:b], s_hi[:b])
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"slot_unpack differs from its plain version at B={b}")
        err = max(err, max_abs_err(got, want))
    timings = {}
    for b in (WINDOW, 1 << 20):
        sets = [(s_lo[j * b:(j + 1) * b], s_hi[j * b:(j + 1) * b])
                for j in range(1 if b == WINDOW else COLD_SETS)]
        iters = 2000 if b == WINDOW else 200
        kern = cycling(ops.slot_unpack, sets)
        by_bytes = 24 * b / HBM_BYTES_PER_S * 1e3
        by_ops = ops_bound_ms(UNPACK_OPS_PER_SLOT, b)
        timings[b] = dict(
            batch=b, ms=time_ms(kern, iters),
            device_ms=device_ms(kern, 50, "slot_unpack_kernel"),
            plain_ms=time_ms(cycling(ref.slot_unpack_ref, sets),
                             iters // 10),
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations")
    out["slot_unpack"] = dict(
        name="slot_unpack", route="cuda",
        source="src/repro_torch/kernels/csrc/slot_unpack.cu",
        replaces="src/repro/kernels/slot_unpack.py:31", max_abs_err=err,
        library_ms=None, **timings[WINDOW], large=timings[1 << 20])
    single = out["ludo_lookup"]["single"]
    log(f"kernel ludo_lookup at B=1: {single['ms']:.6f} ms (device "
        f"{single['device_ms']}), plain {single['plain_ms']:.6f} ms")
    for k in out.values():
        log(f"kernel {k['name']}: bit-identical to its plain version; "
            f"B={WINDOW}: {k['ms']:.6f} ms (device {k['device_ms']}), "
            f"plain {k['plain_ms']:.6f} ms, bound {k['bound_ms']:.9f} ms; "
            f"B=2^20: {k['large']['ms']:.6f} ms (device "
            f"{k['large']['device_ms']}), plain {k['large']['plain_ms']:.6f}"
            f" ms, bound {k['large']['bound_ms']:.6f} ms "
            f"({k['large']['bound_by']})")
    return out


# ------------------------------------------------------------ phase 3
def _results(handles) -> list:
    return [(h.result().values.tolist(), h.result().found.tolist(),
             h.result().statuses) for h in handles]


def agreement_check(seed: int, devices=("cuda", "cpu")) -> None:
    """A small store on the card answers and meters as on the CPU."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    n = 1 << 14
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(7 << 40))
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(n, n + 2048, dtype=np.uint64)
                       + np.uint64(7 << 40))
    rng = np.random.default_rng(seed)
    kinds = rng.choice(4, 8192, p=[0.5, 0.25, 0.15, 0.1])
    stream = []
    for t, (kind, r) in enumerate(zip(kinds, zipf_ranks(rng, n, 8192))):
        op = ("get", "update", "insert", "delete")[kind]
        k = int(fresh[t % 2048]) if op == "insert" else int(keys[r])
        stream.append((op, k, t if op in ("update", "insert") else None))
    spec = StoreSpec("outback", load_factor=0.95, rng_seed=seed,
                     batch=BatchPolicy(window=WINDOW))
    runs = []
    for device in devices:
        st = open_store(spec, keys, vals, device=device)
        hs = [st.submit(op, k) if v is None else st.submit(op, k, v)
              for op, k, v in stream]
        st.flush()
        probe = st.get_batch(np.concatenate([keys, fresh]))
        runs.append((_results(hs), probe.values.tolist(),
                     probe.found.tolist(), st.meter_totals().snapshot(),
                     st.engine.mn_state()["n_keys"]))
    check(runs[0] == runs[1], "the store on the card disagrees with the same "
          "store on the CPU")
    log(f"agreement: a {n}-key store on {devices[0]} answers {len(stream)} "
        f"mixed ops and meters exactly as on {devices[1]}")


def serve(store, keys, vals, rng, n_get: int, n_a: int, n_write: int):
    """YCSB-C, YCSB-A, inserts and deletes through submit/flush, every
    answer checked against the host oracle ``latest``.  Returns the
    per-phase results and the oracle state for :func:`verify_final`."""
    import torch
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import ops
    n = keys.size
    latest = vals.copy()
    perm = rng.permutation(n)  # zipf rank -> key index: hot keys scattered
    stats = store.stats
    res = {}

    def phase(name, fn):
        calls0, l0 = stats.batch_calls, dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] - l0[k] for k in l0}
        batches = stats.batch_calls - calls0
        res[name] = dict(seconds=sec, batches=batches, launches=launches,
                         **(extra or {}))
        log(f"{name}: {sec:.3f} s, {batches} flushed batches, "
            f"launches {launches}, {extra or ''}")

    # ---- YCSB-C: zipf Gets, one window at a time ----
    idx_c = perm[zipf_ranks(rng, n, n_get)]

    def get_windows(idx):
        """Submit the Gets of ``idx`` one window at a time (the last submit
        of a window flushes it) and check every answer; returns the host
        time of each window and of its flush, in ms."""
        lat, flush, got_v, got_f = [], [], [], []
        for w0 in range(0, idx.size, WINDOW):
            ks = keys[idx[w0:w0 + WINDOW]]
            t0 = time.perf_counter()
            hs = [store.submit("get", int(k)) for k in ks[:-1]]
            t1 = time.perf_counter()
            hs.append(store.submit("get", int(ks[-1])))
            if not hs[-1].done:
                store.flush()
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            flush.append(t2 - t1)
            check(hs[0].batch is hs[-1].batch, "a window split its batch")
            got_v.append(hs[-1].batch.values)
            got_f.append(hs[-1].batch.found)
        check(np.concatenate(got_f).all(), "YCSB-C: a present key missed")
        check(np.array_equal(np.concatenate(got_v), latest[idx]),
              "YCSB-C: a wrong value")
        return np.asarray(lat) * 1e3, np.asarray(flush) * 1e3

    def ycsb_c():
        gcs = []  # [generation, seconds] of each collection in the phase

        def on_gc(when, info):
            if when == "start":
                gcs.append([info["generation"], time.perf_counter()])
            else:
                gcs[-1][1] = time.perf_counter() - gcs[-1][1]

        gc.callbacks.append(on_gc)
        try:
            lat, flush = get_windows(idx_c)
        finally:
            gc.callbacks.remove(on_gc)
        return dict(p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)),
                    max_ms=float(lat.max()),
                    flush_p50_ms=float(np.percentile(flush, 50)),
                    flush_p99_ms=float(np.percentile(flush, 99)),
                    gc_collections=[sum(g == k for g, _ in gcs)
                                    for k in range(3)],
                    gc_ms=1e3 * sum(t for _, t in gcs))

    phase("ycsb_c", ycsb_c)
    res["ycsb_c"]["gets_per_s"] = n_get / res["ycsb_c"]["seconds"]

    def ycsb_c_profiled():
        """32 more windows of the same Gets under torch.profiler: the
        device's busy share of the host wall time."""
        from torch.profiler import ProfilerActivity, profile
        idx = idx_c[:32 * WINDOW]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            get_windows(idx)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, spans = device_busy_us(prof)
        return dict(device_busy_share=busy / wall_us if spans else None,
                    device_ops_per_window=spans / 32)

    phase("ycsb_c_profiled", ycsb_c_profiled)

    # ---- YCSB-A: zipf, half reads, half updates, submission order ----
    idx_a = perm[zipf_ranks(rng, n, n_a)]
    is_upd = rng.random(n_a) < 0.5
    new_v = rng.integers(0, 2**64 - 1, n_a, dtype=np.uint64, endpoint=True)

    def ycsb_a():
        reads, upds, expect = [], [], []
        for t in range(n_a):
            i = int(idx_a[t])
            if is_upd[t]:
                upds.append(store.submit("update", int(keys[i]), int(new_v[t])))
                latest[i] = new_v[t]
            else:
                reads.append(store.submit("get", int(keys[i])))
                expect.append(latest[i])
        store.flush()
        check(all(bool(h.result().found[0]) for h in upds),
              "YCSB-A: an update of a present key failed")
        check(all(bool(h.result().found[0]) for h in reads),
              "YCSB-A: a present key missed")
        got = np.asarray([h.result().values[0] for h in reads], np.uint64)
        check(np.array_equal(got, np.asarray(expect, np.uint64)),
              "YCSB-A: a read did not see the latest value")

    phase("ycsb_a", ycsb_a)
    res["ycsb_a"]["ops_per_s"] = n_a / res["ycsb_a"]["seconds"]

    # ---- writes: inserts of new keys, then deletes ----
    fresh = splitmix64(np.arange(n, n + n_write, dtype=np.uint64)
                       + np.uint64(_KEY_OFFSET))
    fresh_v = rng.integers(0, 2**64 - 1, n_write, dtype=np.uint64,
                           endpoint=True)
    del_old = rng.choice(n, n_write // 2, replace=False)
    del_new = rng.choice(n_write, n_write - n_write // 2, replace=False)

    def inserts():
        hs = [store.submit("insert", int(k), int(v))
              for k, v in zip(fresh, fresh_v)]
        store.flush()
        cases = [h.result().statuses[0] for h in hs]
        check(all(c in ("slot", "reseed", "overflow") for c in cases),
              "insert of a new key did not place it")
        return {c: cases.count(c) for c in sorted(set(cases))}

    def deletes():
        gone = np.concatenate([keys[del_old], fresh[del_new]])
        hs = [store.submit("delete", int(k)) for k in gone]
        store.flush()
        check(all(bool(h.result().found[0]) for h in hs),
              "delete of a present key failed")

    phase("inserts", inserts)
    phase("deletes", deletes)
    return res, dict(latest=latest, fresh=fresh, fresh_v=fresh_v,
                     del_old=del_old, del_new=del_new)


def verify_final(store, keys, rng, o) -> None:
    """After the writes: deleted keys are gone, the rest hold their latest
    values (a sample of the old keys, every surviving new key)."""
    gone_new = np.zeros(o["fresh"].size, bool)
    gone_new[o["del_new"]] = True
    r = store.get_batch(np.concatenate([keys[o["del_old"]],
                                        o["fresh"][gone_new]]))
    check(not r.found.any(), "a deleted key is still found")
    r = store.get_batch(o["fresh"][~gone_new])
    check(r.found.all() and np.array_equal(r.values, o["fresh_v"][~gone_new]),
          "an inserted key lost its value")
    keep = np.ones(keys.size, bool)
    keep[o["del_old"]] = False
    live = np.nonzero(keep)[0]
    sample = rng.choice(live, min(1 << 16, live.size), replace=False)
    r = store.get_batch(keys[sample])
    check(r.found.all() and np.array_equal(r.values, o["latest"][sample]),
          "an old key lost its latest value")
    log("final state: deleted keys absent, inserted and old keys hold their "
        "latest values")


# ------------------------------------------------------------ phase 4
def paged_bound(n_pages: int, fetches: int) -> tuple:
    """The least time of one paged decode at the serve shape: the pages'
    K and V tiles (bf16) ``fetches`` times, q, the page ids and the float32
    outputs moved once, against 4 * n_kv * g * d flops a fetched token at
    the float32 rate."""
    tokens = fetches * n_pages * PAGE_SIZE
    by_bytes = (2 * tokens * N_KV * HEAD_DIM * 2 + N_KV * GROUP * HEAD_DIM * 2
                + 4 * n_pages * fetches + 4 * N_KV * GROUP * (HEAD_DIM + 2)
                ) / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * N_KV * GROUP * HEAD_DIM * tokens / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def paged_err(got, want, errs: dict | None = None) -> None:
    """Check each of (o, m, l) within the tests' tolerance of ``want``, and
    keep the largest absolute error of each in ``errs``."""
    import torch
    for name, g, w in zip("oml", got, want):
        check(g.dtype == torch.float32 and g.shape == w.shape
              and torch.allclose(g, w, rtol=PAGED_TOL, atol=PAGED_TOL),
              f"a paged kernel's {name} differs from its plain version "
              f"beyond {PAGED_TOL}")
        if errs is not None:
            errs[name] = max(errs.get(name, 0.0), float((g - w).abs().max()))


def paged_maps(gen, n_pool: int, n_pages: int, split: int):
    """A page map of distinct pages, and a cuckoo map holding it beside
    distinct random decoys, whose first step of every run of ``split``
    pages (step 0 among them) is the unselected candidate."""
    import torch
    pm = torch.randperm(n_pool, generator=gen, device="cuda")[:n_pages].int()
    decoy = torch.randperm(n_pool, generator=gen,
                           device="cuda")[:n_pages].int()
    sel = torch.randint(0, 2, (n_pages,), generator=gen, device="cuda",
                        dtype=torch.int32)
    sel[::split] = 1
    pm2 = torch.where(sel[:, None] == 0, torch.stack([pm, decoy], 1),
                      torch.stack([decoy, pm], 1)).contiguous()
    return pm, pm2, sel


def sdpa_yardstick(q, k_pool, v_pool, pm, seq_len: int):
    """The library yardstick: a gather of the pages, then PyTorch's
    ``scaled_dot_product_attention`` with GQA; gives ``o`` only, and the
    port never calls it."""
    import torch.nn.functional as F
    n_pages = pm.shape[0]
    k = k_pool[pm.long()].reshape(n_pages * PAGE_SIZE, N_KV, HEAD_DIM)
    v = v_pool[pm.long()].reshape(n_pages * PAGE_SIZE, N_KV, HEAD_DIM)
    k = k[:seq_len].transpose(0, 1)[None]
    v = v[:seq_len].transpose(0, 1)[None]
    return F.scaled_dot_product_attention(
        q.reshape(1, N_KV * GROUP, 1, HEAD_DIM), k, v, enable_gqa=True)


def check_paged_kernels(k_pool, v_pool, gen) -> dict:
    """Each paged kernel against its plain version on the card: the test
    shapes, then the serve shape (bf16, L = SERVE_PAGES, over the serve
    pools), and timed at the serve shape."""
    import torch
    from repro_torch.kernels import ops, ref
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"paged_attention": {}, "cuckoo_paged_attention": {}}
    for n_kv, g, d, ps, n_pages, seq_len, dt in (PAGED_TEST_SHAPES
                                                  + PAGED_EDGE_SHAPES):
        dtype = getattr(torch, dt)
        pool = 3 * n_pages
        split = ops.paged_split_plan(n_pages, n_kv, g, n_sm)[0]
        check(n_pages < 2 or split == PAGED_RUN,
              f"the plan cut L={n_pages} into runs of {split} pages, not "
              f"{PAGED_RUN}")
        q = torch.randn((n_kv, g, d), generator=gen, device="cuda").to(dtype)
        kp, vp = (torch.randn((pool, ps, n_kv, d), generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        pm, pm2, sel = paged_maps(gen, pool, n_pages, split)
        want = ref.paged_attention_ref(q, kp, vp, pm, seq_len)
        paged_err(ops.paged_attention(q, kp, vp, pm, seq_len), want,
                  errs["paged_attention"])
        paged_err(ops.cuckoo_paged_attention(q, kp, vp, pm2, sel, seq_len),
                  want, errs["cuckoo_paged_attention"])
    log(f"paged kernels: within {PAGED_TOL} of their plain version at "
        f"{len(PAGED_TEST_SHAPES)} test shapes and {len(PAGED_EDGE_SHAPES)} "
        f"split edges (runs of {PAGED_RUN} pages)")
    # the serve shape; COLD_SETS maps of distinct pages, 64 MB of tiles
    # each, so a timed launch finds its pages outside the 50 MB L2
    n_pool = k_pool.shape[0]
    seq_len = SEQ_TOKENS * N_SEQS
    split, n_splits = ops.paged_split_plan(SERVE_PAGES, N_KV, GROUP, n_sm)
    sets = []
    for _ in range(COLD_SETS):
        q = torch.randn((N_KV, GROUP, HEAD_DIM), generator=gen,
                        device="cuda").to(torch.bfloat16)
        sets.append((q, *paged_maps(gen, n_pool, SERVE_PAGES, split)))
    for q, pm, pm2, sel in sets[:2]:
        want = ref.paged_attention_ref(q, k_pool, v_pool, pm, seq_len)
        paged_err(ops.paged_attention(q, k_pool, v_pool, pm, seq_len), want,
                  errs["paged_attention"])
        paged_err(ops.cuckoo_paged_attention(q, k_pool, v_pool, pm2, sel,
                                             seq_len),
                  want, errs["cuckoo_paged_attention"])
    ludo_sets = [(q, k_pool, v_pool, pm, seq_len) for q, pm, _, _ in sets]
    cuckoo_sets = [(q, k_pool, v_pool, pm2, sel, seq_len)
                   for q, _, pm2, sel in sets]

    def cuckoo_plain(q, kp, vp, pm2, sel, n):
        return ref.paged_attention_ref(
            q, kp, vp, pm2[torch.arange(pm2.shape[0], device="cuda"),
                           sel.long()], n)

    def cuckoo_library(q, kp, vp, pm2, sel, n):
        return sdpa_yardstick(q, kp, vp, pm2.gather(1, sel[:, None].long())
                              .reshape(-1), n)

    out = {}
    for name, src_line, sets_, plain, library, fetches in (
            ("paged_attention", 87, ludo_sets, ref.paged_attention_ref,
             sdpa_yardstick, 1),
            ("cuckoo_paged_attention", 152, cuckoo_sets, cuckoo_plain,
             cuckoo_library, 2)):
        kern = cycling(getattr(ops, name), sets_)
        bound, by = paged_bound(SERVE_PAGES, fetches)
        out[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces=f"src/repro/kernels/paged_attention.py:{src_line}",
            max_abs_err=max(errs[name].values()),
            max_abs_err_oml=errs[name], tolerance=PAGED_TOL,
            shape=dict(n_kv=N_KV, g=GROUP, d=HEAD_DIM, ps=PAGE_SIZE,
                       L=SERVE_PAGES, seq_len=seq_len, dtype="bfloat16"),
            splits=n_splits, split_pages=split,
            split_blocks=N_KV * -(-GROUP // ops.PAGED_QUERY_TILE) * n_splits,
            ms=time_ms(kern, 40),
            device_ms=device_ms(kern, 10, "paged_split_kernel",
                                "paged_combine_kernel"),
            device_ms_split=device_ms(kern, 10, "paged_split_kernel"),
            device_ms_combine=device_ms(kern, 10, "paged_combine_kernel"),
            plain_ms=time_ms(cycling(plain, sets_), 40),
            bound_ms=bound, bound_by=by,
            library_ms=time_ms(cycling(library, sets_), 40),
            library_call="gather + scaled_dot_product_attention "
                         "(two calls, o only)")
        k = out[name]
        log(f"kernel {name}: within {PAGED_TOL} of its plain version (max "
            f"abs err of o, m, l: {k['max_abs_err_oml']}); L={SERVE_PAGES} "
            f"bf16, {n_splits} runs of {split} pages: "
            f"{k['ms']:.6f} ms (device {k['device_ms']}: split pass "
            f"{k['device_ms_split']}, combine {k['device_ms_combine']}), "
            f"plain {k['plain_ms']:.6f} ms, bound {k['bound_ms']:.6f} ms "
            f"({by}), gather + SDPA {k['library_ms']:.6f} ms")
    lu, cu = out["paged_attention"], out["cuckoo_paged_attention"]
    for k in (lu, cu):
        check(k["device_ms"] is not None, f"{k['name']}: no device time in "
              f"the trace")
        k["bound_ratio"] = k["device_ms"] / k["bound_ms"]
    ratio = cu["device_ms"] / lu["device_ms"]
    cu["device_ratio_to_ludo"] = ratio
    log(f"paged kernels at the serve shape: device time "
        f"{lu['bound_ratio']:.3f}x (Ludo) and {cu['bound_ratio']:.3f}x (cuckoo) their byte bounds; "
        f"cuckoo / Ludo device time {ratio:.4f} with random decoys")
    return out


# ------------------------------------------------------------ phase 5
def paged_serve(k_pool, v_pool, gen) -> dict:
    """The Ludo-paged decode path: both page tables fill from the same
    allocator order, then every decode step runs ``lookup_batch`` ->
    ``ops.paged_attention`` and ``lookup2_batch`` ->
    ``ops.cuckoo_paged_attention``, each checked against a dense oracle over
    the true pages.  Returns the phase's numbers."""
    import torch
    from repro_torch.cache import CuckooPageTable, LudoPageTable
    from repro_torch.kernels import ops, ref
    n_pool = k_pool.shape[0]
    t0 = time.perf_counter()
    lt, ct = LudoPageTable(n_pool), CuckooPageTable(n_pool)
    check(lt.device.type == "cuda" and ct.device.type == "cuda",
          "a page table is not on the card")
    build_s = time.perf_counter() - t0
    lens = [SEQ_TOKENS * (i + 1) for i in range(N_SEQS)]
    pages: list[list[int]] = [[] for _ in range(N_SEQS)]
    t_app = {"ludo": 0.0, "cuckoo": 0.0}

    def append(i: int) -> None:
        lp = len(pages[i])
        t0 = time.perf_counter()
        a = lt.append_page(i, lp)
        t1 = time.perf_counter()
        b = ct.append_page(i, lp)
        t_app["ludo"] += t1 - t0
        t_app["cuckoo"] += time.perf_counter() - t1
        check(a == b, "the two tables' allocators diverged")
        pages[i].append(a)

    for i in range(N_SEQS):
        for _ in range(-(-lens[i] // PAGE_SIZE)):
            append(i)
    torch.cuda.synchronize()
    n_filled = sum(map(len, pages))
    log(f"paged fill: {n_filled} pages of {n_pool} "
        f"({n_filled / n_pool:.4f}) in {N_SEQS} sequences; Ludo "
        f"{1e6 * t_app['ludo'] / n_filled:.1f} us a page, cuckoo "
        f"{1e6 * t_app['cuckoo'] / n_filled:.1f} us a page; Ludo table "
        f"built in {build_s:.3f} s")

    unmatched, whole, steps = 0, 0, 0
    for _ in range(DECODE_STEPS):
        for i in range(N_SEQS):
            if lens[i] % PAGE_SIZE == 0:  # the new token opens a page
                append(i)
            page, off = pages[i][lens[i] // PAGE_SIZE], lens[i] % PAGE_SIZE
            kv = torch.randn((2, N_KV, HEAD_DIM), generator=gen,
                             device="cuda").to(torch.bfloat16)
            k_pool[page, off], v_pool[page, off] = kv[0], kv[1]
            lens[i] += 1
            n_pages = len(pages[i])
            q = torch.randn((N_KV, GROUP, HEAD_DIM), generator=gen,
                            device="cuda").to(torch.bfloat16)
            pm, ok = lt.lookup_batch(i, n_pages)
            o_l = ops.paged_attention(q, k_pool, v_pool, pm, lens[i])
            pm2, sel = ct.lookup2_batch(i, n_pages)
            o_c = ops.cuckoo_paged_attention(q, k_pool, v_pool, pm2, sel,
                                             lens[i])
            true_pm = torch.tensor(pages[i], dtype=torch.int32,
                                   device="cuda")
            check(torch.equal(pm[ok], true_pm[ok]),
                  "a matched page-map entry is not the allocator's page")
            check(torch.equal(pm2[torch.arange(n_pages, device="cuda"),
                                  sel.long()], true_pm),
                  "the cuckoo table lost a page")
            paged_err(o_c, ref.paged_attention_ref(q, k_pool, v_pool,
                                                   true_pm, lens[i]))
            miss = int((~ok).sum())
            unmatched += miss
            if miss == 0:
                whole += 1
                paged_err(o_l, o_c)
            steps += 1
    check(whole > 0, "no sequence's page map matched whole")
    for i in range(N_RELEASE):
        n_rel = len(pages[i])
        check(lt.release_sequence(i) == ct.release_sequence(i) == n_rel,
              "release freed another page count")
        check(all(lt.lookup(i, lp) is None for lp in range(n_rel)),
              "a released page is still found")
    torch.cuda.synchronize()
    n_decode = sum(map(len, pages)) - n_filled
    log(f"paged decode: {steps} steps over {N_SEQS} sequences; "
        f"{n_decode} pages appended on the way; "
        f"{unmatched} unmatched page-map lanes in all (overflow residents, "
        f"no Makeup-Get); {whole} steps with a whole map, where Ludo equals "
        f"cuckoo; cuckoo equals the dense oracle on every step; "
        f"{N_RELEASE} sequences released and gone")
    res = dict(
        pages=n_filled, decode_pages=n_decode, seqs=N_SEQS, steps=steps,
        unmatched=unmatched, whole_map_steps=whole,
        append_us_ludo=1e6 * t_app["ludo"] / (n_filled + n_decode),
        append_us_cuckoo=1e6 * t_app["cuckoo"] / (n_filled + n_decode),
        cn_bits_per_page=lt.cn_bits_per_page(),
        cuckoo_bits_per_page=ct.table_bits_per_page())
    log(f"page-table memory: Ludo CN {res['cn_bits_per_page']:.4f} bits a "
        f"page, cuckoo {res['cuckoo_bits_per_page']:.4f} bits a page")
    return res, (lt, ct, pages, lens)


def paged_timings(k_pool, v_pool, gen, lt, ct, pages, lens) -> dict:
    """The path's times at the longest sequence, on its real maps (the
    cuckoo decoys are page 0), after the counted run."""
    import torch
    from repro_torch.kernels import ops
    i = N_SEQS - 1
    n_pages = len(pages[i])
    lat = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm, ok = lt.lookup_batch(i, n_pages)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    pm2, sel = ct.lookup2_batch(i, n_pages)
    lookup2_s = time.perf_counter() - t0
    q = torch.randn((N_KV, GROUP, HEAD_DIM), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def ludo():
        return ops.paged_attention(q, k_pool, v_pool, pm, lens[i])

    def cuckoo():
        return ops.cuckoo_paged_attention(q, k_pool, v_pool, pm2, sel,
                                          lens[i])

    names = ("paged_split_kernel", "paged_combine_kernel")
    res = dict(
        longest_pages=n_pages,
        lookup_batch_p50_ms=1e3 * float(np.percentile(lat, 50)),
        lookup2_batch_ms=1e3 * lookup2_s,
        decoys_page0=int((pm2[torch.arange(n_pages, device="cuda"),
                              1 - sel.long()] == 0).sum()),
        ludo_ms=time_ms(ludo, 40), cuckoo_ms=time_ms(cuckoo, 40),
        ludo_device_ms=device_ms(ludo, 10, *names),
        cuckoo_device_ms=device_ms(cuckoo, 10, *names))
    log(f"longest sequence ({n_pages} pages): lookup_batch p50 "
        f"{res['lookup_batch_p50_ms']:.4f} ms, lookup2_batch "
        f"{res['lookup2_batch_ms']:.4f} ms (host loop); attention on the "
        f"real maps: Ludo {res['ludo_ms']:.6f} ms (device "
        f"{res['ludo_device_ms']}), cuckoo {res['cuckoo_ms']:.6f} ms "
        f"(device {res['cuckoo_device_ms']}; {res['decoys_page0']} of "
        f"{n_pages} decoys are page 0)")
    return res


# ------------------------------------------------------------ phase 6
def fnm_bound(S: int, d: int, F: int, dtype) -> tuple:
    """The least time of one fused norm -> matmul: x, gamma, w read once
    and the output written once over the HBM rate, against 2*S*d*F flops
    over the peak rate of the type."""
    import torch
    elt = 2 if dtype == torch.bfloat16 else 4
    by_bytes = (S * d + d + d * F + S * F) * elt / HBM_BYTES_PER_S * 1e3
    peak = BF16_TC_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    by_ops = 2 * S * d * F / peak * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def fnm_inputs(gen, S: int, d: int, F: int, dtype, n_sets: int = 1):
    """``n_sets`` tuples (x, gamma, w) drawn on the card, as the tests draw
    them (w scaled by 1/sqrt(d)), in ``dtype``."""
    import torch
    sets = []
    for _ in range(n_sets):
        x = torch.randn((S, d), generator=gen, device="cuda").to(dtype)
        g = torch.randn((d,), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((d, F), generator=gen, device="cuda")
             / d ** 0.5).to(dtype)
        sets.append((x, g, w))
    return sets


def fnm_library(x, gamma, w):
    """The library yardstick, which the port never calls: PyTorch's
    ``rms_norm``, then ``matmul``."""
    import torch
    import torch.nn.functional as F
    return torch.matmul(F.rms_norm(x, (x.shape[1],), gamma, 1e-6), w)


def fnm_plan_of(S: int, d: int, F: int, dt: str) -> dict:
    """The plan ``ops.fused_norm_matmul`` takes for a contiguous call of
    these sizes on card 0."""
    import torch
    from repro_torch.kernels import ops
    elt = getattr(torch, dt).itemsize
    return ops.fused_norm_matmul_plan(
        S, d, F, elt, torch.cuda.get_device_properties(0).multi_processor_count)


def fnm_kernels_of(plan: dict) -> tuple:
    """The CUDA kernels, by their names in ``ops.FNM_KERNELS``, that a
    ``fused_norm_matmul`` call of ``plan`` launches, each once: the row
    pass then the tile kernel for ``wgmma`` and ``fma``; the split kernel,
    then the combine when it has more than one split, for the rest."""
    main = f"fused_norm_matmul_{plan['regime']}_kernel"
    if plan["regime"] in ("wgmma", "fma"):
        return "fused_norm_matmul_rows_kernel", main
    if plan["splits"] > 1:
        return main, "fused_norm_matmul_combine_kernel"
    return (main,)


def check_fnm_shapes(gen, check_shapes) -> list:
    """``fused_norm_matmul`` against its plain version on the card at each
    (S, d, F, dtype) of ``check_shapes``, within FNM_TOL, two calls bit for
    bit alike -> each shape's record."""
    import torch
    from repro_torch.kernels import ops, ref
    shapes = []
    for S, d, F, dt in check_shapes:
        dtype = getattr(torch, dt)
        x, g, w = fnm_inputs(gen, S, d, F, dtype)[0]
        got = ops.fused_norm_matmul(x, g, w)
        again = ops.fused_norm_matmul(x, g, w)
        want = ref.fused_norm_matmul_ref(x, g, w)
        torch.cuda.synchronize()
        tol = FNM_TOL[dt]
        e = float((got.float() - want.float()).abs().max())
        plan = fnm_plan_of(S, d, F, dt)
        check(got.dtype == dtype and got.shape == (S, F)
              and torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
              f"fused_norm_matmul differs from its plain version beyond "
              f"{tol} at S={S}, d={d}, F={F}, {dt}, plan {plan} (max abs "
              f"err {e})")
        check(torch.equal(got, again),
              f"fused_norm_matmul: two calls differ at S={S}, d={d}, F={F}, "
              f"{dt}, plan {plan}")
        shapes.append(dict(S=S, d=d, F=F, dtype=dt, max_abs_err=e,
                           tolerance=tol, plan=plan))
        del x, g, w
    regimes = {}
    for sh in shapes:
        regimes[sh["plan"]["regime"]] = regimes.get(sh["plan"]["regime"],
                                                    0) + 1
    log(f"kernel fused_norm_matmul: within tolerance of its plain version, "
        f"and two calls bit for bit alike, at {len(shapes)} shapes (max abs "
        f"err {max(sh['max_abs_err'] for sh in shapes)}; shapes by regime "
        f"{regimes})")
    return shapes


def time_fnm_shape(gen, S: int, d: int, F: int, dt: str,
                   library_device: bool = False) -> dict:
    """One shape of ``fused_norm_matmul`` timed by events and by the
    profiler's device time, beside its bound, its plain version and the
    library's ``rms_norm`` + ``matmul``, each launch on one of enough
    weight sets that it finds its w outside the 50 MB L2, as a layer's
    weights are on the model path.  With ``library_device`` the library is
    also timed like for like, by the median device time of
    FNMB_BUSY_TRACES traces (:func:`device_busy_ms`), and
    ``device_below_library`` compares device with device; else with the
    library's events."""
    import torch
    from repro_torch.kernels import ops, ref
    dtype = getattr(torch, dt)
    w_bytes = d * F * (2 if dtype == torch.bfloat16 else 4)
    sets = fnm_inputs(gen, S, d, F, dtype,
                      max(2, -(-COLD_BYTES // w_bytes)))
    iters = 200
    bound, by = fnm_bound(S, d, F, dtype)
    kern = cycling(ops.fused_norm_matmul, sets)
    plan = fnm_plan_of(S, d, F, dt)
    by_kernel = device_times(kern, 20, *fnm_kernels_of(plan))
    dev = sum(by_kernel.values()) or None
    row = dict(S=S, d=d, F=F, dtype=dt, weight_sets=len(sets), plan=plan,
               ms=time_ms(kern, iters), device_ms=dev,
               device_ms_by_kernel=by_kernel,
               plain_ms=time_ms(cycling(ref.fused_norm_matmul_ref, sets),
                                iters),
               library_ms=time_ms(cycling(fnm_library, sets), iters),
               bound_ms=bound, bound_by=by)
    lib = row["library_ms"]
    if library_device:
        traces = device_busy_ms(cycling(fnm_library, sets), 10)
        check(len(traces) == FNMB_BUSY_TRACES, f"fused_norm_matmul S={S} "
              f"d={d} F={F}: a trace of the library held no device "
              f"operation ({traces})")
        lib = row["library_device_ms"] = float(np.median(traces))
        row["library_device_ms_traces"] = traces
    row["device_below_library"] = dev is not None and dev < lib
    if dev:
        row["share_of_bound"] = bound / dev
    shares = {k: round(v / dev, 4) for k, v in by_kernel.items()} \
        if dev else {}
    log(f"fused_norm_matmul S={S} d={d} F={F} {dt}, plan {row['plan']}: "
        f"{row['ms']:.6f} ms (device {dev}; share by kernel {shares}), "
        f"plain {row['plain_ms']:.6f} ms, rms_norm + matmul "
        f"{row['library_ms']:.6f} ms (device "
        f"{row.get('library_device_ms')}), bound {bound:.6f} ms ({by}); "
        f"device below library ({'device' if library_device else 'events'}"
        f"): {row['device_below_library']}")
    return row


def check_fused_norm_matmul(gen) -> dict:
    """The kernel against its plain version on the card at the test, ragged,
    serve, prefill and regime-edge shapes, two calls bit for bit alike, then
    timed at the serve and prefill shapes."""
    from repro_torch.kernels import ops
    shapes = check_fnm_shapes(gen, FNM_CHECK_SHAPES)
    err = max(sh["max_abs_err"] for sh in shapes)
    timed = {sh: time_fnm_shape(gen, *sh, library_device=sh[0] > 32)
             for sh in FNM_TIMED_SHAPES}
    # the record's numbers: one layer's five entries of a decode step
    layer = [(LANES, D_MODEL, f, "bfloat16") for f in LAYER_ENTRY_FS]
    total = {k: sum(timed[sh][k] for sh in layer)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    dev = [timed[sh]["device_ms"] for sh in layer]
    log(f"fused_norm_matmul, one layer's five decode entries: device "
        f"{None if None in dev else sum(dev)} ms, rms_norm + matmul "
        f"{total['library_ms']:.6f} ms, bound {total['bound_ms']:.6f} ms")
    return dict(
        name="fused_norm_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_norm_matmul.cu",
        replaces="src/repro/kernels/fused_norm_matmul.py:33",
        max_abs_err=err,
        work=f"one layer's five decode entries (wq, wk, wv, w_gate, w_up) "
             f"at S={LANES}, d={D_MODEL}, bf16: F={list(LAYER_ENTRY_FS)}",
        device_ms=None if None in dev else sum(dev),
        bound_by="bytes" if all(timed[sh]["bound_by"] == "bytes"
                                for sh in layer) else "operations",
        library_call="F.rms_norm + torch.matmul (two calls)",
        cuda_kernels=list(ops.FNM_KERNELS),
        **total, check_shapes=shapes, timed_shapes=list(timed.values()))


# ------------------------------------------------------------ phase 7
def serve_model(gen_seed: int) -> dict:
    """The dense-model serving path: ``Engine(LM(llama3.2-1b))`` at full
    width on the card with bf16 weights from the seed, 16 requests through
    8 lanes.  Returns the phase's numbers and the model, for the checks
    that follow the counted run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import LM
    from repro_torch.serve import Engine
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(gen_seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    check(model.device.type == "cuda"
          and params["embed"].is_cuda and params["embed"].dtype
          == torch.bfloat16, "the model is not on the card in bf16")
    log(f"model: {cfg.name}, {n_params} parameters "
        f"({2 * n_params} B in bf16), drawn on the card in {init_s:.3f} s")
    eng = Engine(model, params, lanes=LANES, max_seq=MAX_SEQ)
    reqs = engine_requests(gen_seed, cfg.vocab_size, N_REQUESTS, PROMPT_MIN,
                           PROMPT_MAX, MAX_NEW)
    times, launches, run_s = run_timed_engine(eng, reqs)
    res = dict(model=cfg.name, params=n_params, lanes=LANES,
               max_seq=MAX_SEQ, requests=N_REQUESTS,
               **engine_numbers(eng, reqs, times, launches, run_s, cfg,
                                ENTRIES_PER_LAYER * cfg.num_layers))
    return res, model, params, eng


def engine_numbers(eng, reqs, times, launches, run_s, cfg,
                   fused_per_call: int) -> dict:
    """Checks an engine run of :func:`run_timed_engine` (every request
    finished with its ``max_new`` tokens in range, the prompt tokens and
    decode steps counted, ``fused_per_call`` fused launches in each
    decode_step call) and returns its numbers."""
    n_calls = len(times["prefill"]) + len(times["decode"])
    st = eng.stats
    check(st.finished == len(reqs) and all(r.done for r in reqs),
          f"{cfg.name}: a request did not finish")
    check(all(len(r.out) == r.max_new for r in reqs),
          f"{cfg.name}: a request stopped before max_new")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
          f"{cfg.name}: a generated token is out of range")
    check(st.prefill_tokens == sum(len(r.prompt) for r in reqs),
          f"{cfg.name}: prefill_tokens is not the sum of the prompt lengths")
    check(st.decode_steps == len(times["decode"]),
          f"{cfg.name}: decode steps and timed batched steps differ")
    check(launches["fused_norm_matmul"] == fused_per_call * n_calls,
          f"{cfg.name}: fused_norm_matmul launched "
          f"{launches['fused_norm_matmul']} times in {n_calls} decode_step "
          f"calls, not {fused_per_call} a call")
    dec = np.asarray(times["decode"]) * 1e3
    pre = np.asarray(times["prefill"]) * 1e3
    generated = sum(len(r.out) for r in reqs)
    res = dict(
        prompt_tokens=st.prefill_tokens, generated_tokens=generated,
        decode_steps=st.decode_steps, decode_step_calls=n_calls, run_s=run_s,
        generated_tokens_per_s=generated / run_s,
        decode_step_p50_ms=float(np.percentile(dec, 50)),
        decode_step_p99_ms=float(np.percentile(dec, 99)),
        prefill_token_step_p50_ms=float(np.percentile(pre, 50)),
        fused_per_call=fused_per_call, launches=launches)
    log(f"{cfg.name}: served {len(reqs)} requests ({st.prefill_tokens} "
        f"prompt tokens, {generated} generated) in {run_s:.3f} s: "
        f"{st.decode_steps} batched decode steps p50 "
        f"{res['decode_step_p50_ms']:.4f} ms, p99 "
        f"{res['decode_step_p99_ms']:.4f} ms; prefill-token steps p50 "
        f"{res['prefill_token_step_p50_ms']:.4f} ms; "
        f"{res['generated_tokens_per_s']:.2f} generated tokens/s; launches "
        f"{launches} ({fused_per_call} fused a decode_step call, as the "
        f"program implies)")
    return res


def engine_requests(seed: int, vocab: int, n: int, lo: int, hi: int,
                    max_new: int) -> list:
    """``n`` requests of ``lo``-``hi`` prompt tokens drawn from the seed,
    each for ``max_new`` greedy tokens."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
        1, vocab, int(rng.integers(lo, hi + 1)))], max_new=max_new)
        for i in range(n)]


def run_timed_engine(eng, reqs) -> tuple:
    """``eng`` serves ``reqs`` with every decode_step call synced and timed,
    a call made from the lane-by-lane prefill told apart from the batched
    decode steps; the launch counters are zeroed just before the run and
    read just after -> (times {"prefill": [s], "decode": [s]}, launches,
    run seconds)."""
    import torch
    from repro_torch.kernels import ops
    for r in reqs:
        eng.submit(r)
    step, lane_token = eng._step, eng._decode_lane_token
    in_prefill, times = [False], {"prefill": [], "decode": []}

    def timed_step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a)
        torch.cuda.synchronize()
        times["prefill" if in_prefill[0] else "decode"].append(
            time.perf_counter() - t0)
        return out

    def prefill_token(lane, tok):
        in_prefill[0] = True
        try:
            lane_token(lane, tok)
        finally:
            in_prefill[0] = False

    eng._step, eng._decode_lane_token = timed_step, prefill_token
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    eng._step, eng._decode_lane_token = step, lane_token
    return times, launches, run_s


def profile_decode(model, params, cache, lanes: int = LANES,
                   steps: int = PROFILED_STEPS) -> dict:
    """``steps`` batched decode steps of ``lanes`` lanes as the engine runs
    them (step, greedy sample, pull to the host) under ``torch.profiler``:
    the device busy share of the host wall time and the fused kernel's
    share of device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    tokens = torch.ones((lanes, 1), dtype=torch.int32, device="cuda")
    model.decode_step(params, tokens, cache)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(params, tokens, cache)
            tokens = torch.argmax(logits, -1).int()[:, None]
            tokens.tolist()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_ops = device_busy_us(prof)
    fused = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and any(k in e.name for k in ops.FNM_KERNELS))
    res = dict(profiled_steps=steps,
               profiled_step_ms=wall_us / steps / 1e3,
               device_busy_share=busy / wall_us if n_ops else None,
               fused_share_of_device_time=fused / busy if busy else None,
               device_ops_per_step=n_ops / steps)
    log(f"profiled decode ({steps} steps): "
        f"{res['profiled_step_ms']:.4f} ms a step, device busy share "
        f"{res['device_busy_share']}, fused_norm_matmul "
        f"{res['fused_share_of_device_time']} of device time, "
        f"{res['device_ops_per_step']:.1f} device ops a step")
    return res


def float32_twin(params, gen_seed: int) -> dict:
    """The same weights as float32 on the card and on the CPU (plain
    versions): 4 teacher-forced decode steps of the 8 lanes; logits within
    TWIN_TOL absolute and the same argmax on every lane."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32")
    runs = {}
    for device in ("cuda", "cpu"):
        model = LM(cfg, device=device)
        p32 = tree_map(lambda t: t.to(device=device, dtype=torch.float32),
                       params)
        cache = model.init_cache(LANES, TWIN_STEPS + 1)
        rng = np.random.default_rng(gen_seed + 1)
        out = []
        t0 = time.perf_counter()
        for _ in range(TWIN_STEPS):
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (LANES, 1)).astype(np.int32)).to(device)
            logits, cache = model.decode_step(p32, tok, cache)
            out.append(logits.cpu())
        runs[device] = (torch.stack(out), time.perf_counter() - t0)
        del p32, cache
    (gpu, gpu_s), (cpu, cpu_s) = runs["cuda"], runs["cpu"]
    err = float((gpu - cpu).abs().max())
    same = bool(torch.equal(gpu.argmax(-1), cpu.argmax(-1)))
    check(torch.isfinite(gpu).all() and err <= TWIN_TOL,
          f"float32 twin: card and CPU logits differ by {err} > {TWIN_TOL}")
    check(same, "float32 twin: the argmax differs between card and CPU")
    log(f"float32 twin: {TWIN_STEPS} teacher-forced steps of {LANES} lanes, "
        f"card vs CPU max abs logit err {err} (tolerance {TWIN_TOL}, logits "
        f"up to {float(cpu.abs().max()):.4f}), same argmax on every lane; "
        f"card {gpu_s:.3f} s, CPU {cpu_s:.3f} s")
    return dict(twin_steps=TWIN_STEPS, twin_max_abs_err=err,
                twin_tolerance=TWIN_TOL, twin_same_argmax=same)


# ------------------------------------------------------------ phase 8
def _same(a, b) -> bool:
    """Deep equality of nested dicts, lists and numpy arrays."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def _drive(store, stream) -> list:
    hs = [store.submit(op, k) if v is None else store.submit(op, k, v)
          for op, k, v in stream]
    store.flush()
    return _results(hs)


def _store_image(store) -> dict:
    """What the agreement compares: meter totals, resize events (less their
    wall-clock seconds), directory, depths, every table's MN image and the
    cache's whole state."""
    eng = store.engine
    return dict(meter=store.meter_totals().snapshot(),
                events=[(e.step, e.table_keys, e.locator_bytes,
                         e.buffered_mutations) for e in eng.resize_events],
                directory=list(eng.directory),
                local_depth=list(eng.local_depth),
                tables=[t.mn_state() for t in eng.tables],
                cache=store.cache.state())


def store_agreement_check(seed: int, devices=("cuda", "cpu")) -> dict:
    """A small cached outback-dir store on the card answers, meters, splits
    and caches exactly as the same store on the CPU: zipf Gets with
    repeated absent keys, updates and deletes of hot keys, inserts until a
    table splits on its own, then a forced split with Gets, inserts and
    deletes inside its window."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    n = 1 << DIR_AGREE_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(9 << 40))
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(n, 4 * n, dtype=np.uint64)
                       + np.uint64(9 << 40))
    absent = splitmix64(np.arange(64, dtype=np.uint64) + np.uint64(11 << 40))
    rng = np.random.default_rng(seed)
    ranks = zipf_ranks(rng, n, 1 << 15)
    mixed = []
    for t, kind in enumerate(rng.choice(4, 8192, p=[0.7, 0.1, 0.12, 0.08])):
        k = int(keys[ranks[t]])
        mixed.append([("get", k, None),
                      ("get", int(absent[rng.integers(0, 64)]), None),
                      ("update", k, t), ("delete", k, None)][kind])
    after = [("get", int(keys[r]), None) for r in ranks[12288:16384]]
    order = rng.permutation(2048 + 512 + 256)  # of the split window's ops
    spec = StoreSpec("outback-dir", load_factor=DIR_LOAD_FACTOR,
                     rng_seed=seed, cache_budget_bytes=DIR_AGREE_CACHE,
                     params={"initial_depth": 1},
                     batch=BatchPolicy(window=WINDOW))
    runs = []
    for device in devices:
        st = open_store(spec, keys, vals, device=device)
        eng, out = st.engine, []
        out.append(_drive(st, mixed))
        i = 0  # inserts of new keys until a table splits on its own
        while not eng.resize_events:
            check(i + WINDOW <= fresh.size // 2,
                  "agreement: inserts never split a table")
            out.append(_drive(st, [("insert", int(k), i) for k in
                                   fresh[i:i + WINDOW]] + mixed[:256]))
            i += WINDOW
        organic = len(eng.resize_events)
        h = eng.begin_split(eng.directory[0])
        window = ([("get", int(keys[r]), None) for r in ranks[8192:10240]]
                  + [("insert", int(k), 7) for k in fresh[i:i + 512]]
                  + [("delete", int(keys[r]), None)
                     for r in ranks[10240:10496]])
        out.append(_drive(st, [window[j] for j in order]))
        h.build()
        h.finish()
        out.append(_drive(st, after))
        probe = st.get_batch(np.concatenate([keys, fresh[:i + 512], absent]))
        out.append((probe.values.tolist(), probe.found.tolist()))
        check(len(eng.resize_events) == organic + 1,
              "agreement: the forced split did not finish")
        runs.append((out, _store_image(st)))
    check(runs[0][0] == runs[1][0], "the cached directory store on the card "
          "answers otherwise than on the CPU")
    check(_same(runs[0][1], runs[1][1]), "the cached directory store on the "
          "card meters, splits or caches otherwise than on the CPU")
    img = runs[0][1]
    res = dict(keys=n, ops=sum(len(r) for r in runs[0][0][:-1]),
               resize_events=img["events"],
               cache_stats=img["cache"]["stats"])
    log(f"store agreement: a {n}-key outback-dir store with a "
        f"{DIR_AGREE_CACHE}-byte cache on {devices[0]} answers "
        f"{res['ops']} ops (gets of absent keys, updates and deletes of "
        f"hot keys, inserts through an organic split, a forced split) and "
        f"meters, splits and caches exactly as on {devices[1]}: "
        f"{json.dumps(res)}")
    return res


def _timed_calls(obj, name: str, sink: list) -> None:
    """Wrap ``obj.name`` so each call appends its host µs to ``sink``."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sink.append((time.perf_counter() - t0) * 1e6)
        return out

    setattr(obj, name, timed)


def serve_directory(keys, vals, rng) -> dict:
    """Phase 8 at full size: the cached outback-dir store serves YCSB-C and
    YCSB-A through submit/flush, then splits table 0 with traffic in the
    window; every answer and, after the split, every cached entry is held
    against the host oracle.  The index kernels must launch in every window
    with a cache miss or a write.  It takes the first
    2^``LATER_KEYS_LOG2`` of the keys."""
    import torch
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import ops
    keys, vals = keys[:1 << LATER_KEYS_LOG2], vals[:1 << LATER_KEYS_LOG2]
    n = keys.size
    spec = StoreSpec("outback-dir", load_factor=DIR_LOAD_FACTOR,
                     rng_seed=SEED,
                     cache_budget_bytes=DIR_CACHE_BYTES_PER_KEY * n,
                     params={"initial_depth": 1},
                     batch=BatchPolicy(window=WINDOW))
    t0 = time.perf_counter()
    store = open_store(spec, keys, vals)
    torch.cuda.synchronize()
    eng, cache = store.engine, store.cache
    res = dict(build_seconds=time.perf_counter() - t0,
               table_keys=[t.n_keys for t in eng.tables],
               cache_budget_bytes=cache.budget_bytes,
               cache_memory_bytes=cache.memory_bytes(),
               cache_capacity=cache.capacity)
    check(cache.device.type == "cuda" and cache.k_lo.is_cuda
          and all(t.slots_lo.is_cuda for t in eng.tables),
          "the cached directory store is not on the card")
    log(f"directory store build: {res['build_seconds']:.3f} s, tables "
        f"{res['table_keys']}, cache {res['cache_memory_bytes']} B of "
        f"{res['cache_budget_bytes']} ({cache.nsets} sets of {cache.ways}, "
        f"{cache.nneg} negative slots, sketch 2 x {cache.sketch_w})")
    probe_us, observe_us = [], []
    _timed_calls(cache, "probe_batch", probe_us)
    _timed_calls(cache, "observe_batch", observe_us)
    latest = vals.copy()
    perm = rng.permutation(n)
    stats = cache.stats
    windows_checked = [0, 0]  # [windows with a miss or a write, all-hit]

    def window(stream, expect=None):
        """One window of ops, flushed; checks its reads against ``expect``
        and that both index kernels launched if it missed or wrote.
        Returns (host ms, handles)."""
        l0, m0 = dict(ops.LAUNCHES), stats.misses
        t0 = time.perf_counter()
        hs = [store.submit(op, k) if v is None else store.submit(op, k, v)
              for op, k, v in stream]
        store.flush()
        ms = (time.perf_counter() - t0) * 1e3
        wrote = any(op != "get" for op, _, _ in stream)
        if stats.misses > m0 or wrote:
            windows_checked[0] += 1
            for kern in ("ludo_lookup", "slot_unpack"):
                check(ops.LAUNCHES[kern] > l0[kern],
                      f"a window with a miss launched no {kern}")
        else:
            windows_checked[1] += 1
        if expect is not None:
            got = [h for h, (op, _, _) in zip(hs, stream) if op == "get"]
            check(all(bool(h.result().found[0]) for h in got),
                  "a present key missed")
            check(np.array_equal(np.asarray([h.result().values[0]
                                             for h in got], np.uint64),
                                 expect), "a read did not see the latest "
                  "value")
        return ms, hs

    def gets(name, idx):
        s0 = dataclasses.asdict(stats)
        del probe_us[:], observe_us[:]
        lat = []
        t0 = time.perf_counter()
        for w0 in range(0, idx.size, WINDOW):
            wi = idx[w0:w0 + WINDOW]
            ms, _ = window([("get", int(k), None) for k in keys[wi]],
                           latest[wi])
            lat.append(ms)
        sec = time.perf_counter() - t0
        d = {k: v - s0[k] for k, v in dataclasses.asdict(stats).items()}
        looked = d["hits"] + d["neg_hits"] + d["misses"]
        r = dict(gets=int(idx.size), seconds=sec, gets_per_s=idx.size / sec,
                 p50_ms=float(np.percentile(lat, 50)),
                 p99_ms=float(np.percentile(lat, 99)),
                 hit_rate=d["hits"] / looked,
                 neg_hit_rate=d["neg_hits"] / looked,
                 admitted=d["admitted"], evicted=d["evicted"],
                 probe_us_p50=float(np.median(probe_us)),
                 observe_us_p50=float(np.median(observe_us)))
        res[name] = r
        log(f"{name}: {r['gets_per_s']:.1f} Gets/s over {r['gets']} Gets; "
            f"window p50 {r['p50_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms; "
            f"hit rate {r['hit_rate']:.6f}, negative {r['neg_hit_rate']:.6f}"
            f"; probe_batch {r['probe_us_p50']:.1f} us, observe_batch "
            f"{r['observe_us_p50']:.1f} us a window (host, median)")

    ops.reset_launch_counts()
    # ---- YCSB-C ----
    gets("dir_ycsb_c", perm[zipf_ranks(rng, n, 1 << DIR_GETS_LOG2)])
    # ---- YCSB-A: half reads, half updates, in submission order ----
    n_a = 1 << LATER_YCSB_A_LOG2
    idx_a = perm[zipf_ranks(rng, n, n_a)]
    is_upd = rng.random(n_a) < 0.5
    new_v = rng.integers(0, 2**64 - 1, n_a, dtype=np.uint64, endpoint=True)
    t0 = time.perf_counter()
    for w0 in range(0, n_a, WINDOW):
        stream, expect = [], []
        for t in range(w0, min(w0 + WINDOW, n_a)):
            i = int(idx_a[t])
            if is_upd[t]:
                stream.append(("update", int(keys[i]), int(new_v[t])))
                latest[i] = new_v[t]
            else:
                stream.append(("get", int(keys[i]), None))
                expect.append(latest[i])
        _, hs = window(stream, np.asarray(expect, np.uint64))
        check(all(bool(h.result().found[0]) for h, (op, _, _)
                  in zip(hs, stream) if op == "update"),
              "YCSB-A: an update of a present key failed")
    sec = time.perf_counter() - t0
    res["dir_ycsb_a"] = dict(ops=n_a, seconds=sec, ops_per_s=n_a / sec)
    log(f"dir_ycsb_a: {n_a / sec:.1f} ops/s over {n_a} ops")

    # ---- the split of table 0, with traffic inside its window ----
    n_split = 1 << DIR_SPLIT_GETS_LOG2
    gets("split_before", perm[zipf_ranks(rng, n, n_split)])
    t_idx = eng.directory[0]
    res["split_table_keys"] = eng.tables[t_idx].n_keys
    h = eng.begin_split(t_idx)
    gets("split_during", perm[zipf_ranks(rng, n, n_split)])
    n_ins = 1 << DIR_SPLIT_INSERTS_LOG2
    fresh = splitmix64(np.arange(n, n + n_ins, dtype=np.uint64)
                       + np.uint64(_KEY_OFFSET + (1 << 39)))
    fresh_v = rng.integers(0, 2**64 - 1, n_ins, dtype=np.uint64,
                           endpoint=True)
    frozen_lane = eng._route_tables(fresh) == t_idx
    cases = []
    for w0 in range(0, n_ins, WINDOW):
        _, hs = window([("insert", int(k), int(v)) for k, v in
                        zip(fresh[w0:w0 + WINDOW], fresh_v[w0:w0 + WINDOW])])
        cases += [hh.result().statuses[0] for hh in hs]
    cases = np.asarray(cases)
    check(np.array_equal(cases == "frozen", frozen_lane),
          "an insert routed to the frozen table was not FALSE'd, or one "
          "routed elsewhere was")
    check(np.isin(cases[~frozen_lane], ["slot", "reseed", "overflow"]).all(),
          "an insert of a new key did not place it")
    t0 = time.perf_counter()
    h.build()
    build_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    h.finish()
    torch.cuda.synchronize()
    finish_s = time.perf_counter() - t0
    ev = eng.resize_events[-1]
    res.update(rebuild_seconds=ev.rebuild_seconds, build_wall_s=build_wall,
               finish_seconds=finish_s, locator_bytes=ev.locator_bytes,
               buffered_mutations=ev.buffered_mutations,
               tables_after=[t.n_keys for t in eng.tables],
               directory_after=list(eng.directory))
    check(ev.buffered_mutations == int(frozen_lane.sum()) > 0,
          "the split window buffered another number of inserts")
    log(f"split of table {t_idx} ({res['split_table_keys']} live keys): "
        f"rebuild {ev.rebuild_seconds:.3f} s (host Ludo build of the two "
        f"successors, then their arrays to the card), finish "
        f"{finish_s:.3f} s (locator swap, cache invalidation, replay of "
        f"{ev.buffered_mutations} buffered inserts), locator fetch "
        f"{ev.locator_bytes} B a compute node; tables now "
        f"{res['tables_after']}")
    gets("split_after", perm[zipf_ranks(rng, n, n_split)])
    r = store.get_batch(fresh)
    check(r.found.all() and np.array_equal(r.values, fresh_v),
          "an insert buffered in the split window, or placed beside it, "
          "lost its value")

    # ---- every cached entry against the oracle ----
    st = cache.state()
    order = np.argsort(keys)
    skeys = keys[order]

    def joined(lo, hi):
        return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)

    on = st["valid"] != 0
    ck = joined(st["k_lo"][on], st["k_hi"][on])
    cv = joined(st["v_lo"][on], st["v_hi"][on])
    pos = np.minimum(np.searchsorted(skeys, ck), n - 1)
    old = skeys[pos] == ck
    fresh_of = dict(zip(fresh.tolist(), fresh_v.tolist()))
    check(np.array_equal(cv[old], latest[order[pos[old]]]),
          "a cached entry of an old key disagrees with the oracle")
    check(all(fresh_of.get(int(k)) == int(v)
              for k, v in zip(ck[~old], cv[~old])),
          "a cached entry is neither an old nor an inserted key, or holds "
          "another value")
    nk = joined(st["nk_lo"][st["nvalid"] != 0], st["nk_hi"][st["nvalid"] != 0])
    npos = np.minimum(np.searchsorted(skeys, nk), n - 1)
    check(not (skeys[npos] == nk).any()
          and not any(int(k) in fresh_of for k in nk),
          "the negative cache holds a live key")
    res.update(cached_entries=int(on.sum()), negative_entries=int(nk.size),
               cache_stats=st["stats"], windows_with_miss=windows_checked[0],
               all_hit_windows=windows_checked[1],
               launches=dict(ops.LAUNCHES),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               meter=store.meter_totals().snapshot())
    log(f"after the split: {res['cached_entries']} cached entries and "
        f"{res['negative_entries']} negative ones, all agree with the "
        f"oracle; {windows_checked[0]} windows missed or wrote (both index "
        f"kernels launched in each), {windows_checked[1]} were answered by "
        f"the cache whole")
    return res



# ------------------------------------------------------------ phase 9
def _trace_tuples(trace) -> list:
    return [(type(e).__name__, dataclasses.astuple(e)) for e in trace]


def _sim_fields(res) -> dict:
    """A ``SimResult``'s fields, arrays as lists (compared with ``==``)."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    return out


def baseline_agreement_check(seed: int, devices=("cuda", "cpu")) -> dict:
    """Each baseline, a 2^14-key store on the card and the same on the CPU
    (each with its own transport), takes the same stream of Gets, updates,
    inserts and deletes: answers, meter totals, traces (doorbell marks
    included), the final host images, the device arrays copied back and
    the replay of both traces must be equal."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.net import Transport, simulate
    n = 1 << BASE_AGREE_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(13 << 40))
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(n, n + 2048, dtype=np.uint64)
                       + np.uint64(13 << 40))
    rng = np.random.default_rng(seed)
    stream = []
    for t, (kind, r) in enumerate(zip(
            rng.choice(4, 8192, p=[0.5, 0.25, 0.15, 0.1]),
            zipf_ranks(rng, n, 8192))):
        op = ("get", "update", "insert", "delete")[kind]
        k = int(fresh[t % 2048]) if op == "insert" else int(keys[r])
        stream.append((op, k, t if op in ("update", "insert") else None))
    out = {}
    for kind in BASELINE_KINDS:
        spec = StoreSpec(kind, load_factor=BASE_AGREE_LOAD, rng_seed=seed,
                         batch=BatchPolicy(window=WINDOW))
        runs = []
        for device in devices:
            tr = Transport()
            st = open_store(spec, keys, vals, device=device, transport=tr)
            answers = _drive(st, stream)
            probe = st.get_batch(np.concatenate([keys, fresh]))
            eng = st.engine
            check(eng.device.type == device, f"{kind}: not on {device}")
            runs.append(dict(
                answers=answers,
                probe=(probe.values.tolist(), probe.found.tolist()),
                meter=st.meter_totals().snapshot(),
                trace=_trace_tuples(tr.trace), host=eng.host_image(),
                device=eng.device_image(),
                sim=_sim_fields(simulate(tr.trace, clients=8))))
        for field in runs[0]:
            check(_same(runs[0][field], runs[1][field]), f"{kind}: the store "
                  f"on {devices[0]} differs from {devices[1]} in {field}")
        check(_same(runs[0]["host"], runs[0]["device"]),
              f"{kind}: the device arrays differ from the host image")
        out[kind] = dict(trace_items=len(runs[0]["trace"]),
                         ops=runs[0]["meter"]["ops"],
                         p50_us=float(np.percentile(
                             runs[0]["sim"]["latencies_us"], 50)))
    log(f"baseline agreement: {n}-key race, mica, cluster and dummy stores "
        f"on {devices[0]} answer {len(stream)} mixed ops (window {WINDOW}) "
        f"and meter, trace, hold their arrays and replay exactly as on "
        f"{devices[1]}: {json.dumps(out)}")
    return out


def mn_timing(fn, sets, check_fn) -> dict:
    """One MN-side step at B = ``MN_BATCH``: its answers checked, then
    timed over ``sets`` (cycled, so the gathers find a cold L2) by CUDA
    events and by ``torch.profiler`` device time; µs per op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    check_fn(fn(*sets[0]))
    step = cycling(fn, sets)
    ms = time_ms(step, 4 * len(sets))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2 * len(sets)):
            step()
        torch.cuda.synchronize()
    busy, spans = device_busy_us(prof)
    return dict(events_us_per_op=ms * 1e3 / MN_BATCH,
                device_us_per_op=(busy / (2 * len(sets)) / MN_BATCH
                                  if spans else None),
                device_ops_per_call=spans / (2 * len(sets)))


def outback_mn_timing(eng, keys, rng) -> dict:
    """The Outback MN decode of ``benchmarks/paper_figs.py``'s ``mn_fn``
    (slot gather, ``slot_unpack``, heap gather) over the phase-3 store."""
    from repro_torch.core.hashing import lanes, split_u64
    from repro_torch.kernels import ops
    sets = []
    for _ in range(COLD_SETS):
        q = keys[rng.integers(0, keys.size, MN_BATCH)]
        lo, hi = (lanes(x, eng.device) for x in split_u64(q))
        b, s = eng.cn.locate(lo, hi)
        sets.append((b.long() * 4 + s.long(), lo, hi))

    def mn(flat, lo, hi):
        _, _, _, addr = ops.slot_unpack(eng.slots_lo.view(-1)[flat],
                                        eng.slots_hi.view(-1)[flat])
        a = addr.long()
        return eng.heap_klo[a], eng.heap_khi[a], eng.heap_vlo[a], \
            eng.heap_vhi[a]

    def ok(out):
        lo, hi = sets[0][1:]
        hit = ((out[0] == lo) & (out[1] == hi)).float().mean().item()
        check(hit > 0.99, f"the Outback MN decode found {hit} of its keys")

    return mn_timing(mn, sets, ok)


def batch_visible(eng, kind: str, keys, idx) -> np.ndarray:
    """Which build keys ``keys[idx]`` a batched Get finds: a plain numpy
    model of the reference's batch rules over the engine's host image (a
    build key's heap address is its index).  RACE tries the first 3
    fingerprint candidates of its two groups, MICA the first 3 of its
    4-bucket window, Cluster the first fingerprint hit of each of its first
    ``MAX_CHAIN`` chain buckets; dummy verifies nothing."""
    from repro_torch.core.hashing import hash64_32_np, split_u64
    if kind == "dummy":
        return np.ones(idx.size, bool)
    addr, fp = eng.addr, eng.fp
    S = addr.shape[1]
    flat = addr.ravel()
    live = np.nonzero(flat >= 0)[0]
    where = np.full(eng.h_klo.shape[0], -1, np.int64)
    where[flat[live]] = live
    pos = where[idx]
    row, lane = pos // S, pos % S
    lo, hi = split_u64(keys[idx])
    if kind == "cluster":
        f = hash64_32_np(lo, hi, 0x0F14E) & 0x3FFF
        chain = [(hash64_32_np(lo, hi, 0xC1C1) % eng.nb).astype(np.int64)]
        for _ in range(eng.MAX_CHAIN - 1):
            g = chain[-1]
            chain.append(np.where(g >= 0, eng.nxt[np.maximum(g, 0)], -1))
        on_chain = (np.stack(chain, 1) == row[:, None]).any(1)
        ahead = (fp[row] == f[:, None]) & (addr[row] >= 0) \
            & (np.arange(S)[None, :] < lane[:, None])
        return (pos >= 0) & on_chain & ~ahead.any(1)
    f = hash64_32_np(lo, hi, 0x0F0F8) & 0xFF
    if kind == "race":
        bucks = np.stack([hash64_32_np(lo, hi, 0xACE0) % eng.ng,
                          hash64_32_np(lo, hi, 0xACE1) % eng.ng], 1)
        own = np.where(bucks[:, 0] == row, lane, S + lane)
        inside = pos >= 0
    else:
        home = hash64_32_np(lo, hi, 0x111CA) % eng.nb
        bucks = (home[:, None].astype(np.int64)
                 + np.arange(eng.SCAN_BUCKETS)) % eng.nb
        d = (row - home) % eng.nb
        own = d * S + lane
        inside = (pos >= 0) & (d < eng.SCAN_BUCKETS)
    cand = ((fp[bucks] == f[:, None, None]) & (addr[bucks] >= 0)) \
        .reshape(idx.size, -1)
    before = np.cumsum(cand, 1)[np.arange(idx.size),
                                np.minimum(own, cand.shape[1] - 1)] - 1
    return inside & (before < 3)


def serve_baseline(kind: str, keys, vals, rng) -> dict:
    """Phase 9 at full size, one baseline: build it through ``open_store``
    at the reference's default load factor, serve YCSB-C and YCSB-A at
    window 1024, then deletes and Gets of the deleted keys, every answer
    checked against the oracle (for dummy, which verifies no key, the value
    at index ``key % n``); then time its MN step at B = ``MN_BATCH``.  It
    takes the first 2^``BASE_KEYS_LOG2`` of the keys."""
    import torch
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    keys, vals = keys[:1 << BASE_KEYS_LOG2], vals[:1 << BASE_KEYS_LOG2]
    n = keys.size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = open_store(StoreSpec(kind, load_factor=BASE_LOAD_FACTOR.get(kind),
                                 rng_seed=SEED,
                                 batch=BatchPolicy(window=WINDOW)),
                       keys, vals)
    torch.cuda.synchronize()
    eng = store.engine
    res = dict(kind=kind, build_seconds=time.perf_counter() - t0,
               index_bytes=eng.index_bytes())
    check(all(x.is_cuda for x in eng.mn_arrays()),
          f"{kind}: the store is not on the card")
    verify = store.verifies_keys
    latest = vals.copy()
    perm = rng.permutation(n)

    def expect(idx):
        """The oracle: found where the batch rules reach the key, with its
        latest value (dummy: the value at index ``key % n``)."""
        seen = batch_visible(eng, kind, keys, idx)
        if verify:
            return seen, np.where(seen, latest[idx], np.uint64(0))
        return seen, vals[(keys[idx] % np.uint64(n)).astype(np.int64)]

    def get_windows(idx):
        """The Gets of ``idx``, a window at a time; returns each window's
        host ms and the answers, checked later (outside the timing)."""
        lat, hs = [], []
        for w0 in range(0, idx.size, WINDOW):
            t0 = time.perf_counter()
            hs.append(store.submit("get", keys[idx[w0:w0 + WINDOW]]))
            if not hs[-1].done:
                store.flush()
            lat.append(time.perf_counter() - t0)
        return np.asarray(lat) * 1e3, hs

    def check_gets(idx, hs) -> int:
        seen, want = expect(idx)
        check(np.array_equal(np.concatenate([h.result().found for h in hs]),
                             seen),
              f"{kind}: a Get found a key the batch rules miss, or missed "
              f"one they reach")
        check(np.array_equal(np.concatenate([h.result().values for h in hs]),
                             want), f"{kind}: a Get returned a wrong value")
        return int((~seen).sum())

    ops_0 = store.meter_totals().ops
    t_c = time.perf_counter()
    idx_c = perm[zipf_ranks(rng, n, 1 << BASE_GETS_LOG2)]
    t0 = time.perf_counter()
    lat, hs = get_windows(idx_c)
    sec = time.perf_counter() - t0
    res.update(gets_per_s=idx_c.size / sec, p50_ms=float(np.percentile(
        lat, 50)), p99_ms=float(np.percentile(lat, 99)),
        batch_misses=check_gets(idx_c, hs),
        unreachable_keys=int((~batch_visible(
            eng, kind, keys, np.arange(min(n, 1 << BASE_SCAN_LOG2)))).sum()))
    check(store.meter_totals().ops - ops_0 == idx_c.size,
          f"{kind}: the meter missed Gets")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, hs = get_windows(idx_c[:32 * WINDOW])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check_gets(idx_c[:32 * WINDOW], hs)
    busy, spans = device_busy_us(prof)
    res.update(device_busy_share=busy / wall_us if spans else None,
               device_ops_per_window=spans / 32)

    res["ycsb_c_s"] = time.perf_counter() - t_c

    # ---- YCSB-A: zipf, half reads, half updates, submission order ----
    t_a = time.perf_counter()
    n_a = 1 << LATER_YCSB_A_LOG2
    idx_a = perm[zipf_ranks(rng, n, n_a)]
    is_upd = rng.random(n_a) < 0.5
    new_v = rng.integers(0, 2**64 - 1, n_a, dtype=np.uint64, endpoint=True)
    reads, upds, want = [], [], []
    t0 = time.perf_counter()
    for t in range(n_a):
        i = int(idx_a[t])
        if is_upd[t]:
            upds.append(store.submit("update", int(keys[i]), int(new_v[t])))
            if verify:
                latest[i] = new_v[t]
        else:
            reads.append(store.submit("get", int(keys[i])))
            want.append(latest[i])  # at its place in the stream
    store.flush()
    res["ycsb_a_ops_per_s"] = n_a / (time.perf_counter() - t0)
    check(all(bool(h.result().found[0]) for h in upds),
          f"YCSB-A on {kind}: an update of a present key failed")
    seen, dummy_v = expect(idx_a[~is_upd])
    want = np.where(seen, np.asarray(want, np.uint64), np.uint64(0)) \
        if verify else dummy_v
    check(np.array_equal(np.asarray([h.result().found[0] for h in reads]),
                         seen)
          and np.array_equal(np.asarray([h.result().values[0]
                                         for h in reads], np.uint64), want),
          f"YCSB-A on {kind}: a read did not see the latest value")

    res["ycsb_a_s"] = time.perf_counter() - t_a

    # ---- deletes, then Gets of the deleted keys ----
    t_d = time.perf_counter()
    gone = rng.choice(n, 1 << BASE_DELETES_LOG2, replace=False)
    h = store.submit("delete", keys[gone])
    store.flush()
    check(h.result().found.all(), f"{kind}: a delete of a present key "
          f"failed")
    r = store.get_batch(keys[gone])
    if verify:
        check(not r.found.any(), f"{kind}: a deleted key is still found")
    else:
        check(r.found.all() and np.array_equal(r.values, expect(gone)[1]),
              f"{kind}: a Get after a delete did not read index key % n")

    # ---- the MN step at B = MN_BATCH (RACE: the CN's selection) ----
    q_idx = [rng.integers(0, n, MN_BATCH) for _ in range(COLD_SETS)]
    sets = [eng.query(keys[i]) for i in q_idx]
    arrays = eng.mn_arrays()
    step = eng.cn_select if kind == "race" else eng.mn_get_batch

    def ok(out):
        v_lo, v_hi, found = (x.cpu().numpy() for x in out)
        got = (v_hi.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
            | v_lo.view(np.uint32)
        seen, want = expect(q_idx[0])
        check(np.array_equal(found, seen)
              and np.array_equal(got[seen], want[seen]),
              f"{kind}: the MN step's answers disagree with the oracle")

    res["mn"] = mn_timing(lambda *q: step(*q, arrays), sets, ok)
    res["rest_s"] = time.perf_counter() - t_d
    res.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
               meter=store.meter_totals().snapshot())
    log(f"{kind}: build {res['build_seconds']:.3f} s (host), index "
        f"{res['index_bytes']} B; {res['unreachable_keys']} of the first "
        f"{min(n, 1 << BASE_SCAN_LOG2)} keys past the batch rules "
        f"({res['batch_misses']} of the Gets); YCSB-C "
        f"{res['gets_per_s']:.1f} Gets/s, "
        f"window p50 {res['p50_ms']:.4f} ms, p99 {res['p99_ms']:.4f} ms; "
        f"YCSB-A {res['ycsb_a_ops_per_s']:.1f} ops/s; device busy "
        f"{res['device_busy_share']} over 32 windows; MN step "
        f"{json.dumps(res['mn'])}; max_memory_allocated "
        f"{res['max_memory_allocated']} B; meter {json.dumps(res['meter'])}; "
        f"seconds: YCSB-C with its checks {res['ycsb_c_s']:.1f}, YCSB-A "
        f"{res['ycsb_a_s']:.1f}, deletes and the MN step "
        f"{res['rest_s']:.1f}")
    return res


def modelled_comparison(seed: int) -> dict:
    """The five kinds at 2^20 keys, each recording 2^SIM_GETS_LOG2 YCSB-C
    Gets through a window of 1024, replayed on CX6 with 1, 8 and 64 clients
    and one MN thread.  Checks that every Get is in the trace and that the replay is
    deterministic; the orderings are printed, not asserted."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.net import CX6, Transport, simulate
    n = 1 << SIM_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(17 << 40))
    vals = splitmix64(keys)
    rng = np.random.default_rng(seed)
    q_idx = rng.permutation(n)[zipf_ranks(rng, n, 1 << SIM_GETS_LOG2)]
    q = keys[q_idx]
    out = {}
    for kind in ("outback",) + BASELINE_KINDS:
        tr = Transport()
        st = open_store(StoreSpec(kind, rng_seed=seed,
                                  batch=BatchPolicy(window=WINDOW)),
                        keys, vals, transport=tr)
        hs = [st.submit("get", q[w0:w0 + WINDOW])
              for w0 in range(0, q.size, WINDOW)]
        st.flush()
        found = np.concatenate([h.result().found for h in hs])
        check(np.array_equal(found, np.ones(q.size, bool) if kind == "outback"
                             else batch_visible(st.engine, kind, keys, q_idx)),
              f"{kind}: a recorded Get's answer disagrees with the oracle")
        check(len(tr) == q.size, f"{kind}: {len(tr)} ops in the trace for "
              f"{q.size} Gets")
        runs, t0 = {}, time.perf_counter()
        for c in SIM_CLIENTS:
            r = simulate(tr.trace, clients=c, mn_threads=1, service=CX6)
            check(r.n_ops == q.size, f"{kind}: the replay lost ops")
            runs[c] = r
        again = simulate(tr.trace, clients=SIM_CLIENTS[1], mn_threads=1,
                         service=CX6)
        check(_same(_sim_fields(again), _sim_fields(runs[SIM_CLIENTS[1]])),
              f"{kind}: the replay is not deterministic")
        out[kind] = {str(c): dict(p50_us=r.percentile_us(50),
                                  p99_us=r.percentile_us(99),
                                  mops=r.tput_mops)
                     for c, r in runs.items()}
        out[kind]["replay_seconds"] = time.perf_counter() - t0
        del st, tr
        gc.collect()
    for c in SIM_CLIENTS:
        log(f"modelled (CX6, {c} clients, 1 MN thread): " + ", ".join(
            f"{k} p50 {v[str(c)]['p50_us']:.4f} us p99 "
            f"{v[str(c)]['p99_us']:.4f} us {v[str(c)]['mops']:.4f} Mops"
            for k, v in out.items()))
    return out


# ------------------------------------------------------------ phase 10
def init_world(rdv: str) -> None:
    """A world of this one process, whose group serves CPU tensors with
    gloo and card tensors with NCCL (``file://`` rendezvous at ``rdv``)."""
    import torch.distributed as dist
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{rdv}",
                            rank=0, world_size=1)


def warm_cn_cache(cache, keys, vals, present, idx) -> None:
    """Warm ``cache`` on the Gets ``idx``, a window at a time: each window
    probed, then observed with the keys' values and presence."""
    from repro_torch.core.hashing import split_u64
    for w0 in range(0, idx.size, WINDOW):
        i = idx[w0:w0 + WINDOW]
        lo, hi = split_u64(keys[i])
        v_lo, v_hi = split_u64(vals[i])
        hit, neg, _, _ = cache.probe_batch(lo, hi)
        cache.observe_batch(lo, hi, v_lo, v_hi, present[i], hit, neg)


def _metered(state, tr):
    """``state`` with a fresh meter sinking into ``tr``."""
    from repro_torch.core.meter import CommMeter
    meter = CommMeter()
    meter.sink = tr
    return dataclasses.replace(state, meter=meter)


def mesh_agreement_check(seed: int, meshes: dict) -> dict:
    """A 2^14-key ``sharded`` store (one shard) on the card and the same on
    the CPU, each with its own transport, take the same stream of Gets,
    updates, inserts and deletes: answers, meter totals, traces and the
    re-installed mesh state must be equal.  Then each state's mesh Get
    (``meshes``: the (1, 1) mesh on each device) for both variants, plain
    and with a warmed one-replica CN cache, each with a transport: every
    output lane, the hit mask, the meter and the trace must be equal."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core import sharded_kvs as skv
    from repro_torch.core.cn_cache import CNKeyCache, ShardedCNCache
    from repro_torch.core.hashing import lanes, split_u64, splitmix64
    from repro_torch.kernels import ops
    from repro_torch.net import Transport
    n = 1 << MESH_AGREE_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(15 << 40))
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(n, n + 2048, dtype=np.uint64)
                       + np.uint64(15 << 40))
    rng = np.random.default_rng(seed)
    stream = []
    for t, (kind, r) in enumerate(zip(
            rng.choice(4, 8192, p=[0.5, 0.25, 0.15, 0.1]),
            zipf_ranks(rng, n, 8192))):
        op = ("get", "update", "insert", "delete")[kind]
        k = int(fresh[t % 2048]) if op == "insert" else int(keys[r])
        stream.append((op, k, t if op in ("update", "insert") else None))
    spec = StoreSpec("sharded", rng_seed=seed,
                     batch=BatchPolicy(window=WINDOW),
                     params={"num_shards": 1})
    every = np.concatenate([keys, fresh])
    runs, states = [], {}
    for device, mesh in meshes.items():
        tr = Transport()
        st = open_store(spec, keys, vals, device=mesh.device, transport=tr)
        check({sh.device for sh in st.engine.shards} == {mesh.device},
              f"sharded: the kept shard is not on {mesh.device}")
        answers = _drive(st, stream)
        probe = st.get_batch(every)
        states[device] = st.mesh_state()
        runs.append(dict(answers=answers,
                         probe=(probe.values.tolist(), probe.found.tolist()),
                         meter=st.meter_totals().snapshot(),
                         trace=_trace_tuples(tr.trace),
                         state=[a.copy() for a in states[device].arrays()]))
    for field in runs[0]:
        check(_same(runs[0][field], runs[1][field]), f"sharded: the store "
              f"on the card differs from the CPU's in {field}")
    # the mesh Get over each device's state: zipf lanes over old and new
    # keys (deleted ones among them) and the all-ones sentinel key
    latest = np.asarray(runs[0]["probe"][0], np.uint64)
    present = np.asarray(runs[0]["probe"][1], bool)
    q_idx = zipf_ranks(rng, every.size, 4 * WINDOW)
    q = every[q_idx]
    q[::509] = np.uint64(0xFFFFFFFFFFFFFFFF)
    out = {}
    for variant in MESH_VARIANTS:
        for cached in (False, True):
            res = []
            for device, mesh in meshes.items():
                tr = Transport()
                st = _metered(states[device], tr)
                extra, cache = (), None
                if cached:
                    c = CNKeyCache(DIR_AGREE_CACHE, device=mesh.device)
                    warm_cn_cache(c, every, latest, present,
                                  np.concatenate([q_idx, q_idx]))
                    cache = ShardedCNCache(c, 1)
                    extra = skv.place_cache(mesh, cache)
                fn, _ = skv.make_get_fn(mesh, st, q.size, variant=variant,
                                        cache=cache)
                lo, hi = (lanes(x, mesh.device) for x in split_u64(q))
                l0 = dict(ops.LAUNCHES)
                o = fn(lo, hi, *extra, *skv.place_state(mesh, st))
                launched = [ops.LAUNCHES[k] - l0[k]
                            for k in ("ludo_lookup", "slot_unpack")]
                if mesh.device.type == "cuda":
                    check(min(launched) >= 1, f"mesh {variant}: an index "
                          f"kernel did not launch on the card")
                res.append(dict(lanes=[x.cpu().numpy() for x in o],
                                meter=st.meter.snapshot(),
                                trace=_trace_tuples(tr.trace)))
            name = variant + ("+cache" if cached else "")
            for field in res[0]:
                check(_same(res[0][field], res[1][field]), f"mesh {name}: "
                      f"the card differs from the CPU in {field}")
            lanes_ = res[0]["lanes"]
            out[name] = dict(matched=int(lanes_[2].sum()),
                             hits=int(lanes_[3].sum()) if cached else 0,
                             trace_ops=len(res[0]["trace"]))
    log(f"mesh agreement: a {n}-key sharded store on the card answers "
        f"{len(stream)} mixed ops, meters, traces and re-installs its mesh "
        f"state exactly as on the CPU; the (1, 1) mesh Get of {q.size} "
        f"lanes agrees lane for lane, with meters and traces: "
        f"{json.dumps(out)}")
    return out


def mesh_profile(step, calls: int) -> dict:
    """``calls`` calls of ``step`` under ``torch.profiler``: device time
    and device operations a call, the device's busy share of the wall
    time, and the share of device time in NCCL's kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, spans = device_busy_us(prof)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in dev)
    nccl = sum(e.time_range.elapsed_us() for e in dev
               if "nccl" in e.name.lower())
    if not spans:
        return dict(device_ms_per_call=None, device_ops_per_call=None,
                    device_busy_share=None, collective_share=None)
    return dict(device_ms_per_call=total / calls / 1e3,
                device_ops_per_call=spans / calls,
                device_busy_share=busy / wall_us,
                collective_share=nccl / total)


def serve_mesh(keys, vals, rng, mesh) -> dict:
    """Phase 10 at full size: one ``sharded`` store (one shard) over phase
    3's keys with a transport; YCSB-C through the adapter at window 1024;
    then its mesh state placed on the (1, 1) mesh and 2^20 zipf Gets
    through ``make_get_fn`` for each variant in calls of 1024 and 2^16
    lanes, plain and with a 128 MiB CN cache warmed on the stream's first
    2^18 Gets.  Every answer is checked: a lane misses only where its key
    is an overflow resident (the mesh runs no Makeup-Get) and no cache hit
    answered it; no lane is dropped."""
    import torch
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core import sharded_kvs as skv
    from repro_torch.core.cn_cache import CNKeyCache, ShardedCNCache
    from repro_torch.core.hashing import join_u64, lanes, split_u64
    from repro_torch.kernels import ops
    from repro_torch.net import Transport
    n = keys.size
    tr = Transport()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = open_store(StoreSpec("sharded", rng_seed=SEED,
                                 batch=BatchPolicy(window=WINDOW),
                                 params={"num_shards": 1,
                                         "data_parallel": 1}),
                       keys, vals, device=mesh.device, transport=tr)
    torch.cuda.synchronize()
    res = dict(build_seconds=time.perf_counter() - t0)
    shard = store.engine.shards[0]
    check(shard.device == mesh.device == shard.slots_lo.device,
          f"sharded: the kept shard is not on {mesh.device}")
    o_lo, o_hi, _ = shard.overflow.items()
    over = np.isin(keys, join_u64(o_lo, o_hi))
    res["overflow_keys"] = int(over.sum())
    idx = rng.permutation(n)[zipf_ranks(rng, n, 1 << MESH_GETS_LOG2)]

    # ---- YCSB-C through the adapter, a window a submit ----
    lat, hs = [], []
    t0 = time.perf_counter()
    for w0 in range(0, idx.size, WINDOW):
        t1 = time.perf_counter()
        hs.append(store.submit("get", keys[idx[w0:w0 + WINDOW]]))
        if not hs[-1].done:
            store.flush()
        lat.append(time.perf_counter() - t1)
    sec = time.perf_counter() - t0
    check(np.concatenate([h.result().found for h in hs]).all(),
          "sharded: a present key missed through the adapter")
    check(np.array_equal(np.concatenate([h.result().values for h in hs]),
                         vals[idx]), "sharded: a wrong value through the "
          "adapter")
    check(len(tr) == idx.size, "sharded: the trace missed Gets")
    lat = np.asarray(lat) * 1e3
    res["ycsb_c"] = dict(gets_per_s=idx.size / sec,
                         p50_ms=float(np.percentile(lat, 50)),
                         p99_ms=float(np.percentile(lat, 99)))
    log(f"sharded YCSB-C through the adapter: {json.dumps(res)}")

    # ---- the mesh ----
    t0 = time.perf_counter()
    state = store.mesh_state()
    blocks = skv.place_state(mesh, state)
    torch.cuda.synchronize()
    res["place_seconds"] = time.perf_counter() - t0
    lo_all, hi_all = (lanes(x, mesh.device) for x in split_u64(keys[idx]))
    want_v = vals[idx]
    stored = ~over[idx]
    t0 = time.perf_counter()
    cache = CNKeyCache(MESH_CACHE_BYTES, device=mesh.device)
    warm_cn_cache(cache, keys, vals, np.ones(n, bool),
                  idx[:1 << MESH_WARM_LOG2])
    scache = ShardedCNCache(cache, 1)
    cache_blocks = skv.place_cache(mesh, scache)
    torch.cuda.synchronize()
    res["cache_warm_seconds"] = time.perf_counter() - t0
    res["cache_bytes"] = cache.memory_bytes()
    runs = []
    for cached in (False, True):
        for variant in MESH_VARIANTS:
            for bpd in MESH_BATCHES:
                runs.append(mesh_run(
                    mesh, state, tr, blocks, lo_all, hi_all, want_v, stored,
                    variant, bpd, scache if cached else None,
                    cache_blocks if cached else ()))
                gc.collect()
    res["runs"] = runs
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del store, state, blocks, cache_blocks, cache, scache
    return res


def mesh_run(mesh, state, tr, blocks, lo_all, hi_all, want_v, stored,
             variant: str, bpd: int, cache, cache_blocks) -> dict:
    """One variant at ``bpd`` lanes a call over the whole stream: each call
    synced and timed by the host clock, every answer checked against the
    oracle, the meter and trace checked; then CUDA events over back-to-back
    calls and ``torch.profiler`` over ``MESH_PROFILED[bpd]`` calls."""
    import torch
    from repro_torch.core import sharded_kvs as skv
    from repro_torch.core.hashing import join_u64
    from repro_torch.kernels import ops
    state.meter.reset()
    tr.reset()
    fn, caps = skv.make_get_fn(mesh, state, bpd, variant=variant,
                               cache=cache)
    calls = lo_all.numel() // bpd
    args = [(lo_all[c * bpd:(c + 1) * bpd], hi_all[c * bpd:(c + 1) * bpd],
             *cache_blocks, *blocks) for c in range(calls)]
    l0 = dict(ops.LAUNCHES)
    outs, lat = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in args:
        t1 = time.perf_counter()
        outs.append(fn(*a))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
    sec = time.perf_counter() - t0
    launched = {k: ops.LAUNCHES[k] - l0[k]
                for k in ("ludo_lookup", "slot_unpack")}
    name = f"mesh {variant}{'+cache' if cache else ''} at {bpd}"
    for k, v in launched.items():
        check(v >= calls, f"{name}: {k} launched {v} times in {calls} calls")
    host = torch.stack([torch.cat([o[j] for o in outs]).to(torch.int32)
                        for j in range(len(outs[0]))]).cpu().numpy()
    got_v = join_u64(host[0].view(np.uint32), host[1].view(np.uint32))
    match = host[2] != 0
    hit = host[3] != 0 if cache else np.zeros(match.size, bool)
    check(np.array_equal(match, stored | hit), f"{name}: a lane missed "
          f"that is no overflow resident (a dropped lane), or an overflow "
          f"resident matched")
    check(np.array_equal(got_v[match], want_v[match]),
          f"{name}: a wrong value")
    n_get, n_hit = match.size, int(hit.sum())
    m = state.meter
    check(m.ops == n_get and m.cache_hits == n_hit
          and m.round_trips == MESH_RTS[variant] * (n_get - n_hit)
          and len(tr) == n_get - n_hit, f"{name}: the meter or the trace "
          f"missed Gets")
    cyc = itertools.cycle(args)
    step = lambda: fn(*next(cyc))  # noqa: E731
    lat = np.asarray(lat) * 1e3
    out = dict(variant=variant, cached=cache is not None, batch=bpd,
               calls=calls, caps=list(caps), gets_per_s=n_get / sec,
               call_p50_ms=float(np.percentile(lat, 50)),
               call_p99_ms=float(np.percentile(lat, 99)),
               events_ms_per_call=time_ms(step, min(calls, 64)),
               hit_rate=n_hit / n_get,
               overflow_misses=int((~match).sum()), launches=launched)
    out.update(mesh_profile(step, MESH_PROFILED[bpd]))
    log(f"{name}: {json.dumps(out)}")
    return out


def serve_on_mesh(keys, vals, rng) -> tuple:
    """Phase 10: a world of this one process, the (1, 1) mesh on the card
    and on the CPU, :func:`mesh_agreement_check`, then
    :func:`serve_mesh` on the card with the launch counters zeroed just
    before it and read just after, over the first 2^``LATER_KEYS_LOG2``
    of the keys.  The group is destroyed at the end."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core import sharded_kvs as skv
    from repro_torch.kernels import ops
    with tempfile.TemporaryDirectory() as tmp:
        init_world(str(Path(tmp) / "rdv"))
        try:
            meshes = {d: skv.make_mesh((1, 1), device=d)
                      for d in ("cuda", "cpu")}
            mesh_agreement_check(SEED, meshes)
            gc.collect()
            torch.cuda.empty_cache()
            ops.reset_launch_counts()
            n = 1 << LATER_KEYS_LOG2
            res = serve_mesh(keys[:n], vals[:n], rng, meshes["cuda"])
            launches = dict(ops.LAUNCHES)
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ------------------------------------------------------------ phase 11
def _replica_set(store):
    """The ``ReplicaSetAdapter`` under a store's stack."""
    from repro_torch.api import ReplicaSetAdapter
    adapter = store
    while not isinstance(adapter, ReplicaSetAdapter):
        adapter = adapter.inner
    return adapter


def _mn_only(state):
    """An ``mn_state`` image without a directory store's shipped CN
    locators (each replica rebuilds its own)."""
    if isinstance(state, dict):
        return {k: _mn_only(v) for k, v in state.items() if k != "cn"}
    if isinstance(state, list):
        return [_mn_only(v) for v in state]
    return state


def _attributed(res) -> tuple:
    return (res.values.tolist(), res.found.tolist(), res.statuses,
            res.round_trips, res.req_bytes, res.resp_bytes, res.makeups,
            res.cache_hits, res.cache_neg_hits, res.retries, res.backoffs,
            res.failovers)


def fault_specs(n_ops: int) -> dict:
    """Phase 11 (a)'s five specs, their windows sized to a stream of
    ``n_ops`` op-clock lanes."""
    from repro_torch.api import StoreSpec
    from repro_torch.net import FaultEvent, FaultSchedule
    at, dur = n_ops // 4, n_ops // 4
    crash = FaultSchedule.single_crash(at_op=at, duration_ops=dur,
                                       lease_term_ops=128)
    lf = FAULT_LOAD_FACTOR
    return {
        "k2_crash": StoreSpec("outback", load_factor=lf, replicas=2,
                              faults=crash),
        "k1_crash": StoreSpec("outback", load_factor=lf, faults=crash),
        "generated": StoreSpec("outback", load_factor=lf, replicas=2,
                               faults=FaultSchedule.generate(
                                   SEED + 11, n_ops, replicas=2)),
        "partition": StoreSpec("outback", load_factor=lf, replicas=2,
                               faults=FaultSchedule(
                                   events=(FaultEvent("partition", at, dur,
                                                      mn=1, cn=0,
                                                      down_s=150e-6),),
                                   lease_term_ops=128)),
        # the crash ends before the inserts split a table: a split inside
        # the window diverges the replicas' table numbering, which the
        # per-shard resync refuses (as the reference does)
        "dir_hrw": StoreSpec("outback-dir", load_factor=lf, replicas=3,
                             placement="hrw", placement_k=2,
                             faults=FaultSchedule.single_crash(
                                 at_op=n_ops // 16, duration_ops=n_ops // 16,
                                 mn=1, lease_term_ops=128),
                             params={"initial_depth": 1}),
    }


def fault_agreement_check(seed: int, devices=("cuda", "cpu")) -> dict:
    """Phase 11 (a): one stream (Gets, updates, inserts, deletes, through a
    window of 1024) with a transport through each of :func:`fault_specs`
    on the card and on the CPU; answers, statuses, each OpResult's
    attribution, meter snapshots, traces and every replica's final MN
    image must agree."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.net import Transport
    n = 1 << FAULT_AGREE_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(13 << 40))
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(n, 2 * n, dtype=np.uint64)
                       + np.uint64(13 << 40))
    rng = np.random.default_rng(seed)
    n_ops = 1 << FAULT_AGREE_OPS_LOG2
    ranks = zipf_ranks(rng, n, n_ops)
    stream, ins = [], 0
    for t, kind in enumerate(rng.choice(4, n_ops, p=[0.4, 0.2, 0.3, 0.1])):
        k = int(keys[ranks[t]])
        if kind == 2:
            k, ins = int(fresh[ins]), ins + 1
        stream.append([("get", k, None), ("update", k, t), ("insert", k, t),
                       ("delete", k, None)][kind])
    probe = np.concatenate([keys, fresh[:ins]])
    out = {}
    for name, spec in fault_specs(n_ops).items():
        spec = StoreSpec.from_json_dict({
            **spec.to_json_dict(), "rng_seed": seed,
            "batch": BatchPolicy(window=WINDOW).to_json_dict()})
        runs = []
        for device in devices:
            tr = Transport()
            st = open_store(spec, keys, vals, device=device, transport=tr)
            hs = [st.submit(op, k) if v is None else st.submit(op, k, v)
                  for op, k, v in stream]
            st.flush()
            got = [(_attributed(h.result()), _attributed(h.batch))
                   for h in hs]
            got.append(_attributed(st.get_batch(probe)))
            rs = _replica_set(st)
            runs.append(dict(
                answers=got, meter=st.meter_totals().snapshot(),
                stats=dataclasses.asdict(st.stats),
                trace=_trace_tuples(tr.trace),
                images=[_mn_only(r.engine.mn_state())
                        for r in rs.replicas],
                plane=(rs.primary, sorted(rs._needs_resync),
                       rs.plane.clock)))
            if spec.kind == "outback-dir":
                runs[-1]["tables"] = [len(r.engine.tables)
                                      for r in rs.replicas]
        check(_same(runs[0], runs[1]), f"{name}: the replicated store on "
              f"{devices[0]} disagrees with the same store on {devices[1]}")
        m = runs[0]["meter"]
        out[name] = {k: m[k] for k in ("retries", "backoffs", "drops",
                                        "failovers", "lease_renewals",
                                        "resyncs", "fault_wait_us")}
        out[name]["unavailable_lanes"] = runs[0]["stats"]["unavailable_lanes"]
        if "tables" in runs[0]:
            out[name]["tables"] = runs[0]["tables"]
    check(out["k2_crash"]["failovers"] >= 1
          and out["k2_crash"]["resyncs"] >= 1, "agreement: the K=2 crash "
          "drove no failover or no resync")
    check(out["partition"]["resyncs"] >= 1, "agreement: the partitioned "
          "replica never resynced")
    check(max(out["dir_hrw"]["tables"]) > 2, "agreement: no split in the "
          "hrw directory store")
    log(f"fault agreement: {n}-key stores on {devices[0]} answer {n_ops} "
        f"mixed ops (window {WINDOW}) through each spec, and meter, trace "
        f"and hold every replica's MN image exactly as on {devices[1]}: "
        f"{json.dumps(out)}")
    return out


def _lat_stats(ms) -> dict:
    ms = np.asarray(ms, dtype=np.float64)
    return dict(p50_ms=float(np.percentile(ms, 50)),
                p99_ms=float(np.percentile(ms, 99)),
                p999_ms=float(np.percentile(ms, 99.9)),
                max_ms=float(ms.max()))


def _replicas_equal_on_device(rs) -> bool:
    """Every replica's MN arrays equal replica 0's, compared on the card;
    the small host parts (heap top, overflow cache, flags) on the host."""
    import torch
    a = rs.replicas[0].engine
    for r in rs.replicas[1:]:
        b = r.engine
        for name in ("slots_lo", "slots_hi", "seeds_mn", "heap_klo",
                     "heap_khi", "heap_vlo", "heap_vhi"):
            if not torch.equal(getattr(a, name), getattr(b, name)):
                return False
        if (a.heap_top, a.n_keys, a.frozen) != (b.heap_top, b.n_keys,
                                                b.frozen):
            return False
        if not _same(a.overflow.state(), b.overflow.state()):
            return False
    return True


def serve_replicated(keys, vals, rng) -> dict:
    """Phase 11 (b): a K=2 store over phase 3's keys whose primary crashes
    inside a YCSB-A stream: zipf Gets, then YCSB-A with fresh inserts
    through the window, then recovery Gets; every answer checked, every
    acknowledged write read back, both replicas' MN arrays compared on the
    card.  The launch counters are zeroed just before the traffic and read
    just after."""
    import torch
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import ops
    from repro_torch.net import FaultSchedule
    n = keys.size
    crash_at, crash_ops = FAULT_CRASH_AT, FAULT_CRASH_OPS
    sched = FaultSchedule.single_crash(at_op=crash_at, duration_ops=crash_ops,
                                       mn=0, down_s=200e-6,
                                       lease_term_ops=FAULT_LEASE_OPS)
    spec = StoreSpec("outback", load_factor=FAULT_LOAD_FACTOR, rng_seed=SEED,
                     replicas=2, faults=sched,
                     batch=BatchPolicy(window=WINDOW))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = open_store(spec, keys, vals)
    torch.cuda.synchronize()
    res = dict(build_seconds=time.perf_counter() - t0, replicas=2, keys=n)
    rs = _replica_set(store)
    check(all(r.engine.slots_lo.is_cuda for r in rs.replicas),
          "a replica is not on the card")
    res["mn_state_bytes"] = rs.replicas[0].engine.mn_state_bytes()
    log(f"replicated store build: {res['build_seconds']:.3f} s for 2 "
        f"replicas of {n} keys (host Ludo build twice, then the arrays to "
        f"the card); MN image {res['mn_state_bytes']} B a replica")

    resyncs, failovers = [], []
    resync, failover = rs._resync, rs.failover

    def timed_resync(i):
        b0 = rs.replicas[i].meter.resp_bytes
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok = resync(i)
        torch.cuda.synchronize()
        resyncs.append(dict(mn=i, clock=rs.plane.clock, ok=bool(ok),
                            seconds=time.perf_counter() - t,
                            bytes=rs.replicas[i].meter.resp_bytes - b0))
        return ok

    def noted_failover():
        ok = failover()
        failovers.append(dict(clock=rs.plane.clock, to=rs.primary, ok=ok))
        return ok

    rs._resync, rs.failover = timed_resync, noted_failover
    latest = vals.copy()
    perm = rng.permutation(n)

    def get_windows(idx):
        lat = []
        got_v, got_f = [], []
        for w0 in range(0, idx.size, WINDOW):
            ks = keys[idx[w0:w0 + WINDOW]]
            t0 = time.perf_counter()
            hs = [store.submit("get", int(k)) for k in ks]
            if not hs[-1].done:
                store.flush()
            lat.append((time.perf_counter() - t0) * 1e3)
            check(hs[0].batch is hs[-1].batch, "a window split its batch")
            got_v.append(hs[-1].batch.values)
            got_f.append(hs[-1].batch.found)
            check(hs[-1].batch.statuses is None, "a Get window degraded")
        check(np.concatenate(got_f).all(), "a present key missed")
        check(np.array_equal(np.concatenate(got_v), latest[idx]),
              "a Get read a stale or wrong value")
        return lat

    ops.reset_launch_counts()
    # ---- before: zipf Gets ----
    idx = perm[zipf_ranks(rng, n, 1 << FAULT_N_GETS_LOG2)]
    t0 = time.perf_counter()
    lat = get_windows(idx)
    sec = time.perf_counter() - t0
    res["before"] = dict(gets=idx.size, seconds=sec,
                         gets_per_s=idx.size / sec, clock=rs.plane.clock,
                         **_lat_stats(lat))
    check(rs.plane.clock < crash_at, "the crash opened before YCSB-A")

    # ---- YCSB-A with fresh inserts, through the crash window ----
    n_a, n_ins = 1 << FAULT_N_A_LOG2, 1 << FAULT_N_INS_LOG2
    idx_a = perm[zipf_ranks(rng, n, n_a)]
    is_upd = rng.random(n_a) < 0.5
    new_v = rng.integers(0, 2**64 - 1, n_a, dtype=np.uint64, endpoint=True)
    fresh = splitmix64(np.arange(n, n + n_ins, dtype=np.uint64)
                       + np.uint64(_KEY_OFFSET))
    fresh_v = rng.integers(0, 2**64 - 1, n_ins, dtype=np.uint64,
                           endpoint=True)
    every = n_a // n_ins
    subs = []  # (op, key index or fresh index, value, handle)
    chunks = []  # (first clock, last clock, ops, ms) a chunk of 1024 ops
    t_a = time.perf_counter()
    c0, t_c, k_c = rs.plane.clock, time.perf_counter(), 0
    for t in range(n_a):
        i = int(idx_a[t])
        if is_upd[t]:
            subs.append(("update", i, new_v[t],
                         store.submit("update", int(keys[i]),
                                      int(new_v[t]))))
        else:
            subs.append(("get", i, None, store.submit("get", int(keys[i]))))
        if t % every == every - 1:
            j = t // every
            subs.append(("insert", j, fresh_v[j],
                         store.submit("insert", int(fresh[j]),
                                      int(fresh_v[j]))))
        k_c += 1
        if k_c == WINDOW:
            now = time.perf_counter()
            chunks.append((c0, rs.plane.clock, k_c, (now - t_c) * 1e3))
            c0, t_c, k_c = rs.plane.clock, now, 0
    store.flush()
    now = time.perf_counter()
    if k_c:
        chunks.append((c0, rs.plane.clock, k_c, (now - t_c) * 1e3))
    sec_a = now - t_a
    res["ycsb_a"] = dict(ops=n_a + n_ins, seconds=sec_a,
                         ops_per_s=(n_a + n_ins) / sec_a,
                         clock=rs.plane.clock)
    crash_end = crash_at + crash_ops
    for seg, sel in (("before", lambda a, b: b < crash_at),
                     ("through", lambda a, b: b >= crash_at
                      and a < crash_end),
                     ("after", lambda a, b: a >= crash_end)):
        cs = [c for c in chunks if sel(c[0], c[1])]
        if cs:
            ms = [c[3] for c in cs]
            res["ycsb_a"][seg] = dict(
                chunks=len(cs), ops_per_s=sum(c[2] for c in cs)
                / (sum(ms) / 1e3), **_lat_stats(ms))
    check("through" in res["ycsb_a"] and "after" in res["ycsb_a"],
          "the crash window does not sit inside the YCSB-A stream")

    # the oracle: writes acknowledged in submission order
    acked_ins, unavailable, stale = [], 0, 0
    ins_ok = np.zeros(n_ins, bool)
    for op, i, v, h in subs:
        r = h.result()
        st = None if r.statuses is None else r.statuses[0]
        if st in ("backoff", "unavailable"):
            unavailable += 1
            continue
        if op == "update":
            check(bool(r.found[0]), "an update of a present key failed")
            latest[i] = v
        elif op == "insert":
            check(st in ("slot", "reseed", "overflow"),
                  f"an insert of a new key came back {st!r}")
            ins_ok[i] = True
        else:
            check(bool(r.found[0]), "a YCSB-A Get of a present key missed")
            stale += int(r.values[0] != latest[i])
    check(stale == 0, f"{stale} YCSB-A Gets did not see the latest "
          f"acknowledged value")
    res["ycsb_a"]["unavailable_ops"] = unavailable

    # ---- after: recovery Gets ----
    idx = perm[zipf_ranks(rng, n, 1 << FAULT_N_GETS_LOG2)]
    t0 = time.perf_counter()
    lat = get_windows(idx)
    sec = time.perf_counter() - t0
    res["after"] = dict(gets=idx.size, seconds=sec,
                        gets_per_s=idx.size / sec, **_lat_stats(lat))

    def profiled():
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            get_windows(idx[:32 * WINDOW])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, spans = device_busy_us(prof)
        return dict(device_busy_share=busy / wall_us if spans else None,
                    device_ops_per_window=spans / 32)

    res["after"].update(profiled())
    res["launches"] = dict(ops.LAUNCHES)

    # ---- every acknowledged write reads back; the replicas agree ----
    upd_idx = np.unique(idx_a[is_upd])
    probe = np.concatenate([keys[upd_idx], fresh[ins_ok]])
    want = np.concatenate([latest[upd_idx], fresh_v[ins_ok]])
    g = store.get_batch(probe)
    lost = int((~g.found).sum()) + int((g.values != want)[g.found].sum())
    res["acked_writes"] = dict(updated_keys=int(upd_idx.size),
                               inserts=int(ins_ok.sum()), lost=lost)
    check(lost == 0, f"{lost} acknowledged writes lost through the crash")
    check(_replicas_equal_on_device(rs), "the replicas' MN arrays differ "
          "after recovery")
    m = store.meter_totals()
    res["recovery"] = {k: getattr(m, k) for k in (
        "retries", "backoffs", "drops", "failovers", "lease_renewals",
        "resyncs", "fault_wait_us")}
    res["resyncs"], res["failovers"] = resyncs, failovers
    res["primary"] = rs.primary
    res["unavailable_lanes"] = store.stats.unavailable_lanes
    for k in ("failovers", "resyncs", "retries", "backoffs"):
        check(res["recovery"][k] >= 1, f"the crash drove no {k}")
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    for seg in ("before", "after"):
        s = res[seg]
        log(f"replicated {seg} the window: {s['gets_per_s']:.1f} Gets/s "
            f"over {s['gets']} Gets; window p50 {s['p50_ms']:.4f} ms, p99 "
            f"{s['p99_ms']:.4f} ms, p999 {s['p999_ms']:.4f} ms")
    a = res["ycsb_a"]
    log(f"replicated YCSB-A: {a['ops_per_s']:.1f} ops/s over {a['ops']} ops "
        f"({n_ins} inserts); by chunk of {WINDOW} ops: " + "; ".join(
            f"{seg} {a[seg]['chunks']} chunks {a[seg]['ops_per_s']:.1f} "
            f"ops/s p50 {a[seg]['p50_ms']:.4f} p99 {a[seg]['p99_ms']:.4f} "
            f"p999 {a[seg]['p999_ms']:.4f} ms"
            for seg in ("before", "through", "after") if seg in a))
    log(f"resyncs: {json.dumps(resyncs)}; failovers: {json.dumps(failovers)}")
    log(f"recovery counters: {json.dumps(res['recovery'])}; acknowledged "
        f"writes {json.dumps(res['acked_writes'])}; both replicas' MN arrays "
        f"equal on the card; device busy share "
        f"{res['after']['device_busy_share']}; max_memory_allocated "
        f"{res['max_memory_allocated']} B")
    return res


def _fault_keys(n: int, spare: int):
    from repro_torch.core.hashing import splitmix64
    keys = splitmix64(np.arange(n + spare, dtype=np.uint64)
                      + np.uint64(19 << 40))
    vals = splitmix64(keys)
    return keys[:n], vals[:n], keys[n:], vals[n:]


def modelled_tail(seed: int) -> dict:
    """Phase 11 (c): the reference ``faults`` suite's stream (its warm Get
    calls, insert + Get rounds through a crash at op 800 for 400 ops, a
    recovery tail) over 2^20 keys with a transport, replayed with
    ``simulate(trace, clients=4, replicas=2)``: the reference's model of
    the fabric, not a measurement of the card."""
    from repro_torch.api import StoreSpec, open_store
    from repro_torch.net import FaultSchedule, Transport, simulate
    n = 1 << FAULT_SMALL_KEYS_LOG2
    bk, bv, wk, wv = _fault_keys(n, FAULT_ROUNDS * FAULT_ROUND_LANES)
    sched = FaultSchedule.single_crash(at_op=FAULT_TAIL_AT,
                                       duration_ops=FAULT_TAIL_OPS,
                                       down_s=200e-6, lease_term_ops=256)
    tr = Transport()
    st = open_store(StoreSpec("outback", load_factor=FAULT_LOAD_FACTOR,
                              rng_seed=seed, replicas=2, faults=sched),
                    bk, bv, transport=tr)
    rng = np.random.default_rng(seed)
    q = bk[rng.integers(0, n, FAULT_GET_LANES * FAULT_WARM_CALLS)]
    for i in range(FAULT_WARM_CALLS):
        st.get_batch(q[i * FAULT_GET_LANES:(i + 1) * FAULT_GET_LANES])
    acked = []
    for i in range(FAULT_ROUNDS):
        sl = slice(i * FAULT_ROUND_LANES, (i + 1) * FAULT_ROUND_LANES)
        r = st.insert_batch(wk[sl], wv[sl])
        stats = r.statuses or ("ok",) * FAULT_ROUND_LANES
        acked += [(int(k), int(v)) for k, v, ok, c in
                  zip(wk[sl], wv[sl], r.found, stats)
                  if ok and c not in ("backoff", "unavailable")]
        off = (i % FAULT_WARM_CALLS) * FAULT_GET_LANES
        st.get_batch(q[off:off + FAULT_GET_LANES // 2])
    for i in range(FAULT_WARM_CALLS):
        st.get_batch(q[i * FAULT_GET_LANES:(i + 1) * FAULT_GET_LANES])
    g = st.get_batch(np.asarray([k for k, _ in acked], np.uint64))
    want = np.asarray([v for _, v in acked], np.uint64)
    lost = int((~g.found).sum()) + int((g.values != want)[g.found].sum())
    check(lost == 0, f"modelled tail: {lost} acknowledged writes lost")
    m = st.meter_totals()
    check(m.failovers >= 1 and m.resyncs >= 1, "modelled tail: no failover "
          "or no resync")
    sim = simulate(tr.trace, clients=4, replicas=2)
    again = simulate(tr.trace, clients=4, replicas=2)
    check(_same(_sim_fields(sim), _sim_fields(again)),
          "modelled tail: the replay is not deterministic")
    av = sim.availability()
    out = dict(keys=n, acked=len(acked), ops=sim.n_ops,
               **sim.percentiles(), tput_mops=sim.tput_mops,
               fault_windows=[list(w) for w in sim.fault_windows],
               availability_fault_windows=av["fault_windows"],
               availability_min=float(min(av["availability"])),
               failovers=m.failovers, resyncs=m.resyncs,
               fault_wait_us=m.fault_wait_us)
    log(f"modelled tail (the reference's model of the fabric, simulate("
        f"clients=4, replicas=2), not a card measurement): p50 "
        f"{out['p50_us']:.4f} us, p99 {out['p99_us']:.4f} us, p999 "
        f"{out['p999_us']:.4f} us; fault windows {out['fault_windows']}; "
        f"availability windows {out['availability_fault_windows']}, min "
        f"{out['availability_min']:.4f}")
    return out


def k1_degraded(seed: int) -> dict:
    """Phase 11 (d): the same crash at K=1 over 2^20 keys: lanes degrade to
    ``"unavailable"`` with ``found=False``, never an exception, and after
    the window the store serves every key again."""
    from repro_torch.api import StoreSpec, open_store
    from repro_torch.net import FaultSchedule
    n = 1 << FAULT_SMALL_KEYS_LOG2
    bk, bv, _, _ = _fault_keys(n, 0)
    sched = FaultSchedule.single_crash(at_op=FAULT_TAIL_AT,
                                       duration_ops=FAULT_TAIL_OPS,
                                       down_s=200e-6, max_retries=2,
                                       lease_term_ops=0)
    st = open_store(StoreSpec("outback", load_factor=FAULT_LOAD_FACTOR,
                              rng_seed=seed, faults=sched), bk, bv)
    rng = np.random.default_rng(seed)
    calls = 3 * FAULT_WARM_CALLS
    q = rng.integers(0, n, FAULT_GET_LANES * calls)
    unavailable = served = 0
    for i in range(calls):
        sl = q[i * FAULT_GET_LANES:(i + 1) * FAULT_GET_LANES]
        r = st.get_batch(bk[sl])
        if r.statuses is not None:
            check(set(r.statuses) == {"unavailable"} and not r.found.any(),
                  "a degraded lane answered found=True")
            unavailable += r.statuses.count("unavailable")
        else:
            check(r.found.all() and np.array_equal(r.values, bv[sl]),
                  "K=1: a served Get was wrong")
            served += len(r)
    check(unavailable > 0, "K=1: the crash degraded no lane")
    post = st.get_batch(bk)
    check(post.statuses is None and post.found.all()
          and np.array_equal(post.values, bv),
          "K=1: the store did not serve every key after the window")
    out = dict(keys=n, unavailable_lanes=unavailable, served_lanes=served,
               recovered_keys=int(post.found.sum()))
    log(f"K=1 crash: {unavailable} lanes answered 'unavailable' "
        f"(found=False), {served} served; after the window all {n} keys "
        f"served")
    return out


def dormant_identity(seed: int) -> dict:
    """Phase 11 (e): ``replicas=1`` with the dormant schedule
    (``FaultSchedule(lease_term_ops=0)``) meters and traces byte for byte
    as the plain spec, over 2^20 keys."""
    from repro_torch.api import StoreSpec, open_store
    from repro_torch.net import FaultSchedule, Transport
    n = 1 << FAULT_SMALL_KEYS_LOG2
    bk, bv, sk, sv = _fault_keys(n, 64)
    q = bk[np.random.default_rng(seed).integers(0, n, 512)]
    snaps, traces = [], []
    for spec in (StoreSpec("outback", load_factor=FAULT_LOAD_FACTOR,
                           rng_seed=seed),
                 StoreSpec("outback", load_factor=FAULT_LOAD_FACTOR,
                           rng_seed=seed,
                           faults=FaultSchedule(lease_term_ops=0))):
        tr = Transport()
        st = open_store(spec, bk, bv, transport=tr)
        st.get_batch(q)
        st.insert_batch(sk, sv)
        st.update_batch(bk[:64], bv[:64])
        st.delete_batch(bk[64:96])
        snaps.append(st.meter_totals().snapshot())
        traces.append(_trace_tuples(tr.trace))
    check(snaps[0] == snaps[1] and traces[0] == traces[1],
          "the dormant plane drifted from the plain store")
    check(_replica_set(st).plane.schedule.lease_term_ops == 0,
          "dormant: the plane is not the dormant one")
    log(f"dormant plane: meter snapshot and trace ({len(traces[0])} items) "
        f"byte-identical to the plain spec")
    return dict(ops=snaps[0]["ops"], trace_items=len(traces[0]))


def serve_faults(keys, vals, rng) -> tuple:
    """Phase 11: (a) the agreement, (b) :func:`serve_replicated` with the
    launch counters zeroed just before its traffic and read just after,
    (c) the modelled tail, (d) K=1, (e) the dormant plane."""
    import torch
    from repro_torch.kernels import ops
    res = dict(agreement=fault_agreement_check(SEED))
    gc.collect()
    torch.cuda.empty_cache()
    n = 1 << LATER_KEYS_LOG2
    res["replicated"] = serve_replicated(keys[:n], vals[:n], rng)
    launches = res["replicated"].pop("launches")
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res["modelled_tail"] = modelled_tail(SEED)
    res["k1"] = k1_degraded(SEED)
    res["dormant"] = dormant_identity(SEED)
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ------------------------------------------------------------ phase 12
def _adapter_of(store):
    """The engine adapter at the bottom of a store's stack."""
    while hasattr(store, "inner"):
        store = store.inner
    return store


def _mn_images(store) -> list:
    """Every MN image under a store: each replica's, each shard's of a
    ``sharded`` host, or the one engine's."""
    adapter = _adapter_of(store)
    if hasattr(adapter, "replicas"):
        return [r.engine.mn_state() for r in adapter.replicas]
    if getattr(adapter, "shards", None) is not None:
        return [sh.mn_state() for sh in adapter.shards]
    return [adapter.engine.mn_state()]


def obs_specs(n_ops: int) -> dict:
    """Phase 12 (a)'s four telemetry-on specs."""
    from repro_torch.api import BatchPolicy, StoreSpec, TelemetryConfig
    from repro_torch.net import FaultSchedule
    kw = dict(load_factor=FAULT_LOAD_FACTOR, rng_seed=SEED,
              batch=BatchPolicy(window=WINDOW),
              telemetry=TelemetryConfig(window_ops=256))
    return {
        "outback": StoreSpec("outback", **kw),
        "outback_dir_cached": StoreSpec(
            "outback-dir", cache_budget_bytes=DIR_AGREE_CACHE,
            params={"initial_depth": 1}, **kw),
        "sharded": StoreSpec("sharded", params={"num_shards": 2}, **kw),
        "k2_crash": StoreSpec("outback", replicas=2,
                              faults=FaultSchedule.single_crash(
                                  at_op=n_ops // 4, duration_ops=n_ops // 4,
                                  lease_term_ops=128), **kw),
    }


def obs_agreement_check(seed: int, devices=("cuda", "cpu")) -> dict:
    """Phase 12 (a): (1) each of :func:`obs_specs` with a transport on the
    card and on the CPU takes one stream of Gets, updates, inserts and
    deletes: ``telemetry_rows(hub)`` must be equal JSON for JSON; on the
    card the same spec without telemetry must leave the meters, the trace,
    every MN image and the launch counts as the telemetry-on run did.
    (2) An N=1 ``cluster_of`` against ``open_store`` on the card: answers,
    meters, trace and MN image identical.  (3) ``run_chaos(seed)`` at its
    defaults for each of ``CHAOS_SEEDS`` on the card and on the CPU: each
    passes, and the two reports' ``to_json_dict()`` are equal."""
    import pickle
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.cluster import cluster_of
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import ops
    from repro_torch.net import Transport
    from repro_torch.net.chaos import run_chaos, state_signature
    from repro_torch.obs import telemetry_rows, validate_telemetry_rows
    n = 1 << OBS_AGREE_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(17 << 40))
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(n, 2 * n, dtype=np.uint64)
                       + np.uint64(17 << 40))
    rng = np.random.default_rng(seed)
    n_ops = 1 << OBS_AGREE_OPS_LOG2
    ranks = zipf_ranks(rng, n, n_ops)
    stream, ins = [], 0
    for t, kind in enumerate(rng.choice(4, n_ops, p=[0.5, 0.2, 0.2, 0.1])):
        k = int(keys[ranks[t]])
        if kind == 2:
            k, ins = int(fresh[ins]), ins + 1
        stream.append([("get", k, None), ("update", k, t), ("insert", k, t),
                       ("delete", k, None)][kind])
    out = {}
    for name, spec in obs_specs(n_ops).items():
        runs = {}
        for device, tele in ((devices[0], True), (devices[1], True),
                             (devices[0], False)):
            sp = spec if tele else StoreSpec.from_json_dict(
                {**spec.to_json_dict(), "telemetry": None})
            tr = Transport()
            ops.reset_launch_counts()
            st = open_store(sp, keys, vals, device=device, transport=tr)
            answers = _drive(st, stream)
            answers.append(_attributed(st.get_batch(keys[:WINDOW])))
            hub = st.telemetry
            check((hub is not None) == tele, f"{name}: the store's "
                  f"telemetry is {hub!r}")
            rows = None
            if tele:
                rows = telemetry_rows(hub)
                validate_telemetry_rows(rows)
                rows = json.dumps(rows, sort_keys=True)
            runs[(device, tele)] = dict(
                answers=answers, meter=st.meter_totals().snapshot(),
                trace=_trace_tuples(tr.trace),
                images=pickle.dumps(_mn_images(st)),
                launches=dict(ops.LAUNCHES), rows=rows,
                counters=None if hub is None else dict(hub.counters))
        on, cpu, off = (runs[(devices[0], True)], runs[(devices[1], True)],
                        runs[(devices[0], False)])
        check(on["rows"] == cpu["rows"], f"{name}: telemetry_rows on "
              f"{devices[0]} differ from {devices[1]}")
        check(_same(on["answers"], cpu["answers"])
              and on["meter"] == cpu["meter"] and on["trace"] == cpu["trace"]
              and on["images"] == cpu["images"], f"{name}: the store on "
              f"{devices[0]} disagrees with {devices[1]}")
        for k in ("answers", "meter", "trace", "images", "launches"):
            check(_same(on[k], off[k]), f"{name}: the hub changed the "
                  f"store's {k} on {devices[0]}")
        check(on["launches"]["ludo_lookup"] > 0 or name == "sharded",
              f"{name}: ludo_lookup never launched on {devices[0]}")
        out[name] = dict(rows_bytes=len(on["rows"]),
                         ops_get=on["counters"].get("ops{op=get}", 0),
                         launches=on["launches"])
        log(f"obs agreement {name}: telemetry_rows equal on {devices[0]} "
            f"and {devices[1]} ({out[name]['rows_bytes']} B of JSON); hub "
            f"off on {devices[0]}: the same answers, meters, trace, MN "
            f"images and launches {json.dumps(on['launches'])}")

    # (2) the dormant cluster: N=1 against open_store, on the card
    cspec = StoreSpec("outback-dir", load_factor=FAULT_LOAD_FACTOR,
                      rng_seed=SEED, cache_budget_bytes=DIR_AGREE_CACHE,
                      batch=BatchPolicy(window=WINDOW))
    t_ref = Transport()
    ref = open_store(cspec, keys, vals, device=devices[0], transport=t_ref)
    cl = cluster_of(cspec, keys, vals, n_cns=1, device=devices[0])
    got = []
    for st in (ref, cl.cns[0]):
        got.append(_drive(st, stream))
    check(_same(got[0], got[1]), "N=1 cluster: answers differ from "
          "open_store")
    check(ref.meter_totals().snapshot() == cl.meter_totals().snapshot(),
          "N=1 cluster: meters differ from open_store")
    check(_trace_tuples(t_ref.trace) == _trace_tuples(cl.transports[0].trace),
          "N=1 cluster: trace differs from open_store")
    check(state_signature(ref.engine.mn_state())
          == state_signature(cl.mn_state()), "N=1 cluster: MN state differs "
          "from open_store")
    check(cl.stats.forward_rpcs == 0 and cl.stats.handoffs == 0,
          "N=1 cluster: a cluster-only mechanism fired")
    out["dormant_cluster"] = dict(ops=len(stream),
                                  trace_events=len(t_ref.trace),
                                  tables=len(cl.engine.tables))
    log(f"N=1 cluster on {devices[0]}: answers, meters, trace and MN state "
        f"identical to open_store over {len(stream)} ops "
        f"({len(t_ref.trace)} trace events, {len(cl.engine.tables)} tables)")

    # (3) the chaos harness at its defaults, card against CPU
    out["chaos"] = {}
    for cseed in CHAOS_SEEDS:
        reps = {}
        for device in devices:
            t0 = time.perf_counter()
            rep = run_chaos(cseed, device=device)
            reps[device] = (rep.to_json_dict(), time.perf_counter() - t0)
            check(rep.passed, f"chaos seed {cseed} on {device}: "
                  f"{rep.failures}")
        check(reps[devices[0]][0] == reps[devices[1]][0], f"chaos seed "
              f"{cseed}: the report on {devices[0]} differs from "
              f"{devices[1]}")
        d = reps[devices[0]][0]
        out["chaos"][cseed] = dict(
            lanes=d["lanes"], acked_writes=d["acked_writes"],
            degraded_lanes=d["degraded_lanes"],
            availability=d["availability"], kinds=d["kinds"],
            state_sig=d["state_sig"],
            seconds={dv: reps[dv][1] for dv in devices})
    log(f"chaos at the defaults, seeds {CHAOS_SEEDS}: every report passes "
        f"and equals the CPU's: {json.dumps(out['chaos'])}")
    return out


def telemetry_cost(keys, vals, rng) -> dict:
    """Phase 12 (b): the obs suite's overhead procedure over the first
    2^``OBS_KEYS_LOG2`` of phase 3's keys.  One engine is built (a pure Get stream never changes it) and two
    stacks are assembled over it, as ``open_store`` assembles them: one
    with a ``TelemetryHub(TelemetryConfig(window_ops=4096))`` (its wire
    sink on the engine's meter only during that side's reps), one without.
    A warm-up rep a side, then ``OBS_REPS`` interleaved reps of 2^18
    zipf(0.99) Gets (one ``submit`` each), GC outside the clock, the
    minimum a side; ``ops{op=get}`` must count every Get."""
    import torch
    from repro_torch.api import (BatchPolicy, CNStack, StoreSpec,
                                 TelemetryConfig, TelemetryHub, build_adapter)
    from repro_torch.api.registry import _bind_hub_sinks
    spec = StoreSpec("outback", load_factor=FAULT_LOAD_FACTOR, rng_seed=SEED,
                     batch=BatchPolicy(window=WINDOW, order="relaxed"))
    n = 1 << OBS_KEYS_LOG2
    keys, vals = keys[:n], vals[:n]
    t0 = time.perf_counter()
    adapter, _ = build_adapter(spec, keys, vals)
    torch.cuda.synchronize()
    res = dict(build_seconds=time.perf_counter() - t0, keys=n,
               spec=spec.to_json_dict(), window_ops=OBS_WINDOW_OPS)
    meter = adapter.engine.meter
    off_sinks = list(meter.sinks)
    hub = TelemetryHub(TelemetryConfig(window_ops=OBS_WINDOW_OPS))
    _bind_hub_sinks(adapter, hub)
    on_sinks = list(meter.sinks)
    st_off = CNStack(policy=spec.batch).assemble(adapter)
    st_on = CNStack(policy=spec.batch, hub=hub).assemble(adapter)
    check(st_on.telemetry is hub and st_off.hub is None, "the two stacks")
    n_ops = 1 << OBS_GETS_LOG2
    idx = rng.permutation(n)[zipf_ranks(rng, n, n_ops)]
    want = vals[idx]

    def drive(st, sl=slice(None)):
        meter.sinks = list(on_sinks if st is st_on else off_sinks)
        submit = st.submit
        hs = [submit("get", k) for k in keys[idx[sl]]]
        st.flush()
        return hs

    def timed(st):
        gc.collect()
        gc.disable()
        try:
            t = time.perf_counter()
            hs = drive(st)
            return time.perf_counter() - t, hs
        finally:
            gc.enable()

    for st in (st_off, st_on):  # warm-up rep each, answers checked
        _, hs = timed(st)
        got = np.concatenate([h.batch.values for h in hs[WINDOW - 1::WINDOW]]
                             + ([hs[-1].batch.values]
                                if n_ops % WINDOW else []))
        check(np.array_equal(got, want), "a telemetry-cost Get read a "
              "wrong value")
    t_off = t_on = float("inf")
    for rep in range(OBS_REPS):
        first, second = (st_off, st_on) if rep % 2 == 0 else (st_on, st_off)
        a, _ = timed(first)
        b, _ = timed(second)
        if first is st_off:
            t_off, t_on = min(t_off, a), min(t_on, b)
        else:
            t_off, t_on = min(t_off, b), min(t_on, a)
    got = hub.counters.get("ops{op=get}", 0)
    check(got == n_ops * (OBS_REPS + 1), f"telemetry miscounted the run: "
          f"ops{{op=get}}={got}, drove {n_ops} x {OBS_REPS + 1} reps")

    def busy(st):
        from torch.profiler import ProfilerActivity, profile
        sl = slice(0, OBS_PROFILED_WINDOWS * WINDOW)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            drive(st, sl)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        b_us, spans = device_busy_us(prof)
        return dict(device_busy_share=b_us / wall_us if spans else None,
                    device_ops_per_window=spans / OBS_PROFILED_WINDOWS)

    res.update(ops=n_ops, reps=OBS_REPS, wall_off_s=t_off, wall_on_s=t_on,
               gets_per_s_off=n_ops / t_off, gets_per_s_on=n_ops / t_on,
               overhead_frac=(t_on - t_off) / max(t_off, 1e-9),
               criterion="< 0.05", ops_get=got,
               off=busy(st_off), on=busy(st_on))
    meter.sinks = off_sinks
    log(f"telemetry cost at {n} keys: {res['gets_per_s_off']:.1f} Gets/s "
        f"off, {res['gets_per_s_on']:.1f} on (min of {OBS_REPS} interleaved "
        f"reps of {n_ops} Gets); overhead_frac {res['overhead_frac']:.6f} "
        f"(the suite's criterion < 0.05, not gated); ops{{op=get}} {got}; "
        f"device busy share off {res['off']['device_busy_share']}, on "
        f"{res['on']['device_busy_share']}; build {res['build_seconds']:.3f} "
        f"s")
    return res


def serve_cluster(keys, vals, rng) -> dict:
    """Phase 12 (c): ``cluster_of`` the cluster suite's spec with telemetry
    on, ``CLUSTER_CNS`` CNs over a ``CLUSTER_MNS``-wide pool, over the
    first 2^``LATER_KEYS_LOG2`` of phase 3's keys.  CNs (0, 1, 2) start;
    CN 3 joins at op ``CLUSTER_JOIN_AT``
    (``MembershipSchedule.single_join``) and CN 1 leaves right after a
    burst of updates from non-owners (``single_leave``).  Every live CN
    drives zipf(0.9) Gets in batches of ``CLUSTER_BATCH``,
    2^``CLUSTER_LANES_LOG2`` lanes in all, every answer checked against a host oracle; every acknowledged
    update is read back through the survivors after the leave (0 lost).
    The launch counters are zeroed just before the traffic and read just
    after."""
    import torch
    from repro_torch.api import StoreSpec, TelemetryConfig
    from repro_torch.cluster import (MembershipSchedule, OwnershipTable,
                                     cluster_of)
    from repro_torch.kernels import ops
    from repro_torch.net import simulate_cluster

    def _moves(table) -> bool:
        return bool(table.rebalance(range(CLUSTER_CNS))) and bool(
            table.rebalance([c for c in range(CLUSTER_CNS) if c != 1]))

    keys, vals = keys[:1 << LATER_KEYS_LOG2], vals[:1 << LATER_KEYS_LOG2]
    n = keys.size
    lanes = 1 << CLUSTER_LANES_LOG2
    leave_at = lanes + CLUSTER_BURST
    # the first seed from SEED on whose rendezvous hash gives the joiner
    # and the leaver shards to move (as tests/test_cluster.py picks its
    # forwarding seed), so both handoffs move bytes
    seed = next(s for s in itertools.count(SEED) if _moves(
        OwnershipTable(1 << CLUSTER_DEPTH, range(CLUSTER_CNS - 1), seed=s)))
    join = MembershipSchedule.single_join(CLUSTER_JOIN_AT, CLUSTER_CNS - 1,
                                          initial=tuple(range(
                                              CLUSTER_CNS - 1)), seed=seed)
    leave = MembershipSchedule.single_leave(leave_at, 1, seed=seed)
    sched = MembershipSchedule(events=join.events + leave.events, seed=seed,
                               initial=join.initial)
    spec = StoreSpec("outback-dir", load_factor=FAULT_LOAD_FACTOR,
                     rng_seed=SEED, cache_budget_bytes=CLUSTER_CACHE_BYTES,
                     params={"initial_depth": CLUSTER_DEPTH},
                     telemetry=TelemetryConfig())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cl = cluster_of(spec, keys, vals, n_cns=CLUSTER_CNS, n_mns=CLUSTER_MNS,
                    membership=sched)
    torch.cuda.synchronize()
    res = dict(build_seconds=time.perf_counter() - t0, keys=n,
               n_cns=CLUSTER_CNS, n_mns=CLUSTER_MNS,
               tables=len(cl.engine.tables), spec=spec.to_json_dict(),
               membership=sched.to_json_dict())
    check(all(t.slots_lo.is_cuda for t in cl.engine.tables)
          and all(c.device.type == "cuda" for c in cl.caches),
          "the cluster's pool or a CN cache is not on the card")
    log(f"cluster build: {res['build_seconds']:.3f} s for {n} keys in "
        f"{res['tables']} tables, {CLUSTER_CNS} CN caches of "
        f"{CLUSTER_CACHE_BYTES} B; owners {cl.ownership.owners}")
    latest = vals.copy()
    perm = rng.permutation(n)
    ranks = perm[zipf_ranks(rng, n, lanes, theta=CLUSTER_THETA)]
    lat, per_cn_s, per_cn_lanes = [], {}, {}

    def get(cn, idx, record=True):
        t = time.perf_counter()
        r = cl.cns[cn].get_batch(keys[idx])
        dt = time.perf_counter() - t
        if record:
            lat.append(dt * 1e3)
            per_cn_s[cn] = per_cn_s.get(cn, 0.0) + dt
            per_cn_lanes[cn] = per_cn_lanes.get(cn, 0) + idx.size
        check(r.statuses is None and r.found.all(), f"CN {cn}: a Get of a "
              f"present key missed or degraded")
        check(np.array_equal(r.values, latest[idx]), f"CN {cn}: a Get read "
              f"a stale or wrong value")

    ops.reset_launch_counts()
    t_all = time.perf_counter()
    off, calls = 0, 0
    joined_at = None
    while off < lanes:
        for cn in sorted(cl.live):
            if off >= lanes:
                break
            get(cn, ranks[off:off + CLUSTER_BATCH])
            off += CLUSTER_BATCH
            calls += 1
            if joined_at is None and CLUSTER_CNS - 1 in cl.live:
                joined_at = cl.clock
    wall = time.perf_counter() - t_all
    check(joined_at is not None, "CN 3 never joined")

    def profiled():
        from torch.profiler import ProfilerActivity, profile
        idx = ranks[:CLUSTER_PROFILED_CALLS * CLUSTER_BATCH]
        live = sorted(cl.live)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for i in range(CLUSTER_PROFILED_CALLS):
                get(live[i % len(live)],
                    idx[i * CLUSTER_BATCH:(i + 1) * CLUSTER_BATCH],
                    record=False)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        b_us, spans = device_busy_us(prof)
        return dict(device_busy_share=b_us / wall_us if spans else None,
                    device_ops_per_call=spans / CLUSTER_PROFILED_CALLS)

    res["gets"] = dict(lanes=lanes, calls=calls, seconds=wall,
                       gets_per_s=lanes / wall, joined_at_op=joined_at,
                       per_cn={cn: dict(lanes=per_cn_lanes[cn],
                                        gets_per_s=per_cn_lanes[cn]
                                        / per_cn_s[cn])
                               for cn in sorted(per_cn_lanes)},
                       **_lat_stats(lat))
    res["gets"].update(profiled())

    # a burst of updates, each CN writing keys that other CNs own
    live = sorted(cl.live)
    owners = cl.ownership.owners_for(cl.shards_of(keys))
    per = CLUSTER_BURST // len(live)
    upd = []
    for cn in live:
        pool = np.flatnonzero(owners != cn)
        idx = rng.choice(pool, size=per, replace=False)
        new_v = rng.integers(1, 2**63, per, dtype=np.uint64)
        for b0 in range(0, per, CLUSTER_BATCH):
            sl = slice(b0, b0 + CLUSTER_BATCH)
            w = cl.cns[cn].update_batch(keys[idx[sl]], new_v[sl])
            check(w.statuses is None or not any(
                s in ("backoff", "unavailable") for s in w.statuses),
                f"CN {cn}: an update degraded")
            check(w.found.all(), f"CN {cn}: an update of a present key "
                  f"failed")
            latest[idx[sl]] = new_v[sl]
            upd.append(idx[sl])
    upd = np.unique(np.concatenate(upd))
    fwd_w = cl.stats.forwarded_write_lanes
    check(fwd_w >= per * len(live), "the non-owners' updates did not "
          "forward")

    # the leave, then every acknowledged update through each survivor
    lost = 0
    for b0 in range(0, upd.size, CLUSTER_BATCH):
        idx = upd[b0:b0 + CLUSTER_BATCH]
        r = cl.cns[0].get_batch(keys[idx])
        lost += int((~r.found).sum()) + int(
            (r.values != latest[idx])[r.found].sum())
    check(1 not in cl.live, "CN 1 never left")
    dead = cl.cns[1].get_batch(keys[:8])
    check(set(dead.statuses) == {"unavailable"}, "the departed CN served")
    for cn in sorted(cl.live):
        r = cl.cns[cn].get_batch(keys[upd[:CLUSTER_BATCH]])
        lost += int((r.values != latest[upd[:CLUSTER_BATCH]]).sum())
    check(lost == 0, f"{lost} acknowledged writes lost through the leave")
    res["launches"] = dict(ops.LAUNCHES)
    res["updates"] = dict(lanes=per * len(live), keys=int(upd.size),
                          forwarded_write_lanes=fwd_w, lost=lost)
    stats = cl.stats.snapshot()
    res["stats"] = stats
    res["handoffs"] = [dict(reason=h.reason, cn=h.cn, at_op=h.at_op,
                            shards=len(h.moved), bytes=h.bytes_moved)
                       for h in cl.handoffs]
    check([h["reason"] for h in res["handoffs"]] == ["join", "leave"]
          and all(h["shards"] > 0 for h in res["handoffs"]),
          f"handoffs {res['handoffs']}")
    res["hit_rate"], res["counters"] = {}, {}
    for cn, hub in enumerate(cl.hubs):
        c = hub.counters
        h, ng, m = (c.get("cache.hits", 0), c.get("cache.neg_hits", 0),
                    c.get("cache.misses", 0))
        res["hit_rate"][cn] = h / max(h + ng + m, 1)
        res["counters"][cn] = c
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["meter"] = cl.meter_totals().snapshot()

    # the reference's model of the fabric over the four CNs' traces
    t = time.perf_counter()
    sim = simulate_cluster([tr.trace for tr in cl.transports],
                           replicas=CLUSTER_MNS, **CLUSTER_SIM)
    res["modelled"] = dict(
        replay_seconds=time.perf_counter() - t, replayed_ops=sim.n_ops,
        lane_mops=(lanes + per * len(live)) / max(sim.seconds, 1e-12) / 1e6,
        wire_mops=sim.n_ops / max(sim.seconds, 1e-12) / 1e6,
        p50_us=sim.percentile_us(50), p99_us=sim.percentile_us(99),
        **CLUSTER_SIM, replicas=CLUSTER_MNS)
    g = res["gets"]
    log(f"cluster Gets: {g['gets_per_s']:.1f} Gets/s over {lanes} lanes in "
        f"{calls} batches of {CLUSTER_BATCH} (zipf({CLUSTER_THETA})); "
        f"batch p50 {g['p50_ms']:.4f} ms, p99 {g['p99_ms']:.4f} ms; per CN "
        + ", ".join(f"{cn} {v['gets_per_s']:.1f}" for cn, v
                    in g["per_cn"].items())
        + f"; hit rate per CN {json.dumps(res['hit_rate'])}; device busy "
        f"share {g['device_busy_share']}, {g['device_ops_per_call']} device "
        f"ops a batch")
    log(f"cluster stats: {json.dumps(stats)}; handoffs "
        f"{json.dumps(res['handoffs'])}; {res['updates']['lanes']} updates "
        f"from non-owners, 0 of {upd.size} updated keys lost through the "
        f"leave")
    for cn in range(CLUSTER_CNS):
        log(f"cluster hub cn={cn}: "
            f"{json.dumps(res['counters'][cn], sort_keys=True)}")
    m = res["modelled"]
    log(f"cluster modelled (the reference's model of the fabric, not the "
        f"card): {m['lane_mops']:.4f} lane Mops, {m['wire_mops']:.4f} wire "
        f"Mops, p50 {m['p50_us']:.3f} us, p99 {m['p99_us']:.3f} us over "
        f"{m['replayed_ops']} replayed ops ({m['replay_seconds']:.1f} s of "
        f"replay); peak {res['max_memory_allocated']} B")
    return res


def large_chaos() -> dict:
    """Phase 12 (d): one larger chaos run on the card."""
    from repro_torch.net.chaos import run_chaos
    t0 = time.perf_counter()
    rep = run_chaos(**CHAOS_LARGE)
    sec = time.perf_counter() - t0
    d = rep.to_json_dict()
    check(rep.passed, f"large chaos run: {rep.failures}")
    check(d["lost_acked_writes"] == 0, "large chaos run lost writes")
    check(all(t.slots_lo.is_cuda for t in rep.cluster.engine.tables),
          "the chaos cluster's pool is not on the card")
    out = {k: d[k] for k in ("seed", "n_cns", "replicas", "placement_k",
                             "kinds", "lanes", "acked_writes",
                             "degraded_lanes", "availability", "heal_checks",
                             "lost_acked_writes", "split_brain_acked_writes",
                             "linearizability_violations",
                             "fenced_write_lanes", "partition_arbitrations",
                             "view_syncs", "state_sig", "telemetry_sig")}
    out.update(seconds=sec, **{k: CHAOS_LARGE[k] for k in ("n_keys", "n_ops",
                                                            "batch")})
    log(f"large chaos run: {json.dumps(out)}")
    return out


def serve_cluster_phase(keys, vals, rng) -> tuple:
    """Phase 12: (a) the agreement, (b) the telemetry plane's cost, (c)
    :func:`serve_cluster`, whose traffic is this phase's main path (its
    launch counts), (d) the large chaos run."""
    import torch
    t = time.perf_counter()
    res = dict(agreement=obs_agreement_check(SEED))
    res["agreement"]["seconds"] = time.perf_counter() - t
    log(f"phase 12 (a): {res['agreement']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res["telemetry_cost"] = telemetry_cost(keys, vals, rng)
    res["telemetry_cost"]["seconds"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res["cluster"] = serve_cluster(keys, vals, rng)
    res["cluster"]["seconds"] = time.perf_counter() - t
    launches = res["cluster"].pop("launches")
    gc.collect()
    torch.cuda.empty_cache()
    res["chaos"] = large_chaos()
    log(f"phase 12 (b) {res['telemetry_cost']['seconds']:.1f} s, (c) "
        f"{res['cluster']['seconds']:.1f} s, (d) "
        f"{res['chaos']['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


# ------------------------------------------------------------ phase 13
def _fd_artifacts(fd, st, tr, sig, replay: bool = True) -> dict:
    """What a front-door run leaves behind, in plain values; ``replay``
    adds the ``simulate_open`` replay of its lanes."""
    from repro_torch.net.replay import simulate_open
    sim = (simulate_open(tr.trace, np.asarray(fd.lane_arrivals()))
           if replay else None)
    hub = getattr(st, "hub", None)
    return dict(records=[dataclasses.astuple(r) for r in fd.records],
                stats=fd.stats(), arrivals=fd.lane_arrivals(),
                meter=st.meter_totals().snapshot(),
                trace=_trace_tuples(tr.trace), state=sig(st),
                counters=None if hub is None else dict(hub.counters),
                sim=None if sim is None else (
                    np.asarray(sim.lat_by_op_us).tolist(),
                    np.asarray(sim.completions_by_op_s).tolist(),
                    sim.seconds, sim.n_ops))


def frontdoor_agreement_check(seed: int, devices=("cuda", "cpu")) -> dict:
    """Phase 13 (a), the front door: one generated two-tenant schedule of
    Gets, updates and inserts through four policies (the dormant
    pass-through, singleflight, admission with a token bucket and
    telemetry on, singleflight over a store whose one MN crashes with one
    retry a lane, so lanes degrade), each over a fresh
    ``FD_AGREE_KEYS``-key store with a transport on each device: records,
    stats, lane arrivals, meters, traces, MN images, hub counters and the
    ``simulate_open`` replay must be equal; and on the card the same
    submits made directly must meter, trace and leave the MN images as the
    pass-through door did."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.core.store import make_uniform_keys
    from repro_torch.kernels import ops
    from repro_torch.net import FaultSchedule, Transport
    from repro_torch.net.chaos import state_signature
    from repro_torch.obs import TelemetryConfig
    from repro_torch.serve import (FrontDoor, FrontDoorConfig, TenantLimit,
                                   TenantSpec, TrafficSpec, generate)
    keys = make_uniform_keys(FD_AGREE_KEYS, seed + 3)
    vals = splitmix64(keys)
    offered = generate(TrafficSpec(tenants=(
        TenantSpec("a", 3e5, read_frac=0.7, insert_frac=0.05, keyspace=256),
        TenantSpec("b", 2e5, read_frac=0.5, zipf_theta=0.9, hot_salt=2)),
        duration_s=0.004, seed=seed + 7), keys)
    crash = FaultSchedule.single_crash(at_op=2, duration_ops=4096,
                                       max_retries=1, lease_term_ops=0)
    cases = {
        "passthrough": ({}, FrontDoorConfig()),
        "singleflight": ({}, FrontDoorConfig(singleflight=True, window=64)),
        "admission": (dict(telemetry=TelemetryConfig(window_ops=1024)),
                      FrontDoorConfig(max_inflight=4, queue_depth=8,
                                      service_us=16.0, singleflight=True,
                                      window=128, limits=(
                                          TenantLimit("b", 5e4, burst=4.0),))),
        "k1_crash": (dict(faults=crash),
                     FrontDoorConfig(singleflight=True, window=32)),
    }

    def sig(st):
        inner = st
        while not hasattr(inner, "replicas") and hasattr(inner, "inner"):
            inner = inner.inner
        engines = ([r.engine for r in inner.replicas]
                   if hasattr(inner, "replicas") else [st.engine])
        return [state_signature(e.mn_state()) for e in engines]

    out = {}
    for name, (spec_kw, cfg) in cases.items():
        runs = []
        for device in devices:
            ops.reset_launch_counts()
            tr = Transport()
            st = open_store(StoreSpec("outback", load_factor=0.85,
                                      batch=BatchPolicy(window=256),
                                      **spec_kw),
                            keys, vals, device=device, transport=tr)
            fd = FrontDoor(st, cfg)
            fd.run(offered)
            # a faulted store's retried lanes do not map one to one onto
            # trace ops, so that case is not replayed
            runs.append(_fd_artifacts(fd, st, tr, sig,
                                      replay="faults" not in spec_kw))
            if device == "cuda":
                launches = dict(ops.LAUNCHES)
        check(all(r == runs[0] for r in runs[1:]),
              f"front door {name}: the card's run differs from the CPU's")
        if name == "passthrough":
            passthrough = runs
        # the crash window covers the faulted case's whole stream: its
        # lanes are answered degraded without reaching the index
        check(launches["ludo_lookup"] > 0 or "faults" in spec_kw,
              f"front door {name}: no ludo_lookup launch on the card")
        out[name] = dict(stats=runs[0]["stats"],
                         lanes=len(runs[0]["arrivals"]))
    # the dormant contract on the card: the same submits made directly
    # meter, trace and leave the MN state as the pass-through door did
    tr = Transport()
    st = open_store(StoreSpec("outback", load_factor=0.85,
                              batch=BatchPolicy(window=256)),
                    keys, vals, device=devices[0], transport=tr)
    for o in offered:
        st.submit(o.op, o.key, o.value)
    st.flush()
    door = passthrough[0]
    check((st.meter_totals().snapshot(), _trace_tuples(tr.trace), sig(st))
          == (door["meter"], door["trace"], door["state"]),
          "front door: the dormant door is not byte-invisible on the card")
    outcomes = {o for c in out.values() for o, n in c["stats"].items()
                if n and o not in ("offered", "lanes")}
    check(outcomes >= {"ok", "collapsed", "shed", "ratelimited",
                       "unavailable"}, f"front door agreement: outcomes "
          f"{sorted(outcomes)}")
    log(f"front door on the card against the CPU, {FD_AGREE_KEYS} keys, "
        f"{len(offered)} offers: equal in {sorted(out)}: "
        f"{json.dumps({k: v['stats'] for k, v in out.items()})}")
    return out


def session_agreement_check(seed: int, devices=("cuda", "cpu")) -> dict:
    """Phase 13 (a), the session store: puts of blobs from 0 to 2^16 bytes,
    two gets of each (the second through the CN cache), a shrinking re-put,
    a delete, gets of a deleted and an unknown session, on each device:
    answers, meters, MN images and the cache's whole state must be
    equal."""
    from repro_torch.net.chaos import state_signature
    from repro_torch.serve import KVSessionStore
    rng = np.random.default_rng(seed + 4)
    blobs = {rid: rng.bytes(n) for rid, n in
             enumerate((0, 7, 8, 4093, 1 << 16, 3 * (1 << 14) + 5))}
    runs = []
    for device in devices:
        ss = KVSessionStore(cn_cache_budget_bytes=64 << 10, device=device)
        out = [ss.put(rid, blob) for rid, blob in blobs.items()]
        out += [ss.get(rid) == blob for rid, blob in blobs.items()]
        out += [ss.get(rid) == blob for rid, blob in blobs.items()]
        out += [ss.put(4, b"short"), ss.get(4), ss.delete(2), ss.get(2),
                ss.get(99), ss.delete(2)]
        state = ss.store.cache.state()
        runs.append(dict(
            answers=out, meter=ss.meter_total().snapshot(),
            state=state_signature(ss.store.engine.mn_state()),
            cache={k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in state.items()},
            tables=len(ss.store.engine.tables)))
        if device == "cuda":
            check(all(t.slots_lo.is_cuda for t in ss.store.engine.tables),
                  "the session store is not on the card")
    check(all(r == runs[0] for r in runs[1:]),
          "session store: the card's run differs from the CPU's")
    check(all(runs[0]["answers"][len(blobs):3 * len(blobs)]),
          "session store: a blob came back wrong")
    res = dict(blobs=len(blobs), tables=runs[0]["tables"],
               hits=runs[0]["cache"]["stats"]["hits"])
    log(f"session store on the card against the CPU: equal "
        f"({json.dumps(res)})")
    return res


def rwkv_agreement_check(seed: int) -> dict:
    """Phase 13 (a), rwkv6: the reduced config in float32 from the same
    weights, 6 decode steps of 3 rows (logits and every cache leaf) and a
    32-token prefill, card against CPU, within RWKV_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.common import sorted_leaves, tree_map
    from repro_torch.models.lm import LM, init_params
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                              dtype="float32")
    params = {"cpu": init_params(cfg, seed, device="cpu",
                                 dtype=torch.float32)}
    params["cuda"] = tree_map(lambda t: t.to("cuda"), params["cpu"])
    models = {d: LM(cfg, device=d) for d in params}
    caches = {d: m.init_cache(3, 16) for d, m in models.items()}
    rng = np.random.default_rng(seed + 1)
    err = 0.0

    def close(a, b, what):
        nonlocal err
        a, b = a.cpu().double(), b.double()
        e = float((a - b).abs().max())
        err = max(err, e)
        check(bool(((a - b).abs() <= RWKV_TOL + RWKV_TOL * b.abs()).all()),
              f"rwkv6 {what}: card against CPU off by {e}")

    for i in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))
                               .astype(np.int32))
        logits = {}
        for d, m in models.items():
            logits[d], caches[d] = m.decode_step(params[d], tok.to(d),
                                                 caches[d])
        close(logits["cuda"], logits["cpu"], f"decode step {i}")
    for (p, g), (_, w) in zip(sorted_leaves(caches["cuda"]),
                              sorted_leaves(caches["cpu"])):
        close(g, w, f"cache leaf {p}")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                            .astype(np.int32))
    close(models["cuda"].prefill(params["cuda"], {"tokens": toks.cuda()}),
          models["cpu"].prefill(params["cpu"], {"tokens": toks}), "prefill")
    log(f"rwkv6 (reduced, float32) on the card against the CPU: 6 decode "
        f"steps and a 32-token prefill within {RWKV_TOL}, max abs err {err}")
    return dict(max_abs_err=err, tol=RWKV_TOL)


def _fd_specs(knee: dict) -> dict:
    """The slo suite's singleflight, isolation (contended) and acked-writes
    traffic and front-door policies (benchmarks/slo_bench.py:205-214,
    259-370) at ``FD_OFFERS`` offers each."""
    from repro_torch.serve import (FrontDoorConfig, TenantLimit, TenantSpec,
                                   TrafficSpec)

    def admission(**kw):
        admit = 0.9 * knee["rate_ops_per_s"]
        depth = max(4, int(1.5 * knee["p999_us"] * 1e-6 * admit))
        return FrontDoorConfig(max_inflight=FD_C, queue_depth=depth,
                               service_us=FD_C / admit * 1e6,
                               window=FD_WINDOW, **kw)

    k = knee["rate_ops_per_s"]
    sf_rate = 8 * 100_000.0
    a_limit = 0.15 * k
    rw = 1.2 * k
    return {
        "singleflight": (TrafficSpec(tenants=tuple(
            TenantSpec(name=f"t{i}", rate_ops_per_s=sf_rate / 8,
                       zipf_theta=0.99, keyspace=4096, hot_salt=0)
            for i in range(8)), duration_s=FD_OFFERS["singleflight"]
            / sf_rate, seed=400),
            FrontDoorConfig(singleflight=True, window=FD_WINDOW)),
        "isolation": (TrafficSpec(tenants=(
            TenantSpec(name="compliant", rate_ops_per_s=0.3 * k,
                       zipf_theta=0.99, hot_salt=1),
            TenantSpec(name="abuser", rate_ops_per_s=8.0 * a_limit,
                       zipf_theta=0.99, hot_salt=2)),
            duration_s=FD_OFFERS["isolation"] / (0.3 * k + 8.0 * a_limit),
            seed=500),
            admission(limits=(TenantLimit("abuser", a_limit, burst=16.0),))),
        "acked_writes": (TrafficSpec(tenants=(
            TenantSpec(name="rw0", rate_ops_per_s=rw * 0.4, read_frac=0.5,
                       zipf_theta=0.9, hot_salt=3),
            TenantSpec(name="rw1", rate_ops_per_s=rw * 0.4, read_frac=0.5,
                       zipf_theta=0.9, hot_salt=4),
            TenantSpec(name="greedy", rate_ops_per_s=rw * 0.2, read_frac=0.5,
                       zipf_theta=0.9, hot_salt=5)),
            duration_s=FD_OFFERS["acked_writes"] / rw, seed=600),
            admission(singleflight=True, limits=(
                TenantLimit("greedy", rw * 0.05, burst=8.0),))),
    }


def _modelled(recs, sim, duration_s: float) -> dict:
    """The open-loop replay's view of a run (the reference's model of the
    fabric, not the card): answered requests' latency from arrival to their
    lane's completion (a collapsed follower clamped at zero) and the
    answered requests over the schedule's duration."""
    done = np.asarray(sim.completions_by_op_s)
    lat = np.asarray([max(done[r.lane] - r.t_s, 0.0) * 1e6 for r in recs
                      if r.outcome in ("ok", "collapsed")])
    return dict(answered_mops=lat.size / duration_s / 1e6,
                p50_us=float(np.percentile(lat, 50)),
                p99_us=float(np.percentile(lat, 99)),
                p999_us=float(np.percentile(lat, 99.9)),
                replay_seconds=sim.seconds)


def serve_frontdoor(keys, vals, rng) -> dict:
    """Phase 13 (b): the slo suite's timing store over the first
    2^``LATER_KEYS_LOG2`` of phase 3's keys; the
    knee as the suite's capacity probe measures it; then the singleflight,
    isolation and acked-writes streams through ``FrontDoor.run``, every
    answer held against a host oracle of the latest acknowledged values,
    every update read back after (0 lost acknowledged writes, no refused
    update applied); then a profiled stretch of the singleflight stream.
    The launch counters are zeroed just before the three streams and read
    just after."""
    import torch
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.kernels import ops
    from repro_torch.net import Transport
    from repro_torch.net.replay import simulate_open
    from repro_torch.serve import FrontDoor, FrontDoorConfig, generate
    spec = StoreSpec("outback", load_factor=0.85, rng_seed=SEED,
                     batch=BatchPolicy(window=FD_WINDOW))
    keys, vals = keys[:1 << LATER_KEYS_LOG2], vals[:1 << LATER_KEYS_LOG2]
    tr = Transport()
    t0 = time.perf_counter()
    st = open_store(spec, keys, vals, transport=tr)
    torch.cuda.synchronize()
    res = dict(build_seconds=time.perf_counter() - t0, keys=int(keys.size),
               spec=spec.to_json_dict())
    check(st.engine.slots_lo.is_cuda, "the front door's store is not on "
          "the card")
    order = np.argsort(keys)
    sorted_keys = keys[order]

    def build_value(ks):
        return vals[order[np.searchsorted(sorted_keys, ks)]]

    def since(mark):
        return tr.trace[mark:]

    # the knee: the suite's capacity probe, then a pass-through run at
    # FD_KNEE_FRAC of its rate for the knee's p999
    idx = zipf_ranks(rng, keys.size, FD_PROBE_GETS)
    mark = len(tr.trace)
    for i in idx:
        st.submit("get", int(keys[i]))
    st.flush()
    probe = simulate_open(since(mark), np.zeros(FD_PROBE_GETS), qps=FD_QPS)
    probe_rate = FD_PROBE_GETS / float(np.max(probe.completions_by_op_s))
    from repro_torch.serve import TenantSpec, TrafficSpec
    knee_rate = FD_KNEE_FRAC * probe_rate
    kspec = TrafficSpec(tenants=(TenantSpec("curve", knee_rate,
                                            zipf_theta=0.99),),
                        duration_s=FD_PROBE_GETS * 4 / knee_rate, seed=100)
    mark = len(tr.trace)
    fd = FrontDoor(st, FrontDoorConfig())
    recs = fd.run(generate(kspec, keys))
    km = _modelled(recs, simulate_open(since(mark),
                                       np.asarray(fd.lane_arrivals()),
                                       qps=FD_QPS), kspec.duration_s)
    knee = dict(rate_ops_per_s=knee_rate, p999_us=km["p999_us"],
                probe_rate_ops_per_s=probe_rate)
    res["knee"] = knee
    log(f"front door store: build {res['build_seconds']:.3f} s at "
        f"{keys.size} keys; knee (modelled) {json.dumps(knee)}")

    overrides = {}  # key -> last acknowledged value
    refused = []  # (key, value) of updates shed or rate-limited
    runs = {}
    ops.reset_launch_counts()
    for name, (tspec, cfg) in _fd_specs(knee).items():
        t = time.perf_counter()
        offered = generate(tspec, keys)
        gen_s = time.perf_counter() - t
        mark = len(tr.trace)
        fd = FrontDoor(st, cfg)
        flushes0 = st.stats.flushes
        m0 = st.meter_totals().snapshot()
        gc.collect()
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = fd.run(offered)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t
        stats = fd.stats()
        # the oracle, in offer order: a Get sees the latest acknowledged
        # write before it (the door's hazard flushes keep program order)
        want, got, build_keys = [], [], []
        for r in recs:
            if r.op == "get" and r.outcome in ("ok", "collapsed"):
                got.append((r.found, r.result))
                if r.key in overrides:
                    want.append((True, overrides[r.key]))
                else:
                    want.append(None)
                    build_keys.append(r.key)
            elif r.op in ("update", "insert"):
                if r.outcome == "ok":
                    check(r.found, f"{name}: an admitted {r.op} failed")
                    overrides[r.key] = r.value
                elif r.outcome in ("shed", "ratelimited"):
                    refused.append((r.key, r.value))
        bv = iter(build_value(np.asarray(build_keys, dtype=np.uint64))
                  .tolist())
        want = [(True, next(bv)) if w is None else w for w in want]
        bad = sum(g != w for g, w in zip(got, want))
        check(bad == 0, f"{name}: {bad} answers differ from the oracle")
        check(stats["unavailable"] == 0, f"{name}: unavailable lanes")
        meter = st.meter_totals()
        sf = meter.sf_hits - m0["sf_hits"]
        check(sf == stats["collapsed"], f"{name}: singleflight meter "
              f"{sf} against {stats['collapsed']} collapsed")
        sim = simulate_open(since(mark), np.asarray(fd.lane_arrivals()),
                            qps=FD_QPS)
        check(sim.n_ops == stats["lanes"], f"{name}: lanes and trace ops")
        gets = sum(1 for r in recs if r.op == "get")
        runs[name] = dict(
            offered=len(recs), generate_seconds=gen_s, host_seconds=host_s,
            offers_per_s=len(recs) / host_s, stats=stats,
            singleflight_saved_share=stats["collapsed"] / max(gets, 1),
            windows=st.stats.flushes - flushes0,
            answers_checked=len(got),
            modelled=_modelled(recs, sim, tspec.duration_s),
            policy=cfg.to_json_dict())
        log(f"front door {name}: {len(recs)} offers in {host_s:.3f} s "
            f"({runs[name]['offers_per_s']:.1f} offers/s, host clock; "
            f"generate {gen_s:.3f} s); {json.dumps(stats)}; singleflight "
            f"saved {runs[name]['singleflight_saved_share']:.4f} of Gets; "
            f"{runs[name]['windows']} windows; modelled (the reference's "
            f"model of the fabric, not the card) "
            f"{json.dumps(runs[name]['modelled'])}")
    launches = dict(ops.LAUNCHES)
    # every acknowledged write reads back; no refused update landed
    ks = np.asarray(sorted(overrides), dtype=np.uint64)
    back = st.get_batch(ks)
    check(bool(back.found.all()) and back.values.tolist()
          == [overrides[k] for k in ks.tolist()],
          "front door: an acknowledged write was lost")
    landed = [(k, v) for k, v in refused
              if k not in overrides or overrides[k] != v]
    rk = np.asarray([k for k, _ in landed], dtype=np.uint64)
    if rk.size:
        now = st.get_batch(rk).values
        applied = sum(int(a) == v for a, (_, v) in zip(now, landed))
        check(applied == 0, f"front door: {applied} refused updates landed")
    res["acked_writes"] = dict(acked_keys=int(ks.size),
                               refused_updates=len(refused), lost=0)
    log(f"front door writes: {ks.size} acknowledged keys read back, 0 lost; "
        f"{len(refused)} refused updates, none applied")

    # device ops a window and busy share over a stretch of the
    # singleflight stream (a Get stream changes no state)
    from torch.profiler import ProfilerActivity, profile
    tspec, cfg = _fd_specs(knee)["singleflight"]
    offered = generate(tspec, keys)[:FD_PROFILED_OFFERS]
    fd = FrontDoor(st, cfg)
    flushes0 = st.stats.flushes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fd.run(offered)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    b_us, spans = device_busy_us(prof)
    windows = st.stats.flushes - flushes0
    res["profiled"] = dict(offers=len(offered), windows=windows,
                           device_ops_per_window=spans / max(windows, 1),
                           device_busy_share=b_us / wall_us if spans
                           else None)
    res["runs"] = runs
    res["launches"] = launches
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"front door profiled: {json.dumps(res['profiled'])}")
    return res


def _lane_state(eng, lane: int):
    from repro_torch.models.common import tree_map
    return tree_map(lambda c: (c[:, lane] if c.dim() >= 2 else c[lane]
                               ).clone(), eng.cache)


def _same_state(a, b) -> bool:
    import torch
    from repro_torch.models.common import sorted_leaves
    la, lb = sorted_leaves(a), sorted_leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def serve_sessions(seed: int) -> dict:
    """Phase 13 (c): llama3.2-1b at its published widths (random bf16
    weights from the seed) in ``Engine(lanes=SESSION_LANES,
    max_seq=SESSION_MAX_SEQ, session_store=KVSessionStore(
    cn_cache_budget_bytes=SESSION_CACHE_BYTES))`` on the card: a few steps,
    then lane 0 parks, resumes, parks and resumes again (each timed, parks
    with their flush), its state equal bit for bit to the parked state each
    time, its length kept, CN cache hits rising on the second resume; then
    every request runs to its end and the parked blob is reclaimed.  The
    launch counters are zeroed just before the steps and read after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import sorted_leaves
    from repro_torch.models.lm import LM
    from repro_torch.serve import Engine, KVSessionStore, Request
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(seed)
    ss = KVSessionStore(cn_cache_budget_bytes=SESSION_CACHE_BYTES)
    torch.cuda.synchronize()
    res = dict(init_seconds=time.perf_counter() - t0, lanes=SESSION_LANES,
               max_seq=SESSION_MAX_SEQ,
               cache_budget_bytes=SESSION_CACHE_BYTES)
    check(ss.store.engine.tables[0].slots_lo.is_cuda,
          "the session store is not on the card")
    eng = Engine(model, params, lanes=SESSION_LANES, max_seq=SESSION_MAX_SEQ,
                 session_store=ss)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=100 + i, prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, SESSION_PROMPT)], max_new=SESSION_NEW)
        for i in range(SESSION_LANES)]
    for r in reqs:
        eng.submit(r)
    ops.reset_launch_counts()
    for _ in range(SESSION_STEPS):
        eng.step()
    rid = eng.active[0].rid
    state = _lane_state(eng, 0)
    length = int(state["length"])
    timings, lane = {}, 0

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timings[name] = (time.perf_counter() - t) * 1e3
        return out

    def park():
        eng.park(lane)
        ss.flush()

    tables0 = len(ss.store.engine.tables)
    timed("park1_ms", park)
    chunk_keys = ss._lengths[rid] + 1
    splits = len(ss.store.engine.resize_events)
    lane = timed("resume1_ms", lambda: eng.resume(rid))
    check(_same_state(_lane_state(eng, lane), state), "the first resume did "
          "not restore the parked state bit for bit")
    check(int(eng.cache["length"][lane]) == length, "length not kept")
    timed("park2_ms", park)
    h0 = ss.cache_stats.hits
    lane = timed("resume2_ms", lambda: eng.resume(rid))
    hits = ss.cache_stats.hits - h0
    check(_same_state(_lane_state(eng, lane), state), "the second resume did "
          "not restore the parked state bit for bit")
    check(hits > 0, "the second resume read nothing through the CN cache")
    eng.run()
    check(all(r.done for r in reqs) and eng.stats.finished == len(reqs),
          "a parked session's request did not finish")
    check(ss.get(rid) is None, "the finished session's blob was not "
          "reclaimed")
    launches = dict(ops.LAUNCHES)
    res.update(timings, chunk_keys_per_park=chunk_keys,
               blob_bytes=sum(x.numel() * x.element_size()
                              for _, x in sorted_leaves(state)),
               splits=splits, tables_before=tables0,
               tables_after=len(ss.store.engine.tables),
               second_resume_cache_hits=hits, length=length,
               stats=dataclasses.asdict(eng.stats),
               meter=ss.meter_total().snapshot(), launches=launches)
    log(f"session parking (llama3.2-1b, max_seq {SESSION_MAX_SEQ}): park "
        f"{timings['park1_ms']:.1f} ms, resume {timings['resume1_ms']:.1f} "
        f"ms, re-park {timings['park2_ms']:.1f} ms, resume "
        f"{timings['resume2_ms']:.1f} ms; {chunk_keys} chunk keys a park "
        f"({res['blob_bytes']} B); {splits} splits (tables {tables0} -> "
        f"{res['tables_after']}); {hits} CN cache hits on the second "
        f"resume; state restored bit for bit twice, length {length} kept; "
        f"launches {json.dumps(launches)}")
    return res


def serve_rwkv(seed: int) -> dict:
    """Phase 13 (d): rwkv6-1.6b at its published widths (random bf16
    weights from the seed): ``RWKV_REQUESTS`` requests through
    ``Engine(lanes=RWKV_LANES)``, every step synced and timed, one lane
    parked in process mid-run and resumed with its state bit for bit;
    then the device busy share over profiled decode steps, and a lane's
    blob (12,779,524 B) refused by ``KVSessionStore.put``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serve import Engine, KVSessionStore, Request
    from repro_torch.serve.engine import _to_bytes
    from repro_torch.models.common import sorted_leaves
    cfg = get_config("rwkv6-1.6b")
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(seed)
    torch.cuda.synchronize()
    res = dict(init_seconds=time.perf_counter() - t0)
    eng = Engine(model, params, lanes=RWKV_LANES, max_seq=RWKV_MAX_SEQ)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, RWKV_PROMPT)], max_new=RWKV_NEW)
        for i in range(RWKV_REQUESTS)]
    for r in reqs:
        eng.submit(r)
    steps, parked = [], False
    t_run = time.perf_counter()
    while any(eng.active) or eng.pending or eng.to_prefill:
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        if not parked and eng.stats.decode_steps == 2:
            state = _lane_state(eng, 0)
            rid = eng.park(0)
            lane = eng.resume(rid)
            check(_same_state(_lane_state(eng, lane), state),
                  "rwkv6: the in-process resume changed the state")
            parked = True
            lane_state = state
    run_s = time.perf_counter() - t_run
    toks = [t for r in reqs for t in r.out]
    check(all(r.done for r in reqs) and parked, "rwkv6: a request did not "
          "finish")
    check(all(0 <= t < cfg.vocab_size for t in toks), "rwkv6: a token out "
          "of range")
    # the first engine step (it warms the allocator and the caches) apart:
    # the percentiles and tokens/s are over the steps after it
    ms = np.asarray(steps) * 1e3
    res.update(requests=len(reqs), tokens=len(toks), run_seconds=run_s,
               tokens_per_s=len(toks) / (run_s - steps[0]),
               tokens_per_s_with_first=len(toks) / run_s,
               engine_steps=len(steps), first_step_ms=float(ms[0]),
               step_p50_ms=float(np.percentile(ms[1:], 50)),
               step_p99_ms=float(np.percentile(ms[1:], 99)),
               stats=dataclasses.asdict(eng.stats))
    from torch.profiler import ProfilerActivity, profile
    tok = torch.zeros((RWKV_LANES, 1), dtype=torch.int32,
                      device=model.device)
    cache = eng.cache
    logits, cache = model.decode_step(params, tok, cache)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(RWKV_PROFILED_STEPS):
            logits, cache = model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    b_us, spans = device_busy_us(prof)
    check(bool(torch.isfinite(logits.float()).all()), "rwkv6: logits not "
          "finite")
    res.update(device_busy_share=b_us / wall_us if spans else None,
               device_ops_per_step=spans / RWKV_PROFILED_STEPS,
               profiled_step_ms=wall_us / 1e3 / RWKV_PROFILED_STEPS)
    blob = _to_bytes([x for _, x in sorted_leaves(lane_state)])
    ss = KVSessionStore()
    try:
        ss.put(0, blob)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(len(blob) == 12_779_524 and refused == "session blob too large",
          f"rwkv6: a {len(blob)} B lane was not refused ({refused})")
    res.update(lane_bytes=len(blob), put_refusal=refused,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"rwkv6-1.6b: {len(reqs)} requests, {len(toks)} tokens in "
        f"{run_s:.3f} s ({res['tokens_per_s']:.2f} tokens/s after the first "
        f"engine step, {res['tokens_per_s_with_first']:.2f} with it); "
        f"first engine step {res['first_step_ms']:.3f} ms, then p50 "
        f"{res['step_p50_ms']:.3f} ms, p99 {res['step_p99_ms']:.3f} ms over "
        f"the other {len(steps) - 1} steps; decode step {res['profiled_step_ms']:.3f} "
        f"ms profiled, {res['device_ops_per_step']:.1f} device ops, busy "
        f"share {res['device_busy_share']}; a lane is {len(blob)} B and "
        f"KVSessionStore.put refuses it: {refused!r}")
    return res


def serve_serving_phase(keys, vals, rng) -> tuple:
    """Phase 13: (a) the agreements, (b) :func:`serve_frontdoor`, (c)
    :func:`serve_sessions`, (d) :func:`serve_rwkv`.  Returns the numbers
    and the launch counts of the front door's and the session path's
    runs."""
    import torch
    res = {}
    t = time.perf_counter()
    res["agreement"] = dict(frontdoor=frontdoor_agreement_check(SEED),
                            sessions=session_agreement_check(SEED),
                            rwkv=rwkv_agreement_check(SEED))
    res["agreement"]["seconds"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    for name, fn in (("frontdoor", lambda: serve_frontdoor(keys, vals, rng)),
                     ("sessions", lambda: serve_sessions(SEED)),
                     ("rwkv", lambda: serve_rwkv(SEED))):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res[name] = fn()
        res[name]["seconds"] = time.perf_counter() - t
        if "launches" in res[name]:
            launches[name] = res[name].pop("launches")
        gc.collect()
        torch.cuda.empty_cache()
    log("phase 13 (a) {:.1f} s, (b) {:.1f} s, (c) {:.1f} s, (d) {:.1f} s"
        .format(res["agreement"]["seconds"], res["frontdoor"]["seconds"],
                res["sessions"]["seconds"], res["rwkv"]["seconds"]))
    return res, launches


# ------------------------------------------------------------ phase 14
def fnmb_bound(S: int, d: int, F: int, dtype) -> tuple:
    """The least time of one fused_norm_matmul backward: x, gamma, w and dy
    read once and dx, dgamma and dw written once over the HBM rate, against
    the 2*S*d*F operations of dw over the peak of the pipe the kernel
    takes (the bf16 tensor cores; float32 FMAs)."""
    import torch
    elt = 2 if dtype == torch.bfloat16 else 4
    by_bytes = (2 * S * d + 2 * d + 2 * d * F + S * F) * elt \
        / HBM_BYTES_PER_S * 1e3
    peak = BF16_TC_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    by_ops = 2 * S * d * F / peak * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def fnmb_library(graphs):
    """The library yardstick, which the port never calls: the backward alone
    of ``F.rms_norm`` then ``torch.matmul``, through ``torch.autograd.grad``
    over a graph built beforehand (``graphs``: (y, inputs, dy))."""
    import torch
    it = itertools.cycle(graphs)

    def run():
        y, inputs, dy = next(it)
        return torch.autograd.grad(y, inputs, dy, retain_graph=True)
    return run


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    return err / scale if scale else err


def fnmb_plan_of(S: int, d: int, F: int, dt: str) -> dict:
    """The plan ``ops.fused_norm_matmul_bwd`` takes for a call of these
    sizes on card 0 with dy on a 16-byte boundary."""
    import torch
    from repro_torch.kernels import ops
    return ops.fused_norm_matmul_bwd_dw_plan(
        S, d, F, getattr(torch, dt).itemsize,
        torch.cuda.get_device_properties(0).multi_processor_count)


def fnmb_kernels_of(plan: dict) -> tuple:
    """The CUDA kernels, by their names in ``ops.FNM_BWD_KERNELS``, that a
    ``fused_norm_matmul_bwd`` call of ``plan`` launches, each once: the
    row pass and the dgamma reduction, then the wgmma dw (and the sum of
    its splits when it has more than one) or the mma / fma dw."""
    rows = ("fused_norm_matmul_bwd_warp_rows_kernel",
            "fused_norm_matmul_bwd_reduce_kernel")
    if plan["regime"] != "wgmma":
        return (*rows, "fused_norm_matmul_bwd_dw_kernel")
    if plan["splits"] > 1:
        return (*rows, "fused_norm_matmul_bwd_wgmma_kernel",
                "fused_norm_matmul_bwd_dwsum_kernel")
    return (*rows, "fused_norm_matmul_bwd_wgmma_kernel")


def device_busy_ms(fn, iters: int, traces: int = FNMB_BUSY_TRACES) -> list:
    """The device time a call of ``fn`` in each of ``traces``
    ``torch.profiler`` traces of ``iters`` calls: the union of a trace's
    device intervals over ``iters``, in ms, as :func:`device_trace`'s
    callers take the hand path's.  A trace that holds no device operation
    (late in a long run) is retaken, up to TRACE_TRIES times for each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(traces):
        for _ in range(TRACE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            busy, n_ops = device_busy_us(prof)
            if n_ops:
                out.append(busy / iters / 1e3)
                break
            log(f"profiler: no device operation in a trace of {iters} calls")
    return out


def check_fnmb_shapes(gen, check_shapes) -> list:
    """``fused_norm_matmul_bwd`` against its plain version on the card at
    each (S, d, F, dtype) of ``check_shapes``, each gradient within FNM_TOL
    of its largest value, two calls bit for bit alike -> each shape's
    record."""
    import torch
    from repro_torch.kernels import ops, ref
    shapes = []
    for S, d, F, dt in check_shapes:
        dtype = getattr(torch, dt)
        x, g, w = fnm_inputs(gen, S, d, F, dtype)[0]
        dy = torch.randn((S, F), generator=gen, device="cuda").to(dtype)
        got = ops.fused_norm_matmul_bwd(x, g, w, dy)
        again = ops.fused_norm_matmul_bwd(x, g, w, dy)
        want = ref.fused_norm_matmul_bwd_ref(x, g, w, dy)
        torch.cuda.synchronize()
        rel = {n: _rel_err(a, b) for n, a, b in zip(("dx", "dgamma", "dw"),
                                                     got, want)}
        tol = FNM_TOL[dt]
        plan = fnmb_plan_of(S, d, F, dt)
        check(all(a.dtype == b.dtype and a.shape == b.shape
                  for a, b in zip(got, want)),
              f"fused_norm_matmul_bwd: dtypes or shapes differ at S={S}, "
              f"d={d}, F={F}, {dt}")
        check(max(rel.values()) <= tol,
              f"fused_norm_matmul_bwd differs from its plain version beyond "
              f"{tol} at S={S}, d={d}, F={F}, {dt}, plan {plan}: {rel}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"fused_norm_matmul_bwd: two calls differ at S={S}, d={d}, "
              f"F={F}, {dt}, plan {plan}")
        e = max(float((a.float() - b.float()).abs().max()) if a.numel()
                else 0.0 for a, b in zip(got, want))
        shapes.append(dict(S=S, d=d, F=F, dtype=dt, plan=plan,
                           max_rel_err=rel, max_abs_err=e, tolerance=tol))
    return shapes


def check_fused_norm_matmul_bwd(gen) -> dict:
    """Phase 14 (a): the backward kernel against its plain version on the
    card at FNMB_CHECK_SHAPES (every regime of its plan, a split plan, both
    row passes), two calls bit for bit alike, then timed at the training
    entries against its bound, the plain version and the library's
    backward, the last two like for like by their device time in traces."""
    import torch
    import torch.nn.functional as F_
    from repro_torch.kernels import ops, ref
    shapes = check_fnmb_shapes(gen, FNMB_CHECK_SHAPES)
    err = max(r["max_abs_err"] for r in shapes)
    ran = {(r["plan"]["regime"], r["plan"]["tile"][1],
            r["plan"]["splits"] > 1, r["plan"]["reread"]) for r in shapes}
    check({r[0] for r in ran} == set(ops.FNM_BWD_REGIMES)
          and {r[1] for r in ran if r[0] == "wgmma"} == {128, 256}
          and any(r[2] for r in ran) and {r[3] for r in ran} == {False, True},
          f"fused_norm_matmul_bwd: the check shapes miss a regime, a tile, "
          f"a split plan or a row pass: {sorted(ran)}")
    log(f"kernel fused_norm_matmul_bwd: within tolerance of its plain "
        f"version, and two calls bit for bit alike, at {len(shapes)} shapes "
        f"(regime, tile columns, split, reread: {sorted(ran)}; max rel err "
        f"by gradient "
        f"{ {n: max(r['max_rel_err'][n] for r in shapes) for n in ('dx', 'dgamma', 'dw')} })")
    timed = {}
    for S, d, F, dt in FNMB_TIMED_SHAPES:
        dtype = getattr(torch, dt)
        sets = [(*fnm_inputs(gen, S, d, F, dtype)[0],
                 torch.randn((S, F), generator=gen, device="cuda").to(dtype))
                for _ in range(2)]
        graphs = []
        for x, g, w, dy in sets:
            ins = tuple(t.detach().clone().requires_grad_() for t in (x, g, w))
            y = torch.matmul(F_.rms_norm(ins[0], (d,), ins[1], 1e-6), ins[2])
            graphs.append((y, ins, dy))
        iters = 20
        bound, by = fnmb_bound(S, d, F, dtype)
        kern = cycling(ops.fused_norm_matmul_bwd, sets)
        plan = fnmb_plan_of(S, d, F, dt)
        names = fnmb_kernels_of(plan)
        by_kernel, prof = device_trace(kern, 10, *names)
        busy, _ = device_busy_us(prof)
        check(len(by_kernel) == len(names) and busy > 0,
              f"fused_norm_matmul_bwd S={S} d={d} F={F} {dt}: no trace of "
              f"{TRACE_TRIES} held all of {names} (it held "
              f"{sorted(by_kernel)}, {busy} us busy)")
        dev = sum(by_kernel.values())
        with_dn = device_busy_ms(kern, 10)
        lib_dev = device_busy_ms(fnmb_library(graphs), 10)
        check(len(with_dn) == len(lib_dev) == FNMB_BUSY_TRACES,
              f"fused_norm_matmul_bwd S={S} d={d} F={F} {dt}: a trace held "
              f"no device operation (hand path {with_dn}, library "
              f"{lib_dev})")
        row = dict(S=S, d=d, F=F, dtype=dt, plan=plan,
                   ms=time_ms(kern, iters), device_ms=dev,
                   device_ms_by_kernel=by_kernel,
                   device_ms_with_dn=float(np.median(with_dn)),
                   device_ms_with_dn_traces=with_dn,
                   plain_ms=time_ms(cycling(ref.fused_norm_matmul_bwd_ref,
                                            sets), iters),
                   library_ms=time_ms(fnmb_library(graphs), iters),
                   library_device_ms=float(np.median(lib_dev)),
                   library_device_ms_traces=lib_dev,
                   bound_ms=bound, bound_by=by)
        row["share_of_bound"] = bound / dev
        row["with_dn_over_library_device"] = \
            row["device_ms_with_dn"] / row["library_device_ms"]
        timed[(S, d, F, dt)] = row
        log(f"fused_norm_matmul_bwd S={S} d={d} F={F} {dt}, plan {plan}: "
            f"{row['ms']:.6f} ms (device {dev}, by kernel {by_kernel}; with "
            f"dN's product {row['device_ms_with_dn']:.6f}, traces "
            f"{with_dn}), plain {row['plain_ms']:.6f} ms, rms_norm + matmul "
            f"backward {row['library_ms']:.6f} ms (device "
            f"{row['library_device_ms']:.6f}, traces {lib_dev}), bound "
            f"{bound:.6f} ms ({by}), bound/device {row['share_of_bound']}, "
            f"with dN / library device "
            f"{row['with_dn_over_library_device']}")
        del sets, graphs
    # the record's numbers: one layer's five training entries, bf16
    layer = [(TRAIN_ROWS, D_MODEL, f, "bfloat16") for f in LAYER_ENTRY_FS]
    total = {k: sum(timed[sh][k] for sh in layer)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    lib_dev = sum(timed[sh]["library_device_ms"] for sh in layer)
    with_dn = sum(timed[sh]["device_ms_with_dn"] for sh in layer)
    return dict(
        name="fused_norm_matmul_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_norm_matmul_bwd.cu",
        replaces="src/repro/kernels/fused_norm_matmul.py:33",
        replaces_note="the backward of that kernel, which has no Pallas "
                      "counterpart (the reference differentiates rms_norm "
                      "then einsum)",
        max_abs_err=err,
        work=f"one layer's five training entries (wq, wk, wv, w_gate, "
             f"w_up) at S={TRAIN_ROWS}, d={D_MODEL}, bf16: "
             f"F={list(LAYER_ENTRY_FS)}",
        device_ms=sum(timed[sh]["device_ms"] for sh in layer),
        device_ms_with_dn=with_dn, library_device_ms=lib_dev,
        bound_by="operations" if all(timed[sh]["bound_by"] == "operations"
                                     for sh in layer) else "bytes",
        library_call="torch.autograd.grad of F.rms_norm + torch.matmul",
        cuda_kernels=list(ops.FNM_BWD_KERNELS),
        **total, check_shapes=shapes, timed_shapes=list(timed.values()))


def _twin_config(arch: str):
    from repro_torch.configs import get_config
    if arch == "llama3.2-1b":
        return dataclasses.replace(get_config(arch),
                                   num_layers=TWIN_TRAIN_LAYERS,
                                   dtype="float32")
    return dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32")


def train_twin(arch: str, seed: int) -> dict:
    """One float32 ``make_train_step`` step on the card and on the CPU from
    the same weights and batch: the loss, gnorm and every updated leaf
    (parameter, first and second moment) held to the stated tolerances."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.models.common import sorted_leaves, tree_map
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.optimizer import lr_schedule
    cfg = _twin_config(arch)
    tcfg = TrainConfig(learning_rate=TWIN_TRAIN_LR, warmup_steps=1,
                       total_steps=10)
    p0 = init_params(cfg, seed, device="cuda", dtype=torch.float32)
    batch = synthetic_source(cfg, seed).global_batch_at(0)
    runs = {}
    for device in ("cuda", "cpu"):
        model = LM(cfg, device=device)
        state = init_state(tree_map(lambda t: t.to(device), p0))
        step = make_train_step(model, tcfg)
        ops.reset_launch_counts()
        t = time.perf_counter()
        new, m = step(state, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = (new, m, time.perf_counter() - t,
                        dict(ops.LAUNCHES))
        del state
    (gn, gm, g_s, g_l), (cn, cm, c_s, _) = runs["cuda"], runs["cpu"]
    lr1 = float(lr_schedule(tcfg, 1))
    loss_err = abs(float(gm["loss"]) - float(cm["loss"])) / abs(
        float(cm["loss"]))
    gnorm_err = abs(float(gm["gnorm"]) - float(cm["gnorm"])) / float(
        cm["gnorm"])
    p_err = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in zip(
        sorted_leaves(gn.params), sorted_leaves(cn.params)))
    m_err, v_err = (max(_rel_err(a.cpu(), b) for (_, a), (_, b) in zip(
        sorted_leaves(getattr(gn, k)), sorted_leaves(getattr(cn, k))))
        for k in ("m", "v"))
    check(np.isfinite(float(gm["loss"])) and loss_err <= TWIN_TRAIN_TOL
          and gnorm_err <= TWIN_TRAIN_TOL,
          f"{arch} train twin: loss or gnorm differ between card and CPU "
          f"({loss_err}, {gnorm_err} relative)")
    check(m_err <= TWIN_TRAIN_TOL and v_err <= TWIN_TRAIN_TOL,
          f"{arch} train twin: a first or second moment differs by "
          f"{max(m_err, v_err)} of its largest value")
    check(p_err <= 2 * lr1 + 1e-6,
          f"{arch} train twin: a parameter differs by {p_err} > 2 lr")
    if cfg.family != "ssm":  # rwkv has no norm -> projection entry
        check(g_l["fused_norm_matmul"] > 0 and g_l["fused_norm_matmul_bwd"]
              > 0, f"{arch} train twin: a fused kernel never launched on "
                   f"the card")
    res = dict(arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
               loss_card=float(gm["loss"]), loss_cpu=float(cm["loss"]),
               loss_rel_err=loss_err, gnorm_card=float(gm["gnorm"]),
               gnorm_cpu=float(cm["gnorm"]), gnorm_rel_err=gnorm_err,
               m_rel_err=m_err, v_rel_err=v_err, param_max_abs_err=p_err,
               lr=lr1,
               card_s=g_s, cpu_s=c_s,
               launches_card={k: v for k, v in g_l.items() if v})
    log(f"train twin {arch} ({cfg.num_layers} layers, d {cfg.d_model}): "
        f"loss {res['loss_card']} / {res['loss_cpu']} (rel {loss_err}), "
        f"gnorm rel {gnorm_err}, first moments {m_err} and second moments "
        f"{v_err} of their largest, "
        f"parameters within {p_err} (2 lr = {2 * lr1}); card {g_s:.3f} s, "
        f"CPU {c_s:.3f} s; launches {res['launches_card']}")
    return res


def synthetic_source(cfg, seed: int, seq: int = TWIN_TRAIN_SEQ,
                     batch: int = TWIN_TRAIN_B):
    """The training data of a twin: ``SyntheticLM`` batches of ``cfg``'s
    vocabulary, with seeded patch embeddings for a vlm and frame
    embeddings for an encdec config, as ``launch/train.py`` makes them."""
    from repro_torch.train import SyntheticLM
    return SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                       frontend=("vision" if cfg.vision_tokens else
                                 "audio" if cfg.is_encdec else None),
                       d_model=cfg.d_model,
                       aux_len=cfg.vision_tokens or cfg.encoder_seq)


def train_restart(seed: int, arch: str = "llama3.2-1b") -> dict:
    """A checkpoint restart on the card in bf16, of ``arch``'s twin config
    (phase 14 (b): llama3.2-1b at full width with TWIN_TRAIN_LAYERS layers;
    phase 15 (c): the reduced deepseek-v3-671b, whose binned MoE adds
    nothing with atomics): RESTART_STEPS[0] steps, a save,
    RESTART_STEPS[1] more; then a restore and a replay of those, bit for
    bit equal to the continued state."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.models.common import sorted_leaves
    from repro_torch.models.lm import LM
    from repro_torch.train import init_state, make_train_step, restore, save
    cfg = dataclasses.replace(_twin_config(arch), dtype="bfloat16")
    model = LM(cfg)
    params = model.init(seed)
    step = make_train_step(model, TrainConfig(total_steps=20, warmup_steps=2))
    src = synthetic_source(cfg, seed)
    state = init_state(params)
    n0, n1 = RESTART_STEPS
    for i in range(n0):
        state, _ = step(state, src.global_batch_at(i))
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t = time.perf_counter()
        path = save(d, int(state.step), state.tree())
        save_s = time.perf_counter() - t
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        a = state
        for i in range(n0, n0 + n1):
            a, ma = step(a, src.global_batch_at(i))
        t = time.perf_counter()
        tr = restore(d, state.tree())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    b = dataclasses.replace(init_state(params), params=tr["params"],
                            m=tr["m"], v=tr["v"], step=tr["step"])
    for i in range(n0, n0 + n1):
        b, mb = step(b, src.global_batch_at(i))
    same = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        sorted_leaves(a.tree()), sorted_leaves(b.tree())))
    check(same and torch.equal(ma["loss"], mb["loss"]),
          f"{arch} checkpoint restart on the card: the replayed state "
          f"differs from the continued one")
    res = dict(arch=arch, steps=RESTART_STEPS, checkpoint_bytes=nbytes,
               save_s=save_s, restore_s=restore_s, bit_for_bit=same,
               loss=float(ma["loss"]))
    log(f"{arch} checkpoint restart on the card: {n0} steps, save "
        f"({nbytes} B, {save_s:.3f} s), {n1} more; restore "
        f"({restore_s:.3f} s) and replay bit for bit equal (loss "
        f"{res['loss']})")
    return res


def _state_bytes(tree) -> int:
    from repro_torch.models.common import sorted_leaves
    return sum(t.numel() * t.element_size() for _, t in sorted_leaves(tree))


def _states_equal(a, b) -> bool:
    import torch
    from repro_torch.models.common import sorted_leaves
    return all(x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y)
               in zip(sorted_leaves(a.tree()), sorted_leaves(b.tree())))


def step_peaks(model, tcfg, batch, seed: int) -> tuple:
    """Phase 14 (c)'s first step twice, from fresh states of ``seed``: the
    functional step, then the in-place one, each one's peak
    ``max_memory_allocated`` above the memory allocated just before it;
    the in-place step hands back the state it was given, every leaf in its
    own storage, equal bit for bit to the functional step's.  Returns (the
    in-place state, the record)."""
    import torch
    from repro_torch.models.common import sorted_leaves
    from repro_torch.train import init_state, make_train_step
    out = {}
    state = init_state(model.init(seed))
    for inplace in (False, True):
        step = make_train_step(model, tcfg, inplace=inplace)
        ptrs = [t.data_ptr() for _, t in sorted_leaves(state.tree())]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        new, m = step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out["inplace" if inplace else "functional"] = dict(
            peak=peak, base=base, above_base=peak - base,
            loss=float(m["loss"]), same_object=new is state,
            storage_kept=ptrs == [t.data_ptr() for _, t in
                                  sorted_leaves(new.tree())])
        if inplace:
            equal = _states_equal(functional, new)
            del functional
        else:
            functional = new
            del state, new, m
            state = init_state(model.init(seed))
    f, i = out["functional"], out["inplace"]
    mv = _state_bytes(new.m) + _state_bytes(new.v)
    rec = dict(functional=f, inplace=i, state_bytes=_state_bytes(new.tree()),
               m_v_bytes=mv, fall=f["above_base"] - i["above_base"],
               bit_for_bit=equal)
    check(i["same_object"] and i["storage_kept"] and not f["same_object"],
          f"the in-place step did not hand back the state it was given, "
          f"in its own storage: {rec}")
    check(equal and f["loss"] == i["loss"], f"the in-place step's state or "
          f"loss differs from the functional step's: {rec}")
    check(rec["fall"] >= mv, f"the in-place step's peak above its start is "
          f"not below the functional step's by the m and v bytes: {rec}")
    log(f"{model.cfg.name} one step from fresh states of the seed: "
        f"functional peak {f['peak']} B ({f['above_base']} B above its "
        f"start), in place {i['peak']} B ({i['above_base']} B above its "
        f"start, which holds the functional state): {rec['fall']} B less, "
        f"against m and v's {mv} B (state {rec['state_bytes']} B); states "
        f"equal bit for bit, loss {i['loss']}")
    return new, rec


def profiled_steps(step, state, batches) -> tuple:
    """``step`` over ``batches`` under ``torch.profiler`` -> (the state,
    the device busy share, device ops a step, each CUDA kernel's device ms
    a step, the largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy, n_ops = device_busy_us(prof)
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        t = getattr(ev, "cuda_time_total", 0) if t is None else t
        if t:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t / len(batches) \
                / 1e3
    return (state, busy / wall_us if n_ops else None, n_ops / len(batches),
            dict(sorted(by_name.items(), key=lambda kv: -kv[1])), busy)


def train_model(seed: int) -> tuple:
    """Phase 14 (c), the main path: llama3.2-1b at its published widths,
    random bf16 weights from the seed; :func:`step_peaks`, then
    TRAIN_STEPS in-place steps of ``make_train_step`` on ``SyntheticLM``
    batches from the seed (launch counters zeroed just before the steps
    and read just after), then TRAIN_PROFILED_STEPS profiled.  Returns the
    numbers and the launch counts."""
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticLM, make_train_step
    cfg = get_config("llama3.2-1b")
    model = LM(cfg)
    tcfg = TrainConfig(total_steps=40, warmup_steps=2,
                       learning_rate=TRAIN_LR)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_B, seed=seed)
    state, peaks = step_peaks(model, tcfg, src.global_batch_at(0), seed)
    n_params = count_params(state.params)
    step = make_train_step(model, tcfg, inplace=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, times = [], [], []
    ops.reset_launch_counts()
    for i in range(1, TRAIN_STEPS + 1):
        t = time.perf_counter()
        state, m = step(state, src.global_batch_at(i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"training: a loss or gnorm is not finite ({losses}, {gnorms})")
    check(losses[-1] < losses[0],
          f"training: the loss did not fall below its first value {losses}")
    n = TRAIN_STEPS + 1
    state, share, ops_step, by_name, busy = profiled_steps(
        step, state, [src.global_batch_at(n + i)
                      for i in range(TRAIN_PROFILED_STEPS)])
    top = list(by_name.items())[:8]
    fused = {k: sum(t for nm, t in by_name.items() if any(
        f in nm for f in names)) / (busy / TRAIN_PROFILED_STEPS / 1e3)
        if busy else None
        for k, names in (("fused_norm_matmul", ops.FNM_KERNELS),
                         ("fused_norm_matmul_bwd", ops.FNM_BWD_KERNELS))}
    fwd, bwd = (launches[k] / TRAIN_STEPS
                for k in ("fused_norm_matmul", "fused_norm_matmul_bwd"))
    ms = np.asarray(times) * 1e3
    res = dict(
        model=cfg.name, params=n_params, batch=TRAIN_B, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, losses=losses, gnorms=gnorms, inplace=True,
        step_peaks=peaks,
        step_p50_ms=float(np.percentile(ms, 50)),
        step_p99_ms=float(np.percentile(ms, 99)),
        tokens_per_s=TRAIN_STEPS * TRAIN_B * TRAIN_SEQ / float(np.sum(times)),
        max_memory_allocated=peak,
        device_busy_share=share,
        device_ops_per_step=ops_step,
        share_of_device_time=fused,
        top_kernels_ms_per_step=[(nm[:80], t) for nm, t in top],
        fused_norm_matmul_per_step=fwd, fused_norm_matmul_bwd_per_step=bwd,
        expected_per_step=dict(
            fused_norm_matmul=2 * ENTRIES_PER_LAYER * cfg.num_layers,
            fused_norm_matmul_bwd=ENTRIES_PER_LAYER * cfg.num_layers))
    log(f"trained {cfg.name} ({n_params} parameters, bf16) in place "
        f"{TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_SEQ} SyntheticLM "
        f"tokens: loss {losses[0]:.4f} -> {losses[-1]:.4f} ({losses}), "
        f"gnorm {gnorms[-1]:.4f}; step p50 "
        f"{res['step_p50_ms']:.3f} ms, p99 {res['step_p99_ms']:.3f} ms, "
        f"{res['tokens_per_s']:.1f} tokens/s; max_memory_allocated {peak} "
        f"B; device busy share {res['device_busy_share']} at "
        f"{res['device_ops_per_step']:.1f} device ops a step; launches a "
        f"step: fused_norm_matmul {fwd}, fused_norm_matmul_bwd {bwd} "
        f"(expected {res['expected_per_step']}); their shares of device "
        f"time {fused}; the largest kernels, ms a step: "
        f"{res['top_kernels_ms_per_step']}")
    return res, launches


def time_fnmb_shape(gen, S: int, d: int, F: int, dt: str) -> dict:
    """One shape of ``fused_norm_matmul_bwd`` timed by events and by the
    profiler's device time (its plan's kernels), beside its bound and its
    plain version, and like for like with the library's backward: the
    call with dN's product against ``torch.autograd.grad`` of
    ``F.rms_norm`` + ``torch.matmul``, each by the median device time of
    FNMB_BUSY_TRACES traces."""
    import torch
    import torch.nn.functional as F_
    from repro_torch.kernels import ops, ref
    dtype = getattr(torch, dt)
    sets = [(*fnm_inputs(gen, S, d, F, dtype)[0],
             torch.randn((S, F), generator=gen, device="cuda").to(dtype))
            for _ in range(2)]
    graphs = []
    for x, g, w, dy in sets:
        ins = tuple(t.detach().clone().requires_grad_() for t in (x, g, w))
        y = torch.matmul(F_.rms_norm(ins[0], (d,), ins[1], 1e-6), ins[2])
        graphs.append((y, ins, dy))
    kern = cycling(ops.fused_norm_matmul_bwd, sets)
    plan = fnmb_plan_of(S, d, F, dt)
    names = fnmb_kernels_of(plan)
    by_kernel = device_times(kern, 10, *names)
    check(len(by_kernel) == len(names), f"fused_norm_matmul_bwd S={S} d={d} "
          f"F={F} {dt}: no trace held all of {names} ({sorted(by_kernel)})")
    bound, by = fnmb_bound(S, d, F, dtype)
    row = dict(S=S, d=d, F=F, dtype=dt, plan=plan, ms=time_ms(kern, 20),
               device_ms=sum(by_kernel.values()),
               device_ms_by_kernel=by_kernel,
               plain_ms=time_ms(cycling(ref.fused_norm_matmul_bwd_ref, sets),
                                20),
               bound_ms=bound, bound_by=by)
    row["share_of_bound"] = bound / row["device_ms"]
    with_dn = device_busy_ms(kern, 10)
    lib_dev = device_busy_ms(fnmb_library(graphs), 10)
    check(len(with_dn) == len(lib_dev) == FNMB_BUSY_TRACES,
          f"fused_norm_matmul_bwd S={S} d={d} F={F} {dt}: a trace held no "
          f"device operation (hand path {with_dn}, library {lib_dev})")
    row.update(device_ms_with_dn=float(np.median(with_dn)),
               device_ms_with_dn_traces=with_dn,
               library_ms=time_ms(fnmb_library(graphs), 20),
               library_device_ms=float(np.median(lib_dev)),
               library_device_ms_traces=lib_dev)
    row["with_dn_over_library_device"] = \
        row["device_ms_with_dn"] / row["library_device_ms"]
    log(f"fused_norm_matmul_bwd S={S} d={d} F={F} {dt}, plan {plan}: "
        f"{row['ms']:.6f} ms (device {row['device_ms']:.6f}, by kernel "
        f"{by_kernel}; with dN's product {row['device_ms_with_dn']:.6f}), "
        f"plain {row['plain_ms']:.6f} ms, rms_norm + matmul backward "
        f"device {row['library_device_ms']:.6f} ms (events "
        f"{row['library_ms']:.6f}), bound {bound:.6f} ms ({by}), "
        f"bound/device {row['share_of_bound']}, with dN / library device "
        f"{row['with_dn_over_library_device']}")
    del graphs
    return row


def recording_shapes(shapes: dict):
    """A context in which each ``fused_norm_matmul`` and
    ``fused_norm_matmul_bwd`` call adds its (S, d, F, dtype) to
    ``shapes[name]`` (phase 14 (d)'s steps; ``tools/tp_rank.py``'s
    training meshes)."""
    import contextlib

    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        fnm, fnmb = ops.fused_norm_matmul, ops.fused_norm_matmul_bwd

        def at(x, w) -> tuple:
            return (x.numel() // x.shape[-1], int(x.shape[-1]),
                    int(w.shape[-1]), str(x.dtype).split(".")[-1])

        def rec_fnm(x, gamma, w):
            shapes.setdefault("fused_norm_matmul", set()).add(at(x, w))
            return fnm(x, gamma, w)

        def rec_fnmb(x, gamma, w, dy):
            shapes.setdefault("fused_norm_matmul_bwd", set()).add(at(x, w))
            return fnmb(x, gamma, w, dy)
        ops.fused_norm_matmul, ops.fused_norm_matmul_bwd = rec_fnm, rec_fnmb
        try:
            yield shapes
        finally:
            ops.fused_norm_matmul, ops.fused_norm_matmul_bwd = fnm, fnmb
    return ctx()


def train_qwen3(gen, seed: int) -> tuple:
    """Phase 14 (d): rows 5 and 6 against their plain versions at
    qwen3-4b's training entries (QWEN_TRAIN_SHAPES), each timed beside its
    bound; then qwen3-4b at its published widths and depth, random bf16
    weights from the seed, QWEN_STEPS in-place steps of ``SyntheticLM``
    batches with ``remat="block"`` (launch counters zeroed just before
    them and read just after; every row-5 and row-6 call's shape recorded
    and held to the checked shapes), then QWEN_PROFILED_STEPS profiled.
    Returns the numbers and the launch counts."""
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticLM, init_state, make_train_step
    t0 = time.perf_counter()
    res = dict(fnm_check_shapes=check_fnm_shapes(gen, QWEN_TRAIN_SHAPES),
               fnmb_check_shapes=check_fnmb_shapes(gen, QWEN_TRAIN_SHAPES))
    res["fnm_timed"] = [time_fnm_shape(gen, *sh, library_device=True)
                        for sh in QWEN_TRAIN_SHAPES]
    res["fnmb_timed"] = [time_fnmb_shape(gen, *sh)
                         for sh in QWEN_TRAIN_SHAPES]
    res["kernels_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(QWEN_ARCH)
    check(cfg.d_model == QWEN_D and cfg.num_layers == 36,
          f"{QWEN_ARCH}: not the published widths and depth")
    free0, card = torch.cuda.mem_get_info()
    model = LM(cfg)
    state = init_state(model.init(seed))
    n_params = count_params(state.params)
    state_bytes = _state_bytes(state.tree())
    step = make_train_step(model, TrainConfig(
        total_steps=40, warmup_steps=2, learning_rate=TRAIN_LR,
        remat="block"), inplace=True)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_B, seed=seed)
    held = state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, shapes = [], [], {}
    ops.reset_launch_counts()
    with recording_shapes(shapes):
        for i in range(QWEN_STEPS):
            t = time.perf_counter()
            state, m = step(state, src.global_batch_at(i))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict(fused_norm_matmul=2 * ENTRIES_PER_LAYER * cfg.num_layers,
                fused_norm_matmul_bwd=ENTRIES_PER_LAYER * cfg.num_layers)
    checked = {tuple(sh) for sh in QWEN_TRAIN_SHAPES}
    check(state is held and all(np.isfinite(losses)),
          f"{QWEN_ARCH}: a loss is not finite, or the step handed back "
          f"another state ({losses})")
    check(peak < card, f"{QWEN_ARCH}: peak {peak} B past the card's {card}")
    check(all(launches[k] == v * QWEN_STEPS for k, v in want.items()),
          f"{QWEN_ARCH}: launches {launches} in {QWEN_STEPS} steps, not "
          f"{want} a step")
    check(all(shapes.get(k) == checked for k in want),
          f"{QWEN_ARCH}: the steps called rows 5 and 6 at {shapes}, not at "
          f"the checked shapes {sorted(checked)}")
    state, share, ops_step, by_name, _ = profiled_steps(
        step, state, [src.global_batch_at(QWEN_STEPS + i)
                      for i in range(QWEN_PROFILED_STEPS)])
    ms = np.asarray(times[1:]) * 1e3
    res.update(
        model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, state_bytes=state_bytes, batch=TRAIN_B,
        seq=TRAIN_SEQ, steps=QWEN_STEPS, losses=losses,
        first_step_ms=times[0] * 1e3, step_p50_ms=float(np.median(ms)),
        tokens_per_s=(QWEN_STEPS - 1) * TRAIN_B * TRAIN_SEQ
        / float(np.sum(times[1:])),
        max_memory_allocated=peak, card_memory=card,
        free_before=free0, device_busy_share=share,
        device_ops_per_step=ops_step,
        top_kernels_ms_per_step=[(nm[:80], t) for nm, t in
                                 list(by_name.items())[:8]],
        launches_per_step={k: launches[k] / QWEN_STEPS for k in want},
        expected_per_step=want,
        shapes={k: sorted(v) for k, v in shapes.items()})
    log(f"trained {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{n_params} parameters, bf16) in place {QWEN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_SEQ} SyntheticLM tokens: state {state_bytes} B, "
        f"max_memory_allocated {peak} B of the card's {card} B ({free0} B "
        f"free before); losses {losses}; first step "
        f"{res['first_step_ms']:.3f} ms, then p50 {res['step_p50_ms']:.3f} "
        f"ms, {res['tokens_per_s']:.1f} tokens/s; device busy share {share} "
        f"at {ops_step:.1f} device ops a step; launches a step "
        f"{res['launches_per_step']} (the program's {want}); the largest "
        f"kernels, ms a step: {res['top_kernels_ms_per_step']}")
    del model, state, step, held
    return res, launches


def serve_training_phase(gen) -> tuple:
    """Phase 14: (a) :func:`check_fused_norm_matmul_bwd`, (b) the twins and
    the restart, (c) :func:`train_model`, (d) :func:`train_qwen3`.
    Returns the kernel's record, the numbers and the launch counts of (c)
    (those of (d) are in ``res["qwen3"]["launches"]``)."""
    import torch
    res, t = {}, time.perf_counter()
    record = check_fused_norm_matmul_bwd(gen)
    res["kernel_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["fnm_train_check_shapes"] = check_fnm_shapes(gen, FNM_TRAIN_SHAPES)
    res["fnm_train_timed"] = [time_fnm_shape(gen, *sh, library_device=True)
                              for sh in FNM_TRAIN_SHAPES]
    res["fnm_train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["twins"] = [train_twin(arch, SEED) for arch in TRAIN_TWIN_ARCHS]
    gc.collect()
    torch.cuda.empty_cache()
    res["restart"] = train_restart(SEED)
    res["agreement_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res["train"], launches = train_model(SEED)
    res["train_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res["qwen3"], qlaunch = train_qwen3(gen, SEED)
    res["qwen3"]["launches"] = qlaunch
    res["qwen3_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 14 (a) {:.1f} s (row 5 at (c)'s entries {:.1f} s), (b) "
        "{:.1f} s, (c) {:.1f} s, (d) {:.1f} s (rows 5 and 6 at its shapes "
        "{:.1f} s)".format(
            res["kernel_s"], res["fnm_train_s"], res["agreement_s"],
            res["train_s"], res["qwen3_s"], res["qwen3"]["kernels_s"]))
    return record, res, launches


# ------------------------------------------------------------ phase 15
def fused_per_decode_step(cfg) -> int:
    """``fused_norm_matmul`` launches one decode_step of ``cfg`` makes, as
    its program implies: FNM_ENTRIES of each layer's mixer and ffn (a MoE
    ffn's only with a shared expert)."""
    from repro_torch.models.lm import make_program
    per = dict(FNM_ENTRIES)
    if cfg.moe is not None and cfg.moe.num_shared:
        per["moe"] = FNM_ENTRIES["mlp"]
    return sum(repeat * sum(per[m] + per[f] for m, f in group)
               for repeat, group in make_program(cfg))


def fused_per_prefill(cfg) -> int:
    """``fused_norm_matmul`` launches of one ``LM.prefill``: the decoder's,
    as a decode step's, and an encdec config's encoder, FNM_ENTRIES of a
    gqa mixer and an MLP a layer."""
    enc = cfg.encoder_layers * (FNM_ENTRIES["gqa"] + FNM_ENTRIES["mlp"]) \
        if cfg.is_encdec else 0
    return fused_per_decode_step(cfg) + enc


def family_config(arch: str, layers: int | None):
    """``arch`` at its published widths, its depth cut to ``layers``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def timed_launches(fn) -> tuple:
    """``fn()`` once to warm up, then once synced and timed with the launch
    counters zeroed just before and read just after -> (its result, ms,
    fused_norm_matmul launches)."""
    import torch
    from repro_torch.kernels import ops
    fn()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3, \
        ops.LAUNCHES["fused_norm_matmul"]


def vision_prefill(model, params, seed: int) -> dict:
    """One ``LM.prefill`` of a FAMILY_PROMPT-token prompt behind the
    config's ``vision_tokens`` seeded patch embeddings (576 for llava), on
    the card: logits finite, of the vocabulary's width, each fused entry
    launched once a layer."""
    import torch
    cfg = model.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT),
                                     generator=gen, device="cuda"),
             "patches": torch.randn((1, cfg.vision_tokens, cfg.d_model),
                                    generator=gen, device="cuda")}
    logits, ms, launches = timed_launches(
        lambda: model.prefill(params, batch))
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill with patches: logits not finite or of shape "
          f"{tuple(logits.shape)}")
    check(launches == fused_per_decode_step(cfg),
          f"{cfg.name} prefill with patches: {launches} fused launches")
    rows = cfg.vision_tokens + FAMILY_PROMPT
    log(f"{cfg.name} prefill: {FAMILY_PROMPT} tokens behind "
        f"{cfg.vision_tokens} patch embeddings ({rows} rows) in {ms:.3f} ms, "
        f"{launches} fused launches")
    return dict(prefill_rows=rows, prefill_ms=ms, prefill_launches=launches)


def twin_config(arch: str):
    """A family's float32 twin config: llava at full width cut to
    FAMILY_TWIN_LAYERS, whisper at full width cut to WHISPER_TWIN_LAYERS
    encoder and decoder layers (its 1500 frames kept), the rest
    reduced."""
    from repro_torch.configs import get_config
    if arch == "llava-next-mistral-7b":
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=FAMILY_TWIN_LAYERS)
    elif arch == "whisper-large-v3":
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=WHISPER_TWIN_LAYERS,
                                  encoder_layers=WHISPER_TWIN_LAYERS)
    else:
        cfg = get_config(arch, reduced=True)
    return dataclasses.replace(cfg, dtype="float32")


def family_twin(arch: str, seed: int) -> dict:
    """The float32 card-vs-CPU twin of a family (:func:`twin_config`), the
    same float32 weights on the card and on the CPU (plain versions);
    FAMILY_TWIN_STEPS teacher-forced decode steps of FAMILY_LANES lanes (an
    encdec config's on its encoder's output of seeded frames, computed on
    each device) and a prefill of two FAMILY_PROMPT-token prompts (behind
    the config's patch embeddings for a vlm, over seeded frames for an
    encdec config): logits within TWIN_TOL absolute and the same argmax."""
    import torch
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM, init_params
    cfg = twin_config(arch)
    p0 = init_params(cfg, seed, device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    toks = [rng.integers(0, cfg.vocab_size, (FAMILY_LANES, 1)).astype(
        np.int32) for _ in range(FAMILY_TWIN_STEPS)]
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, FAMILY_PROMPT)).astype(np.int32))}
    for name, n in (("patches", cfg.vision_tokens),
                    ("frames", cfg.encoder_seq if cfg.is_encdec else 0)):
        if n:
            batch[name] = torch.from_numpy(rng.standard_normal(
                (2, n, cfg.d_model)).astype(np.float32))
    frames = torch.from_numpy(rng.standard_normal(
        (FAMILY_LANES, cfg.encoder_seq, cfg.d_model)).astype(np.float32)) \
        if cfg.is_encdec else None
    runs = {}
    for device in ("cuda", "cpu"):
        model = LM(cfg, device=device)
        p = p0 if device == "cuda" else tree_map(lambda t: t.cpu(), p0)
        cache = model.init_cache(FAMILY_LANES, FAMILY_TWIN_STEPS + 1)
        t0 = time.perf_counter()
        enc = None if frames is None else model._encode(p, frames.to(device))
        out = []
        for tok in toks:
            logits, cache = model.decode_step(
                p, torch.from_numpy(tok).to(device), cache, enc_out=enc)
            out.append(logits.cpu())
        pre = model.prefill(p, {k: v.to(device) for k, v in batch.items()})
        runs[device] = (torch.stack(out), pre.cpu(),
                        time.perf_counter() - t0)
        del p, cache
    (gd, gp, g_s), (cd, cp, c_s) = runs["cuda"], runs["cpu"]
    err = max(float((gd - cd).abs().max()), float((gp - cp).abs().max()))
    same = bool(torch.equal(gd.argmax(-1), cd.argmax(-1))
                and torch.equal(gp.argmax(-1), cp.argmax(-1)))
    check(bool(torch.isfinite(gd).all() and torch.isfinite(gp).all())
          and err <= TWIN_TOL,
          f"{arch} float32 twin: card and CPU logits differ by {err} > "
          f"{TWIN_TOL}")
    check(same, f"{arch} float32 twin: the argmax differs between card and "
                f"CPU")
    behind = (f" behind {cfg.vision_tokens} patches" if cfg.vision_tokens
              else f" over {cfg.encoder_seq} frames ({cfg.encoder_layers} "
                   f"encoder layers; decode on its output)"
              if cfg.is_encdec else "")
    log(f"{arch} float32 twin ({cfg.num_layers} layers, d {cfg.d_model}): "
        f"{FAMILY_TWIN_STEPS} teacher-forced steps of {FAMILY_LANES} lanes "
        f"and a prefill of 2 x {FAMILY_PROMPT} tokens{behind}: card vs CPU max abs logit err {err} (tolerance {TWIN_TOL}, logits "
        f"up to {float(cd.abs().max()):.4f}), same argmax; card {g_s:.3f} s, "
        f"CPU {c_s:.3f} s")
    return dict(twin_layers=cfg.num_layers, twin_d_model=cfg.d_model,
                twin_max_abs_err=err, twin_same_argmax=same)


def serve_family(arch: str, layers: int | None, seed: int) -> tuple:
    """One family at its published widths on the card, random bf16 weights
    drawn from the seed (a bank in slices, ``normal_init``):
    ``Engine(lanes=FAMILY_LANES)`` serves FAMILY_REQUESTS requests, the
    launch counters zeroed just before the run and read just after; then
    FAMILY_PROFILED_STEPS profiled decode steps.  Returns the numbers and
    the run's launch counts."""
    import torch
    from repro_torch.models.common import count_params, tree_leaves
    from repro_torch.models.lm import LM, param_template
    from repro_torch.serve import Engine
    cfg = family_config(arch, layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = count_params(params)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    check(model.device.type == "cuda"
          and all(t.is_cuda and t.dtype == getattr(torch, lf.dtype)
                  for t, lf in zip(tree_leaves(params),
                                   tree_leaves(param_template(cfg)))),
          f"{arch}: the model is not on the card in bf16 (mamba's A_log, "
          f"D and dt_bias in float32)")
    log(f"{arch}: {cfg.num_layers} layers at d {cfg.d_model}, {n_params} "
        f"parameters ({n_bytes} B), drawn on the card in {init_s:.3f} s, "
        f"max_memory_allocated {init_peak} B")
    eng = Engine(model, params, lanes=FAMILY_LANES, max_seq=FAMILY_MAX_SEQ)
    reqs = engine_requests(seed, cfg.vocab_size, FAMILY_REQUESTS,
                           FAMILY_PROMPT_MIN, FAMILY_PROMPT_MAX, FAMILY_NEW)
    times, launches, run_s = run_timed_engine(eng, reqs)
    res = dict(model=arch, layers=cfg.num_layers, d_model=cfg.d_model,
               params=n_params, param_bytes=n_bytes, init_s=init_s,
               init_max_memory_allocated=init_peak, lanes=FAMILY_LANES,
               max_seq=FAMILY_MAX_SEQ, requests=FAMILY_REQUESTS,
               **engine_numbers(eng, reqs, times, launches, run_s, cfg,
                                fused_per_decode_step(cfg)))
    res.update(profile_decode(model, params, eng.cache, FAMILY_LANES,
                              FAMILY_PROFILED_STEPS))
    if cfg.vision_tokens:
        res.update(vision_prefill(model, params, seed))
    if cfg.family == "hybrid":
        res.update(hybrid_prefill(model, params, seed))
    if cfg.is_encdec:
        res.update(encdec_runs(model, params, seed))
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"{arch}: max_memory_allocated {res['max_memory_allocated']} B")
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()
    res.update(family_twin(arch, seed))
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches


def serve_families_phase(gen) -> tuple:
    """Phase 15: row 5 at the families' new shapes, then each family served
    (:func:`serve_family`), then the reduced deepseek's bf16 restart.
    Returns row 5's new shapes, the numbers and each family's launch
    counts."""
    res, t = {}, time.perf_counter()
    res["fnm_check_shapes"] = check_fnm_shapes(gen, FAMILY_FNM_SHAPES)
    res["fnm_timed"] = [time_fnm_shape(gen, 8, d, F, "bfloat16")
                        for d, F in FAMILY_FNM_PAIRS]
    res["fnm_s"] = time.perf_counter() - t
    launches = {}
    for arch, layers in FAMILIES:
        t = time.perf_counter()
        res[arch], launches[arch] = serve_family(arch, layers, SEED)
        res[arch]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    res["restart"] = train_restart(SEED, "deepseek-v3-671b")
    res["restart_s"] = time.perf_counter() - t
    log("phase 15: row 5's shapes {:.1f} s, {}, restart {:.1f} s".format(
        res["fnm_s"], ", ".join(f"{a} {res[a]['seconds']:.1f} s"
                                for a, _ in FAMILIES), res["restart_s"]))
    return res, launches


# ------------------------------------------------------------ phase 16
def hybrid_prefill(model, params, seed: int) -> dict:
    """One ``LM.prefill`` of HYBRID_PROMPT tokens on the card (the mamba
    layers' scan): logits finite, of the vocabulary's width, each fused
    entry launched once a layer."""
    import torch
    cfg = model.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, HYBRID_PROMPT),
                                     generator=gen, device="cuda")}
    logits, ms, launches = timed_launches(
        lambda: model.prefill(params, batch))
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill: logits not finite or of shape "
          f"{tuple(logits.shape)}")
    check(launches == fused_per_prefill(cfg),
          f"{cfg.name} prefill: {launches} fused launches, not "
          f"{fused_per_prefill(cfg)}")
    log(f"{cfg.name} prefill of {HYBRID_PROMPT} tokens (the mamba scan on "
        f"the card): {ms:.3f} ms, {launches} fused launches")
    return dict(prefill_tokens=HYBRID_PROMPT, prefill_ms=ms,
                prefill_launches=launches)


def encdec_runs(model, params, seed: int) -> dict:
    """whisper beyond the engine's zero stub, on the card: one
    ``LM.prefill`` of WHISPER_ROWS x FAMILY_PROMPT tokens over seeded frames
    of (WHISPER_ROWS, encoder_seq, d) (the encoder and the decoder's
    cross-attention to it), the encoder alone, then WHISPER_TF_STEPS
    teacher-forced decode steps on its output: logits finite, the fused
    launches of each as the program implies, the times."""
    import torch
    cfg = model.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (WHISPER_ROWS, FAMILY_PROMPT),
                         generator=gen, device="cuda")
    frames = torch.randn((WHISPER_ROWS, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device="cuda")
    batch = {"tokens": toks, "frames": frames}
    logits, pre_ms, pre_l = timed_launches(
        lambda: model.prefill(params, batch))
    enc, enc_ms, enc_l = timed_launches(
        lambda: model._encode(params, frames))
    n_enc = cfg.encoder_layers * (FNM_ENTRIES["gqa"] + FNM_ENTRIES["mlp"])
    check(logits.shape == (WHISPER_ROWS, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(enc).all()),
          f"{cfg.name} prefill over frames: logits or the encoder output "
          f"not finite")
    check(pre_l == fused_per_prefill(cfg) and enc_l == n_enc,
          f"{cfg.name}: {pre_l} fused launches in a prefill and {enc_l} in "
          f"the encoder, not {fused_per_prefill(cfg)} and {n_enc}")
    from repro_torch.kernels import ops
    cache = model.init_cache(WHISPER_ROWS, WHISPER_TF_STEPS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = []
    for t in range(WHISPER_TF_STEPS):
        t0 = time.perf_counter()
        out, cache = model.decode_step(params, toks[:, t:t + 1], cache,
                                       enc_out=enc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out).all()),
              f"{cfg.name}: a decode step on the encoder output is not "
              f"finite")
    tf_l = ops.LAUNCHES["fused_norm_matmul"]
    check(tf_l == WHISPER_TF_STEPS * fused_per_decode_step(cfg),
          f"{cfg.name}: {tf_l} fused launches in {WHISPER_TF_STEPS} decode "
          f"steps on the encoder output")
    ms = np.asarray(times) * 1e3
    res = dict(frames=list(frames.shape), prefill_ms=pre_ms,
               prefill_launches=pre_l, encoder_ms=enc_ms,
               encoder_launches=enc_l, tf_steps=WHISPER_TF_STEPS,
               tf_step_p50_ms=float(np.percentile(ms, 50)),
               tf_step_p99_ms=float(np.percentile(ms, 99)),
               tf_launches=tf_l)
    log(f"{cfg.name}: prefill of {WHISPER_ROWS} x {FAMILY_PROMPT} tokens "
        f"over frames {res['frames']} in {pre_ms:.3f} ms ({pre_l} fused "
        f"launches), the encoder alone {enc_ms:.3f} ms ({enc_l}); "
        f"{WHISPER_TF_STEPS} teacher-forced decode steps on its output: p50 "
        f"{res['tf_step_p50_ms']:.4f} ms, p99 {res['tf_step_p99_ms']:.4f} "
        f"ms ({tf_l} fused launches)")
    return res


def serve_hybrid_phase(gen) -> tuple:
    """Phase 16: row 5 at the hybrid and encdec configs' new shapes, then
    jamba and whisper served (:func:`serve_family`, with
    :func:`hybrid_prefill` and :func:`encdec_runs`).  Returns the numbers
    and each family's launch counts."""
    import torch
    res, t = {}, time.perf_counter()
    res["fnm_check_shapes"] = check_fnm_shapes(gen, HYBRID_FNM_SHAPES)
    res["fnm_timed"] = [time_fnm_shape(gen, 8, d, F, "bfloat16")
                        for d, F in HYBRID_FNM_PAIRS]
    res["fnm_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    res["free_bytes_before_models"], res["total_bytes"] = free, total
    log(f"phase 16: {free} B free of {total} B on the card before the "
        f"models")
    launches = {}
    for arch, layers in HYBRID_FAMILIES:
        t = time.perf_counter()
        res[arch], launches[arch] = serve_family(arch, layers, SEED)
        res[arch]["seconds"] = time.perf_counter() - t
    log("phase 16: row 5's shapes {:.1f} s, {}".format(
        res["fnm_s"], ", ".join(f"{a} {res[a]['seconds']:.1f} s"
                                for a, _ in HYBRID_FAMILIES)))
    return res, launches


# ------------------------------------------------------------ phase 17
def start_tp_world(mode: str, ranks: int = TP_RANKS,
                   gated: bool = False) -> tuple:
    """Start ``ranks`` processes of ``tools/tp_rank.py MODE`` in one world
    (a ``file://`` rendezvous in a temporary directory) -> the handle
    :func:`wait_tp_world` takes.  ``gated``: the ranks import, then wait
    for :func:`wait_tp_world` to release them before they touch the card
    (a world started early, its imports under an earlier phase)."""
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="tp_world_"))
    outs = [tmp / f"rank{r}.json" for r in range(ranks)]
    # two processes share the card's memory: segments that grow in place
    # keep the allocators' fragments from adding up
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    if gated:
        env["TP_WORLD_GATE"] = str(tmp / "go")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "tp_rank.py"), mode,
         str(tmp / "rdv"), str(r), str(outs[r])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(ranks)]
    return tmp, outs, procs


def wait_tp_world(handle, timeout: float) -> tuple:
    """Wait up to ``timeout`` s in all for a world of
    :func:`start_tp_world`, killing its processes after it -> (each rank's
    JSON or None, exit codes, each rank's last 3000 characters of
    output).  A rank's tensors saved beside its JSON (``.pt``) come back
    under the JSON's ``"tensors"``.  A gated world is released first."""
    import torch
    tmp, outs, procs = handle
    (tmp / "go").touch()
    logs, rcs = [""] * len(procs), [None] * len(procs)
    deadline = time.perf_counter() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                logs[r] = p.communicate(
                    timeout=max(1.0, deadline - time.perf_counter()))[0]
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs[r] = p.communicate()[0]
            rcs[r] = p.returncode
        res = [json.loads(o.read_text()) if o.exists() else None
               for o in outs]
        for r, o in zip(res, outs):
            if r is not None and o.with_suffix(".pt").exists():
                r["tensors"] = torch.load(o.with_suffix(".pt"))
    finally:
        stop_tp_world(handle)
    return res, rcs, [(lg or "")[-3000:] for lg in logs]


def stop_tp_world(handle) -> None:
    """Kill what is left of a world of :func:`start_tp_world` and remove
    its directory."""
    import shutil
    tmp, _, procs = handle
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def checked_tp_world(mode: str, timeout: float, phase: int,
                     size: int = TP_RANKS, world=None) -> list:
    """The ranks' JSONs of a world of ``size`` processes of
    ``tools/tp_rank.py MODE`` (``world``: one started already); a failed
    rank's traceback, output and what it finished are logged, and the
    phase fails."""
    world = world or start_tp_world(mode, size)
    ranks, rcs, logs = wait_tp_world(world, timeout)
    failed = [r for r, out in enumerate(ranks)
              if rcs[r] != 0 or out is None or "error" in out]
    for r in failed:
        out = ranks[r] or {}
        log(f"{phase} rank {r} (exit {rcs[r]}): {out.get('traceback', '')}\n"
            f"{logs[r]}\nwhat it finished: "
            f"{json.dumps({k: v for k, v in out.items() if k != 'traceback'})}")
    check(not failed, f"phase {phase}: ranks {failed} failed (above)")
    return ranks


def tp_probe(world) -> dict:
    """17 (a), the probe world ``world`` (:func:`start_tp_world`): which
    collectives gloo serves on card tensors of each dtype in a world of
    two ranks on the one card, and a 40 KB bf16 ``all_reduce``'s host µs.
    ``all_reduce`` and ``all_gather`` must serve every dtype (the phase's
    mesh needs them); ``send``/``recv`` is recorded as it comes (gloo's
    TCP pair writes from the device pointer: the sending rank aborts,
    which ends the probe's world)."""
    outs, rcs, logs = wait_tp_world(world, TP_PROBE_TIMEOUT)
    ops = {}
    for op in ("all_reduce", "all_gather", "send_recv"):
        for dt in TP_PROBE_DTYPES:
            key = f"{op}/{dt}"
            got = [(o or {}).get("ops", {}).get(key, "not reached")
                   for o in outs]
            ops[key] = "ok" if all(g == "ok" for g in got) else got
    res = dict(ops=ops, exit_codes=rcs,
               all_reduce_40KB_us=[(o or {}).get("all_reduce_40KB_us")
                                   for o in outs])
    log(f"17 (a) gloo on card tensors, two ranks on one card: "
        f"{json.dumps(res)}")
    need = [f"{op}/{dt}" for op in ("all_reduce", "all_gather")
            for dt in TP_PROBE_DTYPES]
    check(all(ops[k] == "ok" for k in need),
          f"gloo does not serve {[k for k in need if ops[k] != 'ok']} on card "
          f"tensors; the phase's mesh needs them: {logs}")
    return res


def serve_tp_phase(gen, world=None) -> tuple:
    """Phase 17: row 5 at the tp = 2 shard shapes, the gloo probe, then the
    world of two ranks (``tools/tp_rank.py main``, or ``world``, started
    gated: qwen2.5-14b served, its
    float32 twin, mixtral-8x22b cut to 4 layers served, its float32 twin,
    llama3.2-1b trained over three meshes).  Returns the numbers and the
    launch counts summed over both ranks."""
    import torch
    res, t = {}, time.perf_counter()
    # the probe's ranks start up while row 5 is checked, and are done
    # before it is timed
    probe = start_tp_world("probe")
    res["fnm_check_shapes"] = check_fnm_shapes(gen, TP_FNM_SHAPES
                                               + TP_PREFILL_SHAPES)
    res["fnm_train_check_shapes"] = check_fnm_shapes(gen, TP_TRAIN_SHAPES)
    res["fnmb_train_check_shapes"] = check_fnmb_shapes(gen, TP_TRAIN_SHAPES)
    log(f"kernel fused_norm_matmul_bwd: within tolerance of its plain "
        f"version, and two calls bit for bit alike, at the tp training "
        f"shapes {TP_TRAIN_SHAPES} (max rel err by gradient "
        f"{ {n: max(r['max_rel_err'][n] for r in res['fnmb_train_check_shapes']) for n in ('dx', 'dgamma', 'dw')} })")
    res["probe"] = tp_probe(probe)
    res["fnm_timed"] = [time_fnm_shape(gen, 4, d, F, "bfloat16")
                        for d, F in TP_FNM_PAIRS]
    res["fnm_probe_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = checked_tp_world("main", TP_MAIN_TIMEOUT, 17, world=world)
    res["world_s"] = time.perf_counter() - t
    for r, out in enumerate(ranks):
        check(out["backend"] == "gloo" and out["p2p"] == "all_gather",
              f"rank {r}: backend {out['backend']}, ppermute {out['p2p']}")
        log(f"17 rank {r}: mesh backend {out['backend']} (two ranks on "
            f"{out['device']}), ppermute by {out['p2p']}; "
            f"{out['seconds']:.1f} s")
        for arch in TP_SERVED:
            a = out[arch]
            log(f"17 rank {r} {arch} ({a['layers']} layers, tp {a['tp']}, "
                f"{a['lanes_local']} lanes a rank): "
                f"{a['params_local']} parameters a rank ({a['param_bytes_local']}"
                f" B) drawn in {a['init_s']:.3f} s; decode_step first call"
                f" {a['first_call_ms']:.4f} ms, then p50 "
                f"{a['decode_step_ms']['p50']:.4f} ms, p99 "
                f"{a['decode_step_ms']['p99']:.4f} ms over the other "
                f"{a['decode_step_calls'] - 1} calls; "
                f"{a['generated_tokens_per_s']:.2f} generated tokens/s after "
                f"the first call ({a['generated_tokens_per_s_with_first']:.2f}"
                f" with it); busy "
                f"{a['device_busy_share']}, {a['device_ops_per_step']:.1f} "
                f"device ops a step; collectives a call "
                f"{json.dumps(a['collectives_per_call'])}; peak "
                f"{a['max_memory_allocated']} B; tokens equal on the ranks "
                f"{a.get('tokens_equal_on_ranks')}; row 5 at "
                f"{a['row5_shapes']}, {a['fnm_per_call']} a call; twin "
                f"{json.dumps(a['twin'])}; {a['seconds']:.1f} s")
            if "prefill" in a:
                log(f"17 rank {r} {arch} prefill over frames: "
                    f"{json.dumps(a['prefill'])}")
        tr = out["train"]
        for m in ("tp_1x2", "zero_2x1", "pod_2x1x1", "pod_reduced"):
            log(f"17 rank {r} train {m}: step ms {tr[m]['step_ms']}, losses "
                f"{tr[m]['losses']}, {tr[m]['tokens_per_s']:.1f} tokens/s a "
                f"rank; launches {tr[m]['launches']} (the program's "
                f"{tr[m]['expected_launches']}); {json.dumps({k: v for k, v in tr[m].items() if k not in ('step_ms', 'losses', 'tokens_per_s', 'launches', 'expected_launches', 'fnm_shapes')})}")
        if "zero_twin_max_abs_err" in tr:
            log(f"17 rank {r} float32 twin of the (2, 1) step: max abs err "
                f"{tr['zero_twin_max_abs_err']}; in place equal to the "
                f"functional step bit for bit: "
                f"{tr['zero_twin_inplace_equal']}")
        tf = out["train_families"]
        log(f"17 rank {r} (f) float32 (1, 2) steps of the reduced families "
            f"({tf['seconds']:.1f} s): " + json.dumps(
                {k: v for k, v in tf.items() if k != "fnm_shapes"}))
    checked = {tuple(sh) for sh in TP_TRAIN_SHAPES}
    for r, out in enumerate(ranks):
        for name, ran in out["train"]["fnm_shapes"].items():
            check({tuple(sh) for sh in ran} == checked,
                  f"rank {r}: {name} ran at {sorted(map(tuple, ran))} in the "
                  f"training steps, checked at {sorted(checked)}")
    served = {(S, d, F) for S in (4, 8) for d, F in TP_FNM_PAIRS}
    for r, out in enumerate(ranks):
        for arch in TP_SERVED:
            a = out[arch]
            ran = {(a["lanes_local"], *map(int, sh)) for sh in a["row5_shapes"]}
            check(ran <= served, f"rank {r} {arch}: row 5 ran at "
                  f"{sorted(ran - served)}, which were not checked")
            if "prefill" in a:
                ran = {tuple(sh) for sh in a["prefill"]["row5_shapes"]}
                check(ran == {sh[:3] for sh in TP_PREFILL_SHAPES},
                      f"rank {r} {arch} prefill: row 5 ran at {sorted(ran)}, "
                      f"checked at {TP_PREFILL_SHAPES}")
    # (f): rows 5 and 6 against their plain versions at the shapes the
    # reduced families' float32 steps reached (recorded by both ranks)
    fam = sorted({tuple(sh) for out in ranks for name in (
        "fused_norm_matmul", "fused_norm_matmul_bwd")
        for sh in out["train_families"]["fnm_shapes"][name]})
    res["fnm_family_train_check_shapes"] = check_fnm_shapes(gen, fam)
    res["fnmb_family_train_check_shapes"] = check_fnmb_shapes(gen, fam)
    log(f"kernel fused_norm_matmul_bwd: within tolerance of its plain "
        f"version, and two calls bit for bit alike, at the {len(fam)} shapes "
        f"of the reduced families' tp steps {fam}")
    res["ranks"] = ranks
    launches = {k: sum(out["launches"][k] for out in ranks)
                for k in ranks[0]["launches"]}
    log("phase 17: row 5's shapes and the probe {:.1f} s, the world "
        "{:.1f} s".format(res["fnm_probe_s"], res["world_s"]))
    return res, launches


# ------------------------------------------------------------ phase 18
def serve_seq_phase(gen, world=None) -> tuple:
    """Phase 18: the world of two ranks (``tools/tp_rank.py seq``, or
    ``world``, started gated: jamba's
    batch-1 cache of 524,288 tokens over data, llama3.2-1b under
    ``cache_seq_shard`` at tp = 2, the float32 twins), then row 5 against
    its plain version at every (S, d, F) the ranks' runs recorded.
    Returns the numbers and the launch counts summed over both ranks."""
    res, t = {}, time.perf_counter()
    ranks = checked_tp_world("seq", SEQ_TIMEOUT, 18, world=world)
    res["world_s"] = time.perf_counter() - t
    shapes = set()
    for r, out in enumerate(ranks):
        log(f"18 rank {r}: mesh backend {out['backend']} (two ranks on "
            f"{out['device']}), {out['seconds']:.1f} s")
        for key in ("long", "seqshard"):
            a = out[key]
            log(f"18 rank {r} {key}: {a['model']} ({a['layers']} layers, mesh "
                f"{a['mesh']}, sequence over {a['seq_axes']}, max_seq "
                f"{a['max_seq']}, lengths {a['lengths']}): "
                f"{a['param_bytes_local']} B of parameters and "
                f"{a['cache_bytes_local']} B of cache a rank, drawn in "
                f"{a['init_s']:.3f} s and {a['fill_s']:.3f} s; decode_step "
                f"first call {a['first_call_ms']:.4f} ms, then p50 "
                f"{a['decode_step_ms']['p50']:.4f} ms, p99 "
                f"{a['decode_step_ms']['p99']:.4f} ms over the other "
                f"{a['decode_step_calls'] - 1} calls; "
                f"{a['generated_tokens_per_s']:.2f} generated tokens/s after "
                f"the first call "
                f"({a['generated_tokens_per_s_with_first']:.2f} with it) "
                f"({a['generated']} a lane); profiled step "
                f"{a['profiled_step_ms']:.4f} ms, busy "
                f"{a['device_busy_share']}, {a['device_ops_per_step']:.1f} "
                f"device ops a step; collectives a call "
                f"{json.dumps(a['collectives_per_call'])}; peak "
                f"{a['max_memory_allocated']} B; tokens equal on the ranks "
                f"{a['tokens_equal_on_ranks']}; row 5 "
                f"{a['launches']['fused_norm_matmul']} launches, "
                f"{a['fnm_per_call']} a call, at {a['row5_shapes']}; "
                f"{a['seconds']:.1f} s")
            shapes |= {tuple(sh) for sh in a["row5_shapes"]}
    for key, twin in ranks[0]["twins"].items():
        log(f"18 (c) float32 twin {key}: {json.dumps(twin)}")
        if key != "seconds":
            check(twin["max_abs_err"] <= 1e-4 and twin["same_argmax"],
                  f"phase 18 twin {key}: {json.dumps(twin)}")
    res["fnm_check_shapes"] = check_fnm_shapes(
        gen, [(S, d, F, "bfloat16") for S, d, F in sorted(shapes)])
    res["ranks"] = ranks
    launches = {k: sum(out["launches"][k] for out in ranks)
                for k in ranks[0]["launches"]}
    log("phase 18: the world {:.1f} s".format(res["world_s"]))
    return res, launches


def hd_twin_whole(split_logits) -> dict:
    """Phase 20's float32 twin here at ``(1, 1)``: the same llama3.2-1b
    (``init_params`` from the seed, whole) and seeded cache as the world's
    split twin, teacher-forced by the same tokens; rank 0's logits
    ``split_logits`` of each step within HD_TWIN_TOL and with the same
    argmax."""
    import torch

    from repro_torch.models.lm import LM, init_params
    sys.path.insert(0, str(ROOT / "tools"))
    import tp_rank
    cfg = tp_rank._hd_config("float32", tp_rank.TWIN_LAYERS)
    model = LM(cfg, tp=HD_RANKS, device="cuda")
    want = tp_rank.hd_twin_logits(model, init_params(
        cfg, tp_rank.SEED, device="cuda", dtype=torch.float32, tp=HD_RANKS))
    got = split_logits.to(want.device)
    check(got.shape == want.shape, f"phase 20 twin: rank 0's logits "
          f"{tuple(got.shape)}, the whole run's {tuple(want.shape)}")
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    res = dict(max_abs_err=max(errs), errs=errs, same_argmax=same,
               layers=cfg.num_layers, lanes=tp_rank.HD_TWIN_LANES,
               max_seq=tp_rank.HD_TWIN_MAX,
               lengths=list(tp_rank.HD_TWIN_LENGTHS))
    check(max(errs) <= HD_TWIN_TOL and same,
          f"phase 20 twin: the head_dim split over {HD_RANKS} ranks differs "
          f"from the whole decode: {json.dumps(res)}")
    del model, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_hd_phase(gen, world=None) -> tuple:
    """Phase 20: the world of sixteen ranks (``tools/tp_rank.py hd``, or
    ``world``, started gated by :func:`start_tp_world`:
    llama3.2-1b's decode over a gqa cache split over ``head_dim`` at
    ``(1, 16)``, then its float32 twin split), the twin held to the whole
    decode here, then row 5 against its plain version at every (S, d, F)
    the ranks recorded.  Returns the numbers and the launch counts summed
    over the ranks."""
    res, t, t_wall = {}, time.perf_counter(), time.time()
    ranks = checked_tp_world("hd", HD_TIMEOUT, 20, size=HD_RANKS,
                             world=world)
    res["world_s"] = time.perf_counter() - t
    # the world's time outside the ranks' bodies: the slowest rank's
    # imports (under phase 19 when the world was started early), the last
    # join after the release, and from the last body's end to the exit
    res["world_phases_s"] = dict(
        imports=max(o["imported_at"] - o["started_at"] for o in ranks),
        join=max(o["joined_at"] for o in ranks) - t_wall,
        teardown=t_wall + res["world_s"] - max(o["ended_at"] for o in ranks))
    shapes = set()
    for r, out in enumerate(ranks):
        a = out["serve"]
        check(out["backend"] == "gloo" and a["tokens"] == ranks[0]["serve"][
            "tokens"], f"phase 20 rank {r}: backend {out['backend']}, "
              f"tokens {a['tokens']} against rank 0's")
        shapes |= {tuple(sh) for sh in a["row5_shapes"]}
        if r:
            log(f"20 rank {r}: cache {a['cache_bytes_local']} B, decode_step "
                f"first call {a['first_call_ms']:.4f} ms, p50 "
                f"{a['decode_step_ms']['p50']:.4f} ms, p99 "
                f"{a['decode_step_ms']['p99']:.4f} ms, peak "
                f"{a['max_memory_allocated']} B; {out['seconds']:.1f} s")
            continue
        log(f"20 rank 0: mesh backend {out['backend']} ({HD_RANKS} ranks on "
            f"{out['device']}); {a['model']} ({a['layers']} layers, mesh "
            f"{a['mesh']}, {a['lanes']} lanes of {a['max_seq']} at "
            f"{a['lengths']}): {a['param_bytes_local']} B of parameters a "
            f"rank drawn in {a['init_s']:.3f} s; k spec {a['k_spec']}, local "
            f"k {a['k_local_shape']}, cache {a['cache_bytes_local']} B a rank "
            f"(memory_allocated grew {a['cache_memory_allocated']} B), filled "
            f"in {a['fill_s']:.3f} s; decode_step (in place) first call "
            f"{a['first_call_ms']:.4f} ms, then p50 "
            f"{a['decode_step_ms']['p50']:.4f} ms, p99 "
            f"{a['decode_step_ms']['p99']:.4f} ms over the other "
            f"{len(a['step_ms']) - 1} steps ({a['step_ms']}); "
            f"{a['tokens_per_s']:.3f} tokens/s after the first call "
            f"({a['tokens_per_s_with_first']:.3f} with it); collectives a "
            f"call {json.dumps(a['collectives_per_call'])}; peak "
            f"{a['max_memory_allocated']} B; tokens equal on the ranks "
            f"{a['tokens_equal_on_ranks']}; row 5 "
            f"{a['launches']['fused_norm_matmul']} launches, "
            f"{a['fnm_per_call']} a call, at {a['row5_shapes']}; the served "
            f"run {a['seconds']:.1f} s, the split twin "
            f"{out['twin']['seconds']:.1f} s, the rank {out['seconds']:.1f} s")
    res["twin"] = hd_twin_whole(ranks[0]["tensors"])
    log(f"20 float32 twin, {HD_RANKS} ranks against (1, 1): "
        f"{json.dumps(res['twin'])}")
    res["fnm_check_shapes"] = check_fnm_shapes(
        gen, [(S, d, F, "bfloat16") for S, d, F in sorted(shapes)])
    res["ranks"] = [{k: v for k, v in out.items() if k != "tensors"}
                    for out in ranks]
    launches = {k: sum(out["launches"][k] for out in ranks)
                for k in ranks[0]["launches"]}
    log("phase 20: the world {:.1f} s ({})".format(
        res["world_s"], json.dumps(res["world_phases_s"])))
    return res, launches


# ------------------------------------------------------------ phase 19
def dryrun_cells(recs: list, seconds: float) -> None:
    """Phase 19 (a): the records of ``DRYRUN_CELLS`` through
    ``launch/dryrun.py`` on the host (:class:`Background` runs them, in
    ``seconds``); each must end ``ok`` with its collectives agreeing, or
    ``skip`` for full attention at ``long_500k``."""
    from repro_torch.configs import get_config
    log(f"dry run of {len(recs)} cells: {seconds:.1f} s in a pool of "
        f"{DRYRUN_JOBS}")
    for (arch, shape, _, variant), rec in zip(DRYRUN_CELLS, recs):
        tag = f"{arch} {shape}" + (f" {variant}" if variant else "")
        if shape == "long_500k" and not get_config(arch).sub_quadratic:
            check(rec["status"] == "skip", f"dry run {tag}: not skipped")
            log(f"dry run {tag}: skip ({rec['reason']})")
            continue
        check(rec["status"] == "ok" and rec["collectives_agree"],
              f"dry run {tag}: {rec['status']} {rec.get('error')} "
              f"{rec.get('traceback', '')[-1500:]}")
        rl, mem = rec["roofline"], rec["memory_analysis"]
        log(f"dry run {tag} on {rec['mesh']} ({rec['chips']} ranks): traced "
            f"in {rec['trace_s']} s (ranks {rec['trace_s_ranks']}); "
            f"{rec['collectives']} collectives a step, agreeing with the "
            f"neighbours {rec['ranks_traced']}; arguments "
            f"{mem['argument_size_in_bytes']} B a rank (estimate "
            f"{mem['arguments_per_device_estimate']}), temp "
            f"{mem['temp_size_in_bytes']} B; FLOPs {rl['flops_per_device']}, "
            f"bytes {rl['hbm_bytes_per_device']} (upper "
            f"{rl['hbm_bytes_upper']}), collective bytes "
            f"{rl['coll_by_kind']}; compute {rl['compute_s']:.6f} s, memory "
            f"{rl['memory_s']:.6f} s, collective {rl['collective_s']:.6f} s "
            f"(H100 constants), {rl['dominant']}; model_flops "
            f"{rl['model_flops']}, mfu {rl['mfu']:.4f}; kernels "
            f"{json.dumps(rec['kernels'])}"
            + (f"; assumed {rec['assumed']}" if "assumed" in rec else ""))


def counted_step(kind: str, cell, args, mesh, device: str):
    """One step of ``cell`` under a ``CostMode`` -> (its outputs, the
    mode, the launch counters' delta)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import CostMode
    ops.reset_launch_counts()
    with CostMode(mesh=mesh, device=device) as mode:
        out = cell.fn(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, mode, dict(ops.LAUNCHES)


def count_against_card(seed: int) -> dict:
    """Phase 19 (b): llama3.2-1b's train step at phase 14 (c)'s shape and
    its decode step at phase 7's, through the dry run's builders at mesh
    ``(1, 1)``, counted live on the card and traced on ``meta``; the
    counts must be equal and the kernel calls the launches.  Then the
    steady-state step time on the card beside the roofline on the H100
    constants."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    arch = "llama3.2-1b"
    shapes = {"train": ShapeConfig("chip_train", TRAIN_SEQ, TRAIN_B,
                                   "train"),
              "decode": ShapeConfig("chip_decode", MAX_SEQ, LANES,
                                    "decode")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_world(str(Path(tmp) / "rdv"))
        try:
            live = mesh_mod.make_debug_mesh(1, 1)
            meta = mesh_mod.make_meta_mesh(axis_shapes=(1, 1))
            # warm meta's per-device tables (rope) once, as the card's warm
            # step does there
            warm = dryrun.build_cell(arch, None, meta, shape=shapes["decode"])
            warm.fn(*warm.args)
            for kind, shape in shapes.items():
                out[kind] = count_one(kind, arch, shape, live, meta, seed)
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return out


def _diff_ops(a, b) -> dict:
    return {k: (a.by_op.get(k), b.by_op.get(k))
            for k in sorted(set(a.by_op) | set(b.by_op))
            if a.by_op.get(k) != b.by_op.get(k)}


def count_one(kind, arch, shape, live, meta, seed) -> dict:
    """:func:`count_against_card` for one step kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as roof
    from repro_torch.models import lm
    cm = dryrun.build_cell(arch, None, meta, shape=shape)
    _, mm, _ = counted_step(kind, cm, cm.args, meta, "meta")
    cl = dryrun.build_cell(arch, None, live, shape=shape)
    args = dryrun.materialize(cl, seed)
    res0 = cl.fn(*args)  # warm: the allocator, the rope table
    if kind == "train":  # the state advances: the next step reads it
        args = (res0[0], args[1])
    del res0
    torch.cuda.synchronize()
    res, ml, launches = counted_step(kind, cl, args, live, "cuda")
    a, b = mm.summary(), ml.summary()
    same = {k: a[k] == b[k] for k in ("flops", "bytes", "bytes_upper",
                                      "coll_bytes", "dot_flops")}
    calls = {k: v["calls"] for k, v in b["kernels"].items()}
    check(all(same.values()) and a["kernels"] == b["kernels"],
          f"{kind} step: the meta count {a} differs from the card's {b}: "
          f"{json.dumps(_diff_ops(mm, ml))[:3000]}")
    check(all(launches[k] == calls.get(k, 0) for k in launches),
          f"{kind} step: kernel calls {calls} are not the launches "
          f"{launches}")
    # the steady state: steps after the warm and the counted ones
    if kind == "train":
        args = (res[0], args[1])
        step = lambda a: (cl.fn(*a)[0], a[1])
    else:
        args = (args[0], args[1], res[1])
        step = lambda a: (a[0], a[1], cl.fn(*a)[1])
    del res
    times = []
    for _ in range(COUNT_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        args = step(args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(COUNT_PROFILED_STEPS):
            args = step(args)
        torch.cuda.synchronize()
    busy_us, spans = device_busy_us(prof)
    del args
    cfg = cl.cfg
    n_dense, n_expert = roof.count_params_split(lm.param_template(cfg),
                                                lm.Leaf)
    mf = roof.model_flops_for(cfg, shape, n_dense, n_expert)
    rl = roof.analyse(ml.cost, chips=1, model_flops=mf)
    p50 = float(np.percentile(times, 50))
    busy_ms = busy_us / 1e3 / COUNT_PROFILED_STEPS
    r = dict(shape=dataclasses.asdict(shape), counts=b, launches=launches,
             roofline=rl.to_dict(), step_ms_events=times,
             step_p50_ms=p50, busy_ms_a_step=busy_ms,
             device_ops_a_step=spans / COUNT_PROFILED_STEPS,
             model_flops_share_of_peak=mf / (roof.PEAK_FLOPS * p50 / 1e3),
             counted_flops_share_of_peak=b["flops"]
             / (roof.PEAK_FLOPS * p50 / 1e3),
             roofline_over_step=rl.step_time_s / (p50 / 1e3))
    log(f"count of one {arch} {kind} step ({shape.global_batch} x "
        f"{shape.seq_len}, bf16, mesh (1, 1)), meta = card: FLOPs "
        f"{b['flops']} (dots {b['dot_flops']}), bytes {b['bytes']}, "
        f"bytes_upper {b['bytes_upper']}, peak live {b['peak_live_bytes']} "
        f"B on the card ({a['peak_live_bytes']} on meta); kernel calls "
        f"{calls} = launches; roofline (H100 constants) compute "
        f"{rl.compute_s * 1e3:.4f} ms, memory {rl.memory_s * 1e3:.4f} ms, "
        f"step {rl.step_time_s * 1e3:.4f} ms ({rl.dominant}); model_flops "
        f"{mf}; steady step on the card p50 {p50:.4f} ms by events over "
        f"{COUNT_TIMED_STEPS} steps ({', '.join(f'{t:.4f}' for t in times)}),"
        f" busy {busy_ms:.4f} ms a step at {r['device_ops_a_step']:.1f} "
        f"device ops; model-FLOPs share of the peak "
        f"{r['model_flops_share_of_peak']:.6f}, counted-FLOPs share "
        f"{r['counted_flops_share_of_peak']:.6f}; roofline / step "
        f"{r['roofline_over_step']:.6f}")
    return r


def examples_on_card() -> dict:
    """Phase 19 (c): the examples' counterparts with ``--device cuda``,
    in process, each with the launch counters zeroed just before it and
    read just after."""
    import importlib.util

    from repro_torch.kernels import ops
    out = {}
    for name in ("quickstart_torch", "serve_kvs_torch"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main(["--device", "cuda"])
        out[name] = dict(result=res, launches=dict(ops.LAUNCHES),
                         seconds=time.perf_counter() - t0)
    q, s = out["quickstart_torch"], out["serve_kvs_torch"]
    check(q["result"]["match_rate"] == 1.0, "quickstart: a Get missed")
    for k in ("ludo_lookup", "slot_unpack"):
        check(q["launches"][k] > 0, f"quickstart never launched {k}")
    check(s["result"]["outputs_match"] and s["result"]["pages_found"]
          and s["result"]["finished"] == 10,
          f"serve_kvs: {s['result']}")
    for k in ("fused_norm_matmul", "paged_attention",
              "cuckoo_paged_attention"):
        check(s["launches"][k] > 0, f"serve_kvs never launched {k}")
    log(f"examples on the card: {json.dumps(out)}")
    return out


_KEY_OFFSET = 0x5EED << 40


class Background:
    """The host work that needs no card, started before phase 1 so that it
    runs beside the store's single-threaded host build: the kernels' nvcc
    (one process a source), phase 19 (a)'s dry run in its pool, and the
    imports of phases 17, 18 and 20's worlds, started gated
    (:func:`start_tp_world`) until their phases release them.  All of it
    runs at niceness BG_NICE (a thread's niceness passes to the processes
    it starts; a gated rank sets its own, ``tools/tp_rank.py``), so the
    store's build keeps its core."""

    def __init__(self):
        from repro_torch.kernels import build
        from repro_torch.launch import dryrun
        self.out: dict = {}
        self.threads = {
            "build": threading.Thread(target=self._run, daemon=True,
                                      args=("build", build.build_all)),
            "dryrun": threading.Thread(target=self._run, daemon=True, args=(
                "dryrun", lambda: dryrun.run_cells(DRYRUN_CELLS,
                                                   jobs=DRYRUN_JOBS)))}
        for t in self.threads.values():
            t.start()
        self.worlds = {mode: start_tp_world(mode, size, gated=True)
                       for mode, size in (("main", TP_RANKS),
                                          ("seq", TP_RANKS),
                                          ("hd", HD_RANKS))}

    def _run(self, name: str, fn) -> None:
        os.nice(BG_NICE)  # this thread's, on Linux, and its children's
        t0 = time.perf_counter()
        try:
            self.out[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # raised where the result is read
            self.out[name] = e

    def result(self, name: str):
        """(what ``name`` returned, its seconds), once it has ended."""
        self.threads[name].join()
        r = self.out[name]
        if isinstance(r, BaseException):
            raise r
        return r

    def stop(self) -> None:
        for w in self.worlds.values():
            stop_tp_world(w)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    bg = Background()
    try:
        return run(bg)
    finally:
        bg.stop()


def run(bg: Background) -> int:
    """The phases, with ``bg``'s work started."""
    import torch
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import ops
    # the plain versions' float32 products run in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)

    # ---- set-up: data from the seed, the store on the card ----
    rng = np.random.default_rng(SEED)
    n = 1 << N_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(_KEY_OFFSET))
    vals = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = open_store(StoreSpec("outback", load_factor=0.95,
                                 rng_seed=SEED,
                                 batch=BatchPolicy(window=WINDOW)),
                       keys, vals)
    torch.cuda.synchronize()
    eng = store.engine
    log(f"store build: {time.perf_counter() - t0:.3f} s for {n} keys "
        f"(host Ludo build, then MN/CN arrays to {eng.device}); "
        f"{eng.cn.num_buckets} buckets, {eng.overflow.size} fallback keys, "
        f"MN {eng.mn_index_bytes() + 16 * eng.heap_klo.numel()} B, "
        f"CN {eng.cn_memory_bytes()} B")
    check(eng.device.type == "cuda" and eng.slots_lo.is_cuda
          and eng.cn.seeds.is_cuda, "the store is not on the card")
    # ---- phase 1: the build, begun beside the store's ----
    log(f"kernel build: {bg.result('build')[0]:.3f} s (nvcc, sm_90a, one "
        f"process per source, beside the store's build)")

    log(f"phase 1 and the store: {time.perf_counter() - t_start:.1f} s")

    # ---- phase 2: kernels against their plain versions ----
    t2 = time.perf_counter()
    kernels = check_kernels(eng, keys, rng)
    agreement_check(SEED)
    log(f"phase 2: {time.perf_counter() - t2:.1f} s")
    t3 = time.perf_counter()

    # ---- phase 3: the main path ----
    ops.reset_launch_counts()
    res, oracle = serve(store, keys, vals, rng, 1 << N_GETS_LOG2,
                        1 << N_YCSB_A_LOG2, 1 << N_WRITES_LOG2)
    launches = dict(ops.LAUNCHES)
    for name, k in kernels.items():
        k["launches"] = launches[name]
    log(f"launches on the Outback serve path: {launches}")
    for name in ("ycsb_c", "ycsb_c_profiled", "ycsb_a", "inserts",
                 "deletes"):
        p = res[name]
        for kern in ("ludo_lookup", "slot_unpack"):
            check(p["launches"][kern] >= p["batches"] > 0,
                  f"{name}: fewer {kern} launches than flushed batches")
    check(all(launches[k] > 0 for k in kernels), "a kernel never launched")
    verify_final(store, keys, rng, oracle)

    c = res["ycsb_c"]
    log(f"YCSB-C: {c['gets_per_s']:.1f} Gets/s over {1 << N_GETS_LOG2} "
        f"Gets; per window of {WINDOW}: p50 {c['p50_ms']:.4f} ms, "
        f"p99 {c['p99_ms']:.4f} ms, max {c['max_ms']:.4f} ms; its flush "
        f"p50 {c['flush_p50_ms']:.4f} ms, p99 {c['flush_p99_ms']:.4f} ms; "
        f"garbage collections (gen 0/1/2) {c['gc_collections']}, "
        f"{c['gc_ms']:.1f} ms")
    busy = res["ycsb_c_profiled"]["device_busy_share"]
    log(f"YCSB-C device busy share (torch.profiler, 32 windows): "
        f"{'not measured' if busy is None else f'{busy:.6f}'}")
    log(f"YCSB-A: {res['ycsb_a']['ops_per_s']:.1f} ops/s over "
        f"{1 << N_YCSB_A_LOG2} ops")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    log(f"meter: {store.meter_totals().snapshot()}")
    # phase 9's Outback row: the MN decode over this store, B = MN_BATCH
    outback_mn = outback_mn_timing(eng, keys, rng)
    log(f"Outback MN decode at B={MN_BATCH}: {json.dumps(outback_mn)}")
    del store, eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3: {time.perf_counter() - t3:.1f} s")

    # ---- phase 4: the paged kernels against their plain versions ----
    t4 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    shape = (1 << PAGE_POOL_LOG2, PAGE_SIZE, N_KV, HEAD_DIM)
    k_pool = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    v_pool = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    paged = check_paged_kernels(k_pool, v_pool, gen)

    # ---- phase 5: the paged decode path ----
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pres, tables = paged_serve(k_pool, v_pool, gen)
    torch.cuda.synchronize()
    paged_s = time.perf_counter() - t0
    plaunch = dict(ops.LAUNCHES)
    log(f"launches on the paged decode path: {plaunch} ({paged_s:.3f} s)")
    for name in ("ludo_lookup", "slot_unpack", "paged_attention",
                 "cuckoo_paged_attention"):
        check(plaunch[name] >= pres["steps"] > 0,
              f"paged decode: fewer {name} launches than decode steps")
    for name, k in paged.items():
        k["launches"] = plaunch[name]
    for name, k in kernels.items():
        k["launches_paged_path"] = plaunch[name]
    kernels.update(paged)
    pres.update(paged_timings(k_pool, v_pool, gen, *tables))
    log(f"paged path: {json.dumps(pres)}")
    log(f"paged phase max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated()} B (pools "
        f"{2 * k_pool.numel() * k_pool.element_size()} B)")
    del k_pool, v_pool, tables
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phases 4-5: {time.perf_counter() - t4:.1f} s")

    # ---- phase 6: fused_norm_matmul against its plain version ----
    t6 = time.perf_counter()
    kernels["fused_norm_matmul"] = check_fused_norm_matmul(gen)
    log(f"phase 6: {time.perf_counter() - t6:.1f} s")

    # ---- phase 7: the dense-model serving path ----
    torch.cuda.reset_peak_memory_stats()
    mres, model, params, eng = serve_model(SEED)
    mres["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    for name, k in kernels.items():
        k["launches" if name == "fused_norm_matmul"
          else "launches_model_path"] = mres["launches"][name]
    check(kernels["fused_norm_matmul"]["launches"] > 0,
          "fused_norm_matmul never launched on the model path")
    log(f"model phase max_memory_allocated: {mres['max_memory_allocated']} B")
    mres.update(profile_decode(model, params, eng.cache))
    del eng
    mres.update(float32_twin(params, SEED))
    log(f"model path: {json.dumps(mres)}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t6:.1f} s (with phase 6)")

    # ---- phase 8: the cached, resizable store ----
    t8 = time.perf_counter()
    store_agreement_check(SEED)
    torch.cuda.reset_peak_memory_stats()
    dres = serve_directory(keys, vals, rng)
    for name, k in kernels.items():
        k["launches_store_path"] = dres["launches"].get(name, 0)
    for name in ("ludo_lookup", "slot_unpack"):
        check(dres["launches"][name] > 0, f"{name} never launched on the "
              f"cached directory store's path")
    log(f"launches on the cached directory store's path: {dres['launches']}")
    log(f"directory store path: {json.dumps(dres)}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")

    # ---- phase 9: the comparison baselines and the transport model ----
    t9 = time.perf_counter()
    ops.reset_launch_counts()
    baseline_agreement_check(SEED)
    t9a = time.perf_counter()
    bres = {}
    for kind in BASELINE_KINDS:  # one full-size store at a time
        bres[kind] = serve_baseline(kind, keys, vals, rng)
        gc.collect()
        torch.cuda.empty_cache()
    bres["outback"] = dict(mn=outback_mn)
    t9b = time.perf_counter()
    model = modelled_comparison(SEED)
    log(f"phase 9: the agreement {t9a - t9:.1f} s, the four stores "
        f"{t9b - t9a:.1f} s, the modelled comparison "
        f"{time.perf_counter() - t9b:.1f} s")
    blaunch = dict(ops.LAUNCHES)
    for name, k in kernels.items():
        k["launches_baselines_path"] = blaunch[name]
    for name in ("ludo_lookup", "slot_unpack"):
        check(blaunch[name] >= (1 << SIM_GETS_LOG2) // WINDOW,
              f"{name}: fewer launches than the Outback trace's windows")
    log(f"launches on the baselines' path: {blaunch}")
    log("MN step at B=%d, us per op (events / device): %s" % (
        MN_BATCH, ", ".join(
            f"{k} {v['mn']['events_us_per_op']:.6f} / "
            f"{v['mn']['device_us_per_op']}" for k, v in bres.items())))
    log(f"baselines path: {json.dumps(dict(serve=bres, modelled=model))}")
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")

    # ---- phase 10: Outback over the mesh ----
    t10 = time.perf_counter()
    meshres, mlaunch = serve_on_mesh(keys, vals, rng)
    for name, k in kernels.items():
        k["launches_sharded_path"] = mlaunch[name]
    for name in ("ludo_lookup", "slot_unpack"):
        check(mlaunch[name] > 0, f"{name} never launched on the mesh path")
    log(f"launches on the mesh path: {mlaunch}")
    log(f"mesh path: {json.dumps(meshres)}")
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")

    # ---- phase 11: replication, the fault plane and the retry stage ----
    t11 = time.perf_counter()
    fres, flaunch = serve_faults(keys, vals, rng)
    for name, k in kernels.items():
        k["launches_replicated_path"] = flaunch[name]
    for name in ("ludo_lookup", "slot_unpack"):
        check(flaunch[name] > 0, f"{name} never launched on the replicated "
              f"path")
    log(f"launches on the replicated path: {flaunch}")
    log(f"replicated path: {json.dumps(fres)}")
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")

    # ---- phase 12: the telemetry plane, the cluster and the chaos harness
    t12 = time.perf_counter()
    cres, claunch = serve_cluster_phase(keys, vals, rng)
    for name, k in kernels.items():
        k["launches_cluster_path"] = claunch[name]
    for name in ("ludo_lookup", "slot_unpack"):
        check(claunch[name] > 0, f"{name} never launched on the cluster's "
              f"path")
    log(f"launches on the cluster's path: {claunch}")
    log(f"cluster path: {json.dumps(cres)}")
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")

    # ---- phase 13: the front door, session parking, rwkv6 ----
    t13 = time.perf_counter()
    sres, slaunch = serve_serving_phase(keys, vals, rng)
    for name, k in kernels.items():
        k["launches_frontdoor_path"] = slaunch["frontdoor"][name]
        k["launches_session_path"] = slaunch["sessions"][name]
    for name in ("ludo_lookup", "slot_unpack"):
        check(slaunch["frontdoor"][name] > 0, f"{name} never launched on "
              f"the front door's path")
    for name in ("ludo_lookup", "slot_unpack", "fused_norm_matmul"):
        check(slaunch["sessions"][name] > 0, f"{name} never launched on "
              f"the session path")
    log(f"launches on the front door's path: {slaunch['frontdoor']}")
    log(f"launches on the session path: {slaunch['sessions']}")
    log(f"serving path: {json.dumps(sres)}")
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")

    # ---- phase 14: the training path ----
    t14 = time.perf_counter()
    kernels["fused_norm_matmul_bwd"], tres, tlaunch = \
        serve_training_phase(gen)
    kernels["fused_norm_matmul_bwd"]["launches"] = \
        tlaunch["fused_norm_matmul_bwd"]
    qwen = tres["qwen3"]
    for name, k in kernels.items():
        k["launches_train_path"] = tlaunch[name]
        k["launches_train_qwen3_path"] = qwen["launches"][name]
    for name, shapes in (("fused_norm_matmul", qwen["fnm_check_shapes"]),
                         ("fused_norm_matmul_bwd",
                          qwen["fnmb_check_shapes"])):
        kernels[name]["max_abs_err_qwen3_train_shapes"] = max(
            sh["max_abs_err"] for sh in shapes)
    kernels["fused_norm_matmul"]["max_abs_err_train_shapes"] = max(
        sh["max_abs_err"] for sh in tres["fnm_train_check_shapes"])
    # the training entries' device times beside the library's, like for
    # like: llama3.2-1b's (phase 14 (c)) and qwen3-4b's (d)
    kernels["fused_norm_matmul"]["train_timed"] = [
        {k: r.get(k) for k in ("S", "d", "F", "plan", "device_ms",
                               "device_ms_by_kernel", "library_device_ms",
                               "bound_ms", "share_of_bound",
                               "device_below_library")}
        for r in tres["fnm_train_timed"] + qwen["fnm_timed"]]
    kernels["fused_norm_matmul_bwd"]["train_qwen3_timed"] = [
        {k: r[k] for k in ("S", "d", "F", "device_ms", "device_ms_with_dn",
                           "library_device_ms", "bound_ms")}
        for r in qwen["fnmb_timed"]]
    for name in ("fused_norm_matmul", "fused_norm_matmul_bwd"):
        check(tlaunch[name] > 0 and qwen["launches"][name] > 0,
              f"{name} never launched on a training path")
    log(f"launches on the training path: {tlaunch}; qwen3-4b's: "
        f"{qwen['launches']}")
    log(f"training path: {json.dumps(tres)}")
    log(f"phase 14: {time.perf_counter() - t14:.1f} s")

    # ---- phase 15: the vlm, MoE and MLA families ----
    t15 = time.perf_counter()
    vres, vlaunch = serve_families_phase(gen)
    for name, k in kernels.items():
        k["launches_families_path"] = {a: vlaunch[a][name] for a in vlaunch}
    for arch in vlaunch:
        check(vlaunch[arch]["fused_norm_matmul"] > 0, f"fused_norm_matmul "
              f"never launched on {arch}'s serving path")
    log(f"launches on the families' serving paths: {vlaunch}")
    log(f"families path: {json.dumps(vres)}")
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")

    # ---- phase 16: the hybrid and encdec families ----
    t16 = time.perf_counter()
    hres, hlaunch = serve_hybrid_phase(gen)
    for name, k in kernels.items():
        k["launches_hybrid_path"] = {a: hlaunch[a][name] for a in hlaunch}
    for arch in hlaunch:
        check(hlaunch[arch]["fused_norm_matmul"] > 0, f"fused_norm_matmul "
              f"never launched on {arch}'s serving path")
    log(f"launches on the hybrid and encdec serving paths: {hlaunch}")
    log(f"hybrid and encdec path: {json.dumps(hres)}")
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")

    # ---- phase 17: tensor parallelism, two ranks on the card ----
    t17 = time.perf_counter()
    pres, plaunch = serve_tp_phase(gen, bg.worlds["main"])
    for name, k in kernels.items():
        k["launches_tp_path"] = plaunch[name]
    for name, shapes in (("fused_norm_matmul", pres["fnm_check_shapes"]
                          + pres["fnm_train_check_shapes"]
                          + pres["fnm_family_train_check_shapes"]),
                         ("fused_norm_matmul_bwd",
                          pres["fnmb_train_check_shapes"]
                          + pres["fnmb_family_train_check_shapes"])):
        kernels[name]["max_abs_err_tp_shapes"] = max(
            sh["max_abs_err"] for sh in shapes)
    for name in ("fused_norm_matmul", "fused_norm_matmul_bwd"):
        check(plaunch[name] > 0, f"{name} never launched on the "
              f"tensor-parallel path")
    log(f"launches on the tensor-parallel path (both ranks): {plaunch}")
    log(f"tensor-parallel path: {json.dumps(pres)}")
    log(f"phase 17: {time.perf_counter() - t17:.1f} s")

    # ---- phase 18: the sequence splits of the decode cache, two ranks ----
    t18 = time.perf_counter()
    qres, qlaunch = serve_seq_phase(gen, bg.worlds["seq"])
    for name, k in kernels.items():
        k["launches_seq_path"] = qlaunch[name]
    kernels["fused_norm_matmul"]["max_abs_err_seq_shapes"] = max(
        sh["max_abs_err"] for sh in qres["fnm_check_shapes"])
    check(qlaunch["fused_norm_matmul"] > 0, "fused_norm_matmul never "
          "launched on the split-cache path")
    log(f"launches on the split-cache path (both ranks): {qlaunch}")
    log(f"split-cache path: {json.dumps(qres)}")
    log(f"phase 18: {time.perf_counter() - t18:.1f} s")

    # ---- phase 19: the compile-time tools, checked against the card ----
    t19 = time.perf_counter()
    dryrun_cells(*bg.result("dryrun"))
    log(f"phase 19 (a): {time.perf_counter() - t19:.1f} s (the dry run "
        f"took {bg.result('dryrun')[1]:.1f} s beside phases 1-18)")
    cres = count_against_card(SEED)
    for name, k in kernels.items():
        k["launches_count_path"] = sum(c["launches"][name]
                                       for c in cres.values())
    xres = examples_on_card()
    for name, k in kernels.items():
        k["launches_examples_path"] = {
            ex: x["launches"][name] for ex, x in xres.items()}
    log(f"phase 19: {time.perf_counter() - t19:.1f} s")

    # ---- phase 20: the gqa decode cache over head_dim, sixteen ranks ----
    t20 = time.perf_counter()
    hres, hlaunch = serve_hd_phase(gen, bg.worlds["hd"])
    for name, k in kernels.items():
        k["launches_hd_path"] = hlaunch[name]
    kernels["fused_norm_matmul"]["max_abs_err_hd_shapes"] = max(
        sh["max_abs_err"] for sh in hres["fnm_check_shapes"])
    check(hlaunch["fused_norm_matmul"] > 0, "fused_norm_matmul never "
          "launched on the head_dim-split path")
    log(f"launches on the head_dim-split path (all ranks): {hlaunch}")
    log(f"head_dim-split path: {json.dumps(hres)}")
    log(f"phase 20: {time.perf_counter() - t20:.1f} s")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
