#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (elasticsearch_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device   the card's name, power limit and compute capability;
2. build    every CUDA kernel, from the sources in the checkout (nvcc,
            sm_90a, one process per source, all started together), with
            each kernel's registers and spill bytes;
3. kernels  each kernel against its plain PyTorch twin on the card, bit
            for bit: B1 bm25_dense_topk (all-rows and rows forms: rows of
            a whole 256-row block with pads and repeats, R 1 to 256, the
            hit count exact, f32 subnormals that round to bf16 zero, k up
            to 1000, ragged D, ties, Q=9, the batched form, and at
            Q=2048 with the count, _msearch's tier 1; the batched form's
            tensor-core pass on tie-heavy tops, order-sensitive sums,
            ragged Q, F, D and k on both sides of its thresholds, an
            unaligned block, fewer live docs than k and all docs tied,
            with the docs each query rescored), B2 knn_topk
            (three metrics, both precisions, k up to 1000, ragged D, ties,
            a 90% mask, D under one chunk, Q=9, Q=32 and Q=64 at k=100
            (_msearch's kNN and MaxSim batches), 768 to 40,000 dims
            (narrow ring stages, no staging), an unaligned slab, zero
            rows), B3 adc_scores (the table-sum, and the fused form over a
            whole code table: IVF-shaped slots with pads, filters at 10%
            and 0%, all padded, W=1, unaligned codes, M 8 to 64) and B4
            maxsim_adc (W 1 to 81,920, M 1-64, K 64-256, T 1-100, negative
            tables, a NaN in a later token group, unaligned codes);
4. write    the write path through ``Node``: index, refresh, search,
            delete, checked against the same Node on the CPU;
5. read     the BM25 read path: a 2^20-doc MS-MARCO-shaped corpus loaded
            with ``segment_from_arrays``, 32 Zipfian ``match`` queries
            through ``Node.search`` (B1's launch counts are taken over
            exactly this run), hits held against the plain twin and an
            exact numpy scorer; one fused query must run B1's two
            kernels and one copy each way, nothing else, through the
            mesh path (one slot);
5b. vectors the kNN read path: 1,000,000 SIFT-shaped 128-d vectors
            (``bench.py::make_sift_node``'s recipe) padded to 2^20, IVF
            (C = 4000) and PQ (M = 32, K = 256) built twice on the card
            and required identical, then brute-force, filtered, MaxSim,
            IVF-PQ and filtered IVF-PQ ``knn`` queries through
            ``Node.search`` (B2's and B3's launch counts are taken over
            exactly this run), hits held against the plain twins and an
            exact f64 numpy oracle; one IVF-PQ query must launch B3 once;
5c. hybrid  the hybrid read path: one 2^20-doc segment holding phase 5's
            text field and phase 5b's slab (its IVF and PQ carried
            across), 56 ``hybrid`` queries through ``Node.search`` (RRF,
            linear, an IVF-PQ knn side, a filtered knn side, MaxSim
            re-ranks of a 100-doc window over the slab and over the PQ
            codes; the launches of B2, B3 and B4 are taken over exactly
            this run, per query), hits held against the plain twins, a
            numpy fusion of the engines' own rows and f64 MaxSim;
5d. mesh    phase 5's corpus and 5b's slab split over five shards by
            ``shard_id_for`` (ES 2.0's default shard count), one segment
            a shard: phase 5's 32 queries and 8 brute-force knn queries
            on the default mesh path and on the host loop (the same hits,
            totals exact against the f64 scorer; p50, device time, busy
            share, kernels and copies per query of both),
            ``search_knn`` at Q = 8 against the B2 twin and the oracle,
            and cProfile's top 10 of one match query on each path;
5e. msearch ``Node.msearch`` and the serving coalescer, with bench.py's
            recipes cut to 1024 bodies: (a) 1024 pure-dense bodies on
            phase 5's index, one B1 launch over all rows with the count,
            held against sequential ``Node.search`` and bit for bit
            against a rerun on the B1 twin; (b) 1024 mixed Zipfian bodies (tier 2: the f32
            product and the tails' scatters); (c) 256 mixed bodies on
            phase 5d's five shards through the mesh's batched round,
            against the host tiers and sequential searches; (d) 32
            brute-force kNN and 8 MaxSim bodies on phase 5b's slab, one
            B2 launch each, against sequential searches and the f64
            oracle; (e) (a)'s bodies as single searches from 64 threads
            through the coalescer, equal to (a)'s; queries per second,
            device time, kernels and copies, busy share;
5f. aggs    aggregations on a stand-in for Elastic Rally's ``nyc_taxis``
            track: 4,194,304 generated trips in four shards of one
            2^20-doc segment, the track's aggregation bodies (histogram
            with stats, date_histogram, keyword terms on the mesh's
            device route, terms with an avg, cardinality, percentiles,
            extended_stats, range, missing, filters) on the mesh path and
            the host loop, byte-identical and held against numpy (HLL
            registers against a numpy build of the same hash); p50, p99,
            device time, kernels, copies and busy share per body and
            route;
5g. sort    field sort and the request tail on phase 5f's node: Rally's
            ``desc_sort_*`` form (total_amount desc), 10 pages of 100 by
            ``search_after`` on pickup_datetime, vendor_id then
            trip_distance desc (3 values over 2^20 docs a shard),
            tip_amount with ``missing`` last and first (card trips have
            no tip), a score-ordered ``scroll`` of 25 pages of 1000 and a
            ``scan`` (geonames' scroll), ``min_score``,
            ``terminate_after`` and ``timeout``, ``profile``, and
            ``highlight`` on a small text index written through
            ``Node.index``; every body on each route it takes, held
            against numpy (``np.lexsort``, exact totals); p50, p99,
            device time, kernels, copies and busy share per body and
            route;
5h. writes  the write path and merges (``phase_writepath``): 16,384
            generated log docs (Zipf(1.1) bodies of 20-80 tokens over
            phase 5's vocabulary, a keyword, a long, a date) through
            ``Node.index`` into five shards with 32 refreshes, so the
            tiered policy folds ~32 fresh segments a shard into ~4, and a
            second index of a tenth as many; the mesh's full deep page
            past a round's padded width (C1), B1 on merged segments,
            responses after ``force_merge(1)`` and after a delete-reclaim
            merge byte-identical to one-refresh rebuilds of the live docs
            (C2), no retired segment in the executors and the breakers at
            the live segments' bytes, dfs on both routes and over two
            indices against an f64 scorer, multi-index search with
            ``indices_boost`` and ``fields`` against a CPU Node, the
            request cache; the ingest rate, refresh and merge times,
            breaker bytes and read p50/p99s;
5i. text    the full-text DSL (``phase_fulltext``): the first 2^19
            docs of phase 5's corpus with each token's position kept
            (~31M positions in a term-major, doc-ascending positional
            CSR, one stable sort) and a title field of each doc's first 10 tokens,
            loaded through ``segment_from_arrays``; groups of bodies
            drawn from the corpus (match_phrase of 2-3 consecutive tokens
            at slop 0 and 2, Rally pmc's ``phrase`` shape; multi_match
            best_fields over title and body; prefix; wildcard; fuzzy;
            match with fuzziness; dis_max; boosting; query_string with a
            quoted phrase, a prefix and AND; common), each on the mesh
            path and the host loop for about a second: responses
            byte-identical across the routes, every doc's phrase
            frequency against an f64 numpy oracle over the host positions
            (exact at slop 0), totals and top hits against the oracle's
            scores, every body against a CPU Node of the port on a
            2^14-doc prefix, and the CSR's bytes released when the node
            closes; p50, p99, device time, kernels, copies and busy share
            per group and route;
5j. scoring the scoring DSL (``phase_scoring``) on 5i's index before it
            closes, with two doc-value columns from seed 0: popularity
            (a Zipf(1.5) long, absent on 10% of docs) and published (a
            date over 2015-2020); groups of eight bodies each from the
            seed: (a) function_score field_value_factor log2p (geonames'
            ``field_value_function_score``), (b) its script_score twin,
            (c) random_score, (d) a recency boost (a match times a gauss
            on the date plus a filtered weight), (e) a script filter in a
            bool, (f) span_near in and out of order, span_first, span_or,
            span_not and span_multi, (g) size-0 script aggregations
            (avg, histogram, scripted_metric) and a page of (d) with two
            script_fields; each on the mesh path (or its typed decline)
            and on the host loop for about a second: responses
            byte-identical across the routes, (a), (c) and (d)'s function
            values and top 10 against f64 numpy oracles, span_first,
            span_or and span_not's match sets against numpy over the host
            positions, every body against a CPU Node of the port on
            5i's 2^14-doc prefix; no B1-B4 launch on this path;
5k. joins   joins and geo (``phase_joins_geo``, ROADMAP A9c), corpora
            from seed 0: (a) Rally ``nested``'s shape, 2^17 questions
            with 0-6 nested answers (a Zipf user of 50,000, a date, a
            score) in one block-join segment of about 2^19 docs loaded
            through ``segment_from_arrays`` with ``blocks``: the nested
            bool of a term on the user and a date range in score modes
            avg, sum, max and none, with inner_hits, a match on the
            title (no B1 on a nested segment), a term on the tag (roots
            only), a nested terms agg with reverse_nested and the
            track's nested date histogram, each against numpy f64; sum
            and avg bodies byte-identical over repeated runs; a delete
            of 64 roots cascading into totals and aggs; the block arrays
            charged and released at the close; (b) the same questions as
            ``question`` parents of ``answer`` children over five shards
            by ``shard_id_for(parent)``: has_child (min_children 2, max
            and sum), has_parent, a children agg under a terms agg,
            exact against numpy, and a match riding the mesh and B1;
            (c) Rally ``geopoint``'s shape, 2^20 points around 1,000
            Zipf-weighted centres plus points exactly on geohash cell
            and box edges: polygons, boxes (one across the
            antimeridian), geohash cells at precisions 3 and 6 and
            bounds exact against numpy f32 (true divisions: the card's
            cells of edge points are the exact ones), distances at three
            radii, distance rings and the ``_geo_distance`` sort against
            numpy f64 outside a printed band, ``exists`` on the mesh;
            (d) 4,096 polygons and linestrings through ``Node.index``,
            envelope and polygon queries under intersects, within and
            disjoint against a brute-force refinement; (a) and (c) on
            prefixes against a CPU Node of the port; every group on the
            host loop for about JG_WINDOW_S (and on the mesh where it
            serves), the mesh's declines counted, p50, p99, device time,
            kernels, copies and busy share per group;
5l. a9d     suggesters, the percolator and by-query (ROADMAP A9d),
            from seed 0: (a) inside ``phase_fulltext`` on 5i's live
            index, the term suggester on 5i's tokens with 1-2 seeded
            edits (missing, popular, always; by score and by frequency)
            and the phrase suggester on 2-4-token phrases with one token
            misspelt (highlight, confidence, max_errors), through
            ``IndexService.suggest`` and embedded in a match ``_search``
            on the mesh path and the host loop, every option (text,
            rounded score, freq) against numpy oracles (a textbook
            Levenshtein DP over the vocabulary, bigrams from
            ``np.unique`` over consecutive tokens) and the bigram table
            built on the card equal to the oracle's; (b) completion on
            Rally ``geonames``' shape, 2^17 places over five shards with
            a population weight, a country category and a 100km geo
            context: prefixes of 1-4 characters, fuzzy 1, both contexts,
            against a sorted Python list; (c) 1,000 registered queries
            (term, match, match_phrase, a bool with a range), 64 docs
            percolated one at a time and as one batch against a Python
            oracle over their tokens, a restriction, size, highlight and
            aggs, the breakers back at their bytes after; (d)
            ``Node.bulk`` of 8,192 index, create, update and delete
            items into five shards (~6% failing by design) item by item
            against a dict model, then mget, count, delete-by-query and
            update-by-query through ``run_by_query``, the totals after
            against the model; p50, p99, device time, kernels, copies,
            busy share, ops/s and docs/s per group;
5m. durable durability and the index lifecycle (ROADMAP A10b), from seed
            0, each data path in a temporary directory, each restart a
            new ``Node`` in this process with the blob cache's memory
            layer reset: (a) 2^13 docs of 5h's log recipe by
            ``Node.bulk`` into five shards, every 20th stamped two days
            back so the 1d ``_ttl`` purges it at the refresh (the count
            exact), 32 match bodies, then a restart with no flush (the
            translog replay: ops/s to the first answer) and a restart
            after ``flush`` (the committed blocks), each giving the same
            hits, scores, totals and ``_version``s (B1); (b) 2^13
            SIFT-shaped vectors into one ``ivf_pq`` shard, a restart
            loading the quantizer and PQ tier from ``<data>/_ivf``
            (``ivf_cache_hit``/``pq_cache_hit`` move, the builds do not)
            against a cold one that runs k-means, brute and IVF-PQ knn
            equal before and after (B2, B3); (c) full snapshots of both
            indices (seconds, bytes), incremental ones after 1% more
            writes (blobs written), a restore of the full ones into a
            fresh node (seconds, hits equal, the quantizer from the
            seeded blob); (d) close and open, an alias with a filter, a
            template at create, a mappings PUT and the ``stats`` groups
            exact against the bodies sent;
5n. replicas in-process replicas (ROADMAP A10c), from seed 0, in ES
            2.0's default layout of five primaries with one replica
            each: (a) RP_DOCS docs of 5h's log recipe with a 128-d
            ``dense_vector`` by ``Node.bulk`` (a refresh a bulk) into a
            one-copy and a two-copy index, docs/s of each, device bytes
            and the ``segments``/``fielddata`` breakers' bytes of each,
            every doc's (version, seq no, term) and every segment layout
            equal on every copy; (b) 32 match and 8 brute-force knn
            bodies under ``_primary``, ``_replica`` and round-robin on the
            mesh and the host loop (p50, p99, device time, B1 and B2
            launches, the executor's stacked-data hits and misses under
            round-robin), held against the f64 BM25 oracle (2^-7) and the
            f64 cosine oracle, the three preferences' responses
            byte-identical; (c) ``fail_shard`` on every shard (the time to
            the promotion and to the first answer), writes after it under
            term 2, a stale group's write fenced by StalePrimaryException
            and on no live copy, every acknowledged doc found on both
            routes; on a data path (RP_DURABLE docs) the promotion with
            its store handed over and committed (ms), the writes after
            it found after a restart under term 2, a stale group's write
            refused by the failed engine; (d) a scale to two replicas (the full copies' docs/s),
            one copy failed by the ``replication.fanout`` fault point, 1%
            more docs, the copy re-added by an ops-based recovery (ops/s),
            the global checkpoint at the max seq no on every group;
5o. fielddata fielddata under pressure (ROADMAP A10d), from seed 0, on
            one ``segment_from_arrays`` segment holding phase 5b's slab
            (its IVF and PQ carried across, no k-means), a second 2^20 x
            128 slab ``emb2`` and eight double columns: (a) the lazy
            placement of each 512 MiB slab on its first knn body (ms,
            GB/s) beside a 512 MiB ``copy_`` from pinned and from
            pageable memory, ``memory_allocated``/``memory_reserved``;
            (b) 16 brute-force knn bodies, emb and emb2 in turn, under a
            ``fielddata`` limit that holds one slab (p50, p99, each
            rehydration's ms and GB/s from its ``tpu.rehydrate`` span,
            evictions, B2 launches) beside the same bodies at the default
            limit, hits byte-equal to the unlimited run and held against
            the f64 cosine oracle; (c) sort and terms-agg bodies over the
            eight columns round-robin under a limit that holds three,
            byte-equal to the unlimited run; ``evict_all("fielddata")``
            then IVF-PQ bodies (B3 on codes rehydrated bit-equal to the
            host mirror, recall@10); ``evict_all()`` on phase 5's node,
            then 8 match bodies (B1 on the rehydrated dense impact block,
            hits byte-equal to those before); (d) a 2-shard index with
            the column on shard 0 only at a 1-byte limit (``_shards.
            failed`` 1, a 429 entry, shard 1's hits), a 1-shard index
            raising, the default limit healing it, ``resources.reserve``
            armed once giving one entry; (e) ``nodes_stats``' accelerator
            and fielddata counters, ``tpu.rehydrate`` spans, a profiled
            body's ``rehydrate_nanos``, every breaker back at its start
            after the index closes;
5p. rest    the REST front door (ROADMAP A10e): (a) ``python -m
            elasticsearch_tpu_torch.server --port 0`` as a subprocess on
            the card: ``GET /``, an index of 4,096 of 5h's log docs by one
            ``_bulk`` with ``refresh=true`` (docs/s), a match body whose B1
            launch is read from the server's own ``_nodes/stats``, 64
            acknowledged ids read back, SIGTERM to exit 0 (s); (b) an
            in-process ``RestServer`` over phase 5's node, with phase 5b's
            slab added as an index (its IVF and PQ carried across): phase
            5's 32 match bodies (B1), 8 brute-force (B2) and 8 IVF-PQ (B3)
            knn bodies through ``POST /{index}/_search``, each answer
            byte-equal to ``Node.search``'s once ``took`` is masked; p50
            and p99 over HTTP and in process and their difference, the
            REST overhead a request; the device busy share; 5e(a)'s 1,024
            pure-dense bodies as one ``_msearch`` (one B1 launch,
            byte-equal to ``Node.msearch``) and as single searches from 64
            client threads through the coalescer (q/s at 1 and 64 client
            threads; held at 5e(e)'s bar); (c) a tenant over its QoS share
            answered 429 while another answers 200, a saturated search
            pool answered 429 ``es_rejected_execution_exception``; (d) an
            update-by-query on (a)'s index listed by ``GET /_tasks`` and
            stopped by ``_cancel``, ``estpu_rest_requests_total`` equal to
            the requests sent;
5q. cluster the multi-node cluster (ROADMAP A10f): (a) three
            ``python -m elasticsearch_tpu_torch.server --device cuda``
            members with the multi-host flags, started together on the
            one card (each its own CUDA context and an 8 GiB breaker
            budget): one master, three nodes, the same term and state
            version on each; (b) a 3-shard, 1-replica index of 2^12 of
            5h's log docs, through ``_bulk`` to all three coordinators at
            once (one client process each): docs/s and the transport's
            bytes; (c) 64 match and bool bodies sent to each coordinator:
            answers byte-equal across coordinators once ``took`` is
            masked, equal to one in-process ``Node`` on the card holding
            the same 3 shards and docs (ids, order, totals; scores at
            B1's bf16 band), p50 and p99 against that node's, B1
            launched in every member's process (its own
            ``_nodes/stats``); (d) the master SIGKILLed while a survivor
            streams ``_bulk``: the time to a new master at a bumped term,
            every acknowledged doc found by count and 64 sampled ids by
            GET, the survivors exit 0 on SIGTERM; after (c) one
            ``/_cluster/diagnostics`` holds the three members' parts, and
            after (d) the new master's ``/_nodes/_local/flight`` holds its
            election in the ``cluster`` ring;
5r. watchdog the flight recorder and the stall watchdog (ROADMAP A10g),
            run after 5p on phase 5's node, before 5q: (a) a spin of
            0.5 s, or four times the key's bound where that is longer
            (``torch.cuda._sleep``) queued on the stream ahead of one B1
            search in the mesh round, while another thread ticks a
            watchdog whose program bound is twice the key's p99, at
            least 0.05 s: ``program_stall``
            trips on the dispatch's key and captures an incident (the
            time from the spin's launch to the trip), the search's hits
            unchanged and its key's execute seconds grown by the stall;
            (b) a launcher on the card with a data path and
            ``ESTPU_FAULTS=watchdog.program_stall:count=1`` over 2,048 of
            5n's docs serving 64 match (B1) and 8 knn (B2) bodies over
            HTTP for 2.2 s while
            its watchdog ticks: ``/_cat/incidents`` lists the incident,
            ``/_nodes/_local/flight`` holds the trip and the metric
            snapshots, and after SIGTERM and a restart on the same path
            the incident is listed as persisted and its payload answers;
            (c) 64 match bodies on phase 5's node for 1.5 s with the
            watchdog ticking and 1.5 s closed, twice: the p50s; (d) phase
            5's body field split into 4 term-range slots on the card
            (``postings_split(n_devices=4)``): 32 tail-term bodies give
            the unsplit path's top 10 and totals, scores within 1e-5;
5s. warm    the compile/warm layer (ROADMAP A11), after 5r: (a) a node
            process over a data path builds a mesh index (two slots) and
            a host-loop index of 1,024 of 5n's docs, serves bodies that
            reach B1 (head-term match), B2 (brute-force knn), B3 (IVF-PQ
            knn) and B4 (hybrid with a PQ re-rank) and closes, which
            stores its census and its kernel-library blobs; (b) a second
            process over the same path with an empty kernel build
            directory (``ops.build._BUILD_DIR``) starts its
            ``RestServer``, waits for the boot warmup and answers the
            same bodies: every library an ``aot_hit`` (no nvcc, no g++),
            every request ``warmup="false"``, each body's hits (a)'s;
            (c) a third over a copy of the data without the census, the
            libraries built: its first request pays the first touch.
            Printed: each key's first call against its execute p50, the
            first request's latency warmed and cold, each library's load
            and build seconds;
5t. encoder the dual encoder (ROADMAP A12) at its default widths
            (vocab 8192, d_model 256, 4 heads, 4 layers, d_ff 1024,
            embed 128, bf16) with ``init_params(seed=0)``, last: (a)
            phase 5's 2^20 passages cut at 128 tokens, tokenized through
            a term-id -> bucket table built once with the tokenizer's
            crc32 rule (the first 1,024 equal ``SimpleTokenizer``'s ids
            and mask) and encoded in calls of 4,096: passages/s,
            tokens/s, peak memory, 256 of them against the port's CPU
            encode (cosine > 0.999); (b) the embeddings as a one-shard
            cosine ``dense_vector`` index (``segment_from_arrays``), 32
            encoded queries from phase 5's query terms as ``knn`` k=10
            through ``Node.search`` (B2 once a query): hits against an
            f64 oracle (ids outside tie bands, scores rtol 1e-5) and bit
            for bit B2's twin's; (c) ``ring_encode`` at max_len 4,096
            over 8 sequence slots against the dense encode, B=4 ragged
            rows (cosine > 0.999), each path's ms and peak memory; (d)
            20 contrastive train steps at B=64 (span, passage) pairs,
            L=128, bf16: the loss falls, steps/s;
5v. meshes  training and the ring across devices (ROADMAP A1), after
            5t on its config, token table, batch and long rows: (a) the
            device list, every card when there are two or more, else the
            one card named 8 times (the reference's dryrun_multichip(8)
            mesh, dp 2 x tp 4), and ``training_mesh`` over it; (b) f32:
            3 steps at B=64, L=128 under the mesh and under
            ``training_mesh(1)`` from one ``init_params(seed=0)``, the
            first free, each later one from the same parameters (each
            side keeps its own AdamW moments): each loss within rtol
            1e-4, each leaf's summed gradient within 1e-3 of the
            one-device one's norm (plus 1e-5 of the largest leaf's), the
            gathered parameters within rtol 1e-4 (atol 1e-5 of each
            tensor's largest entry) where the one-device gradient stayed
            clear of the rounding floor (under 1e-5 in some step, an
            exact zero on both sides held), at most a tenth of the
            entries left to the losses; (c) 5t(d)'s 20
            bf16 steps under the mesh: the loss falls, the first within
            rtol 1e-2 of 5t(d)'s, steps/s against 5t(d)'s, each card's
            peak and one profiled step; (d) the ring at max_len 4,096
            over 8 slots over the device list: cosine > 0.99999 against
            5t(c)'s one-device ring and > 0.999 against dense, ms and
            each card's peak;
6. timing   each kernel, its plain twin, a library yardstick and the
            card's bound at the main path's shape (B1 and B3 also at
            their earlier shapes, B1's batched form with the count at Q =
            32, 256 and 1,024 and with every doc tied, B2 at phase 5e's
            batch shapes), by CUDA events and by the profiler's device
            time ("not measured" where it records none twice).

Each corpus is generated once and shared by the phases that read it.

The last three lines of standard output are the ``{"kernels": [...]}``
record, the card's name and power limit (as ``nvidia-smi`` gives them),
and ``{"ok": true, "device": {...}}``. The script needs a CUDA card and
the repository around it; without either it fails.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores

N_DOCS = 1 << 20          # product bench size (bench.py --docs default)
VOCAB = 30_000
N_QUERIES = 32
SEED = 0

N_VECS = 1_000_000        # SIFT1M (BASELINE.json configs[2])
DIMS = 128
IVF_LISTS = 4000
PQ_CANDIDATES = 10_000     # num_candidates of the IVF-PQ queries


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def check_topk(v, i, pv, pi, what: str, rtol: float = 1e-5) -> float:
    """Kernel (v, i) against the plain twin (pv, pi), rows of [Q, k+1]
    for the twin where k < D: values at rtol; ids equal wherever a value
    is more than rtol away from its neighbours (ties may permute).
    Returns the max abs error over finite values."""
    import numpy as np

    k = v.shape[1]
    both = np.isfinite(pv[:, :k])
    if not np.array_equal(np.isfinite(v), both) or not np.allclose(
            np.where(both, v, 0), np.where(both, pv[:, :k], 0), rtol=rtol,
            atol=0):
        raise AssertionError(f"{what}: values disagree with the plain twin")
    for q in range(v.shape[0]):
        row = pv[q]
        for j in range(k):
            near = lambda a, b: a == b or (np.isfinite(a) and np.isfinite(b)
                                           and abs(a - b) <= rtol * abs(b))
            tied = (j > 0 and near(row[j - 1], row[j])) or (
                j + 1 < row.shape[0] and near(row[j], row[j + 1]))
            if not tied and i[q, j] != pi[q, j]:
                raise AssertionError(
                    f"{what}: id at row {q} rank {j} is {i[q, j]}, plain "
                    f"twin has {pi[q, j]}")
    return float(np.max(np.abs(np.where(both, v - pv[:, :k], 0)),
                        initial=0.0))


def check_hits(got: dict, want: dict, what: str, rtol: float = 1e-5):
    """Two search responses: same total, scores at rtol, ids equal
    outside groups of near-equal scores."""
    import numpy as np

    if got["hits"]["total"] != want["hits"]["total"]:
        raise AssertionError(f"{what}: total {got['hits']['total']} != "
                             f"{want['hits']['total']}")
    g, w = got["hits"]["hits"], want["hits"]["hits"]
    if len(g) != len(w):
        raise AssertionError(f"{what}: {len(g)} hits != {len(w)}")
    if not g:
        return
    gv = np.array([[h["_score"] for h in g]], np.float64)
    wv = np.array([[h["_score"] for h in w] + [-np.inf]], np.float64)
    ids = {h["_id"]: n for n, h in enumerate(w + g)}
    gi = np.array([[ids[h["_id"]] for h in g]])
    wi = np.array([[ids[h["_id"]] for h in w] + [-1]])
    check_topk(gv, gi, wv, wi, what, rtol=rtol)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    from elasticsearch_tpu_torch.utils.device import is_hopper, resolve_device

    dev = resolve_device()
    line = card_line()
    cap = torch.cuda.get_device_capability(dev)
    log(f"[device] {line}; capability {cap[0]}.{cap[1]}; hopper "
        f"{is_hopper(dev)}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    return dev, line


def ptxas_usage(text: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] of each
    entry function in ``nvcc -Xptxas -v`` output, names demangled where
    ``c++filt`` exists."""
    rows, name, spill = [], None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.split("\n")
        for r, n in zip(rows, names):
            # knn_chunk_topk<8, 0>: the name and template arguments only
            r[0] = re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0]
    return [tuple(r) for r in rows]


def phase_build():
    from elasticsearch_tpu_torch.ops import build

    t0 = time.perf_counter()
    out = build.build_all()
    spilled = []
    for name, text in out.items():
        usage = ptxas_usage(text)
        log(f"[build] {name}: " + (" | ".join(
            f"{fn} {regs} registers, spill {st}/{ld} bytes"
            for fn, regs, st, ld in usage) or "cached"))
        spilled += [f"{name} {fn} ({st}/{ld} bytes)"
                    for fn, _, st, ld in usage if st or ld]
    if any(out.values()):  # a cached library prints nothing
        log("[build] spill stores/loads: " + (", ".join(spilled) or "none"))
    log(f"[build] {len(out)} libraries in {time.perf_counter() - t0:.1f} s")


def _b1_inputs(torch, dev, Q, F, D, seed, quant=None, prefix=0):
    """Seeded qw f32[Q, F] (idf-like), impact f32[F, D] (tfnorm-like,
    sparse), mask bool[D]; ``quant`` quantizes the impacts into heavy
    ties, ``prefix`` masks the first docs out."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qw = torch.rand(Q, F, generator=g, device=dev) * 3
    if quant is not None:
        impact = torch.round(torch.rand(F, D, generator=g, device=dev)
                             / quant) * quant
    else:
        keep = torch.rand(F, D, generator=g, device=dev) < 0.2
        impact = keep * torch.rand(F, D, generator=g, device=dev) * 2.2
    mask = torch.rand(D, generator=g, device=dev) > 0.2
    mask[:prefix] = False
    return qw.contiguous(), impact.contiguous(), mask.contiguous()


def phase_kernels(torch, dev) -> dict:
    """Max abs error of each kernel against its twin, by kernel name."""
    return {"bm25_dense_topk": _kernels_b1(torch, dev),
            "knn_topk": _kernels_b2(torch, dev),
            "adc_scores": _kernels_b3(torch, dev),
            "maxsim_adc": _kernels_b4(torch, dev)}


def _kernels_b1(torch, dev) -> float:
    """B1 against its twin, bit for bit with exact counts (the bf16
    products are exact in f32 and both sides add them in increasing row
    order; ties go to the lower doc id on both sides): the all-rows form
    and the rows form (rows of a whole 256-row block, pads at -1,
    repeated rows) with the hit count."""
    from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk

    def check(name, qw, impact, mask, k, rows=None, count=None):
        count = rows is not None if count is None else count
        got = bm25_dense_topk(qw, impact, mask, k=k, rows=rows, count=count)
        torch.cuda.synchronize()
        want = bm25_dense_topk(qw, impact, mask, k=k, rows=rows,
                               count=count, plain=True)
        what = (f"bm25_dense_topk {name} Q={qw.shape[0]} R={qw.shape[1]} "
                f"D={impact.shape[1]} k={k}")
        check_exact(got[0].cpu().numpy(), got[1].cpu().numpy(),
                    want[0].cpu().numpy(), want[1].cpu().numpy(), what)
        if count and not torch.equal(got[2], want[2]):
            raise AssertionError(f"{what}: hit counts {got[2].tolist()} vs "
                                 f"the twin's {want[2].tolist()}")
        log(f"[kernels] {what}: bit-equal to the plain twin"
            + (f", counts equal ({got[2].tolist()[:3]})" if count else ""))
        return got

    cases = [  # (name, Q, F, D, k, quant, masked prefix)
        ("single query", 1, 8, 1 << 20, 10, None, 0),
        ("k=1000", 1, 8, 1 << 20, 1000, None, 0),
        ("quantized ties, masked prefix", 16, 16, 4096, 10, 1.0, 600),
        ("batched", 256, 256, 1 << 20, 10, None, 0),
        # both sides of the running list (k <= 128), ragged D
        ("k=1", 1, 8, 70_001, 1, None, 0),
        ("k=32", 3, 8, 1_000_003, 32, None, 0),
        ("k=33", 1, 16, 1 << 20, 33, 0.5, 0),
        ("k=129", 2, 8, 300_000, 129, None, 0),
    ]
    for n, (name, Q, F, D, k, quant, prefix) in enumerate(cases):
        qw, impact, mask = _b1_inputs(torch, dev, Q, F, D, 100 + n, quant,
                                      prefix)
        check(name, qw, impact, mask, k)
        del qw, impact, mask
    # _msearch tier 1's shape: 2048 queries over all rows with the count,
    # weights on a few rows a query (D cut so the twin's [Q, D] fits)
    qw, impact, mask = _b1_inputs(torch, dev, 2048, 256, 1 << 16, 118)
    keep = torch.rand(qw.shape, generator=torch.Generator(
        device=dev).manual_seed(119), device=dev) < 4 / 256
    check("batched, msearch tier 1", (qw * keep).contiguous(), impact, mask,
          10, count=True)
    del qw, impact, mask, keep
    # one query row past a launch's 65,535: two launches whose rows stack
    # (D cut so the twin's [Q, D] fits)
    qw, impact, mask = _b1_inputs(torch, dev, 65_536, 16, 4096, 120)
    check("batched, past one launch (two launches)", qw, impact, mask, 10,
          count=True)
    del qw, impact, mask

    # the rows form over one whole block of 256 rows, as a segment holds
    _, block, mask = _b1_inputs(torch, dev, 1, 256, 1 << 20, 121)

    def pick(R, Q=1, pads=0, repeat=False, seed=0):
        gg = torch.Generator(device=dev).manual_seed(130 + seed)
        rows = torch.randperm(256, generator=gg, device=dev)[:R]
        if repeat:
            rows[R // 2:] = rows[:R - R // 2]
        rows = rows.to(torch.int32)
        if pads:  # pads at -1 and outside the block, anywhere in the list
            at = torch.randperm(R, generator=gg, device=dev)[:pads]
            rows[at] = torch.tensor([(-1, 256, -7, 1000)[i % 4]
                                     for i in range(pads)],
                                    dtype=torch.int32, device=dev)
        qw = torch.rand(Q, R, generator=gg, device=dev) * 3
        return qw.contiguous(), rows.contiguous()

    for n, (R, Q, pads, repeat, k) in enumerate((
            (1, 1, 0, False, 10), (3, 1, 1, False, 10), (8, 1, 0, False, 10),
            (8, 1, 3, False, 10), (16, 1, 4, True, 10), (16, 1, 0, False, 100),
            (5, 1, 2, False, 1000), (16, 9, 3, False, 10),
            (256, 1, 0, False, 10))):
        qw, rows = pick(R, Q, pads, repeat, n)
        check(f"rows form ({pads} pads{', repeated rows' if repeat else ''})",
              qw, block, mask, k, rows)
    del block
    # ragged D (the scalar loads) and quantized ties, in the rows form
    qw, impact, mask = _b1_inputs(torch, dev, 2, 12, 1_000_003, 140, 0.5, 77)
    rows = torch.tensor([3, -1, 0, 11, 5, 5], dtype=torch.int32, device=dev)
    check("rows form, ragged D, quantized ties", qw[:, :6].contiguous(),
          impact, mask, 10, rows)
    # f32 subnormals: their bf16 rounding is 0, their hits still count
    impact = torch.zeros(4, 1 << 16, device=dev)
    impact[1, ::7] = 2.0 ** -140
    impact[2, ::5] = 1.5
    mask = torch.ones(1 << 16, dtype=torch.bool, device=dev)
    qw = torch.ones(1, 3, device=dev)
    rows = torch.tensor([1, -1, 2], dtype=torch.int32, device=dev)
    got = check("subnormal impacts", qw, impact, mask, 10, rows)
    want = len(set(range(0, 1 << 16, 7)) | set(range(0, 1 << 16, 5)))
    if int(got[2][0]) != want:
        raise AssertionError(f"bm25_dense_topk subnormal hits: "
                             f"{int(got[2][0])} counted, {want} expected")
    del qw, impact, mask
    torch.cuda.empty_cache()
    _kernels_b1_tensor_cores(torch, dev, check)
    return 0.0


def _kernels_b1_tensor_cores(torch, dev, check):
    """The batched form's tensor-core pass (csrc/bm25_tc.cuh), whose
    tensor-core sums only pick candidates for exact sums: cases aimed at
    that filter, each bit-equal to the twin with equal counts, with the
    docs each query rescored exactly, and the built kernel's plan held to
    its invariants. Ties at the top, sums whose order moves the last bits,
    weights below the normal range against large impacts, ragged Q, F and
    D on both sides of the small-Q threshold and of the running lists
    (k = 128 | 129), an unaligned block (no tensor copies), fewer live
    docs than k, all docs tied, and two threads launching at once."""
    from elasticsearch_tpu_torch.ops.bm25_topk import (
        SMEM_LIMIT, TC_MAX_F, TC_MAX_K, TC_MIN_Q, bm25_dense_topk_rescored,
        kernel_plan, unpack_topk)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan_holds(name, Q, F, D, k):
        """The built kernel's plan: the tensor-core pass exactly from
        TC_MIN_Q queries (F <= TC_MAX_F, k <= TC_MAX_K), a query tile of
        64 rows up to 64 queries and of 128 past that, the grid within the
        SMs, shared memory within a block's, a tile's slots and one more,
        and at the batched caller's k the running lists in shared memory."""
        p = kernel_plan(Q, F, D, k)
        takes = Q >= TC_MIN_Q and F <= TC_MAX_F and k <= TC_MAX_K
        nqt = -(-Q // (64 if Q <= 64 else 128))
        if (p is not None) != takes or p is not None and not (
                p["QT"] == (64 if Q <= 64 else 128)
                and p["query_tiles"] == nqt
                and 1 <= p["G"] <= p["tiles"]
                and p["G"] * nqt <= max(sms, nqt)
                and p["smem"] <= SMEM_LIMIT
                and p["values_stages"] >= p["stages"] + 1
                and (k > 10 or p["lists_in_smem"])):
            raise AssertionError(f"bm25_dense_topk {name}: the kernel's "
                                 f"plan {p} breaks its invariants")
        return p

    def tc_check(name, qw, impact, mask, k):
        Q, F = qw.shape
        D = impact.shape[1]
        got = check(name, qw, impact, mask, k, count=True)
        plan = plan_holds(name, Q, F, D, k)
        if plan is None:
            log(f"[kernels]   {name}: CUDA-core pass (Q < {TC_MIN_Q}, F > "
                f"{TC_MAX_F} or k > {TC_MAX_K})")
            return
        buf, resc = bm25_dense_topk_rescored(qw, impact, mask, k=k)
        v, i, t = unpack_topk(buf, k)
        if not (torch.equal(v.view(torch.int32), got[0].view(torch.int32))
                and torch.equal(i, got[1]) and torch.equal(t, got[2])):
            raise AssertionError(f"bm25_dense_topk {name}: the counted "
                                 f"launch differs from the plain one")
        r = resc.double()
        log(f"[kernels]   {name}: tensor-core pass, QT={plan['QT']} "
            f"G={plan['G']} smem={plan['smem']} B; rescored a query mean "
            f"{r.mean().item():.1f} max {int(r.max())} of {D} docs")

    # a tie-heavy top: quantized impacts, each query's weights equal
    qw, impact, mask = _b1_inputs(torch, dev, 256, 256, 1 << 20, 150, 1.0)
    tc_check("tie-heavy top", qw[:, :1].expand(-1, 256).contiguous(), impact,
             mask, 10)
    del qw, impact, mask
    # order-sensitive sums: impacts near 2^10 and 2^-10 in one doc, weights
    # from 2^-8 to 2^8, so that summation orders differ in the last bits
    g = torch.Generator(device=dev).manual_seed(151)
    big = torch.rand(256, 1 << 18, generator=g, device=dev) < 0.5
    impact = (torch.where(big, 2.0 ** 10, 2.0 ** -10)
              * (1 + torch.rand(256, 1 << 18, generator=g, device=dev)))
    qw = 2.0 ** (torch.rand(64, 256, generator=g, device=dev) * 16 - 8)
    mask = torch.rand(1 << 18, generator=g, device=dev) > 0.1
    tc_check("order-sensitive sums", qw.contiguous(), impact.contiguous(),
             mask, 10)
    del qw, impact, mask, big
    # weights below the normal range (bf16 keeps a few bits of them)
    # against impacts near 2^24: should the tensor cores flush such a
    # weight, its row's loss is up to 2^-126 M, which the margin covers
    keep = torch.rand(256, 1 << 18, generator=g, device=dev) < 0.5
    impact = keep * (2.0 ** 24 * (1 + torch.rand(256, 1 << 18, generator=g,
                                                 device=dev)))
    qw = ((torch.rand(64, 256, generator=g, device=dev) < 0.75)
          * 2.0 ** (-133 + 7 * torch.rand(64, 256, generator=g, device=dev)))
    mask = torch.rand(1 << 18, generator=g, device=dev) > 0.1
    tc_check("subnormal weights, large impacts", qw.contiguous(),
             impact.contiguous(), mask, 10)
    del qw, impact, mask, keep
    # ragged edges: (Q, F, D, k, masked prefix); D no multiple of the 64-doc
    # tile and, odd, no 16-byte row pitch (4-byte copies, no tensor copies)
    for n, (Q, F, D, k, prefix) in enumerate((
            (1, 12, 5003, 10, 0), (7, 200, 70_001, 10, 0),
            (8, 200, 70_001, 10, 0), (9, 12, 4099, 1, 0),
            (63, 256, 1_000_003, 128, 0), (65, 200, 131_075, 129, 0),
            (257, 256, 65_539, 1000, 0), (257, 256, 262_147, 10, 262_140),
            (65, 12, 301, 10, 296), (9, 256, 100_003, 1, 99_990))):
        qw, impact, mask = _b1_inputs(torch, dev, Q, F, D, 160 + n, None,
                                      prefix)
        tc_check(f"ragged Q={Q} F={F} D={D} k={k}"
                 + (f" {D - prefix} docs unmasked" if prefix else ""),
                 qw, impact, mask, k)
        del qw, impact, mask
    # a block whose rows start off 16-byte alignment (D a multiple of 4)
    g = torch.Generator(device=dev).manual_seed(171)
    flat = torch.rand(64 * 65536 + 1, generator=g, device=dev)
    impact = flat[1:].view(64, 65536)
    qw = torch.rand(32, 64, generator=g, device=dev)
    mask = torch.rand(65536, generator=g, device=dev) > 0.2
    tc_check("block off 16-byte alignment", qw, impact, mask, 10)
    del flat, impact, qw, mask
    # every doc tied: each live doc is a candidate and rescored
    qw = torch.full((64, 64), 1.5, device=dev)
    impact = torch.ones(64, 1 << 16, device=dev)
    mask = torch.rand(1 << 16, generator=g, device=dev) > 0.3
    tc_check("all docs tied", qw, impact, mask, 10)
    del qw, impact, mask
    torch.cuda.empty_cache()
    _b1_threads(torch, dev)


def _b1_threads(torch, dev, iters: int = 400) -> None:
    """Two threads launch the batched form at once, ``iters`` times each,
    at shapes whose plans differ (Q=32: one 64-row query tile; Q=1,024:
    128-row tiles, more shared memory), as the REST pool and the coalescer
    do; the library is called through ctypes, which lets the GIL go, so
    both are inside it together. Every launch must succeed and equal the
    twin (a launch must not find the shared-memory cap another thread's
    plan set)."""
    import threading

    from elasticsearch_tpu_torch.ops.bm25_topk import (bm25_dense_topk,
                                                       kernel_plan)

    F, D, k = 256, 1 << 16, 10
    _, impact, mask = _b1_inputs(torch, dev, 1, F, D, 180)
    g = torch.Generator(device=dev).manual_seed(181)
    qws, want, smem = {}, {}, {}
    for Q in (32, 1024):
        qws[Q] = (torch.rand(Q, F, generator=g, device=dev) * 3).contiguous()
        want[Q] = bm25_dense_topk(qws[Q], impact, mask, k=k, count=True,
                                  packed=True, plain=True)
        p = kernel_plan(Q, F, D, k)
        if p is None:
            raise AssertionError(f"bm25_dense_topk threads: Q={Q} is not on "
                                 f"the tensor-core pass")
        smem[Q] = p["smem"]
    outs = {Q: [] for Q in qws}
    errs = []

    def run(Q):
        try:
            for _ in range(iters):
                outs[Q].append(bm25_dense_topk(qws[Q], impact, mask, k=k,
                                               count=True, packed=True))
        except Exception as e:  # raised below
            errs.append(f"Q={Q} after {len(outs[Q])} launches: {e}")

    threads = [threading.Thread(target=run, args=(Q,)) for Q in qws]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    torch.cuda.synchronize()
    if errs or any(th.is_alive() for th in threads):
        raise AssertionError(f"bm25_dense_topk, two threads at once: {errs}")
    for Q, got in outs.items():
        bad = sum(not torch.equal(o, want[Q]) for o in got)
        if bad:
            raise AssertionError(f"bm25_dense_topk, two threads at once: "
                                 f"Q={Q}: {bad} of {iters} results differ "
                                 f"from the twin")
    log(f"[kernels]   two threads at once, Q=32 (smem {smem[32]} B) and "
        f"Q=1024 (smem {smem[1024]} B), {iters} launches each: every one "
        f"bit-equal to the twin with equal counts")


def check_exact(v, i, pv, pi, what: str) -> float:
    """Kernel (v, i) against its twin (pv, pi): the same bits and (unless
    the ids are None) the same ids in every slot. Returns the max abs
    error (0)."""
    import numpy as np

    if v.shape != pv.shape:
        raise AssertionError(f"{what}: shape {v.shape} != {pv.shape}")
    if not np.array_equal(v.view(np.uint32), pv.view(np.uint32)):
        bad = np.argwhere(v.view(np.uint32) != pv.view(np.uint32))
        raise AssertionError(f"{what}: values differ from the plain twin at "
                             f"{bad[:3].tolist()}: {v[tuple(bad[0])]} vs "
                             f"{pv[tuple(bad[0])]}")
    if i is not None and not np.array_equal(i, pi):
        bad = np.argwhere(i != pi)
        raise AssertionError(f"{what}: ids differ from the plain twin at "
                             f"{bad[:3].tolist()}")
    return 0.0


def _b2_inputs(torch, dev, Q, D, dims, seed, live=0.9, quant=None):
    """Seeded queries f32[Q, dims], slab f32[D, dims], mask bool[D];
    ``quant`` rounds the vectors to multiples of it (heavy ties)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(Q, dims, generator=g, device=dev)
    v = torch.randn(D, dims, generator=g, device=dev)
    if quant is not None:
        q = torch.round(q / quant) * quant
        v = torch.round(v / quant) * quant
    mask = torch.rand(D, generator=g, device=dev) < live
    return q.contiguous(), v.contiguous(), mask.contiguous()


def _kernels_b2(torch, dev) -> float:
    """B2 against its twin, bit for bit in both precisions: each sum runs
    in increasing dims with one rounding per operation on both sides."""
    from elasticsearch_tpu_torch.ops.knn_topk import knn_topk
    from elasticsearch_tpu_torch.utils import shapes

    ks = (1, 10, 100, 1000)
    cases = []  # (name, Q, D, dims, k, metric, precise, live, quant)
    for c, (metric, precise) in enumerate(
            (m, p) for m in ("cosine", "dot_product", "l2_norm")
            for p in (False, True)):
        for j, k in enumerate(ks):
            cases.append((f"{metric} {'f32' if precise else 'bf16'}",
                          (1, 8)[j % 2], (1 << 20, 1_000_003)[(j + c) % 2],
                          (128, 100)[(j // 2) % 2], k, metric, precise, 0.9,
                          None))
    cases += [("quantized ties", 8, 1 << 20, 128, 100, "dot_product", True,
               0.9, 0.5),
              ("4-byte staging (dims % 4 != 0)", 1, 1 << 20, 37, 10,
               "l2_norm", True, 0.9, None),
              ("90% masked", 1, 1 << 20, 128, 100, "cosine", False, 0.1,
               None)]
    # the staging plan's edges: each bit-equal too
    cases += [("D smaller than one chunk", 3, 1000, 128, 10, "cosine", True,
               0.9, None),
              ("Q=9, a partial group of 8", 9, 1 << 20, 128, 100, "cosine",
               True, 0.9, None),
              # _msearch's kNN and MaxSim batches: Q * T rows at k = 100
              ("msearch kNN batch", 32, 1 << 20, 128, 100, "cosine", True,
               1.0, None),
              ("msearch MaxSim batch", 64, 1 << 20, 128, 100, "cosine",
               True, 1.0, None),
              # 2048 MaxSim bodies of 32 tokens: one row past a launch's
              # 65,535, two launches (D cut so the twin's [Q, D] fits)
              ("msearch MaxSim batch past one launch (two launches)",
               65_536, 4096, 128, 100, "cosine", True, 1.0, None),
              # key lists past the scratch budget: launches of 24 rows
              ("msearch MaxSim batch on a 24-row scratch budget (three "
               "launches)", 64, 1 << 20, 128, 100, "cosine", True, 1.0,
               "budget"),
              ("wide rows, 8 per stage", 8, 100_003, 1024, 100,
               "dot_product", False, 0.9, None),
              # rings of fewer than 32 rows: groups that share a warp
              # wait on each other's stages (blocks walk two chunks at 768)
              ("wide rows, 4 per stage", 1, 600_000, 768, 100, "cosine",
               True, 0.9, None),
              ("wide rows, 4 per stage", 1, 50_000, 1024, 10, "l2_norm",
               True, 0.9, None),
              ("wide rows, 2 per stage", 1, 50_000, 1536, 100, "cosine",
               False, 0.9, None),
              ("wide rows, 4 per stage", 8, 300_000, 2048, 100, "cosine",
               True, 0.9, None),
              ("wide rows, 2 per stage", 8, 40_000, 4096, 10,
               "dot_product", True, 0.9, None),
              ("rows too wide to stage", 2, 3000, 40_000, 10, "l2_norm",
               True, 0.9, None),
              ("slab one float off 16-byte alignment", 1, 1 << 20, 128, 100,
               "cosine", True, 0.9, "offset"),
              ("zero rows (the 1e-12 clamp)", 1, 65_536, 128, 100, "cosine",
               True, 0.9, "zero")]
    for n, (name, Q, D, dims, k, metric, precise, live, quant) in \
            enumerate(cases):
        tweak = quant if isinstance(quant, str) else None
        q, v, mask = _b2_inputs(torch, dev, Q, D, dims, 200 + n, live,
                                None if tweak else quant)
        if tweak == "offset":  # a contiguous view one float into its buffer
            buf = torch.empty(D * dims + 1, device=dev)
            buf[1:] = v.reshape(-1)
            v = buf[1:].view(D, dims)
        elif tweak == "zero":  # every score below 0.5 but the zero rows'
            q, v = q.abs(), -v.abs()
            v[::97] = 0.0
        budget = shapes.TOPK_SCRATCH_BYTES
        if tweak == "budget":  # two u64 buffers of D / 2048 lists of k
            shapes.TOPK_SCRATCH_BYTES = 24 * 16 * (D // 2048) * k
        try:
            want = (3 if tweak == "budget"
                    else -(-Q // shapes.MAX_QUERY_ROWS))
            if len(shapes.query_slices(Q, D, k)) != want:
                raise AssertionError(f"knn_topk {name}: launches "
                                     f"{shapes.query_slices(Q, D, k)}")
            kv, ki = knn_topk(q, v, mask, k=k, metric=metric,
                              precise=precise)
            torch.cuda.synchronize()
        finally:
            shapes.TOPK_SCRATCH_BYTES = budget
        pv, pi = knn_topk(q, v, mask, k=k, metric=metric, precise=precise,
                          plain=True)
        check_exact(kv.cpu().numpy(), ki.cpu().numpy(), pv.cpu().numpy(),
                    pi.cpu().numpy(), f"knn_topk {name} Q={Q} D={D} "
                                      f"dims={dims} k={k}")
        log(f"[kernels] knn_topk {name} Q={Q} D={D} dims={dims} k={k}: "
            f"bit-equal to the plain twin")
        del q, v, mask, kv, ki, pv, pi
    torch.cuda.empty_cache()
    return 0.0


def _kernels_b3(torch, dev) -> float:
    """B3 against its twin, bit for bit (one f32 add per m, in order): the
    table-sum form, and the fused form over a whole code table with
    probed candidates (pads, filters, tables off 16-byte alignment,
    byte-path widths)."""
    from elasticsearch_tpu_torch.ops.adc import adc_scores
    from elasticsearch_tpu_torch.ops.bitvec import pack_mask

    def check(what, codes, lut, cand=None, words=None):
        out = adc_scores(codes, lut, cand=cand, filter_words=words)
        torch.cuda.synchronize()
        want = adc_scores(codes, lut, cand=cand, filter_words=words,
                          plain=True)
        check_exact(out.cpu().numpy(), None, want.cpu().numpy(), None,
                    f"adc_scores {what}")
        log(f"[kernels] adc_scores {what}: bit-equal to the plain twin"
            + ("" if cand is None else
               f" ({int(torch.isfinite(out).sum())} of {out.numel()} "
               f"slots live)"))

    def table(n, N, M, K, misalign=False):
        g = torch.Generator(device=dev).manual_seed(300 + n)
        codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                              dtype=torch.int64).to(torch.uint8)
        if misalign:  # a contiguous view one byte into its buffer
            buf = torch.empty(N * M + 1, dtype=torch.uint8, device=dev)
            buf[1:] = codes.reshape(-1)
            codes = buf[1:].view(N, M)
        return codes, torch.randn(M, K, generator=g, device=dev), g

    n = 0
    for W in (1000, 65_536, 1 << 20):
        for M in (8, 32):
            for K in (16, 256):
                codes, lut, _ = table(n, W, M, K)
                check(f"W={W} M={M} K={K}", codes, lut)
                n += 1

    def probed(g, N, W, live):
        """W slots of IVF-shaped lists: runs of ids, the rest pads."""
        cand = torch.full((W,), N, dtype=torch.int32, device=dev)
        real = torch.rand(W, generator=g, device=dev) < live
        cand[real] = torch.randint(0, N, (int(real.sum()),), generator=g,
                                   device=dev, dtype=torch.int32)
        return cand

    N = 1 << 20
    for what, M, K, W, live, filt, mis in (
            ("IVF-PQ slots, 12% live", 32, 256, 81_920, 0.12, None, False),
            ("filter at 10%", 32, 256, 81_920, 0.12, 0.1, False),
            ("filter at 0%", 32, 256, 81_920, 0.12, 0.0, False),
            ("every slot padded", 32, 256, 81_920, 0.0, None, False),
            ("W=1", 32, 256, 1, 1.0, None, False),
            ("codes off 16-byte alignment", 32, 256, 81_920, 0.12, 0.5, True),
            ("M=20 (byte path)", 20, 256, 40_000, 0.5, 0.5, False),
            ("M=64", 64, 256, 40_000, 0.5, None, False),
            ("M=8 K=16", 8, 16, 40_000, 0.5, 0.3, False)):
        codes, lut, g = table(n, N, M, K, mis)
        cand = probed(g, N, W, live)
        words = None
        if filt is not None:
            words = pack_mask(torch.rand(N, generator=g, device=dev) < filt)
        check(f"fused, {what} N={N} W={W} M={M} K={K}", codes, lut, cand,
              words)
        n += 1
    # ids below 0 are pads too; a filter without candidates
    codes, lut, g = table(n, 4096, 32, 256)
    cand = torch.randint(-50, 4200, (3000,), generator=g, device=dev,
                         dtype=torch.int32)
    check("fused, ids outside [0, N)", codes, lut, cand)
    check("filter without candidates", codes, lut, None,
          pack_mask(torch.rand(4096, generator=g, device=dev) < 0.5))
    del codes, lut, cand
    torch.cuda.empty_cache()
    return 0.0


def check_exact_nan(v, pv, what: str) -> float:
    """Kernel values against the twin's: NaN in the same places, the same
    bits everywhere else (a NaN's payload may differ). Returns 0."""
    import numpy as np

    nan = np.isnan(v)
    if v.shape != pv.shape or not np.array_equal(nan, np.isnan(pv)):
        raise AssertionError(f"{what}: NaN places differ from the plain twin")
    return check_exact(v[~nan], None, pv[~nan], None, what)


def _kernels_b4(torch, dev) -> float:
    """B4 against its twin, bit for bit (per token one f32 add per m in
    order, then the max with torch.maximum's NaN rule), over the
    re-rank's shapes, LUTs that lean negative (the l2 form), a NaN, a
    code array off 16-byte alignment and rows wider than 32 codes."""
    from elasticsearch_tpu_torch.ops.maxsim_adc import maxsim_adc

    def run(n, W, M, K, T, what, nan=False, misalign=False):
        g = torch.Generator(device=dev).manual_seed(400 + n)
        codes = torch.randint(0, K, (W, M), generator=g, device=dev,
                              dtype=torch.int64).to(torch.uint8)
        if misalign:  # a contiguous view one byte into its buffer
            buf = torch.empty(W * M + 1, dtype=torch.uint8, device=dev)
            buf[1:] = codes.reshape(-1)
            codes = buf[1:].view(W, M)
        luts = torch.randn(T, M, K, generator=g, device=dev) - 1.5
        if nan:
            luts[T // 2, M // 2, codes[W // 2, M // 2].long()] = float("nan")
        out = maxsim_adc(codes, luts)
        torch.cuda.synchronize()
        want = maxsim_adc(codes, luts, plain=True)
        check_exact_nan(out.cpu().numpy(), want.cpu().numpy(),
                        f"maxsim_adc {what} W={W} M={M} K={K} T={T}")
        if nan and not bool(torch.isnan(out).any()):
            raise AssertionError("maxsim_adc dropped the NaN sum")

    n = 0
    for W in (1, 100, 4097, 10_000, 81_920):
        for M in (32, 16, 1):
            for K in (256, 64):
                for T in (1, 8, 32, 64, 100):
                    run(n, W, M, K, T, "grid")
                    n += 1
        log(f"[kernels] maxsim_adc W={W}, M in (32, 16, 1), K in (256, 64),"
            f" T in (1, 8, 32, 64, 100): bit-equal to the plain twin")
    extra = [(4097, 32, 256, 32, "NaN in one token's table", True, False),
             (10_000, 32, 256, 32, "codes off 16-byte alignment", False,
              True),
             (4097, 64, 256, 8, "rows of 64 codes", False, False),
             (100, 33, 64, 5, "rows of 33 codes", False, False),
             (300, 3, 255, 7, "tables of an odd width", False, False),
             # the token groups' edges
             (1, 32, 256, 32, "a single candidate", False, False),
             (100, 32, 256, 33, "NaN in a token of a later group", True,
              False),
             (4097, 32, 255, 32, "K=255 with M=32", False, False)]
    for W, M, K, T, what, nan, mis in extra:
        run(n, W, M, K, T, what, nan, mis)
        n += 1
        log(f"[kernels] maxsim_adc {what} W={W} M={M} K={K} T={T}: "
            f"bit-equal to the plain twin")
    return 0.0


WRITE_MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
}}


def _write_docs(np):
    rng = np.random.default_rng(SEED)
    words = ("quick brown fox jumps over lazy dog river mountain valley "
             "ocean forest desert island search engine index query shard "
             "segment score token running runner alpha bravo charlie "
             "delta echo golf hotel kilo lima").split()
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    return [(f"w{i}", {"body": " ".join(rng.choice(words, int(
        rng.integers(5, 20)), p=p)), "tag": f"t{i % 9}",
        "n": int(rng.integers(0, 10_000))}) for i in range(2000)]


def phase_write(torch, np, dev):
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.search import queries

    docs = _write_docs(np)
    nodes = [Node(name="card", device=dev), Node(name="host", device="cpu")]
    for node in nodes:
        node.create_index("w", {"settings": {"number_of_shards": 2},
                                "mappings": WRITE_MAPPING})
        for doc_id, src in docs:
            node.index("w", doc_id, src)
        node.refresh("w")
    bodies = {
        "match": {"query": {"match": {"body": "quick brown fox"}}},
        "match_tail": {"query": {"match": {"body": "kilo lima echo"}}},
        "term": {"query": {"term": {"tag": "t3"}}, "size": 5},
        "bool_range": {"query": {"bool": {
            "must": [{"match": {"body": "river ocean"}}],
            "filter": [{"range": {"n": {"gte": 1000, "lt": 6000}}}]}}},
        "paged": {"query": {"match": {"body": "lazy dog jumps"}},
                  "from": 10, "size": 10},
    }
    fused0 = queries.FUSED_CALLS
    for name, body in bodies.items():
        card, host = (n.search("w", dict(body)) for n in nodes)
        if not card["hits"]["hits"]:
            raise AssertionError(f"write path {name}: no hits")
        check_hits(card, host, f"write path {name}")
    if queries.FUSED_CALLS == fused0:
        raise AssertionError("write path: no query took the fused path")
    body = {"query": {"match": {"body": "kilo lima echo"}}, "size": 3}
    victim = nodes[0].search("w", body)["hits"]["hits"][0]["_id"]
    for node in nodes:
        node.delete("w", victim)
        node.refresh("w")
    card, host = (n.search("w", dict(body)) for n in nodes)
    if victim in [h["_id"] for h in card["hits"]["hits"]] \
            or nodes[0].get("w", victim)["found"]:
        raise AssertionError("deleted doc still found")
    check_hits(card, host, "write path after delete")
    for node in nodes:
        node.close()
    log(f"[write] 2000 docs, 2 shards: {len(bodies)} bodies agree with the "
        f"CPU node, fused path taken, delete vanishes")


_TOKENS: dict = {}


def corpus_tokens(np, n_docs, vocab, seed):
    """bench.py::build_corpus's token stream: (doc lengths, ~60 each, and
    every doc's Zipf(1.15) term ids in order). Generated once a process
    and shared, read-only, by the phases that read it (5, 5i, 5t)."""
    key = (n_docs, vocab, seed)
    if key not in _TOKENS:
        rng = np.random.default_rng(seed)
        doc_len = np.clip(rng.normal(60, 15, n_docs), 20, 120).astype(
            np.int64)
        nnz_tok = int(doc_len.sum())
        terms = rng.zipf(1.15, nnz_tok).astype(np.int64)
        terms = np.where(terms >= vocab, rng.integers(1, vocab, nnz_tok),
                         terms)
        doc_len.setflags(write=False)
        terms.setflags(write=False)
        _TOKENS[key] = (doc_len, terms)
    return _TOKENS[key]


def build_corpus(np, n_docs, vocab, seed):
    """bench.py::build_corpus's recipe: ~60-token passages, Zipf(1.15)
    vocabulary, term-major postings CSR with BM25 tf-normalization."""
    k1, b = 1.2, 0.75
    doc_len, terms = corpus_tokens(np, n_docs, vocab, seed)
    docs = np.repeat(np.arange(n_docs, dtype=np.int64), doc_len)
    uniq, tf = np.unique(terms * n_docs + docs, return_counts=True)
    u_term = (uniq // n_docs).astype(np.int32)
    u_doc = (uniq % n_docs).astype(np.int32)
    df = np.bincount(u_term, minlength=vocab).astype(np.int32)
    cf = np.bincount(u_term, weights=tf, minlength=vocab).astype(np.int64)
    offsets = np.zeros(vocab + 1, np.int64)
    offsets[1:] = np.cumsum(df)
    avg = doc_len.mean()
    tfn = (tf * (k1 + 1) / (tf + k1 * (1 - b + b * doc_len[u_doc] / avg))
           ).astype(np.float32)
    return u_doc, tf.astype(np.float32), tfn, offsets, df, cf, doc_len


def make_queries(np, n_q, vocab, df, seed, terms_per_q=4, dense_only=None):
    """bench.py::make_queries's recipe: 2-4 Zipf(1.3) term ids each; with
    ``dense_only`` (bool[vocab]) drawn from those terms instead."""
    rng = np.random.default_rng(seed + 1)
    qs = []
    pool = np.nonzero(dense_only)[0] if dense_only is not None else None
    for _ in range(n_q):
        npick = rng.integers(2, terms_per_q + 1)
        if pool is not None:
            t = rng.choice(pool, size=npick, replace=False)
        else:
            t = rng.zipf(1.3, npick).astype(np.int64)
            t = np.where((t >= vocab) | (df[np.clip(t, 0, vocab - 1)] == 0),
                         rng.integers(1, vocab, npick), t)
        qs.append(np.unique(t))
    return qs


def exact_top10(np, q, u_doc, tfn, offsets, df, n_docs, D):
    """Independent f64 BM25 over the CSR: (ids, scores, total)."""
    s = np.zeros(D)
    hit = np.zeros(D, bool)
    for t in q:
        lo, hi = offsets[t], offsets[t + 1]
        idf = np.log(1.0 + (n_docs - df[t] + 0.5) / (df[t] + 0.5))
        s += np.bincount(u_doc[lo:hi], weights=tfn[lo:hi] * idf,
                         minlength=D)
        hit[u_doc[lo:hi]] = True
    total = int(hit.sum())
    order = top_desc(np, np.where(hit, s, -np.inf), min(10, total))
    return order, s[order], total


def text_field(np, corpus):
    """``segment_from_arrays``'s entry for the corpus's text field."""
    u_doc, tf, tfn, offsets, df, cf, doc_len = corpus
    return {"terms": [f"t{t}" for t in range(VOCAB)], "df": df, "cf": cf,
            "offsets": offsets, "doc_ids_host": u_doc, "tfnorm_host": tfn,
            "tf_host": tf, "avg_len": float(doc_len.mean()),
            "num_docs": N_DOCS, "total_terms": int(doc_len.sum()),
            "lengths": doc_len.astype(np.float32)}


def phase_read(torch, np, dev, card, corpus):
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    u_doc, tf, tfn, offsets, df, cf, doc_len = corpus
    D = N_DOCS  # pow2_bucket(2^20) == 2^20
    arrays = {"num_docs": N_DOCS, "max_docs": D,
              "fields": {"body": text_field(np, corpus)}}
    node = Node(name="msmarco", device=dev)
    node.create_index("msmarco", {
        "settings": {"number_of_shards": 1},
        "mappings": {"properties": {"body": {"type": "text"}}}})
    seg = segment_from_arrays(arrays, node.residency)
    node.get_index("msmarco").shards[0].engine.add_segment(seg)
    rows, impact = seg.inverted["body"].dense_block()
    torch.cuda.synchronize()
    log(f"[read] corpus {N_DOCS} docs, vocab {VOCAB}, {u_doc.size} "
        f"postings; dense block {tuple(impact.shape)} f32 = "
        f"{impact.numel() * 4 / 2**20:.0f} MiB ({int((rows >= 0).sum())} "
        f"terms); set-up {time.perf_counter() - t0:.1f} s")

    qs = make_queries(np, N_QUERIES, VOCAB, df, SEED)
    bodies = [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
               "size": 10} for q in qs]
    node.search("msmarco", dict(bodies[0]))  # first-use set-up, untimed

    bm25_topk.LAUNCHES = 0
    fused0 = queries.FUSED_CALLS
    times, got, took_fused = [], [], []
    for body in bodies:
        f = queries.FUSED_CALLS
        t = time.perf_counter()
        got.append(node.search("msmarco", dict(body)))
        times.append(time.perf_counter() - t)
        took_fused.append(queries.FUSED_CALLS > f)
    launches = bm25_topk.LAUNCHES
    fused = queries.FUSED_CALLS - fused0
    if launches == 0:
        raise AssertionError("the main path launched no bm25_dense_topk")

    # the same searches with the kernel swapped for its plain twin
    real = queries.bm25_dense_topk
    queries.bm25_dense_topk = functools.partial(real, plain=True)
    try:
        for n, body in enumerate(bodies):
            check_hits(got[n], node.search("msmarco", dict(body)),
                       f"read query {n} vs plain twin")
    finally:
        queries.bm25_dense_topk = real
    # and against an exact f64 scorer: the fused path rounds both factors
    # of each product to bf16 (8 significant bits, each rounding within
    # 2^-8 relative), so a sum of positive products is within 2^-7
    recalls = []
    for n, q in enumerate(qs):
        ids, sc, total = exact_top10(np, q, u_doc, tfn, offsets, df,
                                     N_DOCS, D)
        hits = got[n]["hits"]["hits"]
        if got[n]["hits"]["total"] != total or len(hits) != len(ids):
            raise AssertionError(f"read query {n}: total/size disagree "
                                 f"with the exact scorer")
        s = np.array([h["_score"] for h in hits])
        if not (np.all(np.isfinite(s)) and np.all(np.diff(s) <= 0)
                and np.allclose(s, sc, rtol=2.0 ** -7, atol=0)):
            raise AssertionError(f"read query {n}: scores off the exact "
                                 f"scorer: {s} vs {sc}")
        recall = len({int(h["_id"]) for h in hits} & set(ids.tolist())) \
            / len(ids)
        recalls.append(recall)
    # the reference's bar for its kernel: mean recall@k >= 0.95
    if np.mean(recalls) < 0.95:
        raise AssertionError(f"read path mean recall@10 {np.mean(recalls)}"
                             f" < 0.95")
    ms = np.array(times) * 1e3
    fz = np.array(took_fused)
    log(f"[read] {N_QUERIES} match queries through Node.search on {card}: "
        f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
        f"{np.percentile(ms, 99):.3f} ms (fused path {fused} of "
        f"{N_QUERIES}: p50 {_p50(np, ms[fz])}; generic: p50 "
        f"{_p50(np, ms[~fz])}); bm25_dense_topk "
        f"launches {launches}; hits equal the plain twin's; recall@10 vs "
        f"exact f64: mean {np.mean(recalls)}, min {min(recalls)}")
    profile_read(torch, node, "msmarco", bodies, float(ms.sum()), "read")
    # one fused query's device work through Node.search (the mesh path,
    # S = 1): one copy in, B1's two launches, one copy back. "from": 0
    # makes the body new to the prepared-query memo, so its tables are
    # built and copied as a first request's are
    fresh = dict(bodies[took_fused.index(True)], **{"from": 0})
    ops = device_ops(torch, lambda: node.search("msmarco", dict(fresh)))
    if ops is None:
        log("[read] a fused query's device ops: not measured (the profiler "
            "recorded none)")
    else:
        kernels = {k: c for k, c in ops.items()
                   if not k.startswith(("Memcpy", "Memset"))}
        if sorted(c for k, c in kernels.items() if "bm25_" in k) != [1, 1] \
                or len(kernels) != 2 \
                or sum(c for k, c in ops.items() if "HtoD" in k) != 1 \
                or sum(c for k, c in ops.items() if "DtoH" in k) != 1:
            raise AssertionError(f"a fused query ran {ops}, where one copy "
                                 f"in, B1's two launches and one copy back "
                                 f"were expected")
        log(f"[read] one fused query's device ops through the mesh path: "
            + "; ".join(f"{k[:48]} x{c}" for k, c in ops.items()))
    return launches, node  # phase 5e reads the same index


# ---------------------------------------------------------------------------
# phase 5b: the kNN read path
# ---------------------------------------------------------------------------

def make_sift(np, n_vecs, dims, seed):
    """bench.py::make_sift_node's recipe (256 Gaussian clusters plus unit
    noise, f32, from ``seed + 7``), padded to a power of two, with an
    integer ``bucket`` column 0-99 for filters, and bench.py's queries
    (corpus points plus 0.1 noise, from ``seed + 3``)."""
    rng = np.random.default_rng(seed + 7)
    cents = rng.standard_normal((256, dims)).astype(np.float32)
    assign = rng.integers(0, 256, n_vecs)
    vecs = cents[assign] + rng.standard_normal((n_vecs, dims)).astype(
        np.float32)
    D = 1 << max(6, (n_vecs - 1).bit_length())
    vpad = np.zeros((D, dims), np.float32)
    vpad[:n_vecs] = vecs
    exists = np.zeros(D, bool)
    exists[:n_vecs] = True
    bucket = np.zeros(D, np.int64)
    bucket[:n_vecs] = np.random.default_rng(seed + 11).integers(0, 100,
                                                                n_vecs)
    qrng = np.random.default_rng(seed + 3)

    def queries(n):
        idx = qrng.integers(0, n_vecs, n)
        return vecs[idx] + 0.1 * qrng.standard_normal((n, dims)).astype(
            np.float32)

    return vpad, exists, bucket, D, queries


def exact_cosine_top(np, vpad, admitted, qs, k):
    """Exact f64 cosine oracle, one pass over the slab for all queries:
    (ids [n, k], scores [n, k] as (1 + cos) / 2, full f64 score of any
    doc via the returned function)."""
    qn = qs.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-12)
    D = vpad.shape[0]
    s = np.empty((qs.shape[0], D), np.float64)
    step = 1 << 17
    for a in range(0, D, step):
        x = vpad[a:a + step].astype(np.float64)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        s[:, a:a + step] = (1.0 + qn @ x.T) / 2.0
    s[:, ~admitted] = -np.inf
    ids = np.stack([top_desc(np, row, k) for row in s])
    return ids, np.take_along_axis(s, ids, axis=1), s


def top_desc(np, row, k):
    """``np.argsort(-row, kind="stable")[:k]`` without sorting the whole
    row: the candidates at or above the k-th largest value (every tie
    kept, in index order), sorted stably by descending value."""
    if k == 0:
        return np.empty(0, np.int64)
    kth = np.partition(row, row.size - k)[row.size - k]
    cand = np.nonzero(row >= kth)[0]
    return cand[np.argsort(-row[cand], kind="stable")][:k]


def check_oracle(np, got, ids, sc, full, what):
    """Hits against the exact oracle: a hit may differ from the oracle's
    only where both are within 1e-6 of the oracle's last score; every
    score within 1e-5 relative of the doc's exact score."""
    hits = got["hits"]["hits"]
    gid = np.array([int(h["_id"]) for h in hits])
    gs = np.array([h["_score"] for h in hits])
    if len(gid) != len(ids):
        raise AssertionError(f"{what}: {len(gid)} hits, oracle {len(ids)}")
    if not np.allclose(gs, full[gid], rtol=1e-5, atol=0):
        raise AssertionError(f"{what}: scores off the exact oracle: {gs} vs "
                             f"{full[gid]}")
    edge = sc[-1]
    for a, b in zip(gid, ids):
        if a != b and not (abs(full[a] - edge) <= 1e-6
                           and abs(full[b] - edge) <= 1e-6):
            raise AssertionError(f"{what}: hit {a} where the oracle has {b}")


VEC_MAPPING = {"properties": {
    "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine",
            "index_options": {"type": "ivf_pq"}},
    "bucket": {"type": "long"},
}}


def phase_vectors(torch, np, dev, card, sift):
    """The kNN read path; returns (B2 launches, B3 launches, B3's inputs
    in one IVF-PQ query, the built IVF index and PQ parts)."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import adc, ivf, knn_topk
    from elasticsearch_tpu_torch.ops.ivf import build_ivf
    from elasticsearch_tpu_torch.ops.pq import build_pq, place_pq
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    vpad, exists, bucket, D, make_q = sift
    node = Node(name="sift", device=dev)
    node.create_index("sift", {"settings": {"number_of_shards": 1},
                               "mappings": VEC_MAPPING})
    seg = segment_from_arrays({
        "num_docs": N_VECS, "max_docs": D,
        "numerics": {"bucket": {"exact": bucket, "exists": exists,
                                "kind": "long"}},
        "vectors": {"emb": {"vecs": vpad, "exists": exists, "dims": DIMS,
                            "similarity": "cosine"}}}, node.residency)
    node.get_index("sift").shards[0].engine.add_segment(seg)
    vc = seg.vectors["emb"]
    torch.cuda.synchronize()
    log(f"[vectors] {N_VECS} x {DIMS} f32 SIFT-shaped slab, padded to {D}; "
        f"set-up {time.perf_counter() - t0:.1f} s")

    builds = []
    for _ in range(2):
        t = time.perf_counter()
        index = build_ivf(vc.vecs, vc.exists, D, C=IVF_LISTS,
                          metric=vc.similarity, place=node.residency.device_put)
        torch.cuda.synchronize()
        t_ivf = time.perf_counter() - t
        t = time.perf_counter()
        parts = build_pq(vc.vecs, vc.exists, vc.similarity)
        torch.cuda.synchronize()
        builds.append((index, parts, t_ivf, time.perf_counter() - t))
    (i1, p1, ti1, tp1), (i2, p2, ti2, tp2) = builds
    if not (torch.equal(i1.lists, i2.lists)
            and torch.equal(i1.centroids, i2.centroids)
            and torch.equal(p1.codes, p2.codes)
            and torch.equal(p1.codebooks, p2.codebooks)):
        raise AssertionError("vector builds are not deterministic")
    vc._ivf = i1
    vc._pq = place_pq(p1, node.residency, label="pq[emb]")
    if vc._pq is None:
        raise AssertionError("the PQ codes were denied placement")
    del builds, i2, p2
    lens = i1.list_lens.cpu().numpy()
    nprobe = i1.nprobe_for(PQ_CANDIDATES)
    W = nprobe * i1.Lmax
    log(f"[vectors] IVF C={i1.C} Lmax={i1.Lmax} (lists {lens.min()}-"
        f"{lens.max()}, mean {lens.mean():.1f}) built in {ti1:.2f} s and "
        f"{ti2:.2f} s; PQ M={p1.M} K={p1.K} dsub={p1.dsub} built in "
        f"{tp1:.2f} s and {tp2:.2f} s; both builds bit-identical; IVF-PQ "
        f"probes {nprobe} lists, W={W} codes per query")

    flt = {"range": {"bucket": {"lt": 10}}}
    qv = make_q(32 + 8 + 8 * 8 + 32 + 8)
    rows = iter(range(qv.shape[0]))

    def vec():
        return [float(a) for a in qv[next(rows)]]

    mix = []  # (branch, body)
    mix += [("brute", {"knn": {"field": "emb", "query_vector": vec(),
                               "ann": False}}) for _ in range(32)]
    mix += [("brute_filter", {"knn": {"field": "emb", "query_vector": vec(),
                                      "ann": False, "filter": flt}})
            for _ in range(8)]
    mix += [("maxsim", {"knn": {"field": "emb", "query_vectors": [
        vec() for _ in range(8)]}}) for _ in range(8)]
    mix += [("ivf_pq", {"knn": {"field": "emb", "query_vector": vec(),
                                "num_candidates": PQ_CANDIDATES}})
            for _ in range(32)]
    mix += [("ivf_pq_filter", {"knn": {"field": "emb", "query_vector": vec(),
                                       "num_candidates": PQ_CANDIDATES,
                                       "filter": flt}}) for _ in range(8)]
    bodies = [{"query": q, "size": 10} for _, q in mix]
    node.search("sift", copy.deepcopy(bodies[0]))  # first-use set-up
    node.search("sift", copy.deepcopy(bodies[-1]))

    knn_topk.LAUNCHES = 0
    adc.LAUNCHES = 0
    times, got, per_query = [], [], []
    for body in bodies:
        b2, b3 = knn_topk.LAUNCHES, adc.LAUNCHES
        body = copy.deepcopy(body)  # the search may mutate it; not timed
        t = time.perf_counter()
        got.append(node.search("sift", body))
        times.append(time.perf_counter() - t)
        per_query.append((knn_topk.LAUNCHES - b2, adc.LAUNCHES - b3))
    b2_launches, b3_launches = knn_topk.LAUNCHES, adc.LAUNCHES
    if b2_launches == 0 or b3_launches == 0:
        raise AssertionError(f"the kNN path launched knn_topk "
                             f"{b2_launches} and adc_scores {b3_launches} "
                             f"times")
    starved = 0
    for (branch, _), (n2, n3) in zip(mix, per_query):
        want = (0, 1) if branch.startswith("ivf_pq") else (1, 0)
        if branch.startswith("ivf_pq") and (n2, n3) == (1, 1):
            starved += 1  # a filter starved the probes: brute force ran
        elif (n2, n3) != want:
            raise AssertionError(f"{branch}: launched knn_topk {n2} and "
                                 f"adc_scores {n3} times, expected {want}")

    # the same searches with the kernels swapped for their plain twins
    real_b2, real_b3 = queries.knn_topk, ivf.adc_scores
    queries.knn_topk = functools.partial(real_b2, plain=True)
    ivf.adc_scores = functools.partial(real_b3, plain=True)
    try:
        for n, body in enumerate(bodies):
            check_hits(got[n], node.search("sift", copy.deepcopy(body)),
                       f"{mix[n][0]} query {n} vs plain twins")
    finally:
        queries.knn_topk, ivf.adc_scores = real_b2, real_b3

    # brute force (plain and filtered) against the exact f64 oracle, and
    # the IVF-PQ recall@10 against it
    live = exists.copy()
    sel = live & (bucket < 10)
    for branch, admitted in (("brute", live), ("brute_filter", sel)):
        idx = [n for n, (b, _) in enumerate(mix) if b == branch]
        qs = np.stack([np.array(mix[n][1]["knn"]["query_vector"],
                                np.float32) for n in idx])
        ids, sc, full = exact_cosine_top(np, vpad, admitted, qs, 10)
        for r, n in enumerate(idx):
            if got[n]["hits"]["total"] != min(100, int(admitted.sum())):
                raise AssertionError(f"{branch} query {n}: total "
                                     f"{got[n]['hits']['total']}")
            check_oracle(np, got[n], ids[r], sc[r], full[r],
                         f"{branch} query {n}")
    recalls = {}
    for branch, admitted in (("ivf_pq", live), ("ivf_pq_filter", sel)):
        idx = [n for n, (b, _) in enumerate(mix) if b == branch]
        qs = np.stack([np.array(mix[n][1]["knn"]["query_vector"],
                                np.float32) for n in idx])
        ids, _sc, _full = exact_cosine_top(np, vpad, admitted, qs, 10)
        recalls[branch] = float(np.mean([
            len({int(h["_id"]) for h in got[n]["hits"]["hits"]}
                & set(ids[r].tolist())) / 10 for r, n in enumerate(idx)]))

    ms = np.array(times) * 1e3
    per_branch = "; ".join(
        f"{b} x{sum(1 for m, _ in mix if m == b)}: p50 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 50):.3f} ms, p99 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 99):.3f} ms"
        for b in dict.fromkeys(m for m, _ in mix))
    log(f"[vectors] {len(bodies)} knn queries through Node.search on {card}:"
        f" {per_branch}; knn_topk launches {b2_launches}, adc_scores "
        f"launches {b3_launches} ({starved} filtered IVF-PQ queries starved "
        f"into brute force); hits equal the plain twins'; brute-force hits "
        f"match the exact f64 oracle; IVF-PQ recall@10 vs exact: "
        f"{recalls['ivf_pq']} (filtered {recalls['ivf_pq_filter']})")
    profile_read(torch, node, "sift", bodies, float(ms.sum()), "vectors")
    body = next(b for m, b in zip(mix, bodies) if m[0] == "ivf_pq")
    ops = device_ops(torch, lambda: node.search("sift", copy.deepcopy(body)))
    if ops is None:
        log("[vectors] an IVF-PQ query's device ops: not measured (the "
            "profiler recorded none)")
    else:
        b3 = sum(c for k, c in ops.items() if "adc_table_sum" in k)
        if b3 != 1:
            raise AssertionError(f"an IVF-PQ query launched adc_scores {b3} "
                                 f"times: {ops}")
        kernels = sum(c for k, c in ops.items()
                      if not k.startswith(("Memcpy", "Memset")))
        log(f"[vectors] one IVF-PQ query's device ops: {kernels} kernels, "
            f"adc_scores once; " + "; ".join(f"{k[:40]} x{c}"
                                            for k, c in ops.items()))
    b3_case = b3_query_case(torch, np, seg, vc, i1, nprobe, next(
        body for m, body in mix if m == "ivf_pq")["knn"]["query_vector"])
    node.close()
    return b2_launches, b3_launches, b3_case, i1, p1


def b3_query_case(torch, np, seg, vc, index, nprobe, query):
    """B3's inputs in one unfiltered IVF-PQ query of the segment, as
    ``ivf_pq_search`` gives them to it: the whole code table, the probed
    slots, the LUT and the packed liveness words."""
    from elasticsearch_tpu_torch.ops import ivf
    from elasticsearch_tpu_torch.ops.bitvec import pack_mask
    from elasticsearch_tpu_torch.ops.pq import adc_lut

    q = torch.as_tensor(np.asarray(query, np.float32), device=vc.vecs.device)
    return {"codes": vc._pq.codes_dev(),
            "cand": ivf._probe(index, q, nprobe),
            "words": pack_mask(vc.exists & seg.live),
            "lut": adc_lut(q, vc._pq.codebooks, vc._pq.metric)}


# ---------------------------------------------------------------------------
# phase 5c: the hybrid read path
# ---------------------------------------------------------------------------

HYB_MAPPING = {"properties": {"body": {"type": "text"},
                              **VEC_MAPPING["properties"]}}
RERANK_TOKENS = 32
RERANK_WINDOW = 100


def _rrf_np(np, scores, mask, rank_constant, weight):
    """tests/unit/test_hybrid.py::_rrf_ref: numpy RRF contribution."""
    key = np.where(mask, scores, -np.inf).astype(np.float32)
    rank = np.empty(key.size, np.int64)
    rank[np.argsort(-key, kind="stable")] = np.arange(key.size)
    contrib = np.where(
        mask, np.float32(1.0) / (np.float32(rank_constant) + np.float32(1.0)
                                 + rank.astype(np.float32)),
        np.float32(0.0)).astype(np.float32)
    return (np.float32(weight) * contrib).astype(np.float32)


def fuse_np(np, ls, lm, vs, vm, method, weights, rank_constant):
    """tests/unit/test_hybrid.py::_fuse_ref: the numpy fusion."""
    if method == "linear":
        fused = (np.float32(weights[0]) * np.where(lm, ls, np.float32(0))
                 + np.float32(weights[1]) * np.where(vm, vs, np.float32(0)))
    else:
        fused = (_rrf_np(np, ls, lm, rank_constant, weights[0])
                 + _rrf_np(np, vs, vm, rank_constant, weights[1]))
    return fused.astype(np.float32), lm | vm


def phase_hybrid(torch, np, dev, card, corpus, sift, ivf_index, pq_parts):
    """The hybrid read path over one 2^20-doc segment holding phase 5's
    text field and phase 5b's vector slab, with phase 5b's IVF and PQ.
    Returns the launches of B2, B3 and B4 over the query mix."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import adc, ivf, knn_topk, maxsim_adc
    from elasticsearch_tpu_torch.ops.pq import place_pq
    from elasticsearch_tpu_torch.search import hybrid, queries
    from elasticsearch_tpu_torch.search.context import SegmentContext

    t0 = time.perf_counter()
    vpad, exists, bucket, D, make_q = sift
    if D != N_DOCS:
        raise AssertionError(f"slab of {D} rows, text of {N_DOCS} docs")
    df = corpus[4]
    node = Node(name="hybrid", device=dev)
    node.create_index("hybrid", {"settings": {"number_of_shards": 1},
                                 "mappings": HYB_MAPPING})
    seg = segment_from_arrays({
        "num_docs": N_DOCS, "max_docs": D,
        "fields": {"body": text_field(np, corpus)},
        "numerics": {"bucket": {"exact": bucket, "exists": exists,
                                "kind": "long"}},
        "vectors": {"emb": {"vecs": vpad, "exists": exists, "dims": DIMS,
                            "similarity": "cosine"}}}, node.residency)
    vc = seg.vectors["emb"]
    vc._ivf = ivf_index
    vc._pq = place_pq(pq_parts, node.residency, label="pq[emb]")
    if vc._pq is None:
        raise AssertionError("the PQ codes were denied placement")
    svc = node.get_index("hybrid")
    svc.shards[0].engine.add_segment(seg)
    torch.cuda.synchronize()
    log(f"[hybrid] one segment of {N_DOCS} docs: phase 5's text field and "
        f"phase 5b's {N_VECS} x {DIMS} slab (IVF C={ivf_index.C}, PQ "
        f"M={pq_parts.M} K={pq_parts.K} carried across); set-up "
        f"{time.perf_counter() - t0:.1f} s")

    lex = make_queries(np, 56, VOCAB, df, SEED + 5)
    qv = make_q(56)
    pool = make_q(16 * (RERANK_TOKENS - 1))
    flt = {"range": {"bucket": {"lt": 10}}}

    def vec(a):
        return [float(x) for x in a]

    def hyb(i, method="rrf", weights=(1.0, 1.0), **knn):
        return {"hybrid": {
            "query": {"match": {"body": " ".join(f"t{t}" for t in lex[i])}},
            "knn": dict({"field": "emb", "query_vector": vec(qv[i])}, **knn),
            "fusion": {"method": method, "weights": list(weights),
                       "rank_constant": 60}}}

    mix = []  # (branch, body)
    for i in range(56):
        if i < 16:
            mix.append(("rrf", {"query": hyb(i, ann=False,
                                             num_candidates=100)}))
        elif i < 24:
            mix.append(("linear", {"query": hyb(i, "linear", (0.3, 2.0),
                                                ann=False, boost=1.7)}))
        elif i < 32:
            mix.append(("rrf_ivf_pq", {"query": hyb(
                i, num_candidates=PQ_CANDIDATES)}))
        elif i < 40:
            mix.append(("rrf_filter", {"query": hyb(i, ann=False,
                                                    filter=flt)}))
        else:
            j = i - 40
            q = hyb(i, ann=False, num_candidates=100)
            q["hybrid"]["rerank"] = {
                "query_vectors": [vec(qv[i])] + [
                    vec(t) for t in pool[j * (RERANK_TOKENS - 1):
                                         (j + 1) * (RERANK_TOKENS - 1)]],
                "window_size": RERANK_WINDOW, "pq": i >= 48}
            mix.append(("rerank_pq" if i >= 48 else "rerank_exact",
                        {"query": q, "size": RERANK_WINDOW}))
    for _, body in mix:
        body.setdefault("size", 10)
    for b in ("rrf", "rrf_ivf_pq", "rerank_exact", "rerank_pq"):
        node.search("hybrid", copy.deepcopy(  # first-use set-up, untimed
            next(body for m, body in mix if m == b)))

    knn_topk.LAUNCHES = adc.LAUNCHES = maxsim_adc.LAUNCHES = 0
    times, got, per_query = [], [], []
    for _, body in mix:
        before = (knn_topk.LAUNCHES, adc.LAUNCHES, maxsim_adc.LAUNCHES)
        body = copy.deepcopy(body)  # the search may mutate it; not timed
        t = time.perf_counter()
        got.append(node.search("hybrid", body))
        times.append(time.perf_counter() - t)
        per_query.append((knn_topk.LAUNCHES - before[0],
                          adc.LAUNCHES - before[1],
                          maxsim_adc.LAUNCHES - before[2]))
    launches = {"knn_topk": knn_topk.LAUNCHES, "adc_scores": adc.LAUNCHES,
                "maxsim_adc": maxsim_adc.LAUNCHES}
    starved = 0
    for (branch, _), n in zip(mix, per_query):
        want = {"rrf_ivf_pq": (0, 1, 0),
                "rerank_pq": (1, 0, 1)}.get(branch, (1, 0, 0))
        if branch == "rrf_ivf_pq" and n == (1, 1, 0):
            starved += 1  # the probes starved: brute force ran
        elif n != want:
            raise AssertionError(f"{branch}: launched (knn_topk, adc_scores,"
                                 f" maxsim_adc) {n} times, expected {want}")
    if launches["maxsim_adc"] != 8:
        raise AssertionError(f"maxsim_adc launched {launches['maxsim_adc']}"
                             f" times over 8 PQ re-ranks")

    # the same searches with the kernels swapped for their plain twins
    real = queries.knn_topk, ivf.adc_scores, hybrid.maxsim_adc
    queries.knn_topk = functools.partial(real[0], plain=True)
    ivf.adc_scores = functools.partial(real[1], plain=True)
    hybrid.maxsim_adc = functools.partial(real[2], plain=True)
    try:
        for n, (branch, body) in enumerate(mix):
            twin = node.search("hybrid", copy.deepcopy(body))
            check_hits(got[n], twin, f"{branch} query {n} vs plain twins")
            if got[n].get("hybrid") != twin.get("hybrid"):
                raise AssertionError(f"{branch} query {n}: hybrid section "
                                     f"{got[n].get('hybrid')} vs twins' "
                                     f"{twin.get('hybrid')}")
    finally:
        queries.knn_topk, ivf.adc_scores, hybrid.maxsim_adc = real

    # stage 1 against a numpy fusion of the port's own per-engine rows
    live = seg.live.cpu().numpy()
    fused_checked = 0
    for n in (0, 1, 2, 3, 16, 17, 24, 32):
        q = queries.parse_query(mix[n][1]["query"])
        ctx = SegmentContext(seg, svc.mappings, svc.analysis)
        ls, lm = q.lexical.score_or_mask(ctx)
        vs, vm = q.knn.score_or_mask(ctx)
        ls, lm, vs, vm = (x.cpu().numpy() for x in (ls, lm, vs, vm))
        fused, mask = fuse_np(np, ls, lm & live, vs, vm & live, q.method,
                              q.weights, q.rank_constant)
        eff = np.where(mask, fused, -np.inf)
        top = top_desc(np, eff, 10)
        want = [(str(i), float(fused[i])) for i in top if np.isfinite(eff[i])]
        have = [(h["_id"], h["_score"]) for h in got[n]["hits"]["hits"]]
        if have != want or got[n]["hits"]["total"] != int(mask.sum()):
            raise AssertionError(f"{mix[n][0]} query {n}: hits differ from "
                                 f"the numpy fusion: {have[:3]} vs "
                                 f"{want[:3]}")
        fused_checked += 1

    # stage 2: the windows against f64 MaxSim, exact and over the codes
    codes = pq_parts.codes.cpu().numpy()
    books = pq_parts.codebooks.cpu().numpy().astype(np.float64)
    M, K, dsub = books.shape
    for n, (branch, body) in enumerate(mix):
        if not branch.startswith("rerank"):
            continue
        if got[n].get("hybrid") != {"rerank": "applied",
                                    "window": RERANK_WINDOW}:
            raise AssertionError(f"{branch} query {n}: hybrid section "
                                 f"{got[n].get('hybrid')}")
        toks = np.array(body["query"]["hybrid"]["rerank"]["query_vectors"],
                        np.float64)
        toks /= np.maximum(np.linalg.norm(toks, axis=1, keepdims=True),
                           1e-12)
        plain = copy.deepcopy(body)
        del plain["query"]["hybrid"]["rerank"]
        stage1 = {h["_id"]: h["_score"] for h in node.search(
            "hybrid", plain)["hits"]["hits"]}
        hits = got[n]["hits"]["hits"]
        if sorted(stage1) != sorted(h["_id"] for h in hits):
            raise AssertionError(f"{branch} query {n}: the window is not "
                                 f"stage 1's top {RERANK_WINDOW}")
        ids = np.array([int(h["_id"]) for h in hits])
        gs = np.array([h["_score"] for h in hits])
        has = exists[ids]
        if branch == "rerank_exact":
            x = vpad[ids].astype(np.float64)
            x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            ms = ((1.0 + toks @ x.T) * 0.5).max(axis=0)
        else:
            luts = np.einsum("tmd,mkd->tmk", toks.reshape(-1, M, dsub), books)
            ms = luts[:, np.arange(M)[None, :], codes[ids]].sum(2).max(0)
        s1 = np.array([stage1[h["_id"]] for h in hits])
        if not (np.allclose(gs[has], ms[has], rtol=1e-5, atol=0)
                and np.array_equal(gs[~has], s1[~has])
                and np.all(np.diff(gs) <= 0)):
            raise AssertionError(f"{branch} query {n}: window scores off "
                                 f"the f64 MaxSim: {gs[:4]} vs {ms[:4]}")

    ms = np.array(times) * 1e3
    per_branch = "; ".join(
        f"{b} x{sum(1 for m, _ in mix if m == b)}: p50 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 50):.3f} ms, p99 "
        f"{np.percentile(ms[[m == b for m, _ in mix]], 99):.3f} ms"
        for b in dict.fromkeys(m for m, _ in mix))
    log(f"[hybrid] {len(mix)} hybrid queries through Node.search on {card}:"
        f" {per_branch}; launches knn_topk {launches['knn_topk']}, "
        f"adc_scores {launches['adc_scores']}, maxsim_adc "
        f"{launches['maxsim_adc']} ({starved} IVF-PQ knn sides starved into "
        f"brute force); hits and hybrid sections equal the plain twins'; "
        f"{fused_checked} stage-1 queries equal a numpy fusion of the "
        f"engines' rows; 16 re-rank windows match f64 MaxSim (exact and "
        f"over the PQ codes) at rtol 1e-5")
    profile_read(torch, node, "hybrid", [b for _, b in mix],
                 float(ms.sum()), "hybrid")
    node.close()
    return launches


# ---------------------------------------------------------------------------
# phase 5d: the mesh path over five shards
# ---------------------------------------------------------------------------

MESH_SHARDS = 5  # ES 2.0's default index.number_of_shards
MESH_MAPPING = {"properties": {
    "body": {"type": "text"},
    "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
}}


def shard_arrays(np, corpus, u_term, sift, shard_of, s):
    """``segment_from_arrays``'s arrays for shard s: its docs (ids are the
    global doc numbers, local ids in their order), the text field's CSR
    restricted to them with BM25 tf-normalization at the shard's own
    average length, and their rows of the slab."""
    from elasticsearch_tpu_torch.utils.shapes import pow2_bucket

    k1, b = 1.2, 0.75
    u_doc, tf, _tfn, _offsets, _df, _cf, doc_len = corpus
    vpad, exists = sift[0], sift[1]
    docs = np.nonzero(shard_of == s)[0]
    n = int(docs.size)
    D = pow2_bucket(n, minimum=64)
    local = np.full(shard_of.size, -1, np.int32)
    local[docs] = np.arange(n, dtype=np.int32)
    keep = shard_of[u_doc] == s
    t, d, tf_s = u_term[keep], u_doc[keep], tf[keep]
    avg = float(doc_len[docs].mean())
    tfn_s = (tf_s * (k1 + 1) / (tf_s + k1 * (1 - b + b * doc_len[d] / avg))
             ).astype(np.float32)
    df_s = np.bincount(t, minlength=VOCAB).astype(np.int32)
    offsets = np.zeros(VOCAB + 1, np.int64)
    offsets[1:] = np.cumsum(df_s)
    lengths = np.zeros(D, np.float32)
    lengths[:n] = doc_len[docs]
    vecs = np.zeros((D, DIMS), np.float32)
    vecs[:n] = vpad[docs]
    ex = np.zeros(D, bool)
    ex[:n] = exists[docs]
    return {"num_docs": n, "max_docs": D, "ids": [str(x) for x in docs],
            "fields": {"body": {
                "terms": [f"t{x}" for x in range(VOCAB)], "df": df_s,
                "cf": np.bincount(t, weights=tf_s,
                                  minlength=VOCAB).astype(np.int64),
                "offsets": offsets, "doc_ids_host": local[d],
                "tfnorm_host": tfn_s, "tf_host": tf_s, "avg_len": avg,
                "num_docs": n, "total_terms": int(doc_len[docs].sum()),
                "lengths": lengths}},
            "vectors": {"emb": {"vecs": vecs, "exists": ex, "dims": DIMS,
                                "similarity": "cosine"}}}


def profile_path(torch, run):
    """(device ms, kernels, copies in, copies back, the top four device
    items as "name ms xcount") of ``run()`` under torch.profiler; None
    when a second session records nothing too."""
    for _ in range(2):
        with _profiled(torch) as prof:
            run()
        ev = _device_rows(prof)
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        if busy > 0:
            top = sorted(ev, key=lambda e: -e.self_device_time_total)[:4]
            return (busy, sum(e.count for e in ev if not e.key.startswith(
                ("Memcpy", "Memset"))),
                sum(e.count for e in ev if "HtoD" in e.key),
                sum(e.count for e in ev if "DtoH" in e.key),
                [f"{e.key[:36]} {e.self_device_time_total / 1e3:.3f} ms "
                 f"x{e.count}" for e in top])
    return None


def phase_mesh(torch, np, dev, card, corpus, sift, dense_bodies,
               tail_bodies):
    """Phase 5d: phase 5's corpus and phase 5b's slab split over five
    shards by document routing, one segment a shard; phase 5's queries
    and brute-force knn on the mesh path and on the host loop, and
    ``search_knn`` at Q = 8; then phase 5u, the same shards on a node
    over several devices (``phase_multidevice``; ``dense_bodies``: 5e(a)'s
    pure-dense bodies for its ``_msearch``). Returns the mesh runs' (B1,
    B2) launches, 5u's included."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.routing import shard_id_for
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk, knn_topk
    from elasticsearch_tpu_torch.parallel import executor as mesh_exec
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    u_doc, tf, tfn, offsets, df, cf, doc_len = corpus
    shard_of = np.fromiter((shard_id_for(str(x), MESH_SHARDS)
                            for x in range(N_DOCS)), np.int32, N_DOCS)
    u_term = np.repeat(np.arange(VOCAB, dtype=np.int32), df)
    node = Node(name="mesh", device=dev)
    node.create_index("mesh5", {
        "settings": {"number_of_shards": MESH_SHARDS},
        "mappings": MESH_MAPPING})
    svc = node.get_index("mesh5")
    qs = make_queries(np, N_QUERIES, VOCAB, df, SEED)
    # the exact f64 scorer on each shard's own arrays (per-shard idf and
    # average length, as the engine scores a shard): (score, shard, local,
    # doc) of each shard's top 10, and the hit counts
    exact_cands = [[] for _ in qs]
    exact_totals = [0] * len(qs)
    shard_text = []  # each shard's text CSR and doc numbers, for 5e
    kept = []  # each shard's arrays, for 5u's node
    for s in range(MESH_SHARDS):
        arrays = shard_arrays(np, corpus, u_term, sift, shard_of, s)
        fb = arrays["fields"]["body"]
        docs = np.asarray(arrays["ids"], np.int64)
        shard_text.append(((fb["doc_ids_host"], fb["tfnorm_host"],
                            fb["offsets"], fb["df"], arrays["num_docs"],
                            arrays["max_docs"]), docs))
        for n, q in enumerate(qs):
            ids, sc, total = exact_top10(
                np, q, fb["doc_ids_host"], fb["tfnorm_host"], fb["offsets"],
                fb["df"], arrays["num_docs"], arrays["max_docs"])
            exact_cands[n] += [(float(v), s, int(i), int(docs[i]))
                               for v, i in zip(sc, ids)]
            exact_totals[n] += total
        svc.shards[s].engine.add_segment(segment_from_arrays(
            arrays, node.residency))
        kept.append(arrays)
        del arrays, fb
    del u_term
    sizes = np.bincount(shard_of, minlength=MESH_SHARDS)
    torch.cuda.synchronize()
    log(f"[mesh] {N_DOCS} docs over {MESH_SHARDS} shards by "
        f"shard_id_for ({', '.join(map(str, sizes))} docs), one segment "
        f"each with its text postings and slab rows; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    def on_mesh(flag):
        svc.settings["search"] = {"mesh": flag}

    def run(bodies):
        times, got = [], []
        for body in bodies:
            t = time.perf_counter()
            got.append(node.search("mesh5", copy.deepcopy(body)))
            times.append(time.perf_counter() - t)
        return np.array(times) * 1e3, got

    bodies = [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
               "size": 10} for q in qs]
    warm = {"query": {"match": {"body": "t1 t2 t3"}}, "size": 10}
    qv = sift[4](16)
    knn_bodies = [{"query": {"knn": {"field": "emb", "ann": False,
                                     "query_vector": [float(a) for a in v]}},
                   "size": 10} for v in qv[:8]]
    results = {}
    for path in (True, False):
        on_mesh(path)
        # first-use set-up (dense blocks, stacked postings), untimed
        node.search("mesh5", dict(warm))
        node.search("mesh5", copy.deepcopy(knn_bodies[0]))
        counters.reset()
        bm25_topk.LAUNCHES = knn_topk.LAUNCHES = 0
        ms, got = run(bodies)
        b1 = bm25_topk.LAUNCHES
        kms, kgot = run(knn_bodies)
        b2 = knn_topk.LAUNCHES
        snap = counters.snapshot()
        # a repeat of the same requests: the mesh's prepared-query memo
        # serves them without a build or a copy in
        ms2, _ = run(bodies)
        # the device's view of first requests ("from": 0 makes each body
        # new to the memo; the stacked segment data stays cached)
        prof = profile_path(torch, lambda: run(
            [dict(b, **{"from": 0}) for b in bodies]))
        kprof = profile_path(torch, lambda: run(
            [dict(b, **{"from": 0}) for b in knn_bodies]))
        results[path] = (ms, got, b1, kms, kgot, b2, snap, ms2, prof, kprof)
    on_mesh(True)
    (ms, got, b1, kms, kgot, b2, snap, ms2, prof, kprof) = results[True]
    if snap.get("mesh_search") != len(bodies) + len(knn_bodies) \
            or snap.get("mesh_fallback_total"):
        raise AssertionError(f"phase 5d: the mesh path did not serve every "
                             f"request: {snap}")
    if b1 == 0 or b2 == 0:
        raise AssertionError(f"phase 5d: the mesh path launched B1 {b1} "
                             f"and B2 {b2} times")
    h = results[False]
    identical = 0
    for n, body in enumerate(bodies + knn_bodies):
        a = (got + kgot)[n]
        want = (h[1] + h[4])[n]
        if [x["_id"] for x in a["hits"]["hits"]] != \
                [x["_id"] for x in want["hits"]["hits"]]:
            raise AssertionError(f"phase 5d query {n}: the mesh's hits "
                                 f"differ from the host loop's")
        check_hits(a, want, f"phase 5d query {n}, mesh vs host loop")
        identical += a["hits"] == want["hits"]
    # the same requests on the mesh path with B1 and B2 swapped for their
    # twins: the same hits; scores bit for bit where no round took the
    # generic route (whose index_add_ adds in no fixed order on the card),
    # else at 1e-5
    real = (queries.bm25_dense_topk, queries.knn_topk)
    queries.bm25_dense_topk = functools.partial(real[0], plain=True)
    queries.knn_topk = functools.partial(real[1], plain=True)
    try:
        for n, body in enumerate(bodies + knn_bodies):
            before = counters.snapshot()
            twin = node.search("mesh5", copy.deepcopy(body))
            after = counters.snapshot()
            generic = any(after.get(c, 0) != before.get(c, 0)
                          for c in ("bm25_hybrid", "bm25_scatter"))
            a = (got + kgot)[n]
            if [x["_id"] for x in a["hits"]["hits"]] != \
                    [x["_id"] for x in twin["hits"]["hits"]] \
                    or (not generic and a["hits"] != twin["hits"]):
                raise AssertionError(f"phase 5d query {n}: the mesh's hits "
                                     f"differ from the plain twins'")
            check_hits(a, twin, f"phase 5d query {n}, mesh vs plain twins")
    finally:
        queries.bm25_dense_topk, queries.knn_topk = real
    # match queries against the exact f64 scorer: totals exact; scores
    # within 2^-7 (phase 5's bar for B1's bf16 products), recall@10
    recalls = []
    for n in range(len(qs)):
        want = sorted(exact_cands[n], key=lambda c: (-c[0], c[1], c[2]))
        want = want[:10]
        hits = got[n]["hits"]["hits"]
        if got[n]["hits"]["total"] != exact_totals[n] \
                or len(hits) != len(want):
            raise AssertionError(f"phase 5d query {n}: total "
                                 f"{got[n]['hits']['total']} and {len(hits)} "
                                 f"hits, exact {exact_totals[n]} and "
                                 f"{len(want)}")
        sc = np.array([c[0] for c in want])
        s_ = np.array([h["_score"] for h in hits])
        if not (np.all(np.isfinite(s_)) and np.all(np.diff(s_) <= 0)
                and np.allclose(s_, sc, rtol=2.0 ** -7, atol=0)):
            raise AssertionError(f"phase 5d query {n}: scores off the exact "
                                 f"scorer: {s_} vs {sc}")
        recalls.append(len({int(h["_id"]) for h in hits}
                           & {c[3] for c in want}) / len(want))
    if np.mean(recalls) < 0.95:
        raise AssertionError(f"phase 5d mean recall@10 {np.mean(recalls)} "
                             f"< 0.95")
    # knn queries against the exact f64 cosine oracle (one pass for
    # these and search_knn's queries)
    o_ids, o_sc, o_full = exact_cosine_top(np, sift[0], sift[1], qv, 10)
    for r in range(len(knn_bodies)):
        check_oracle(np, kgot[r], o_ids[r], o_sc[r], o_full[r],
                     f"phase 5d knn query {r}")

    def fmt(ms_, prof_, launches, nq, kernel):
        if prof_ is None:
            dev_txt = "device time not measured"
        else:
            busy, kern, hd, dh, _top = prof_
            dev_txt = (f"device {busy:.3f} ms ({100 * busy / ms_.sum():.1f}"
                       f"% busy), {kern / nq:.1f} kernels, {hd / nq:.2f} "
                       f"copies in and {dh / nq:.2f} back per query")
        return (f"p50 {np.percentile(ms_, 50):.3f} ms, p99 "
                f"{np.percentile(ms_, 99):.3f} ms, {dev_txt}, {kernel} "
                f"{launches / nq:.2f} per query")

    nb, nk = len(bodies), len(knn_bodies)
    log(f"[mesh] {nb} match queries on {card}: mesh path "
        f"{fmt(ms, prof, b1, nb, 'B1')}, repeated (memo) p50 "
        f"{np.percentile(ms2, 50):.3f} ms; host loop "
        f"{fmt(h[0], h[8], h[2], nb, 'B1')}, repeated p50 "
        f"{np.percentile(h[7], 50):.3f} ms; hits equal on both paths "
        f"({identical} of {nb + nk} responses bit-identical) and to the "
        f"plain twins'; totals exact and scores within 2^-7 of the f64 "
        f"scorer, recall@10 mean {np.mean(recalls)}, min {min(recalls)}; "
        f"knn hits match the f64 oracle")
    log(f"[mesh] {nk} brute-force knn queries: mesh path "
        f"{fmt(kms, kprof, b2, nk, 'B2')}; host loop "
        f"{fmt(h[3], h[9], h[5], nk, 'B2')}")

    # search_knn at Q = 8: B2 per slot at 4k in bf16, the f32 re-rank,
    # the merge; held against the same call on the B2 twin and against
    # the exact f64 oracle
    mesh_host_profile(node, on_mesh, bodies)
    ex = svc.mesh_executor()
    qk = qv[8:16]
    knn_topk.LAUNCHES = 0
    got_k = ex.search_knn("emb", qk, k=10)
    b2_knn = knn_topk.LAUNCHES
    t = time.perf_counter()
    for _ in range(5):
        ex.search_knn("emb", qk, k=10)
    knn_ms = (time.perf_counter() - t) / 5 * 1e3
    real = mesh_exec.knn_topk
    mesh_exec.knn_topk = functools.partial(real, plain=True)
    try:
        twin = ex.search_knn("emb", qk, k=10)
    finally:
        mesh_exec.knn_topk = real
    for a, w, what in zip(got_k[:4], twin[:4],
                          ("values", "shards", "locals", "segments")):
        if not np.array_equal(a, w):
            raise AssertionError(f"search_knn: {what} differ from the B2 "
                                 f"twin's")
    vals, shard, local, seg_ord, _ = got_k
    gid = np.array([[int(svc.shards[s].segments[o].ids[lc])
                     for s, o, lc in zip(*r)]
                    for r in zip(shard, seg_ord, local)])
    for r in range(qk.shape[0]):
        o = r + 8  # qk is qv[8:16]
        check_oracle(np, {"hits": {"hits": [
            {"_id": str(i), "_score": float(v)}
            for i, v in zip(gid[r], vals[r])]}}, o_ids[o], o_sc[o],
            o_full[o], f"search_knn query {r}")
    log(f"[mesh] search_knn Q=8 k=10 over {MESH_SHARDS} slots: "
        f"{knn_ms:.3f} ms a call, B2 launches {b2_knn}; equal to the B2 "
        f"twin's, hits match the exact f64 oracle")
    b1_u, b2_u = phase_multidevice(
        torch, np, dev, card, kept, node, bodies, knn_bodies,
        (ms, got, kms, kgot), dense_bodies, tail_bodies)
    del kept
    # phase 5e reads the node and the shards' arrays
    return b1 + b1_u, b2 + b2_knn + b2_u, node, shard_text


# ---------------------------------------------------------------------------
# phase 5u: the shard mesh over several devices
# ---------------------------------------------------------------------------

MULTI_NAMED = 4      # mesh devices on a machine with one card: it, 4 times
MULTI_MSEARCH = 256  # 5u(c)'s _msearch: the first of 5e(a)'s bodies


def multi_devices(torch, dev):
    """Phase 5u's device list and how it was made: every card when there
    are two or more, else the one card named MULTI_NAMED times (each
    entry a mesh device with its own residency registry)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(n)], f"every card ({n} cards)"
    return [str(dev)] * MULTI_NAMED, (f"one card named {MULTI_NAMED} times "
                                      f"(the machine has one)")


def _launch_owner(svc):
    """{data_ptr of each shard segment's live mask and slab: its mesh
    device}: what B1 (the live mask) and B2 (the slab) read tells which
    device a launch served."""
    ex = svc.mesh_executor()
    out = {}
    for s, sh in enumerate(svc.shards):
        for seg in sh.segments:
            out[seg.live.data_ptr()] = ex.mesh.device_of(s)
            vc = seg.vectors.get("emb")
            if vc is not None:
                out[vc.vecs.data_ptr()] = ex.mesh.device_of(s)
    return out


def multi_split(torch, np, node, svc, tail_bodies) -> str:
    """Phase 5u(e): the body field of the shard with the most postings
    split over the node's registries; returns the log line."""
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.parallel import postings_shard

    s_big = max(range(len(svc.shards)), key=lambda s: svc.shards[s]
                .segments[0].inverted["body"].nnz)
    inv = svc.shards[s_big].segments[0].inverted["body"]
    os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        unsplit = [node.search("mesh5", copy.deepcopy(b))
                   for b in tail_bodies]
    finally:
        del os.environ["ESTPU_DISABLE_MESH"]
    regs = node.residency.members
    saved, split = postings_shard.POSTINGS_SHARD_NNZ, None
    postings_shard.POSTINGS_SHARD_NNZ = inv.nnz
    try:
        t = time.perf_counter()
        split = inv.postings_split()
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t) * 1e3
        _hold(split is not None and split.S == len(regs),
              f"(e) the split {split} over {len(regs)} registries", "5u")
        for r in range(split.S):
            reg = split.registry_of(r)
            _hold(reg is regs[r % len(regs)]
                  and all(x.device == reg.device
                          for x in split.slot_arrays(r)),
                  f"(e) range {r} is not on registry {r % len(regs)}", "5u")
        held = [sum(h.nbytes for part in split.parts if part[0] is reg
                    for h in part[2:]) for reg in regs]
        k0 = counters.snapshot().get("bm25_postings_sharded", 0)
        f0 = counters.snapshot().get("mesh_fallback_total", 0)
        worst = 0.0
        ms = []
        for b, u in zip(tail_bodies, unsplit):
            t = time.perf_counter()
            r = node.search("mesh5", copy.deepcopy(b))
            ms.append((time.perf_counter() - t) * 1e3)
            _hold([h["_id"] for h in r["hits"]["hits"]]
                  == [h["_id"] for h in u["hits"]["hits"]]
                  and r["hits"]["total"] == u["hits"]["total"],
                  f"(e) the split's hits differ for {b}", "5u")
            for x, y in zip(r["hits"]["hits"], u["hits"]["hits"]):
                worst = max(worst, abs(x["_score"] - y["_score"])
                            / max(abs(y["_score"]), 1e-30))
        snap = counters.snapshot()
        sharded = snap.get("bm25_postings_sharded", 0) - k0
        _hold(sharded >= len(tail_bodies), f"(e) the split served "
              f"{sharded} term groups", "5u")
        _hold(worst <= 1e-5, f"(e) scores off by {worst:.3e}", "5u")
    finally:
        postings_shard.POSTINGS_SHARD_NNZ = saved
        if split is not None:
            split.close()
        inv._pshard = None
    return (f"[5u] (e) shard {s_big}'s body field ({inv.nnz} postings) "
            f"split into {split.S} term ranges over the node's "
            f"{len(regs)} registries in {build_ms:.3f} ms (bytes a "
            f"registry {held}); {len(tail_bodies)} tail-term bodies on "
            f"the host loop (the mesh declined "
            f"{snap.get('mesh_fallback_total', 0) - f0} times): the "
            f"unsplit host loop's top 10 and totals, scores within "
            f"{worst:.3e} relative, {sharded} term groups through the "
            f"split, p50 {np.percentile(ms, 50):.3f} ms")


def phase_multidevice(torch, np, dev, card, arrays, one_node, bodies,
                      knn_bodies, one_run, dense_bodies, tail_bodies):
    """Phase 5u: phase 5d's five shards (the same arrays) on a node over
    several mesh devices (``multi_devices``): shard i on mesh device i %
    n, each round a part on every device, the parts merged on the first.
    (a) the device list; (b) 5d's match and knn bodies, against 5d's
    one-device node: the same ids in the same order, exact totals,
    scores bit-equal where B1 alone served and within 1e-5 elsewhere;
    (c) an ``_msearch`` of 5e(a)'s first MULTI_MSEARCH pure-dense bodies
    (the mesh's postings round), against the one-device node's at 1e-5
    and against the node's own sequential searches (their B1 band where
    B1 served alone); (e) the body field of the shard with the most
    postings split over the node's registries (``postings_split()``'s
    default slot count, the split threshold lowered to that field, as
    5r(d) does): 5r(d)'s tail-term bodies (``tail_bodies``) through it,
    the same ids and totals as the unsplit host loop and scores within
    1e-5, ``bm25_postings_sharded`` counted, each range's tensors on the
    registry of its slot; (f) per device its bytes and B1/B2 launches,
    and the p50s against 5d's. Returns (b)'s (B1, B2) launches."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk, knn_topk
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    devs, form = multi_devices(torch, dev)
    node = Node(name="mesh-multi", device=devs)
    try:
        node.create_index("mesh5", {
            "settings": {"number_of_shards": MESH_SHARDS},
            "mappings": MESH_MAPPING})
        svc = node.get_index("mesh5")
        for s, a in enumerate(arrays):
            svc.shards[s].engine.add_segment(segment_from_arrays(
                a, svc.shards[s].engine.residency))
        ex = svc.mesh_executor()
        nd = ex.n_devices
        torch.cuda.synchronize()
        log(f"[5u] (a) {form}: device list "
            f"{', '.join(map(str, node.devices))}; {MESH_SHARDS} shards "
            f"over {nd} mesh devices (shard i on mesh device i % {nd}); "
            f"set-up {time.perf_counter() - t0:.1f} s")

        def run(bodies_):
            times, got, generic = [], [], []
            for b in bodies_:
                before = counters.snapshot()
                t = time.perf_counter()
                got.append(node.search("mesh5", copy.deepcopy(b)))
                times.append(time.perf_counter() - t)
                after = counters.snapshot()
                generic.append(any(after.get(c, 0) != before.get(c, 0)
                                   for c in ("bm25_hybrid", "bm25_scatter")))
            return np.array(times) * 1e3, got, generic

        # first use: dense blocks, the word buffers' first copies
        node.search("mesh5", {"query": {"match": {"body": "t1 t2 t3"}},
                              "size": 10})
        node.search("mesh5", copy.deepcopy(knn_bodies[0]))
        owner = _launch_owner(svc)
        per = {"B1": [0] * nd, "B2": [0] * nd}
        real = (queries.bm25_dense_topk, queries.knn_topk)

        def b1_counted(qw, block, live, *a, **kw):
            per["B1"][owner[live.data_ptr()]] += 1
            return real[0](qw, block, live, *a, **kw)

        def b2_counted(q, vecs, *a, **kw):
            per["B2"][owner[vecs.data_ptr()]] += 1
            return real[1](q, vecs, *a, **kw)

        queries.bm25_dense_topk, queries.knn_topk = b1_counted, b2_counted
        try:
            counters.reset()
            bm25_topk.LAUNCHES = knn_topk.LAUNCHES = 0
            ms, got, generic = run(bodies)
            b1 = bm25_topk.LAUNCHES
            kms, kgot, _ = run(knn_bodies)
            b2 = knn_topk.LAUNCHES
            snap = counters.snapshot()
        finally:
            queries.bm25_dense_topk, queries.knn_topk = real
        if snap.get("mesh_search") != len(bodies) + len(knn_bodies) \
                or snap.get("mesh_fallback_total"):
            raise AssertionError(f"phase 5u(b): the mesh did not serve every "
                                 f"request: {snap}")
        if sum(per["B1"]) != b1 or sum(per["B2"]) != b2 \
                or min(per["B1"]) == 0 or min(per["B2"]) == 0:
            raise AssertionError(f"phase 5u(b): B1 {b1} and B2 {b2} launches, "
                                 f"by device {per}: every device must launch "
                                 f"both")
        one_ms, one_got, one_kms, one_kgot = one_run
        exact = 0
        for n, (a, w) in enumerate(zip(got + kgot, one_got + one_kgot)):
            if [x["_id"] for x in a["hits"]["hits"]] != \
                    [x["_id"] for x in w["hits"]["hits"]] \
                    or a["hits"]["total"] != w["hits"]["total"]:
                raise AssertionError(f"phase 5u(b) query {n}: hits or total "
                                     f"differ from the one-device node's")
            if n < len(bodies) and not generic[n]:
                if a["hits"] != w["hits"]:
                    raise AssertionError(f"phase 5u(b) query {n}: B1's "
                                         f"scores differ from the one-device "
                                         f"node's")
                exact += 1
            else:
                check_hits(a, w, f"phase 5u(b) query {n}", rtol=1e-5)

        # (c) the batched postings round, a part on every device
        pairs = [({"index": "mesh5"}, copy.deepcopy(b)) for b in dense_bodies]
        node.msearch(copy.deepcopy(pairs))  # first use
        counters.reset()
        got_c = node.msearch(copy.deepcopy(pairs))["responses"]
        snap_c = counters.snapshot()
        if snap_c.get("mesh_msearch") != 1 \
                or snap_c.get("mesh_msearch_fallback"):
            raise AssertionError(f"phase 5u(c): counters {snap_c}; one mesh "
                                 f"round expected")
        c_ms, _ = _median_ms(np, lambda p: node.msearch(p), [
            copy.deepcopy(pairs) for _ in range(4)])
        c_one_ms, want_c = _median_ms(np, lambda p: one_node.msearch(p), [
            copy.deepcopy(pairs) for _ in range(4)])
        want_c = want_c["responses"]
        for n, (g, w) in enumerate(zip(got_c, want_c)):
            if [x["_id"] for x in g["hits"]["hits"]] != \
                    [x["_id"] for x in w["hits"]["hits"]]:
                raise AssertionError(f"phase 5u(c) body {n}: hits differ "
                                     f"from the one-device node's")
            check_hits(g, w, f"phase 5u(c) body {n} vs one device",
                       rtol=1e-5)
        n_fused, rec_c = _hold_mixed(np, got_c, _sequential(
            node, "mesh5", dense_bodies), "5u(c)")

        split_line = multi_split(torch, np, node, svc, tail_bodies)

        # (f) per device: bytes and launches
        st = node.residency.stats()["devices"]
        seg_bytes = [0] * nd
        for s, sh in enumerate(svc.shards):
            seg_bytes[ex.mesh.device_of(s)] += sum(
                g.memory_bytes() for g in sh.segments)
        for d in range(nd):
            log(f"[5u] (f) mesh device {d} ({node.devices[d]}): shards "
                f"{ex.mesh.slots_of(d)}, {seg_bytes[d]} bytes of segments "
                f"(postings, live masks), {st[d]['resident_bytes']} held by "
                f"its registry (blocks, slabs, copies), B1 launches "
                f"{per['B1'][d]}, B2 {per['B2'][d]}")
        log("[5u] (f) allocated on the card(s): " + ", ".join(
            f"{d} {torch.cuda.memory_allocated(d)} bytes"
            for d in sorted({str(d) for d in node.devices})))
        log(f"[5u] (b) {len(bodies)} match queries over {nd} mesh devices "
            f"on {card}: p50 {np.percentile(ms, 50):.3f} ms against 5d's "
            f"one-device {np.percentile(one_ms, 50):.3f}; {len(knn_bodies)} "
            f"knn p50 {np.percentile(kms, 50):.3f} ms against "
            f"{np.percentile(one_kms, 50):.3f}; B1 {b1}, B2 {b2} launches; "
            f"the same ids in the same order and exact totals as 5d's node, "
            f"{exact} B1-only responses bit-equal, the rest within 1e-5")
        log(f"[5u] (c) {len(dense_bodies)} of 5e(a)'s bodies in one "
            f"Node.msearch over {nd} mesh devices: median {c_ms:.3f} ms of 3 "
            f"calls against the one-device node's {c_one_ms:.3f}; "
            f"mesh_msearch once a call; "
            f"equal to the one-device node's at 1e-5 and to sequential "
            f"searches ({len(dense_bodies) - n_fused} at 1e-5, {n_fused} in "
            f"B1's band, recall@10 {rec_c:.4f})")
        log(split_line)
        log(f"[5u] phase 5u took {time.perf_counter() - t0:.1f} s")
        return b1, b2
    finally:
        node.close()


# ---------------------------------------------------------------------------
# phase 5e: batched _msearch and the serving coalescer
# ---------------------------------------------------------------------------

MSEARCH_BATCH = 1024       # bench.py --batch-queries 2048, cut (PERF.md §4)
MSEARCH_MESH_BATCH = 256
COALESCE_THREADS = 64      # bench.py::coalesced_qps


def _median_ms(np, fn, args):
    """Median wall ms of ``fn(a)`` over ``args[1:]`` after a warm call on
    ``args[0]``, and the last result."""
    fn(args[0])
    ms, out = [], None
    for a in args[1:]:
        t = time.perf_counter()
        out = fn(a)
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ms)), out


def _sequential(node, index, bodies):
    """Each body through ``Node.search`` alone, with whether kernel B1
    served any of its segments (B1 rounds to bf16 where a batch's tier 2
    and the mesh round sum in f32)."""
    from elasticsearch_tpu_torch.search import queries

    out = []
    for b in bodies:
        f = queries.FUSED_CALLS
        r = node.search(index, copy.deepcopy(b))
        out.append((r, queries.FUSED_CALLS > f))
    return out


#: B1's bf16 products against f32 sums: each of its two roundings is
#: within 2^-8 relative, so a sum of positive products is within 2^-7
BF16_BAND = 2.0 ** -7


def _fused_bar(np, got, want, what) -> float:
    """One side scored in f32, the other by B1's bf16 products: exact
    total, as many hits, scores within ``BF16_BAND`` rank by rank (phase
    5's bar against the exact scorer), and an id on one side only scoring
    within two bands of that side's last score: a near-tie at the cut
    that the roundings can swap. Returns the recall of ``got``'s ids in
    ``want``'s."""
    g, w = got["hits"]["hits"], want["hits"]["hits"]
    if got["hits"]["total"] != want["hits"]["total"] or len(g) != len(w):
        raise AssertionError(f"{what}: total {got['hits']['total']} and "
                             f"{len(g)} hits, sequential "
                             f"{want['hits']['total']} and {len(w)}")
    gs = np.array([h["_score"] for h in g])
    ws = np.array([h["_score"] for h in w])
    if not np.allclose(gs, ws, rtol=BF16_BAND, atol=0):
        raise AssertionError(f"{what}: scores {gs} vs sequential {ws}")
    gi, wi = [h["_id"] for h in g], [h["_id"] for h in w]
    for ids, other, sc in ((gi, set(wi), gs), (wi, set(gi), ws)):
        for d, v in zip(ids, sc):
            if d not in other and v > sc[-1] * (1 + 2 * BF16_BAND):
                raise AssertionError(f"{what}: doc {d} at {v} is missing on "
                                     f"the other side, above the cut's "
                                     f"rounding band ({sc[-1]})")
    return len(set(gi) & set(wi)) / max(len(wi), 1)


def _hold_mixed(np, got, seq, what):
    """A mixed batch against its sequential answers: where B1 served the
    sequential search, ``_fused_bar``; else ``check_hits`` at 1e-5.
    Returns (how many took the fused bar, their mean recall)."""
    recalls = []
    for n, (g, (w, b1)) in enumerate(zip(got, seq)):
        if b1:
            recalls.append(_fused_bar(np, g, w, f"{what} body {n}"))
        else:
            check_hits(g, w, f"{what} body {n} vs sequential", rtol=1e-5)
    return len(recalls), float(np.mean(recalls)) if recalls else 1.0


def exact_top10_card(torch, np, dev, qs, csr, chunk=64):
    """``exact_top10`` of many queries, in f64 on the card: the same
    arithmetic (each term's postings add tfn * idf, idf in f64, per doc
    in term order), so the same bits. Per query (ids, scores, total)."""
    u_doc, tfn, offsets, df, n_docs, D = csr
    docs = torch.from_numpy(np.asarray(u_doc, np.int64)).to(dev)
    w = torch.from_numpy(np.asarray(tfn, np.float64)).to(dev)
    out = []
    for c0 in range(0, len(qs), chunk):
        part = qs[c0: c0 + chunk]
        s = torch.zeros(len(part) * D, dtype=torch.float64, device=dev)
        hit = torch.zeros(len(part) * D, dtype=torch.bool, device=dev)
        for i, q in enumerate(part):
            for t in q:
                lo, hi = int(offsets[t]), int(offsets[t + 1])
                idf = float(np.log(1.0 + (n_docs - df[t] + 0.5)
                                   / (df[t] + 0.5)))
                s.index_add_(0, docs[lo:hi] + i * D, w[lo:hi] * idf)
                hit[docs[lo:hi] + i * D] = True
        s = torch.where(hit, s, float("-inf")).view(len(part), D)
        totals = hit.view(len(part), D).sum(1).cpu().numpy()
        v, idx = torch.topk(s, min(42, D), dim=1)
        v, idx = v.cpu().numpy(), idx.cpu().numpy()
        for r in range(len(part)):  # ties by doc id among the candidates
            o = np.lexsort((idx[r], -v[r]))[:min(10, int(totals[r]))]
            out.append((idx[r][o], v[r][o], int(totals[r])))
    return out


def exact_mesh_card(torch, np, dev, qs, shard_text):
    """The f64 scorer over the five shards, each with its own idf and
    average length, merged as the engine merges shards: (-score, shard,
    local) order. Per query (global doc ids, scores, total)."""
    per = [exact_top10_card(torch, np, dev, qs, csr, chunk=256)
           for csr, _docs in shard_text]
    out = []
    for n in range(len(qs)):
        cands = [(float(v), sh, int(i), int(shard_text[sh][1][i]))
                 for sh in range(len(per))
                 for i, v in zip(per[sh][n][0], per[sh][n][1])]
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        top = cands[:10]
        out.append((np.array([c[3] for c in top], np.int64),
                    np.array([c[0] for c in top]),
                    sum(per[sh][n][2] for sh in range(len(per)))))
    return out


def _hold_exact(np, resp, exact, band, what) -> float:
    """A response against the f64 scorer's (ids, scores, total): exact
    total, as many hits, scores within ``band`` of the exact ones rank by
    rank, and a doc outside the exact top only within two bands of its
    cut (a near-tie that the side's rounding can swap). Returns its
    recall of the exact top."""
    ids, sc, total = exact
    hits = resp["hits"]["hits"]
    if resp["hits"]["total"] != total or len(hits) != len(ids):
        raise AssertionError(f"{what}: total {resp['hits']['total']} and "
                             f"{len(hits)} hits, exact {total} and "
                             f"{len(ids)}")
    s = np.array([h["_score"] for h in hits])
    if not np.allclose(s, sc, rtol=band, atol=0):
        raise AssertionError(f"{what}: scores {s} vs exact {sc}")
    want = set(ids.tolist())
    got = [int(h["_id"]) for h in hits]
    for d, v in zip(got, s):
        if d not in want and v > sc[-1] * (1 + 2 * band):
            raise AssertionError(f"{what}: doc {d} at {v} is not in the "
                                 f"exact top, above the cut's band "
                                 f"({sc[-1]})")
    return len(set(got) & want) / max(len(ids), 1)


#: f32 sums of a few positive f32 products of f32-rounded weights: well
#: within 1e-5 relative of the f64 scores
F32_BAND = 1e-5


def _hold_fused_exact(np, got, seq, exact, what):
    """The members of a mixed batch whose sequential search took B1, each
    side against the f64 scorer within its own rounding: the batch's f32
    sums within ``F32_BAND``, the sequential B1 answer within
    ``BF16_BAND``. Returns (their count, mean recall of each side)."""
    rb, rs = [], []
    for n, (g, (w, b1)) in enumerate(zip(got, seq)):
        if b1:  # exact: {body number: (ids, scores, total)}
            rb.append(_hold_exact(np, g, exact[n], F32_BAND,
                                  f"{what} body {n}, batch vs f64"))
            rs.append(_hold_exact(np, w, exact[n], BF16_BAND,
                                  f"{what} body {n}, sequential vs f64"))
    return len(rb), float(np.mean(rb or [1.0])), float(np.mean(rs or [1.0]))


def _fmt_prof(prof, wall_ms, per="msearch") -> str:
    if prof is None:
        return "device time not measured"
    busy, kern, hd, dh, top = prof
    return (f"device {busy:.3f} ms ({100 * busy / wall_ms:.1f}% busy), "
            f"{kern} kernels, {hd} copies in and {dh} back a {per} (top: "
            + "; ".join(top) + ")")


def phase_msearch(torch, np, dev, card, corpus, sift, read_node, mesh_node,
                  shard_text):
    """Phase 5e: ``Node.msearch`` and the serving coalescer on phase 5's
    index (one 2^20-doc segment), phase 5d's five shards and phase 5b's
    slab, with ``bench.py``'s recipes (``make_queries``, pure-dense and
    mixed; ``batched_msearch_qps``; ``coalesced_qps``). Returns its (B1,
    B2) launches, counted in its single-threaded runs."""
    import itertools
    import threading

    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk, knn_topk
    from elasticsearch_tpu_torch.search import queries

    t0 = time.perf_counter()
    df = corpus[4]
    node = read_node
    seg = node.get_index("msmarco").shards[0].segments[0]
    dense_rows = seg.inverted["body"].dense_block()[0]
    dense = np.asarray(dense_rows[:VOCAB]) >= 0

    def bodies_of(qs):
        return [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
                 "size": 10} for q in qs]

    def pairs_of(index, bodies):
        return [({"index": index}, copy.deepcopy(b)) for b in bodies]

    def msearch(nd, index):
        return lambda pairs: nd.msearch(pairs)["responses"]

    # (a) pure-dense msearch: tier 1, B1's batched form
    bodies_a = bodies_of(make_queries(np, MSEARCH_BATCH, VOCAB, df, SEED,
                                      dense_only=dense))
    run_a = msearch(node, "msmarco")
    run_a(pairs_of("msmarco", bodies_a))  # first use, untimed
    counters.reset()
    bm25_topk.LAUNCHES = 0
    got_a = run_a(pairs_of("msmarco", bodies_a))
    b1_a, snap = bm25_topk.LAUNCHES, counters.snapshot()
    if b1_a != 1 or snap.get("bm25_fused_topk") != MSEARCH_BATCH \
            or snap.get("bm25_hybrid") or snap.get("bm25_scatter"):
        raise AssertionError(f"5e(a): {b1_a} B1 launches, counters {snap}; "
                             f"one launch for the one segment expected")
    wall_a, _ = _median_ms(np, run_a, [pairs_of("msmarco", bodies_a)
                                       for _ in range(4)])
    prof_a = profile_path(torch, lambda: run_a(pairs_of("msmarco",
                                                        bodies_a)))
    seq_a = _sequential(node, "msmarco", bodies_a)
    same_a = 0
    for n, (w, b1) in enumerate(seq_a):
        if not b1:
            raise AssertionError(f"5e(a) body {n}: B1 did not serve it alone")
        check_hits(got_a[n], w, f"5e(a) body {n} vs sequential", rtol=1e-6)
        same_a += got_a[n]["hits"] == w["hits"]
    real = queries.bm25_dense_topk
    queries.bm25_dense_topk = functools.partial(real, plain=True)
    try:  # the twin at 256 queries a call: its [Q, D] rows and sort fit
        twin = []
        for a in range(0, MSEARCH_BATCH, 256):
            twin += run_a(pairs_of("msmarco", bodies_a[a: a + 256]))
    finally:
        queries.bm25_dense_topk = real
    for n in range(MSEARCH_BATCH):
        if got_a[n]["hits"] != twin[n]["hits"]:
            raise AssertionError(f"5e(a) body {n}: hits differ from the B1 "
                                 f"twin's")
    qps_a = MSEARCH_BATCH / wall_a * 1e3
    log(f"[msearch] (a) {MSEARCH_BATCH} pure-dense bodies in one "
        f"Node.msearch on {card}: {qps_a:.1f} queries/s (median "
        f"{wall_a:.3f} ms a call of 3 after a warm one), "
        f"{_fmt_prof(prof_a, wall_a)}; B1 launches {b1_a} (one segment), "
        f"no generic BM25; equal to sequential Node.search "
        f"({same_a} of {MSEARCH_BATCH} bit-identical), bit for bit the B1 "
        f"twin's")

    # (b) mixed Zipfian msearch: tier 2, the f32 product and the tails
    qs_b = make_queries(np, MSEARCH_BATCH, VOCAB, df, SEED + 9)
    bodies_b = bodies_of(qs_b)
    run_b = msearch(node, "msmarco")
    run_b(pairs_of("msmarco", bodies_b))
    counters.reset()
    bm25_topk.LAUNCHES = 0
    got_b = run_b(pairs_of("msmarco", bodies_b))
    snap = counters.snapshot()
    if bm25_topk.LAUNCHES or snap.get("bm25_hybrid") != MSEARCH_BATCH:
        raise AssertionError(f"5e(b): {bm25_topk.LAUNCHES} B1 launches, "
                             f"counters {snap}; tier 2 for every body "
                             f"expected")
    wall_b, _ = _median_ms(np, run_b, [pairs_of("msmarco", bodies_b)
                                       for _ in range(4)])
    prof_b = profile_path(torch, lambda: run_b(pairs_of("msmarco",
                                                        bodies_b)))
    seq_b = _sequential(node, "msmarco", bodies_b)
    n_fused, rec_b = _hold_mixed(np, got_b, seq_b, "5e(b)")
    # the pure-dense members, each side against the f64 scorer (phase 5's,
    # on the card; its first four checked against the numpy one)
    csr = (corpus[0], corpus[2], corpus[3], df, N_DOCS, N_DOCS)
    at = [n for n, (_, b1) in enumerate(seq_b) if b1]
    exact = dict(zip(at, exact_top10_card(torch, np, dev,
                                          [qs_b[n] for n in at], csr)))
    for n in at[:4]:
        ids, sc, total = exact_top10(np, qs_b[n], corpus[0], corpus[2],
                                     corpus[3], df, N_DOCS, N_DOCS)
        if not (np.array_equal(ids, exact[n][0]) and total == exact[n][2]
                and np.array_equal(sc, exact[n][1])):
            raise AssertionError(f"5e(b) body {n}: the card's f64 scorer "
                                 f"differs from the numpy one")
    _, xb_b, xs_b = _hold_fused_exact(np, got_b, seq_b, exact, "5e(b)")
    log(f"[msearch] (b) {MSEARCH_BATCH} mixed Zipfian bodies in one "
        f"Node.msearch: {MSEARCH_BATCH / wall_b * 1e3:.1f} queries/s "
        f"(median {wall_b:.3f} ms), {_fmt_prof(prof_b, wall_b)}; tier 2 "
        f"for all, no B1 launch; equal to sequential Node.search ("
        f"{MSEARCH_BATCH - n_fused} at 1e-5, {n_fused} pure-dense within "
        f"B1's rounding band, recall@10 of those {rec_b:.4f}); those "
        f"{n_fused} against the f64 scorer: the batch within {F32_BAND} "
        f"(recall@10 {xb_b:.4f}), sequential within 2^-7 (recall@10 "
        f"{xs_b:.4f})")

    # (c) five shards: the mesh's batched round against the host tiers
    svc = mesh_node.get_index("mesh5")
    bodies_c = bodies_b[:MSEARCH_MESH_BATCH]
    run_c = msearch(mesh_node, "mesh5")
    run_c(pairs_of("mesh5", bodies_c))
    counters.reset()
    bm25_topk.LAUNCHES = 0
    got_c = run_c(pairs_of("mesh5", bodies_c))
    snap = counters.snapshot()
    if snap.get("mesh_msearch") != 1 or snap.get("mesh_msearch_fallback") \
            or bm25_topk.LAUNCHES:
        raise AssertionError(f"5e(c): counters {snap}, B1 launches "
                             f"{bm25_topk.LAUNCHES}; one mesh round and no "
                             f"B1 expected")
    wall_c, _ = _median_ms(np, run_c, [pairs_of("mesh5", bodies_c)
                                       for _ in range(4)])
    prof_c = profile_path(torch, lambda: run_c(pairs_of("mesh5", bodies_c)))
    svc.settings["search"] = {"mesh": False}
    try:
        run_c(pairs_of("mesh5", bodies_c))
        counters.reset()
        t = time.perf_counter()
        host_c = run_c(pairs_of("mesh5", bodies_c))
        host_ms = (time.perf_counter() - t) * 1e3
        if counters.snapshot().get("mesh_msearch"):
            raise AssertionError("5e(c): the host tiers took the mesh")
    finally:
        svc.settings["search"] = {"mesh": True}
    for n in range(MSEARCH_MESH_BATCH):
        check_hits(got_c[n], host_c[n], f"5e(c) body {n}, mesh vs host "
                                        f"tiers", rtol=1e-5)
    seq_c = _sequential(mesh_node, "mesh5", bodies_c)
    n_fused, rec_c = _hold_mixed(np, got_c, seq_c, "5e(c)")
    at = [n for n, (_, b1) in enumerate(seq_c) if b1]
    exact = dict(zip(at, exact_mesh_card(torch, np, dev,
                                         [qs_b[n] for n in at], shard_text)))
    _, xb_c, xs_c = _hold_fused_exact(np, got_c, seq_c, exact, "5e(c)")
    log(f"[msearch] (c) {MSEARCH_MESH_BATCH} mixed bodies over "
        f"{MESH_SHARDS} shards: mesh round "
        f"{MSEARCH_MESH_BATCH / wall_c * 1e3:.1f} queries/s (median "
        f"{wall_c:.3f} ms), {_fmt_prof(prof_c, wall_c)}; host tiers "
        f"{host_ms:.3f} ms a call; mesh_msearch once, no B1; equal to the "
        f"host tiers at 1e-5 and to sequential Node.search "
        f"({MSEARCH_MESH_BATCH - n_fused} at 1e-5, {n_fused} with a "
        f"pure-dense shard within B1's rounding band, recall@10 of those "
        f"{rec_c:.4f}; against the f64 scorer: the mesh round within "
        f"{F32_BAND} (recall@10 {xb_c:.4f}), sequential within 2^-7 "
        f"(recall@10 {xs_c:.4f}))")

    # (d) brute-force kNN and MaxSim msearch on phase 5b's slab
    vpad, exists, bucket, D, make_q = sift
    vnode = Node(name="msearch-vec", device=dev)
    vnode.create_index("sift", {"settings": {"number_of_shards": 1},
                                "mappings": VEC_MAPPING})
    vnode.get_index("sift").shards[0].engine.add_segment(segment_from_arrays({
        "num_docs": N_VECS, "max_docs": D,
        "numerics": {"bucket": {"exact": bucket, "exists": exists,
                                "kind": "long"}},
        "vectors": {"emb": {"vecs": vpad, "exists": exists, "dims": DIMS,
                            "similarity": "cosine"}}}, vnode.residency))
    qv = make_q(32 + 8 * 8)
    knn_bodies = [{"query": {"knn": {"field": "emb", "ann": False,
                                     "query_vector": [float(a) for a in v]}},
                   "size": 10} for v in qv[:32]]
    toks = qv[32:].reshape(8, 8, DIMS)
    ms_bodies = [{"query": {"knn": {"field": "emb", "query_vectors": [
        [float(a) for a in v] for v in t]}}, "size": 10} for t in toks]
    _ids, _sc, full = exact_cosine_top(np, vpad, exists, qv, 10)
    oracles = {"knn": full[:32],
               "maxsim": full[32:].reshape(8, 8, -1).max(axis=1)}
    del full
    b2_d, d_txt = 0, []
    for name, bodies in (("knn", knn_bodies), ("maxsim", ms_bodies)):
        run_d = msearch(vnode, "sift")
        run_d(pairs_of("sift", bodies))
        counters.reset()
        knn_topk.LAUNCHES = 0
        t = time.perf_counter()
        got = run_d(pairs_of("sift", bodies))
        d_ms = (time.perf_counter() - t) * 1e3
        b2, snap = knn_topk.LAUNCHES, counters.snapshot()
        if b2 != 1 or snap.get("knn_fused_batch") != len(bodies):
            raise AssertionError(f"5e(d) {name}: {b2} B2 launches, counters "
                                 f"{snap}; one launch expected")
        b2_d += b2
        same = 0
        for n, (w, _) in enumerate(_sequential(vnode, "sift", bodies)):
            check_hits(got[n], w, f"5e(d) {name} body {n} vs sequential",
                       rtol=1e-6)
            same += got[n]["hits"] == w["hits"]
        orc = oracles[name]
        for n in range(len(bodies)):
            ids = top_desc(np, orc[n], 10)
            check_oracle(np, got[n], ids, orc[n][ids], orc[n],
                         f"5e(d) {name} body {n}")
        d_txt.append(f"{len(bodies)} {name} bodies {d_ms:.3f} ms, B2 once, "
                     f"{same} bit-identical to sequential")
    del oracles
    vnode.close()
    log(f"[msearch] (d) on the {N_VECS}-vector slab: " + "; ".join(d_txt)
        + "; hits equal sequential Node.search and the f64 oracle")

    # (e) the coalescer: 64 threads send (a)'s bodies as single searches
    coal = node.serving.coalescer

    def round_(_=None):
        out = [None] * MSEARCH_BATCH
        errs = []
        nxt = itertools.count()

        def worker():
            while True:
                i = next(nxt)
                if i >= MSEARCH_BATCH:
                    return
                try:
                    out[i] = node.search("msmarco", bodies_a[i])
                except Exception as e:  # raised below
                    errs.append(e)
                    return

        threads = [threading.Thread(target=worker)
                   for _ in range(COALESCE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errs or any(th.is_alive() for th in threads):
            raise AssertionError(f"5e(e): a coalesced round failed: "
                                 f"{errs[:1]}")
        return out

    # the same rounds with the coalescer on (adaptive, its default) and
    # off (each search on its own path), alternated after a warm round of
    # each
    def in_mode(mode):
        node.serving.apply_cluster_settings({"serving.coalescer.mode": mode})
        return round_()

    in_mode("adaptive")
    in_mode("off")
    before = coal.stats()
    ms_e = {"adaptive": [], "off": []}
    got_e = {}
    for _ in range(3):
        for mode in ms_e:
            t = time.perf_counter()
            got_e[mode] = in_mode(mode)
            ms_e[mode].append((time.perf_counter() - t) * 1e3)
    after = coal.stats()
    in_mode("off")
    prof_off = profile_path(torch, round_)
    in_mode("adaptive")
    prof_e = profile_path(torch, round_)
    node.serving.apply_cluster_settings({})
    flushes = {r: n - before["flushes"].get(r, 0)
               for r, n in after["flushes"].items()
               if n > before["flushes"].get(r, 0)}
    batches = after["batch_size"]["count"] - before["batch_size"]["count"]
    sizes = after["batch_size"]["sum"] - before["batch_size"]["sum"]
    if batches < 1 or after["batch_size"]["max"] < 2:
        raise AssertionError(f"5e(e): no flush held more than one request: "
                             f"{after}")
    for mode, got in got_e.items():
        for n in range(MSEARCH_BATCH):
            check_hits(got[n], got_a[n], f"5e(e) {mode} body {n} vs (a)",
                       rtol=1e-6)
    wall_e = float(np.median(ms_e["adaptive"]))
    wall_off = float(np.median(ms_e["off"]))
    qps_e = MSEARCH_BATCH / wall_e * 1e3
    qps_off = MSEARCH_BATCH / wall_off * 1e3
    solo = after["bypass"].get("solo", 0) - before["bypass"].get("solo", 0)
    log(f"[msearch] (e) {MSEARCH_BATCH} single searches from "
        f"{COALESCE_THREADS} threads through the coalescer: {qps_e:.1f} "
        f"queries/s (median {wall_e:.3f} ms a round of 3), "
        f"{_fmt_prof(prof_e, wall_e, 'round')}; {100 * qps_e / qps_a:.1f}% "
        f"of (a)'s rate; over 3 rounds {batches} batches of "
        f"{sizes / max(batches, 1):.1f} requests on average (largest "
        f"{after['batch_size']['max']}), flushes {flushes}, {solo} solo "
        f"bypasses. The coalescer off, alternated with those rounds: "
        f"{qps_off:.1f} queries/s (median {wall_off:.3f} ms), "
        f"{_fmt_prof(prof_off, wall_off, 'round')}; coalesced / off "
        f"{qps_e / qps_off:.3f}. Every response equal to (a)'s")
    log(f"[msearch] phase 5e took {time.perf_counter() - t0:.1f} s")
    return b1_a, b2_d


# ---------------------------------------------------------------------------
# phase 5f: aggregations on an nyc_taxis stand-in
# ---------------------------------------------------------------------------

TAXI_SHARDS = 4
TAXI_DOCS = 1 << 20        # per shard: one 2^20-doc segment each
TAXI_WINDOW_S = 0.25       # timed requests per body and route: for about
TAXI_MIN_REPS = 10         # this many seconds, at least TAXI_MIN_REPS and
TAXI_MAX_REPS = 200        # at most TAXI_MAX_REPS of them
TAXI_TAIL_REPS = 100       # a p99 is printed from this many requests on
TAXI_PROFILED = 6          # requests per body and route under the profiler
SAMPLE_CAP = 1 << 16       # percentiles' per-segment sample (the reference's)
TAXI_YEAR = 1_420_070_400_000   # 2015-01-01T00:00:00Z
DAY_MS = 86_400_000
#: keyword fields: their values in term order (ordinal = position)
TAXI_KEYWORDS = {
    "vendor_id": ("1", "2", "4"),
    "payment_type": ("1", "2", "3", "4", "5", "6"),
    "rate_code_id": ("1", "2", "3", "4", "5", "6", "99"),
    "store_and_fwd_flag": ("N", "Y"),
}
TAXI_MAPPING = {"properties": dict(
    {k: {"type": "keyword"} for k in TAXI_KEYWORDS},
    passenger_count={"type": "integer"},
    trip_distance={"type": "double"}, fare_amount={"type": "double"},
    tip_amount={"type": "double"}, total_amount={"type": "double"},
    pickup_datetime={"type": "date", "format": "yyyy-MM-dd HH:mm:ss"},
    dropoff_datetime={"type": "date", "format": "yyyy-MM-dd HH:mm:ss"})}
#: the track's aggregation operations (operations/default.json) and the
#: agg types the port serves, every body size 0 as the track sends them
TAXI_BODIES = {
    "distance_amount_agg": {"size": 0, "query": {"bool": {"filter": {
        "range": {"trip_distance": {"lt": 50, "gte": 0}}}}}, "aggs": {
        "distance_histo": {"histogram": {"field": "trip_distance",
                                         "interval": 1}, "aggs": {
            "total_amount_stats": {"stats": {"field": "total_amount"}}}}}},
    "date_histogram_agg": {"size": 0, "query": {"range": {
        "dropoff_datetime": {"gte": "01/01/2015", "lte": "21/01/2015",
                             "format": "dd/MM/yyyy"}}}, "aggs": {
        "dropoffs_over_time": {"date_histogram": {
            "field": "dropoff_datetime", "interval": "day"}}}},
    "keyword_terms": {"size": 0, "aggs": {
        "vendors": {"terms": {"field": "vendor_id"}},
        "payments": {"terms": {"field": "payment_type"}}}},
    "terms_avg_tip": {"size": 0, "aggs": {"payments": {
        "terms": {"field": "payment_type"},
        "aggs": {"avg_tip": {"avg": {"field": "tip_amount"}}}}}},
    "cardinality": {"size": 0, "aggs": {
        "fares": {"cardinality": {"field": "fare_amount"}},
        "rate_codes": {"cardinality": {"field": "rate_code_id"}}}},
    "percentiles": {"size": 0, "aggs": {
        "total": {"percentiles": {"field": "total_amount"}}}},
    "numeric_mix": {"size": 0, "aggs": {
        "fare_stats": {"extended_stats": {"field": "fare_amount"}},
        "passengers": {"stats": {"field": "passenger_count"}},
        "distance_ranges": {"range": {"field": "trip_distance", "ranges": [
            {"to": 2}, {"from": 2, "to": 10}, {"from": 10}]}},
        "no_tip": {"missing": {"field": "tip_amount"}},
        "trips": {"filters": {"filters": {
            "long": {"range": {"trip_distance": {"gte": 10}}},
            "january": {"range": {"pickup_datetime": {
                "gte": "2015-01-01 00:00:00",
                "lt": "2015-02-01 00:00:00"}}}}}}}},
}


def make_taxis(np, n, seed):
    """Generated trip records, one array per field (keywords as term
    ordinals): the shapes of the track's fields, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {
        "vendor_id": rng.choice(3, n, p=[0.46, 0.50, 0.04]),
        "payment_type": rng.choice(
            6, n, p=[0.62, 0.365, 0.008, 0.004, 0.002, 0.001]),
        "rate_code_id": rng.choice(
            7, n, p=[0.972, 0.02, 0.004, 0.002, 0.001, 0.0008, 0.0002]),
        "store_and_fwd_flag": (rng.random(n) < 0.01).astype(np.int64),
        "passenger_count": rng.choice(
            10, n, p=[0.004, 0.70, 0.14, 0.04, 0.02, 0.06, 0.034, 0.001,
                      0.0005, 0.0005]).astype(np.int64),
    }
    for k in TAXI_KEYWORDS:
        out[k] = out[k].astype(np.int32)
    dist = np.round(rng.lognormal(0.8, 0.9, n), 2)
    fare = np.round(np.maximum(2.5, 2.5 + 2.6 * dist
                               + rng.normal(0.0, 1.5, n)), 2)
    # a tip is recorded for card payments; cash trips have none
    tip_exists = out["payment_type"] != 1
    tip = np.round(fare * rng.uniform(0.0, 0.3, n), 2)
    pickup = TAXI_YEAR + rng.integers(0, 365 * DAY_MS, n)
    out.update(
        trip_distance=dist, fare_amount=fare,
        tip_amount=np.where(tip_exists, tip, 0.0), tip_exists=tip_exists,
        total_amount=np.round(fare + np.where(tip_exists, tip, 0.0) + 0.8,
                              2),
        pickup_datetime=pickup,
        dropoff_datetime=pickup + (rng.lognormal(6.5, 0.6, n)
                                   * 1000).astype(np.int64))
    return out


def taxi_shard_arrays(np, taxis, s):
    """``segment_from_arrays``'s arrays for shard s: docs [s * 2^20,
    (s + 1) * 2^20), keyword postings and ordinals, numeric columns."""
    lo, hi = s * TAXI_DOCS, (s + 1) * TAXI_DOCS
    n = TAXI_DOCS
    ones = np.ones(n, np.float32)
    fields, keywords = {}, {}
    for name, terms in TAXI_KEYWORDS.items():
        ords = taxis[name][lo:hi]
        df = np.bincount(ords, minlength=len(terms)).astype(np.int32)
        offsets = np.zeros(len(terms) + 1, np.int64)
        offsets[1:] = np.cumsum(df)
        fields[name] = {
            "terms": list(terms), "df": df, "cf": df.astype(np.int64),
            "offsets": offsets,
            "doc_ids_host": np.argsort(ords, kind="stable").astype(np.int32),
            "tfnorm_host": ones, "tf_host": ones, "avg_len": 1.0,
            "num_docs": n, "total_terms": n}
        single = [[t] for t in terms]  # shared: never mutated
        keywords[name] = {"ords": ords, "exists": np.ones(n, bool),
                          "host_values": [single[o] for o in ords.tolist()]}
    numerics = {}
    for name, kind in (("passenger_count", "integer"),
                       ("trip_distance", "double"),
                       ("fare_amount", "double"), ("tip_amount", "double"),
                       ("total_amount", "double"),
                       ("pickup_datetime", "date"),
                       ("dropoff_datetime", "date")):
        exists = taxis["tip_exists"][lo:hi] if name == "tip_amount" \
            else np.ones(n, bool)
        numerics[name] = {"exact": taxis[name][lo:hi], "exists": exists,
                          "kind": kind}
    return {"num_docs": n, "max_docs": n, "fields": fields,
            "keywords": keywords, "numerics": numerics}


def hash32_np(np, x):
    """The HLL value mix in numpy uint32 (wrapping multiplies)."""
    h = x.astype(np.uint32)
    h = h * np.uint32(2654435761)
    h ^= h >> np.uint32(16)
    h = h * np.uint32(0x45D9F3B)
    h ^= h >> np.uint32(16)
    return h


def hll_bounds(np, values):
    """(lo, hi) int32[4096] register bounds of an f64 column's HLL: each
    value's rank is its exact leading-zero count + 1; a rest whose f32
    lies within 2^-20 below or at a power of two may take one more or
    one less (the f32 formula's log2), the rest exactly that."""
    bits = values.view(np.int64)
    h = hash32_np(np, (bits & 0xFFFFFFFF) ^ ((bits >> 32) & 0xFFFFFFFF))
    reg = (h >> np.uint32(20)).astype(np.int64)
    rest = (h << np.uint32(12)).astype(np.uint32)
    bl = np.zeros(rest.shape, np.int64)  # bit length
    r = rest.astype(np.int64)
    for b in range(32, 0, -1):
        bl = np.where((bl == 0) & (r >> (b - 1) > 0), b, bl)
    exact = np.clip(32 - bl + 1, 1, 21)
    f = rest.astype(np.float32).astype(np.float64)
    with np.errstate(divide="ignore"):
        up = np.exp2(np.ceil(np.log2(np.maximum(f, 1.0))))
    band = (rest > 0) & (f >= up * (1 - 2.0 ** -20))
    lo = np.zeros(4096, np.int64)
    hi = np.zeros(4096, np.int64)
    np.maximum.at(lo, reg, np.clip(exact - band, 1, 21))
    np.maximum.at(hi, reg, np.clip(exact + band, 1, 21))
    return lo, hi, exact, reg


def _hold(cond, what, phase="5f"):
    if not cond:
        raise AssertionError(f"phase {phase}: {what}")


def _near(got, want, rtol, what):
    _hold(got is not None and abs(got - want) <= rtol * abs(want),
          f"{what}: {got!r} vs {want!r} (rtol {rtol})")


def taxi_oracle_check(np, name, resp, t):
    """Hold one response against numpy over the generated arrays ``t``:
    keys, order and counts exact; count, min and max exact; sums and
    averages at rtol 1e-5 of an f64 sum (variance, a difference of two
    sums, at 1e-4); percentiles equal numpy's on the same sample."""
    f32 = np.float32
    aggs = resp["aggregations"]
    n_all = t["trip_distance"].size
    if name == "distance_amount_agg":
        td32 = t["trip_distance"].astype(f32)
        q = (td32 >= f32(0)) & (td32 < f32(50))
        _hold(resp["hits"]["total"] == int(q.sum()), "distance total")
        keys = np.floor(t["trip_distance"][q]).astype(np.int64)
        cnt = np.bincount(keys - keys.min())
        got = aggs["distance_histo"]["buckets"]
        _hold([b["key"] for b in got]
              == [float(k) for k in range(keys.min(), keys.max() + 1)]
              and [b["doc_count"] for b in got] == cnt.tolist(),
              "distance_histo keys or counts")
        tot32 = t["total_amount"].astype(f32)
        for b in got:
            k = b["key"]
            m = q & (td32 >= f32(k)) & (td32 < f32(k + 1))
            n = int(m.sum())
            s = b.get("total_amount_stats")
            if not b["doc_count"]:
                _hold(s is None, f"bucket {k}: stats of an empty bucket")
                continue
            _hold(s["count"] == n and s["min"] == float(tot32[m].min())
                  and s["max"] == float(tot32[m].max()),
                  f"bucket {k} stats count/min/max {s}")
            want = float(t["total_amount"][m].sum())
            _near(s["sum"], want, 1e-5, f"bucket {k} sum")
            _near(s["avg"], want / n, 1e-5, f"bucket {k} avg")
    elif name == "date_histogram_agg":
        lo = TAXI_YEAR
        hi = TAXI_YEAR + 20 * DAY_MS
        d = t["dropoff_datetime"]
        q = (d >= lo) & (d <= hi)
        _hold(resp["hits"]["total"] == int(q.sum()), "date total")
        days = d[q] // DAY_MS
        cnt = np.bincount(days - days.min())
        got = aggs["dropoffs_over_time"]["buckets"]
        want_keys = [int(x) * DAY_MS for x in range(days.min(),
                                                    days.max() + 1)]
        _hold([b["key"] for b in got] == want_keys
              and [b["doc_count"] for b in got] == cnt.tolist(),
              "dropoffs_over_time keys or counts")
        _hold(all(b["key_as_string"] == time.strftime(
            "%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(b["key"] // 1000))
            for b in got), "dropoffs_over_time key_as_string")
    elif name in ("keyword_terms", "terms_avg_tip"):
        _hold(resp["hits"]["total"] == n_all, "terms total")
        fields = (("vendors", "vendor_id"), ("payments", "payment_type")) \
            if name == "keyword_terms" else (("payments", "payment_type"),)
        for agg, field in fields:
            terms = TAXI_KEYWORDS[field]
            cnt = np.bincount(t[field], minlength=len(terms))
            want = sorted(((int(c), terms[i]) for i, c in enumerate(cnt)
                           if c), reverse=True)[:10]
            got = aggs[agg]
            _hold([(b["doc_count"], b["key"]) for b in got["buckets"]]
                  == want and got["sum_other_doc_count"] == 0
                  and got["doc_count_error_upper_bound"] == 0,
                  f"{agg} buckets {got['buckets']}")
            if name == "terms_avg_tip":
                for b in got["buckets"]:
                    m = (t[field] == terms.index(b["key"])) & t["tip_exists"]
                    n = int(m.sum())
                    v = b["avg_tip"]["value"]
                    if n == 0:
                        _hold(v is None, f"avg_tip of {b['key']}")
                    else:
                        _near(v, float(t["tip_amount"][m].sum()) / n, 1e-5,
                              f"avg_tip of {b['key']}")
    elif name == "percentiles":
        rng_parts = []
        for s in range(TAXI_SHARDS):
            part = t["total_amount"][s * TAXI_DOCS: (s + 1) * TAXI_DOCS]
            if part.size > SAMPLE_CAP:
                part = np.random.default_rng(17).choice(
                    part, SAMPLE_CAP, replace=False)
            rng_parts.append(part)
        allv = np.concatenate(rng_parts)
        want = {f"{float(p)}": float(np.percentile(allv, p))
                for p in (1, 5, 25, 50, 75, 95, 99)}
        _hold(aggs["total"]["values"] == want,
              f"percentiles {aggs['total']['values']} vs {want}")
    elif name == "numeric_mix":
        fare = t["fare_amount"]
        fs = aggs["fare_stats"]
        f32v = fare.astype(f32)
        _hold(fs["count"] == n_all and fs["min"] == float(f32v.min())
              and fs["max"] == float(f32v.max()), f"fare_stats {fs}")
        s, sq = float(fare.sum()), float((fare * fare).sum())
        _near(fs["sum"], s, 1e-5, "fare sum")
        _near(fs["avg"], s / n_all, 1e-5, "fare avg")
        _near(fs["sum_of_squares"], sq, 1e-5, "fare sum_of_squares")
        var = sq / n_all - (s / n_all) ** 2
        _near(fs["variance"], var, 1e-4, "fare variance")
        _near(fs["std_deviation"], var ** 0.5, 1e-4, "fare std_deviation")
        ps = aggs["passengers"]
        pc = t["passenger_count"]
        _hold(ps["count"] == n_all and ps["min"] == float(pc.min())
              and ps["max"] == float(pc.max()), f"passengers {ps}")
        _near(ps["sum"], float(pc.sum()), 1e-5, "passengers sum")
        td32 = t["trip_distance"].astype(f32)
        want = [("*-2", int((td32 < f32(2)).sum())),
                ("2-10", int(((td32 >= f32(2)) & (td32 < f32(10))).sum())),
                ("10-*", int((td32 >= f32(10)).sum()))]
        _hold([(b["key"], b["doc_count"])
               for b in aggs["distance_ranges"]["buckets"]] == want,
              f"distance_ranges {aggs['distance_ranges']}")
        _hold(aggs["no_tip"]["doc_count"] == int((~t["tip_exists"]).sum()),
              "no_tip")
        pk = t["pickup_datetime"]
        jan = int(((pk >= TAXI_YEAR) & (pk < TAXI_YEAR + 31 * DAY_MS)).sum())
        _hold(aggs["trips"]["buckets"] == {
            "long": {"doc_count": int((td32 >= f32(10)).sum())},
            "january": {"doc_count": jan}}, f"trips {aggs['trips']}")


def taxi_cardinality_check(np, torch, node, resp, t):
    """Cardinality: each shard's registers (the collector on the card)
    against the numpy build of the same hash; the response is their
    merge. Returns how many of the 4 x 4096 fare registers equal the
    numpy build's exact-rank registers, and the values in the f32 band."""
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.context import SegmentContext
    from elasticsearch_tpu_torch.utils.hashing import (hll_update_host,
                                                       murmur3_32)

    svc = node.get_index("taxis")
    (fares, rates) = parse_aggs(TAXI_BODIES["cardinality"]["aggs"])
    regs, equal, in_band = [], 0, 0
    for s in range(TAXI_SHARDS):
        seg = svc.shards[s].segments[0]
        ctx = SegmentContext(seg, svc.mappings, svc.analysis)
        got = fares.collect(ctx, seg.live).astype(np.int64)
        lo, hi, exact, reg = hll_bounds(
            np, t["fare_amount"][s * TAXI_DOCS: (s + 1) * TAXI_DOCS])
        _hold(np.all((lo <= got) & (got <= hi)),
              f"shard {s}: fare registers outside the numpy bounds")
        want = np.zeros(4096, np.int64)
        np.maximum.at(want, reg, exact)
        equal += int((got == want).sum())
        in_band += int((lo != hi).sum())
        regs.append(got.astype(np.int32))
    _hold(resp["aggregations"]["fares"] == fares.reduce(regs),
          "fares: the response is not the merge of the shards' registers")
    rate_regs = np.zeros(4096, np.int32)
    for s in range(TAXI_SHARDS):
        present = np.unique(t["rate_code_id"][s * TAXI_DOCS:
                                              (s + 1) * TAXI_DOCS])
        hll_update_host(rate_regs, np.array(
            [murmur3_32(TAXI_KEYWORDS["rate_code_id"][i]) for i in present],
            np.uint32))
    _hold(resp["aggregations"]["rate_codes"] == rates.reduce([rate_regs]),
          "rate_codes value")
    return equal, in_band


def phase_aggs(torch, np, dev, card):
    """Phase 5f: aggregations on a stand-in for Elastic Rally's public
    ``nyc_taxis`` track (its ``index.json`` mapping and the aggregation
    operations of ``operations/default.json``), generated from seed 0.
    Cut from the track: 4,194,304 docs in four shards of one 2^20-doc
    segment (the track has 165M); the track's scaled_float fields are
    doubles (ES 2.0 has none); no geo_point fields (geo is ROADMAP A9);
    the other fields of the track's mapping left out. The doc count is
    cut for time, not for the card's memory (the track's keyword and
    numeric columns, about 10 GB, would fit): generating and building
    the docs on the host takes 4-5.3 s per 2^20 of them (the set-up
    line prints it), so the track's 165M would take 11-14 minutes of
    the script's 20 before a request, and the phase has about 60 s.

    Every body runs on the mesh path and on the host loop
    (``index.search.mesh: false``), the two byte-identical and each held
    against numpy over the generated arrays. Per body and route: p50
    over about TAXI_WINDOW_S seconds of requests (TAXI_MIN_REPS to
    TAXI_MAX_REPS), p99 where they number TAXI_TAIL_REPS or more (else
    the slowest, labelled so), device time, kernels and copies a request
    over TAXI_PROFILED profiled requests, and the busy share. Returns
    the node and the generated arrays for phase 5g."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.search.aggregations.metrics import \
        PercentilesAggregator

    _hold(PercentilesAggregator.SAMPLE_CAP == SAMPLE_CAP,
          "the port's percentile sample cap moved")
    t0 = time.perf_counter()
    taxis = make_taxis(np, TAXI_SHARDS * TAXI_DOCS, SEED)
    node = Node(name="taxis", device=dev)
    node.create_index("taxis", {
        "settings": {"number_of_shards": TAXI_SHARDS},
        "mappings": TAXI_MAPPING})
    svc = node.get_index("taxis")
    tarrays = [taxi_shard_arrays(np, taxis, s) for s in range(TAXI_SHARDS)]
    for s in range(TAXI_SHARDS):
        svc.shards[s].engine.add_segment(segment_from_arrays(
            tarrays[s], node.residency))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    log(f"[aggs] {TAXI_SHARDS * TAXI_DOCS} generated trips over "
        f"{TAXI_SHARDS} shards of one {TAXI_DOCS}-doc segment; set-up "
        f"{setup:.1f} s ({setup * (1 << 20) / (TAXI_SHARDS * TAXI_DOCS):.2f}"
        f" s per 2^20 docs)")

    def on_mesh(flag):
        svc.settings["search"] = {"mesh": flag}

    def run(body, n, window_s=0.0):
        """n requests, or more until ``window_s`` seconds have passed,
        at most TAXI_MAX_REPS: (each one's ms, the last response)."""
        ms, out = [], None
        start = time.perf_counter()
        while len(ms) < n or (len(ms) < TAXI_MAX_REPS and
                              time.perf_counter() - start < window_s):
            t = time.perf_counter()
            out = node.search("taxis", copy.deepcopy(body))
            ms.append((time.perf_counter() - t) * 1e3)
        return np.array(ms), out

    lines, card_eq = [], None
    for name, body in TAXI_BODIES.items():
        res = {}
        for mesh in (True, False):
            on_mesh(mesh)
            run(body, 1)  # first use: dense blocks, stacked copies
            counters.reset()
            ms, resp = run(body, TAXI_MIN_REPS, TAXI_WINDOW_S)
            snap = counters.snapshot()
            prof = profile_path(torch, lambda: run(body, TAXI_PROFILED))
            res[mesh] = (ms, resp, snap, prof)
        on_mesh(True)
        (ms, resp, snap, prof), host = res[True], res[False]
        route = "agg_terms_device" if name == "keyword_terms" else "agg_mask"
        _hold(snap.get("mesh_search") == len(ms)
              and snap.get(route) == len(ms),
              f"{name}: the mesh route did not serve it: {snap}")
        _hold(not any(k.startswith(("mesh_", "agg_")) for k in host[2]),
              f"{name}: the host loop ran the mesh: {host[2]}")
        _hold(json.dumps(dict(resp, took=0), sort_keys=True)
              == json.dumps(dict(host[1], took=0), sort_keys=True),
              f"{name}: the mesh's response differs from the host loop's")
        taxi_oracle_check(np, name, resp, taxis)
        if name == "cardinality":
            card_eq = taxi_cardinality_check(np, torch, node, resp, taxis)
        for label, (ms_, _r, _s, prof_) in (("mesh path", res[True]),
                                            ("host loop", host)):
            if prof_ is None:
                dev_txt = "device time not measured"
            else:
                busy, kern, hd, dh, top = prof_
                per = busy / TAXI_PROFILED
                dev_txt = (f"device {per:.3f} ms a request "
                           f"({100 * per / ms_.mean():.1f}% busy), "
                           f"{kern / TAXI_PROFILED:.1f} kernels, "
                           f"{hd / TAXI_PROFILED:.1f} copies in and "
                           f"{dh / TAXI_PROFILED:.1f} back a request; top: "
                           + "; ".join(top[:3]))
            tail = (f"p99 {np.percentile(ms_, 99):.3f} ms"
                    if len(ms_) >= TAXI_TAIL_REPS else
                    f"slowest {ms_.max():.3f} ms (too few for a p99)")
            lines.append(
                f"[aggs] {name}, {label}"
                + (f" ({route})" if label == "mesh path" else "")
                + f" on {card}: p50 {np.percentile(ms_, 50):.3f} ms, "
                  f"{tail} over {len(ms_)} requests, {dev_txt}")
    for line in lines:
        log(line)
    log(f"[aggs] every response byte-identical on both routes and held "
        f"against numpy: keys, order and counts exact, count/min/max "
        f"exact, sums and averages within 1e-5 of f64 (variance 1e-4), "
        f"percentiles equal numpy's sample; fare HLL registers in the "
        f"numpy bounds on all {TAXI_SHARDS} shards, {card_eq[0]} of "
        f"{TAXI_SHARDS * 4096} equal to the exact-rank build "
        f"({card_eq[1]} with a value in the f32 band)")
    multi_aggs(torch, np, dev, card, node, taxis, tarrays)
    del tarrays
    log(f"[aggs] phase 5f took {time.perf_counter() - t0:.1f} s")
    return node, taxis


MULTI_AGG_REPS = 9  # 5u(d)'s timed requests a body and node
#: phase 5u(d)'s bodies: keyword terms counted in the round, and terms,
#: value_count, avg and stats over the round's mask
MULTI_AGG_BODIES = {
    "keyword_terms": TAXI_BODIES["keyword_terms"],
    "metrics": {"size": 0, "aggs": {
        "payments": {"terms": {"field": "payment_type"}},
        "tips": {"value_count": {"field": "tip_amount"}},
        "avg_fare": {"avg": {"field": "fare_amount"}},
        "passengers": {"stats": {"field": "passenger_count"}}}},
}


def multi_aggs(torch, np, dev, card, one_node, t, tarrays):
    """Phase 5u(d): 5f's four shards of trips (the same arrays) on a node
    over the mesh devices of ``multi_devices`` (four: one shard each).
    Terms, value_count, avg and stats: the response byte-identical to
    5f's one-device node's and held against numpy (buckets and counts
    exact, sums within 1e-5), with the integer lanes summed across the
    devices (``mesh_psum`` once per agg)."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters

    t0 = time.perf_counter()
    devs, form = multi_devices(torch, dev)
    node = Node(name="taxis-multi", device=devs)
    try:
        node.create_index("taxis", {
            "settings": {"number_of_shards": TAXI_SHARDS},
            "mappings": TAXI_MAPPING})
        svc = node.get_index("taxis")
        for s in range(TAXI_SHARDS):
            svc.shards[s].engine.add_segment(segment_from_arrays(
                tarrays[s], svc.shards[s].engine.residency))
        nd = svc.mesh_executor().n_devices
        n_all = int(t["trip_distance"].size)
        lines = []
        for name, body in MULTI_AGG_BODIES.items():
            node.search("taxis", copy.deepcopy(body))  # first use
            counters.reset()
            resp = node.search("taxis", copy.deepcopy(body))
            snap = counters.snapshot()
            ms, _ = _median_ms(np, lambda b: node.search("taxis", b), [
                copy.deepcopy(body) for _ in range(MULTI_AGG_REPS + 1)])
            one_ms, want = _median_ms(
                np, lambda b: one_node.search("taxis", b),
                [copy.deepcopy(body) for _ in range(MULTI_AGG_REPS + 1)])
            n_aggs = len(body["aggs"])
            _hold(snap.get("mesh_search") == 1
                  and snap.get("mesh_psum") == n_aggs,
                  f"(d) {name}: the cross-device merge did not run once an "
                  f"agg: {snap}", "5u")
            _hold(json.dumps(dict(resp, took=0), sort_keys=True)
                  == json.dumps(dict(want, took=0), sort_keys=True),
                  f"(d) {name}: the response differs from the one-device "
                  f"node's", "5u")
            if name == "keyword_terms":
                taxi_oracle_check(np, name, resp, t)
            else:
                a = resp["aggregations"]
                terms = TAXI_KEYWORDS["payment_type"]
                cnt = np.bincount(t["payment_type"], minlength=len(terms))
                _hold([(b["doc_count"], b["key"])
                       for b in a["payments"]["buckets"]]
                      == sorted(((int(c), terms[i]) for i, c in
                                 enumerate(cnt) if c), reverse=True)[:10],
                      f"(d) payments {a['payments']}", "5u")
                _hold(a["tips"]["value"] == int(t["tip_exists"].sum()),
                      f"(d) tips {a['tips']}", "5u")
                _near(a["avg_fare"]["value"],
                      float(t["fare_amount"].sum()) / n_all, 1e-5,
                      "5u(d) avg_fare")
                pc = t["passenger_count"]
                ps = a["passengers"]
                _hold(ps["count"] == n_all and ps["min"] == float(pc.min())
                      and ps["max"] == float(pc.max()),
                      f"(d) passengers {ps}", "5u")
                _near(ps["sum"], float(pc.sum()), 1e-5, "5u(d) passengers")
            lines.append(f"{name} median {ms:.3f} ms of {MULTI_AGG_REPS} "
                         f"(one device {one_ms:.3f}), mesh_psum "
                         f"{snap.get('mesh_psum')} a request")
        log(f"[5u] (d) {TAXI_SHARDS} shards of trips over {nd} mesh devices "
            f"({form}) on {card}: " + "; ".join(lines) + "; byte-identical "
            f"to 5f's one-device node, buckets and counts equal numpy's, "
            f"sums within 1e-5; took {time.perf_counter() - t0:.1f} s")
    finally:
        node.close()


# ---------------------------------------------------------------------------
# phase 5g: field sort and the request tail on the nyc_taxis stand-in
# ---------------------------------------------------------------------------

SORT_WINDOW_S = 0.25       # timed requests per body and route: about this
SORT_MIN_REPS = 10         # many seconds, at least SORT_MIN_REPS, at most
SORT_PROFILED = 4          # TAXI_MAX_REPS; this many under the profiler
AFTER_PAGES, AFTER_SIZE = 10, 100      # http_logs' search_after operations
SCROLL_PAGES, SCROLL_SIZE = 25, 1000   # geonames' scroll operation
SCROLL_DRAINS = 3          # timed drains of the scroll and of the scan
HL_DOCS = 2000             # the highlight index, written by Node.index
HL_WORDS = ("the quick brown fox jumps over lazy dog river mountain valley "
            "ocean forest desert island city night morning light water "
            "stone bridge road market garden").split()
SCROLL_QUERY = {"range": {"trip_distance": {"gte": 2, "lt": 10}}}
#: scores 1 to 3: how many of three ranges a trip falls in
TAIL_QUERY = {"bool": {"should": [
    {"range": {"trip_distance": {"gte": 5}}},
    {"range": {"fare_amount": {"gte": 20}}},
    {"range": {"tip_amount": {"gte": 3}}}]}}
#: name -> (body, its sort keys for the oracle, runs on the mesh too)
SORT_BODIES = {
    "a_total_amount_desc": ({"sort": [{"total_amount": "desc"}],
                             "size": 10},
                            [("total_amount", "desc", "_last")], True),
    "c_vendor_then_distance": ({"sort": ["vendor_id",
                                         {"trip_distance": "desc"}],
                                "size": 10},
                               [("vendor_id", "asc", "_last"),
                                ("trip_distance", "desc", "_last")], True),
    "d_tip_missing_last": ({"sort": [{"tip_amount": {
        "order": "asc", "missing": "_last"}}], "size": 10},
        [("tip_amount", "asc", "_last")], True),
    "d_tip_missing_first": ({"sort": [{"tip_amount": {
        "order": "asc", "missing": "_first"}}], "size": 10},
        [("tip_amount", "asc", "_first")], True),
    "f_min_score": ({"query": TAIL_QUERY, "min_score": 2, "size": 10},
                    None, False),
    "f_terminate_after": ({"query": SCROLL_QUERY, "terminate_after": 1000,
                           "size": 10}, None, False),
    "f_timeout": ({"query": SCROLL_QUERY, "timeout": "10s", "size": 10},
                  None, False),
    "g_profile": ({"sort": [{"total_amount": "desc"}], "size": 10,
                   "profile": True}, [("total_amount", "desc", "_last")],
                  False),
}


def _taxi_value(t, field, i):
    """The sort value a hit reports for trip ``i`` (None when missing)."""
    if field in TAXI_KEYWORDS:
        return TAXI_KEYWORDS[field][int(t[field][i])]
    if field == "tip_amount" and not t["tip_exists"][i]:
        return None
    v = t[field][i]
    return int(v) if t[field].dtype.kind == "i" else float(v)


def taxi_sort_order(np, t, keys, n):
    """The first ``n`` trips in ES order by ``np.lexsort``: per key a
    missing rank and the value (keywords by ordinal, which is term
    order), then shard and local id, which for one segment a shard is
    the trip's index."""
    cols = []
    for field, order, missing in keys:
        v = t[field]
        if field == "tip_amount":
            rank = np.where(t["tip_exists"], 1, 0 if missing == "_first"
                            else 2)
            v = np.where(t["tip_exists"], v, 0.0)
        else:
            rank = np.ones(v.size, np.int8)
        cols += [rank, -v if order == "desc" else v]
    idx = np.arange(t["trip_distance"].size)
    return np.lexsort([idx] + cols[::-1])[:n]


def _hold_hits(t, resp, want_idx, keys, what):
    """A response's hits are the trips ``want_idx`` in order: each hit's
    local id and, sorted, its sort values."""
    hits = resp["hits"]["hits"]
    _hold([h["_id"] for h in hits]
          == [str(int(i) % TAXI_DOCS) for i in want_idx],
          f"{what}: the hits are not numpy's", "5g")
    if keys:
        _hold([h["sort"] for h in hits]
              == [[_taxi_value(t, f, int(i)) for f, _o, _m in keys]
                  for i in want_idx],
              f"{what}: the sort values are not numpy's", "5g")


def _route_line(np, name, label, ms, prof, per_call=SORT_PROFILED):
    tail = (f"p99 {np.percentile(ms, 99):.3f} ms"
            if len(ms) >= TAXI_TAIL_REPS else
            f"slowest {ms.max():.3f} ms (too few for a p99)")
    if prof is None:
        dev_txt = "device time not measured"
    else:
        busy, kern, hd, dh, top = prof
        per = busy / per_call
        dev_txt = (f"device {per:.3f} ms a request "
                   f"({100 * per / ms.mean():.1f}% busy), "
                   f"{kern / per_call:.1f} kernels, {hd / per_call:.1f} "
                   f"copies in and {dh / per_call:.1f} back a request; "
                   f"top: " + "; ".join(top[:3]))
    return (f"[sort] {name}, {label}: p50 {np.percentile(ms, 50):.3f} ms, "
            f"{tail} over {len(ms)} requests, {dev_txt}")


def phase_sort(torch, np, dev, card, node, t):
    """Phase 5g: field sort, ``search_after``, scroll and the request
    tail on phase 5f's node (4,194,304 generated trips in four shards of
    one 2^20-doc segment), with the bodies of Rally's public tracks:
    ``http_logs``' ``desc_sort_*`` / ``asc_sort_*`` and their
    ``search_after`` forms, ``geonames``' ``scroll`` (25 pages of 1000).
    Each body runs on every route it takes (the mesh path and the host
    loop; ``min_score``, ``terminate_after``, ``timeout``,
    ``search_after``, ``scroll`` and ``profile`` keep a request on the
    host loop) and is held against numpy over the generated arrays:
    ``np.lexsort`` order and sort values exact, totals exact. Per body
    and route: p50 over about SORT_WINDOW_S seconds of requests, p99
    from TAXI_TAIL_REPS on, device time, kernels and copies over
    SORT_PROFILED profiled requests, busy share."""
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import (adc, bm25_topk, knn_topk,
                                             maxsim_adc)
    from elasticsearch_tpu_torch.search.service import (clear_scroll,
                                                        scroll_next)

    hand = (bm25_topk, knn_topk, adc, maxsim_adc)
    t0 = time.perf_counter()
    svc = node.get_index("taxis")
    f32 = np.float32
    n_all = t["trip_distance"].size
    idx_all = np.arange(n_all)

    def on_mesh(flag):
        svc.settings["search"] = {"mesh": flag}

    def timed(fn, n, window_s):
        ms, out = [], None
        start = time.perf_counter()
        while len(ms) < n or (len(ms) < TAXI_MAX_REPS and
                              time.perf_counter() - start < window_s):
            a = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - a) * 1e3)
        return np.array(ms), out

    lines = []
    for name, (body, keys, mesh_too) in SORT_BODIES.items():
        want = None
        if keys is not None:
            want = taxi_sort_order(np, t, keys, body["size"])
        answers = {}
        # True: the mesh path; False: the host loop, pinned; None: the
        # host loop because the mesh declines the body's keys
        for mesh in ((True, False) if mesh_too else (None,)):
            on_mesh(mesh is not False)

            def one():
                return node.search("taxis", copy.deepcopy(body))

            for m in hand:
                m.LAUNCHES = 0
            one()  # first use: the sort mirrors, stacked copies
            # the sort path and the request tail launch no hand kernel
            _hold(not any(m.LAUNCHES for m in hand),
                  f"{name}: a hand kernel ran", "5g")
            counters.reset()
            ms, resp = timed(one, SORT_MIN_REPS, SORT_WINDOW_S)
            snap = counters.snapshot()
            if mesh is False:
                _hold(not any(k.startswith("mesh_") for k in snap),
                      f"{name}: the pinned host loop ran the mesh", "5g")
            else:
                route = "mesh_search" if mesh else "mesh_fallback_total"
                _hold(snap.get(route) == len(ms),
                      f"{name}: not served by {route}: {snap}", "5g")
            prof = profile_path(torch, lambda: [one() for _ in
                                                range(SORT_PROFILED)])
            label = {True: "mesh path", False: "host loop",
                     None: "host loop (the mesh declines it)"}[mesh]
            answers[mesh] = resp
            what = f"{name} ({label})"
            if want is not None:
                _hold(resp["hits"]["total"] == n_all,
                      f"{what}: total {resp['hits']['total']}", "5g")
                _hold_hits(t, resp, want, keys, what)
            lines.append(_route_line(np, name, label, ms, prof))
            if name == "g_profile":
                shards = resp["profile"]["shards"]
                _hold(len(shards) == TAXI_SHARDS and all(
                    s["tpu"]["segments"] == 1 and s["tpu"]["phases"][
                        "device_execute_nanos"] > 0 for s in shards),
                    f"{what}: profile {shards[:1]}", "5g")
                ph = shards[0]["tpu"]["phases"]
                lines.append(
                    "[sort] g_profile, shard 0's phases (ms): " + ", ".join(
                        f"{k[:-6]} {v / 1e6:.3f}" for k, v in ph.items()
                        if v))
        if mesh_too:
            _hold(json.dumps(dict(answers[True], took=0), sort_keys=True)
                  == json.dumps(dict(answers[False], took=0),
                                sort_keys=True),
                  f"{name}: the mesh's response differs from the host "
                  f"loop's", "5g")
        if name.startswith("f_"):
            td, fare, tip = (t["trip_distance"].astype(f32),
                             t["fare_amount"].astype(f32),
                             t["tip_amount"].astype(f32))
            if name == "f_min_score":
                score = ((td >= f32(5)).astype(np.int64)
                         + (fare >= f32(20)) + ((tip >= f32(3))
                                                & t["tip_exists"]))
                ok = score >= 2
                total = int(ok.sum())
                top = idx_all[ok][np.lexsort((idx_all[ok], -score[ok]))][
                    :10]
                _hold([h["_score"] for h in resp["hits"]["hits"]]
                      == [float(score[i]) for i in top],
                      f"{name}: scores", "5g")
            else:
                ok = (td >= f32(2)) & (td < f32(10))
                total = int(ok.sum())
                top = idx_all[ok][:10]
                if name == "f_terminate_after":
                    total = TAXI_SHARDS * 1000
                    _hold(resp.get("terminated_early") is True,
                          f"{name}: not terminated early", "5g")
                else:
                    _hold(resp["timed_out"] is False, f"{name}: timed out",
                          "5g")
            _hold(resp["hits"]["total"] == total,
                  f"{name}: total {resp['hits']['total']} vs {total}", "5g")
            _hold_hits(t, resp, top, None, name)
    on_mesh(True)

    # (b) search_after: AFTER_PAGES pages of AFTER_SIZE by pickup time
    pick = t["pickup_datetime"]
    order = np.argsort(pick, kind="stable")
    walk_body = {"sort": [{"pickup_datetime": "asc"}], "size": AFTER_SIZE}
    for mesh in (True, False):
        on_mesh(mesh)
        ms, got = [], []
        counters.reset()
        for _ in range(SORT_MIN_REPS // 2):
            after, ids = None, []
            for _ in range(AFTER_PAGES):
                b = dict(walk_body, search_after=after) if after else \
                    walk_body
                a = time.perf_counter()
                page = node.search("taxis", copy.deepcopy(b))
                ms.append((time.perf_counter() - a) * 1e3)
                ids += [h["_id"] for h in page["hits"]["hits"]]
                after = page["hits"]["hits"][-1]["sort"]
            got = ids
        snap = counters.snapshot()
        # ES's rule, in numpy: a page starts strictly after the cursor
        want, pos = [], 0
        for _ in range(AFTER_PAGES):
            pg = order[pos: pos + AFTER_SIZE]
            want += [str(int(i) % TAXI_DOCS) for i in pg]
            pos = int(np.searchsorted(pick[order], pick[pg[-1]],
                                      side="right"))
        _hold(got == want, "b: the search_after walk is not numpy's", "5g")
        reps = SORT_MIN_REPS // 2
        _hold((snap.get("mesh_search", 0), snap.get("mesh_fallback_total",
                                                    0))
              == ((reps, (AFTER_PAGES - 1) * reps) if mesh else (0, 0)),
              f"b: routes {snap}", "5g")

        def walk():
            after = None
            for _ in range(AFTER_PAGES):
                b = dict(walk_body, search_after=after) if after else \
                    walk_body
                after = node.search("taxis", copy.deepcopy(b))[
                    "hits"]["hits"][-1]["sort"]

        prof = profile_path(torch, walk)
        lines.append(_route_line(
            np, f"b_search_after ({AFTER_PAGES} pages of {AFTER_SIZE})",
            f"page 1 on the mesh path, pages 2-{AFTER_PAGES} on the host "
            f"loop"
            if mesh else "host loop", np.array(ms), prof,
            per_call=AFTER_PAGES))
    on_mesh(True)

    # (e) a score-ordered scroll and a scan: SCROLL_PAGES of SCROLL_SIZE
    td = t["trip_distance"].astype(f32)
    match = idx_all[(td >= f32(2)) & (td < f32(10))]
    for kind in ("scroll", "scan"):
        body = {"query": SCROLL_QUERY, "scroll": "1m", "size": SCROLL_SIZE}
        if kind == "scan":
            body["search_type"] = "scan"
        opens, pages = [], []

        def drain(timing):
            a = time.perf_counter()
            first = node.search("taxis", copy.deepcopy(body))
            if timing:
                opens.append((time.perf_counter() - a) * 1e3)
            got = [h["_id"] for h in first["hits"]["hits"]]
            while len(got) < SCROLL_PAGES * SCROLL_SIZE:
                a = time.perf_counter()
                page = scroll_next(first["_scroll_id"])
                if timing:
                    pages.append((time.perf_counter() - a) * 1e3)
                got += [h["_id"] for h in page["hits"]["hits"]]
            clear_scroll(first["_scroll_id"])
            return first, got

        for _ in range(SCROLL_DRAINS):
            first, got = drain(True)
        _hold(first["hits"]["total"] == match.size
              and got == [str(int(i) % TAXI_DOCS)
                          for i in match[: SCROLL_PAGES * SCROLL_SIZE]],
              f"e: the {kind}'s pages are not numpy's", "5g")
        _hold(kind != "scan" or not first["hits"]["hits"],
              "e: a scan's first page has hits", "5g")
        prof = profile_path(torch, lambda: drain(False))
        busy = (f"device {prof[0]:.3f} ms a drain, {prof[1]} kernels, "
                f"{prof[2]} copies in and {prof[3]} back; top: "
                + "; ".join(prof[4][:3])) if prof else \
            "device time not measured"
        op, pg = np.array(opens), np.array(pages)
        lines.append(
            f"[sort] e_{kind} ({SCROLL_PAGES} pages of {SCROLL_SIZE}, "
            f"{match.size} matches), host loop: open p50 "
            f"{np.percentile(op, 50):.3f} ms (slowest {op.max():.3f}), next "
            f"page p50 {np.percentile(pg, 50):.3f} ms, p99 "
            f"{np.percentile(pg, 99):.3f} ms over {pg.size} pages, a drain "
            f"{(op.sum() + pg.sum()) / SCROLL_DRAINS:.3f} ms; {busy}")

    # (h) highlight on a small text index written through Node.index
    rng = np.random.default_rng(SEED)
    ts = time.perf_counter()
    node.create_index("hl", {"settings": {"number_of_shards": 2},
                             "mappings": {"properties": {
                                 "body": {"type": "text",
                                          "analyzer": "standard"}}}})
    texts = {}
    for i in range(HL_DOCS):
        words = rng.choice(HL_WORDS, size=int(rng.integers(20, 41)))
        texts[str(i)] = " ".join(words).capitalize() + "."
        node.index("hl", str(i), {"body": texts[str(i)]})
    node.refresh("hl")
    hl_setup = time.perf_counter() - ts
    hsvc = node.get_index("hl")
    hl_body = {"query": {"match": {"body": "fox river"}}, "size": 10,
               "highlight": {"fields": {"body": {"fragment_size": 60}}}}
    res, b1 = {}, 0
    for mesh in (True, False):
        hsvc.settings["search"] = {"mesh": mesh}

        def one():
            return node.search("hl", copy.deepcopy(hl_body))

        bm25_topk.LAUNCHES = 0
        one()  # a pure-dense match: B1 on each shard's segment
        _hold(bm25_topk.LAUNCHES == 2, f"h: B1 launched "
              f"{bm25_topk.LAUNCHES} times, not once a shard", "5g")
        b1 += bm25_topk.LAUNCHES
        ms, resp = timed(one, SORT_MIN_REPS, SORT_WINDOW_S)
        prof = profile_path(torch, lambda: [one() for _ in
                                            range(SORT_PROFILED)])
        res[mesh] = resp
        lines.append(_route_line(np, f"h_highlight ({HL_DOCS} docs)",
                                 "mesh path" if mesh else "host loop", ms,
                                 prof))
    _hold(json.dumps(dict(res[True], took=0), sort_keys=True)
          == json.dumps(dict(res[False], took=0), sort_keys=True),
          "h: the mesh's response differs from the host loop's", "5g")
    n_match = sum(1 for s in texts.values()
                  if re.search(r"\b(fox|river)\b", s.lower()))
    _hold(res[True]["hits"]["total"] == n_match, "h: total", "5g")
    for h in res[True]["hits"]["hits"]:
        for frag in h["highlight"]["body"]:
            plain = frag.replace("<em>", "").replace("</em>", "")
            tagged = re.findall(r"<em>(.*?)</em>", frag)
            _hold(plain in texts[h["_id"]] and tagged and all(
                w.lower() in ("fox", "river") for w in tagged)
                and not re.search(r"\b(fox|river)\b", re.sub(
                    r"<em>.*?</em>", "", frag).lower()),
                f"h: fragment {frag!r}", "5g")
    for line in lines:
        log(line)
    log(f"[sort] every body held against numpy on every route it takes "
        f"(order, sort values and totals exact), the mesh's responses "
        f"equal to the host loop's; the highlight index ({HL_DOCS} docs of "
        f"20-40 words, two shards) took {hl_setup:.1f} s to write")
    log(f"[sort] phase 5g took {time.perf_counter() - t0:.1f} s; B1 "
        f"launches in (h)'s two counted requests: {b1}")
    return b1


# ---------------------------------------------------------------------------
# phase 5h: the write path and merges on the card
# ---------------------------------------------------------------------------

WP_DOCS = 1 << 13          # logs-a's documents (cut from 2^18, PERF.md §4)
WP_REFRESHES = 32          # refreshes over logs-a: ~32 fresh segments a shard
WP_SHARDS = 5              # ES 2.0's default index.number_of_shards
WP_B_SHARE = 10            # logs-b holds a further 1/WP_B_SHARE of the docs
WP_PREFIX = 1 << 12        # the CPU comparison's prefix of logs-a
WP_RECLAIM = 0.3           # the share of one shard's docs deleted
WP_REPS = 40               # timed requests per body
WP_MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "ts": {"type": "date"},
}}
#: phase 4's five body shapes on 5h's vocabulary, and a deep page
WP_BODIES = {
    "match": {"query": {"match": {"body": "t0 t1 t5"}}},
    "match_tail": {"query": {"match": {"body": "t2000 t7000 t15000"}}},
    "term": {"query": {"term": {"tag": "g3"}}, "size": 5},
    "bool_range": {"query": {"bool": {
        "must": [{"match": {"body": "t10 t40"}}],
        "filter": [{"range": {"n": {"gte": 100_000, "lt": 600_000}}}]}}},
    "paged": {"query": {"match": {"body": "t3 t9 t27"}},
              "from": 10, "size": 10},
    "deep": {"query": {"match": {"body": "t1 t300"}}, "from": 5000,
             "size": 20},
}
#: dfs bodies: a head term with rarer ones (the f32 generic route)
WP_DFS = [{"query": {"match": {"body": q}}, "size": 10}
          for q in ("t2 t150 t900", "t0 t70 t3000", "t12 t500",
                    "t6 t45 t260 t8000")]


def wp_docs(np, n, seed, start=0):
    """[(id, source)]: a ``body`` of 20-80 tokens drawn Zipf(1.1) from
    phase 5's 30,000-term vocabulary (MS-MARCO-passage lengths), a
    ``tag`` of 9 values, a long ``n`` and a date ``ts``."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.1
    p /= p.sum()
    lens = rng.integers(20, 81, n)
    toks = rng.choice(VOCAB, size=int(lens.sum()), p=p)
    words = np.array([f"t{i}" for i in range(VOCAB)])
    cuts = np.concatenate([[0], np.cumsum(lens)])
    tags = rng.integers(0, 9, n)
    nums = rng.integers(0, 1_000_000, n)
    ts = TAXI_YEAR + rng.integers(0, 30 * DAY_MS, n)
    return [(f"d{start + i}", {
        "body": " ".join(words[toks[cuts[i]: cuts[i + 1]]].tolist()),
        "tag": f"g{int(tags[i])}", "n": int(nums[i]), "ts": int(ts[i])})
        for i in range(n)]


def _strip_took(resp) -> str:
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


@contextlib.contextmanager
def _host_loop():
    """The host loop for every index while the block runs."""
    os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        yield
    finally:
        del os.environ["ESTPU_DISABLE_MESH"]


def _wp_time(np, torch, node, index, bodies, reps=WP_REPS):
    """ms of each search of ``bodies`` on ``index``, in turn, until
    ``reps`` requests ran (synchronized), after one warm-up pass."""
    for b in bodies:
        node.search(index, copy.deepcopy(b))
    torch.cuda.synchronize()
    ms = []
    for r in range(reps):
        b = copy.deepcopy(bodies[r % len(bodies)])
        t = time.perf_counter()
        node.search(index, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return np.array(ms)


def _pcts(np, ms) -> str:
    return (f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms over {len(ms)}")


def _dev_line(np, prof, n, ms) -> str:
    """Device time, kernels and copies a request over ``n`` profiled
    requests, and the busy share against the mean of ``ms``."""
    if prof is None:
        return "device time not measured"
    busy, kern, hd, dh, top = prof
    return (f"device {busy / n:.3f} ms a request "
            f"({100 * busy / n / ms.mean():.1f}% busy), {kern / n:.1f} "
            f"kernels, {hd / n:.1f} copies in and {dh / n:.1f} back; top: "
            + "; ".join(top[:3]))


def _profile_bodies(torch, node, index, bodies):
    return profile_path(torch, lambda: [node.search(index, copy.deepcopy(b))
                                        for b in bodies])


def _hold_no_retired(node, retired, what):
    """The executors hold no retired segment; the ``segments`` breaker
    holds exactly the live segments' charges, ``fielddata`` the live
    segments' and the executors' caches'. Returns the two byte counts."""
    segs = [seg for svc in node.indices.values() for s in svc.shards
            for seg in s.segments]
    execs = [svc._mesh_executor for svc in node.indices.values()
             if svc._mesh_executor is not None]
    held = set().union(*[ex.cached_segments() for ex in execs])
    _hold(not (held & retired), f"{what}: an executor holds a retired "
          f"segment", "5h")
    seg_used = node.breakers.breaker("segments").used
    fd_used = node.breakers.breaker("fielddata").used
    want_fd = sum(s.fielddata_bytes() for s in segs) + sum(
        ex.data_bytes() + sum(rd.nbytes for rd in ex._prep.values())
        for ex in execs)
    _hold(seg_used == sum(s.memory_bytes() for s in segs),
          f"{what}: segments breaker {seg_used} != the live segments' "
          f"{sum(s.memory_bytes() for s in segs)}", "5h")
    _hold(fd_used == want_fd, f"{what}: fielddata breaker {fd_used} != "
          f"{want_fd}", "5h")
    return seg_used, fd_used


def _f64_dfs(np, searchers, body, k):
    """The want-response of a dfs ``match`` (or-group) over ``searchers``
    in f64: idf from the df and doc counts summed over every searched
    segment, BM25 tf-normalisation from each segment's own lengths and
    average length, the host loop's order (-score, shard, local)."""
    from elasticsearch_tpu_torch.index.segment import B, K1

    terms = list(dict.fromkeys(body["query"]["match"]["body"].split()))
    segs = [(pos, seg) for pos, s in enumerate(searchers)
            for seg in s.segments]
    n_all = sum(seg.inverted["body"].num_docs for _, seg in segs
                if "body" in seg.inverted)
    df = {t: sum(int(seg.inverted["body"].df[seg.inverted["body"].vocab[t]])
                 for _, seg in segs if t in seg.inverted["body"].vocab)
          for t in terms}
    cands, total = [], 0
    for pos, seg in segs:
        inv = seg.inverted["body"]
        dl = seg.field_lengths["body"].cpu().numpy().astype(np.float64)
        score = np.zeros(seg.max_docs, np.float64)
        hit = np.zeros(seg.max_docs, bool)
        for t in terms:
            if t not in inv.vocab:
                continue
            tid = inv.vocab[t]
            lo, hi = int(inv.offsets[tid]), int(inv.offsets[tid + 1])
            docs = inv.doc_ids_host[lo:hi].astype(np.int64)
            tf = inv.tf_host[lo:hi].astype(np.float64)
            tfn = tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * dl[docs]
                                                 / inv.avg_len))
            idf = np.log(1.0 + (n_all - df[t] + 0.5) / (df[t] + 0.5))
            score[docs] += idf * tfn
            hit[docs] = True
        hit &= seg.live_host
        total += int(hit.sum())
        for i in np.nonzero(hit)[0].tolist():
            cands.append((-score[i], pos, i, seg.ids[i], score[i]))
    cands.sort(key=lambda c: c[:3])
    return {"hits": {"total": total, "hits": [
        {"_id": c[3], "_score": c[4]} for c in cands[:k]]}}


def phase_writepath(torch, np, dev, card):
    """Phase 5h: the write path and merges on the card. WP_DOCS generated
    documents (``wp_docs``) go through ``Node.index`` into ``logs-a``
    (five shards) with a refresh every WP_DOCS / WP_REFRESHES docs, so
    each shard gets ~32 fresh segments that the tiered policy (8 a tier)
    folds into ~4; ``logs-b`` takes a further 1/WP_B_SHARE. Checks, each
    held on the card: the mesh's deep page past the round's padded
    width (C1); B1 on merged segments; after ``force_merge(1)`` and after
    a delete-reclaim merge, responses byte-identical to one-refresh
    rebuilds of the live docs in each merged segment's order (C2); no
    retired segment in the executors and the breakers at the live
    segments' bytes after each merge; dfs on one index alike on both
    routes and, over two indices, against an f64 scorer; multi-index
    search, ``indices_boost`` and ``fields`` against a CPU Node on a
    WP_PREFIX-doc prefix; the request cache's hit, byte-equality and
    invalidation. Prints the ingest rate, refresh and merge times, the
    breaker bytes and the read p50/p99s. Returns B1's launches."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk

    t_phase = time.perf_counter()
    docs = wp_docs(np, WP_DOCS, SEED)
    docs_b = wp_docs(np, WP_DOCS // WP_B_SHARE, SEED + 1, start=WP_DOCS)
    log(f"[5h] {len(docs)} + {len(docs_b)} docs generated in "
        f"{time.perf_counter() - t_phase:.1f} s")
    bm25_topk.LAUNCHES = 0
    node = Node(name="writes", device=dev)
    for name in ("logs-a", "logs-b"):
        node.create_index(name, {"settings": {"number_of_shards": WP_SHARDS},
                                 "mappings": WP_MAPPING})
    svc = node.indices["logs-a"]
    every = WP_DOCS // WP_REFRESHES
    refresh_ms, merges = [], []
    c1 = None
    t0 = time.perf_counter()
    for j, (doc_id, src) in enumerate(docs):
        node.index("logs-a", doc_id, src)
        if (j + 1) % every:
            continue
        before = [(s.engine.stats.merge_total, s.engine.stats.merge_docs,
                   s.engine.stats.merge_time_ms) for s in svc.shards]
        t = time.perf_counter()
        node.refresh("logs-a")
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t) * 1e3)
        for s, (m, d, ms) in zip(svc.shards, before):
            st = s.engine.stats
            if st.merge_total > m:
                merges.append((st.merge_time_ms - ms, st.merge_docs - d))
        if (j + 1) // every == 7:
            # C1: seven fresh segments a shard; a page past the rounds'
            # padded width needs more candidates than one slot's width
            t_c1 = time.perf_counter()
            width = max(seg.max_docs for s in svc.shards
                        for seg in s.segments)
            deep = {"query": {"match_all": {}},
                    "from": min(9990, j + 1 - 10), "size": 10}
            _hold(deep["from"] > width, "C1: the page is not past the "
                  "round's width", "5h")
            counters.reset()
            mesh = node.search("logs-a", copy.deepcopy(deep))
            _hold(counters.snapshot().get("mesh_search") == 1,
                  "C1: the deep page did not run on the mesh", "5h")
            with _host_loop():
                host = node.search("logs-a", copy.deepcopy(deep))
            _hold(len(mesh["hits"]["hits"]) == 10 and _strip_took(mesh)
                  == _strip_took(host), "C1: the mesh's deep page is not "
                  "the host loop's full page", "5h")
            c1 = (deep["from"], width, mesh["hits"]["total"],
                  (time.perf_counter() - t_c1) * 1e3)
            t0 += time.perf_counter() - t_c1  # not part of the ingest
    ingest_s = time.perf_counter() - t0
    t = time.perf_counter()
    for doc_id, src in docs_b:
        node.index("logs-b", doc_id, src)
    node.refresh("logs-b")
    b_s = time.perf_counter() - t
    layout = [len(s.segments) for s in svc.shards]
    log(f"[5h] C1 on {card}: match_all from {c1[0]} on the mesh, round "
        f"width {c1[1]}, {c1[2]} docs: the full page, byte-identical to "
        f"the host loop ({c1[3]:.1f} ms for both)")
    rm = np.array(refresh_ms)
    log(f"[5h] ingest on {card}: {WP_DOCS} docs through Node.index into "
        f"logs-a ({WP_SHARDS} shards) in {ingest_s:.1f} s with "
        f"{len(rm)} refreshes and {len(merges)} tier merges counted in: "
        f"{WP_DOCS / ingest_s:.0f} docs/s; refresh p50 "
        f"{np.percentile(rm, 50):.1f} ms, p99 {np.percentile(rm, 99):.1f} "
        f"ms; segments a shard {layout}; logs-b {len(docs_b)} docs in "
        f"{b_s:.1f} s")
    log(f"[5h] tier merges on {card} (ms, docs): " + ", ".join(
        f"({ms:.1f}, {d})" for ms, d in merges))

    # B1 on merged segments, reads with ~4 segments a shard
    match = [{"query": {"match": {"body": f"t{a} t{b}"}}}
             for a, b in ((0, 3), (1, 6), (2, 9), (4, 12), (5, 20),
                          (7, 33), (8, 60), (11, 99))]
    tier_merged = {id(seg) for s in svc.shards for seg in s.segments
                   if seg.num_docs > every}
    _hold(bool(tier_merged), "no tier-merged segment to search", "5h")
    counters.reset()
    b1 = bm25_topk.LAUNCHES
    node.search("logs-a", copy.deepcopy(WP_BODIES["match"]))
    snap = counters.snapshot()
    _hold(snap.get("mesh_search") == 1 and snap.get("bm25_fused_topk", 0)
          >= len(layout) and bm25_topk.LAUNCHES > b1,
          f"B1 did not serve the merged segments on the mesh: {snap}", "5h")

    ms4 = _wp_time(np, torch, node, "logs-a", match)
    prof4 = _profile_bodies(torch, node, "logs-a", match)
    dfs = [dict(b, search_type="dfs_query_then_fetch") for b in WP_DFS]
    for b, plain in zip(dfs, WP_DFS):
        got = node.search("logs-a", copy.deepcopy(b))
        with _host_loop():
            host = node.search("logs-a", copy.deepcopy(b))
        check_hits(got, host, f"5h dfs mesh vs host loop {b}")
        check_hits(got, _f64_dfs(np, [s.searcher for s in svc.shards], b,
                                 10), f"5h dfs vs f64 {b}")
        two = node.search("logs-a,logs-b", copy.deepcopy(b))
        check_hits(two, _f64_dfs(np, [s.searcher for n in ("logs-a",
                                                            "logs-b")
                                      for s in node.indices[n].shards], b,
                                 10), f"5h dfs over two indices vs f64 {b}")
        _hold(node.search("logs-a", copy.deepcopy(plain))["hits"]["hits"]
              != got["hits"]["hits"], "dfs changed no score", "5h")

    dfs_ms = _wp_time(np, torch, node, "logs-a", dfs)
    qtf_ms = _wp_time(np, torch, node, "logs-a", WP_DFS)
    prof_dfs = _profile_bodies(torch, node, "logs-a", dfs)
    multi = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
             for a, b in ((2, 150), (0, 44), (9, 700), (3, 31))]
    multi_ms = _wp_time(np, torch, node, "logs-*", multi)
    prof_multi = _profile_bodies(torch, node, "logs-*", multi)
    log(f"[5h] reads on {card}, {layout} segments a shard: match on the "
        f"mesh {_pcts(np, ms4)} requests, "
        f"{_dev_line(np, prof4, len(match), ms4)}")
    log(f"[5h] dfs on {card}: p50 {np.percentile(dfs_ms, 50):.3f} ms "
        f"against query_then_fetch p50 {np.percentile(qtf_ms, 50):.3f} ms "
        f"on the mesh ({len(dfs)} bodies; the same hits on the mesh and "
        f"the host loop, within 1e-5 of the f64 scorer on logs-a and on "
        f"logs-a,logs-b), {_dev_line(np, prof_dfs, len(dfs), dfs_ms)}")
    log(f"[5h] multi-index on {card}: logs-* (two indices, ten shards, the "
        f"host loop) {_pcts(np, multi_ms)} requests, "
        f"{_dev_line(np, prof_multi, len(multi), multi_ms)}")

    # force merge to one segment a shard
    retired = {id(seg) for s in svc.shards for seg in s.segments}
    seg0, fd0 = (node.breakers.breaker(b).used
                 for b in ("segments", "fielddata"))
    t = time.perf_counter()
    svc.force_merge(1)
    torch.cuda.synchronize()
    fm_ms = (time.perf_counter() - t) * 1e3
    seg1, fd1 = _hold_no_retired(node, retired, "force merge")
    _hold([len(s.segments) for s in svc.shards] == [1] * WP_SHARDS,
          "force merge left more than one segment a shard", "5h")
    counters.reset()
    b1 = bm25_topk.LAUNCHES
    node.search("logs-a", copy.deepcopy(WP_BODIES["match"]))
    snap = counters.snapshot()
    _hold(snap.get("mesh_search") == 1 and snap.get("bm25_fused_topk") ==
          WP_SHARDS and bm25_topk.LAUNCHES == b1 + WP_SHARDS,
          f"B1 did not serve the force-merged segments: {snap}", "5h")
    ms1 = _wp_time(np, torch, node, "logs-a", match)
    prof1 = _profile_bodies(torch, node, "logs-a", match)
    log(f"[5h] force merge on {card}: {svc.num_docs} docs into one segment "
        f"a shard in {fm_ms:.1f} ms; breakers segments {seg0} -> {seg1} "
        f"bytes, fielddata {fd0} -> {fd1} bytes (each equal to the live "
        f"segments' and caches' charges; no retired segment cached)")
    log(f"[5h] reads on {card}, one segment a shard: match on the mesh "
        f"{_pcts(np, ms1)} requests, {_dev_line(np, prof1, len(match), ms1)}")

    # C2: responses byte-identical to one-refresh rebuilds
    def rebuild(label):
        fresh = Node(name=label, device=dev)
        fresh.create_index("logs-a", {"settings": {
            "number_of_shards": WP_SHARDS}, "mappings": WP_MAPPING})
        for s in svc.shards:
            for seg in s.segments:
                live = seg.live_host
                for local, doc_id in enumerate(seg.ids):
                    if live[local]:
                        fresh.index("logs-a", doc_id, seg.sources[local])
        fresh.refresh("logs-a")
        want = [len(s.segments) for s in svc.shards]
        _hold([len(s.segments) for s in fresh.indices["logs-a"].shards]
              == want, f"{label}: the rebuild's layout differs", "5h")
        return fresh

    def hold_bytes(fresh, what):
        for name, body in WP_BODIES.items():
            for route in ("mesh", "host"):
                with (_host_loop() if route == "host"
                      else contextlib.nullcontext()):
                    got = node.search("logs-a", copy.deepcopy(body))
                    want = fresh.search("logs-a", copy.deepcopy(body))
                _hold(_strip_took(got) == _strip_took(want) and
                      got["hits"]["hits"], f"{what} {name} {route}: not "
                      "byte-identical to the rebuild", "5h")

    t = time.perf_counter()
    fresh = rebuild("rebuild")
    hold_bytes(fresh, "C2 force merge")
    fresh.close()
    rb1 = time.perf_counter() - t
    shard0 = svc.shards[0]
    (seg,) = shard0.segments
    victims = [d for i, d in enumerate(seg.ids) if i % 10 < 10 * WP_RECLAIM]
    retired = {id(seg)}
    m0 = shard0.engine.stats.merge_total
    t = time.perf_counter()
    for doc_id in victims:
        node.delete("logs-a", doc_id)
    node.refresh("logs-a")
    torch.cuda.synchronize()
    reclaim_ms = (time.perf_counter() - t) * 1e3
    st = shard0.engine.stats
    _hold(st.merge_total == m0 + 1 and shard0.segments[0].deleted_count == 0,
          "the delete-reclaim merge did not fire", "5h")
    _hold_no_retired(node, retired, "reclaim merge")
    t = time.perf_counter()
    fresh = rebuild("rebuild2")
    hold_bytes(fresh, "C2 reclaim")
    fresh.close()
    rb2 = time.perf_counter() - t
    log(f"[5h] C2 on {card}: after force_merge(1) and after deleting "
        f"{len(victims)} of shard 0's {seg.num_docs} docs (a reclaim merge "
        f"of {shard0.segments[0].num_docs} docs; deletes, refresh and "
        f"merge {reclaim_ms:.1f} ms), {len(WP_BODIES)} bodies on both "
        f"routes byte-identical to one-refresh rebuilds of the live docs "
        f"in merged order (rebuilds and checks {rb1:.1f} s and {rb2:.1f} "
        f"s); no retired segment cached")

    # multi-index, indices_boost and fields against a CPU Node
    t = time.perf_counter()
    pair = [Node(name="mi-card", device=dev), Node(name="mi-cpu",
                                                   device="cpu")]
    pre = docs[:WP_PREFIX]
    pre_b = docs_b[: WP_PREFIX // WP_B_SHARE]
    for n in pair:
        for name, part in (("logs-a", pre), ("logs-b", pre_b)):
            n.create_index(name, {"settings": {
                "number_of_shards": WP_SHARDS}, "mappings": WP_MAPPING})
            step = max(1, len(part) // WP_REFRESHES)
            for j, (doc_id, src) in enumerate(part):
                n.index(name, doc_id, src)
                if (j + 1) % step == 0:
                    n.refresh(name)
            n.refresh(name)
    for expr, body in (
            ("logs-*", {"query": {"match": {"body": "t2 t150"}},
                        "size": 20}),
            ("logs-a,logs-b", {"query": {"match": {"body": "t0 t77"}},
                               "indices_boost": {"logs-b": 2.5},
                               "fields": ["tag", "n"], "size": 20}),
            ("_all", dict(WP_DFS[0], search_type="dfs_query_then_fetch",
                          stored_fields=["ts"])),
            ("l*-b", {"query": {"term": {"tag": "g4"}}, "fields": "n"})):
        got, want = (n.search(expr, copy.deepcopy(body)) for n in pair)
        check_hits(got, want, f"5h {expr} card vs CPU")
        _hold([(h["_index"], h.get("fields")) for h in got["hits"]["hits"]]
              == [(h["_index"], h.get("fields"))
                  for h in want["hits"]["hits"]],
              f"5h {expr}: indices or fields differ from the CPU", "5h")
    for n in pair:
        n.close()
    log(f"[5h] multi-index on {card}: logs-*, a comma list with "
        f"indices_boost and fields, _all with dfs and stored_fields, and a "
        f"wildcard equal a CPU Node fed the same writes (a {WP_PREFIX}-doc "
        f"prefix of logs-a and {len(pre_b)} docs of logs-b; "
        f"{time.perf_counter() - t:.1f} s)")

    # the request cache
    agg = {"size": 0, "_query_cache": True,
           "query": {"match": {"body": "t4 t8"}},
           "aggs": {"tags": {"terms": {"field": "tag"}},
                    "n": {"avg": {"field": "n"}}}}
    first = node.search("logs-a", copy.deepcopy(agg))
    second = node.search("logs-a", copy.deepcopy(agg))
    _hold(svc.query_cache_stats == {"hits": 1, "misses": 1, "evictions": 0}
          and json.dumps(first) == json.dumps(second),
          f"request cache: {svc.query_cache_stats}", "5h")
    hit_ms = _wp_time(np, torch, node, "logs-a", [agg])
    node.index("logs-a", "new", {"body": "t4 t8", "tag": "g1", "n": 5,
                                 "ts": TAXI_YEAR})
    node.refresh("logs-a")
    misses = svc.query_cache_stats["misses"]
    third = node.search("logs-a", copy.deepcopy(agg))
    _hold(svc.query_cache_stats["misses"] == misses + 1 and
          third["hits"]["total"] == first["hits"]["total"] + 1,
          "request cache: a write and a refresh did not miss", "5h")
    miss_ms = _wp_time(np, torch, node, "logs-a",
                       [dict(agg, _query_cache=False)], reps=WP_REPS // 4)
    log(f"[5h] request cache on {card}: a size-0 terms+avg body, the second "
        f"call a hit byte-equal to the first, a write and refresh a miss; "
        f"hit {_pcts(np, hit_ms)}, uncached p50 "
        f"{np.percentile(miss_ms, 50):.3f} ms")
    node.close()
    b1 = bm25_topk.LAUNCHES
    log(f"[5h] B1 launched {b1} times in 5h; phase 5h took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1


# ---------------------------------------------------------------------------
# phase 5i: the full-text DSL on a positional CSR
# ---------------------------------------------------------------------------

FT_DOCS = N_DOCS // 2      # phase 5's first docs, with each token's position
FT_TITLE = 10              # the title field: each doc's first 10 tokens
FT_VARIANTS = 8            # bodies of each group, run in turn
FT_WINDOW_S = 0.25         # timed requests per group and route: about this
FT_MIN_REPS = 10           # many seconds, at least FT_MIN_REPS, at most
FT_MAX_REPS = 400          # FT_MAX_REPS; p99 from TAXI_TAIL_REPS on
FT_PROFILED = 4            # requests per group and route under the profiler
FT_PREFIX = 1 << 14        # the CPU comparison's prefix of the corpus
FT_MAPPING = {"properties": {"body": {"type": "text"},
                             "title": {"type": "text"},
                             "popularity": {"type": "long"},
                             "published": {"type": "date"}}}


def csr_field(np, terms, docs, pos, n_docs, vocab, lengths):
    """``segment_from_arrays``'s entry for a text field of the token
    stream (term, doc, position), in doc then position order: one stable
    sort by term (a radix sort of 16-bit ids; the stream's doc and
    position order stays within a term) gives the postings
    (build_corpus's, term-major, doc-ascending) and, in the same order,
    the positional CSR."""
    k1, b = 1.2, 0.75
    order = np.argsort(terms.astype(np.int16), kind="stable")
    key = terms[order] * n_docs + docs[order]
    positions = pos[order].astype(np.int32)
    brk = np.ones(key.size, bool)
    brk[1:] = key[1:] != key[:-1]
    first = np.nonzero(brk)[0]
    del brk, order
    tf = np.diff(np.append(first, key.size))
    u_term = (key[first] // n_docs).astype(np.int32)
    u_doc = (key[first] % n_docs).astype(np.int32)
    del key
    df = np.bincount(u_term, minlength=vocab).astype(np.int32)
    offsets = np.zeros(vocab + 1, np.int64)
    offsets[1:] = np.cumsum(df)
    avg = float(lengths[lengths > 0].mean())
    tfn = (tf * (k1 + 1) / (tf + k1 * (1 - b + b * lengths[u_doc] / avg))
           ).astype(np.float32)
    return {"terms": [f"t{t}" for t in range(vocab)], "df": df,
            "cf": np.bincount(u_term, weights=tf,
                              minlength=vocab).astype(np.int64),
            "offsets": offsets, "doc_ids_host": u_doc, "tfnorm_host": tfn,
            "tf_host": tf.astype(np.float32), "avg_len": avg,
            "num_docs": int((lengths > 0).sum()),
            "total_terms": int(lengths.sum()),
            "lengths": lengths.astype(np.float32),
            "positions": positions,
            "pos_offsets": np.append(first, pos.size).astype(np.int64)}


def fulltext_arrays(np, doc_len, terms, n_docs):
    """``segment_from_arrays``'s arrays of the first ``n_docs`` docs: the
    body and its first FT_TITLE tokens as the title."""
    n_tok = int(doc_len[:n_docs].sum())
    dl = doc_len[:n_docs]
    docs = np.repeat(np.arange(n_docs, dtype=np.int64), dl)
    pos = np.arange(n_tok, dtype=np.int64) - np.repeat(np.cumsum(dl) - dl,
                                                       dl)
    body = csr_field(np, terms[:n_tok], docs, pos, n_docs, VOCAB,
                     dl.astype(np.float64))
    head = pos < FT_TITLE
    title = csr_field(np, terms[:n_tok][head], docs[head], pos[head],
                      n_docs, VOCAB, np.minimum(dl, FT_TITLE).astype(
                          np.float64))
    pop, pop_ok, pub = scoring_columns(np, n_docs)
    return {"num_docs": n_docs, "max_docs": n_docs,
            "fields": {"body": body, "title": title},
            "numerics": {
                "popularity": {"exact": pop, "exists": pop_ok,
                               "kind": "long"},
                "published": {"exact": pub,
                              "exists": np.ones(n_docs, bool),
                              "kind": "date"}}}


def scoring_columns(np, n_docs):
    """Phase 5j's doc values of the first ``n_docs`` of FT_DOCS, from seed
    0: popularity, a heavy-tailed Zipf(1.5) long absent on 10% of docs
    (0 there), and published, a date uniform over 2015-2020 (epoch ms)."""
    rng = np.random.default_rng(0)
    pop = rng.zipf(1.5, FT_DOCS).astype(np.int64)
    pop_ok = rng.random(FT_DOCS) >= 0.1
    pub = rng.integers(TAXI_YEAR, PUB_END, FT_DOCS).astype(np.int64)
    return (np.where(pop_ok, pop, 0)[:n_docs], pop_ok[:n_docs],
            pub[:n_docs])


def fulltext_bodies(np, doc_len, terms, seed):
    """Groups of FT_VARIANTS bodies, each drawn from the corpus with a
    seeded rng: (name, [bodies], served by the mesh, phrase slop or
    None). Phrases are 2-3 consecutive tokens of random docs (Rally
    pmc's ``phrase`` operation's shape)."""
    rng = np.random.default_rng(seed + 9)
    start = np.cumsum(doc_len) - doc_len

    def toks(n):
        d = int(rng.integers(doc_len.size))
        s = int(rng.integers(0, doc_len[d] - n + 1))
        return [f"t{t}" for t in terms[start[d] + s: start[d] + s + n]]

    def phrase():
        return " ".join(toks(int(rng.integers(2, 4))))

    def head(n):  # tokens of a doc's title
        d = int(rng.integers(doc_len.size))
        s = int(rng.integers(0, FT_TITLE - n + 1))
        return [f"t{t}" for t in terms[start[d] + s: start[d] + s + n]]

    V = range(FT_VARIANTS)
    ph = [phrase() for _ in V]
    ph2 = [phrase() for _ in V]
    return [
        ("a_phrase", [{"match_phrase": {"body": p}} for p in ph], True, 0),
        ("b_phrase_slop2", [{"match_phrase": {"body": {
            "query": p, "slop": 2}}} for p in ph], True, 2),
        ("c_multi_match", [{"multi_match": {
            "query": " ".join(head(2) + toks(1)), "type": "best_fields",
            "fields": ["title", "body"], "tie_breaker": 0.3}} for _ in V],
         False, None),
        ("d_prefix", [{"prefix": {"body": f"t{int(rng.integers(100, 999))}"}}
                      for _ in V], True, None),
        ("d_wildcard", [{"wildcard": {"body": f"t{int(rng.integers(1, 9))}?"
                                              f"{int(rng.integers(0, 9))}"}}
                        for _ in V], True, None),
        # three characters: AUTO allows one edit (a scan of the term dict
        # on the host, as in the reference)
        ("e_fuzzy", [{"fuzzy": {"body": f"t{int(rng.integers(10, 99))}"}}
                     for _ in V], True, None),
        ("e_match_fuzziness", [{"match": {"body": {
            "query": " ".join(toks(2)) + f" x{int(rng.integers(10, 99))}",
            "fuzziness": "AUTO"}}} for _ in V], False, None),
        ("f_dis_max", [{"dis_max": {"tie_breaker": 0.2, "queries": [
            {"match_phrase": {"body": p}},
            {"match": {"title": " ".join(head(1))}}]}} for p in ph2],
         True, None),
        ("f_boosting", [{"boosting": {
            "positive": {"match_phrase": {"body": {"query": p, "slop": 1}}},
            "negative": {"wildcard": {"title": "t1?"}},
            "negative_boost": 0.5}} for p in ph2], True, None),
        ("g_query_string", [{"query_string": {
            "query": f'"{p}" AND {toks(1)[0][:3]}*',
            "default_field": "body"}} for p in ph2], False, None),
        ("h_common", [{"common": {"body": {
            "query": " ".join(toks(4)), "cutoff_frequency": 0.001}}}
            for _ in V], False, None),
    ]


def phrase_oracle(np, field, words, slop, D):
    """f64 phrase frequency per doc over the host positional CSR, by
    Lucene's greedy rule as the reference documents it: each occurrence
    of the first term anchors; exact (slop 0): every other term at its
    offset; sloppy: each term's position nearest its expected slot
    (the later one on a tie), matchLength the spread, weight
    1 / (1 + matchLength) when it fits the slop."""
    offsets, u_doc = field["offsets"], field["doc_ids_host"]
    po, positions = field["pos_offsets"], field["positions"]
    cache = field.setdefault("_oracle_entries", {})

    def entries(word):
        """(docs, positions, packed doc << 32 | position keys, sorted)."""
        if word not in cache:
            t = int(word[1:])
            lo, hi = int(offsets[t]), int(offsets[t + 1])
            docs = np.repeat(u_doc[lo:hi].astype(np.int64),
                             np.diff(po[lo:hi + 1]))
            p = positions[po[lo]: po[hi]].astype(np.int64)
            cache[word] = (docs, p, docs * 2 ** 32 + p)
        return cache[word]

    adoc, apos, _ = entries(words[0])
    ok = np.ones(adoc.size, bool)
    lo_adj, hi_adj = apos.copy(), apos.copy()
    for j, w in enumerate(words[1:], 1):
        d, p, key = entries(w)
        want = adoc * 2 ** 32 + apos + j
        i = np.searchsorted(key, want)
        i1, i0 = np.minimum(i, key.size - 1), np.maximum(i - 1, 0)
        if slop == 0:
            ok &= key[i1] == want
            continue
        c1_ok = (i < key.size) & (d[i1] == adoc)
        c0_ok = (i >= 1) & (d[i0] == adoc)
        d1 = np.where(c1_ok, np.abs(p[i1] - apos - j), np.inf)
        d0 = np.where(c0_ok, np.abs(p[i0] - apos - j), np.inf)
        adj = np.where(d0 < d1, p[i0], p[i1]) - j
        found = c0_ok | c1_ok
        ok &= found
        lo_adj = np.where(found, np.minimum(lo_adj, adj), lo_adj)
        hi_adj = np.where(found, np.maximum(hi_adj, adj), hi_adj)
    mlen = hi_adj - lo_adj
    w = np.where(ok & (mlen <= slop), 1.0 / (1.0 + mlen), 0.0)
    return np.bincount(adoc, weights=w, minlength=D)


def _ft_line(np, name, label, ms, prof, tag="5i"):
    tail = (f"p99 {np.percentile(ms, 99):.3f} ms"
            if len(ms) >= TAXI_TAIL_REPS else
            f"slowest {ms.max():.3f} ms (too few for a p99)")
    return (f"[{tag}] {name}, {label}: p50 {np.percentile(ms, 50):.3f} ms, "
            f"{tail} over {len(ms)} requests, "
            + _dev_line(np, prof, FT_PROFILED, ms))


def _hold_same_hits(got, want, what, tag="5i"):
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    _hold(got["hits"]["total"] == want["hits"]["total"]
          and [h["_id"] for h in gh] == [h["_id"] for h in wh],
          f"{what}: total {got['hits']['total']} vs "
          f"{want['hits']['total']}, ids differ", tag)
    g = [h["_score"] for h in gh]
    w = [h["_score"] for h in wh]
    _hold(len(g) == len(w) and all(abs(a - b) <= 1e-5 * abs(b)
                                   for a, b in zip(g, w)),
          f"{what}: scores {g[:3]} vs {w[:3]}", tag)


def phase_fulltext(torch, np, dev, card):
    """Phase 5i: the full-text DSL (ROADMAP A9a) on phase 5's 2^20-doc
    MS-MARCO-shaped corpus, its positional CSR kept (~63M positions),
    with a title field of each doc's first 10 tokens, loaded through
    ``segment_from_arrays``. Every group of bodies (match_phrase at slop 0
    and 2, multi_match best_fields, prefix, wildcard, fuzzy, match with
    fuzziness, dis_max, boosting, query_string, common) runs on the mesh
    path and on the host loop for about FT_WINDOW_S each: the routes'
    responses byte-identical, the phrases' frequencies against a float64
    numpy oracle over the host positions (exact at slop 0), every body on
    the card against a CPU Node of the port on a 2^14-doc prefix, and the
    positional CSR's bytes released when the node closes."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.ops.positional import (phrase_freq,
                                                        positional_bytes)

    t_phase = time.perf_counter()
    doc_len, terms = corpus_tokens(np, N_DOCS, VOCAB, SEED)
    doc_len = doc_len[:FT_DOCS]
    terms = terms[:int(doc_len.sum())]
    arrays = fulltext_arrays(np, doc_len, terms, FT_DOCS)
    body_f = arrays["fields"]["body"]
    n_pos = int(body_f["positions"].size)
    t_data = time.perf_counter() - t_phase
    node = Node(name="fulltext", device=dev)
    node.create_index("ft", {"settings": {"number_of_shards": 1},
                             "mappings": FT_MAPPING})
    svc = node.get_index("ft")
    seg = segment_from_arrays(arrays, node.residency)
    svc.shards[0].engine.add_segment(seg)
    fd = node.breakers.breaker("fielddata")
    segs_br = node.breakers.breaker("segments")
    fd0 = fd.used
    groups = fulltext_bodies(np, doc_len, terms, SEED)
    node.search("ft", {"query": groups[0][1][0]})  # places the CSR
    inv = seg.inverted["body"]
    csr_bytes = positional_bytes(inv)
    _hold(csr_bytes == 4 * (2 * n_pos + int(body_f["pos_offsets"].size)),
          f"positional CSR {csr_bytes} bytes", "5i")
    log(f"[5i] {FT_DOCS} docs, {n_pos} positions ({int(body_f['df'].sum())}"
        f" postings) in a term-major, doc-ascending positional CSR, a "
        f"{FT_TITLE}-token title field; data {t_data:.1f} s, set-up "
        f"{time.perf_counter() - t_phase:.1f} s; the CSR on the card "
        f"{csr_bytes} bytes (positions, pos_offsets, doc_per_pos); "
        f"breakers: segments {segs_br.used} bytes, fielddata {fd0} -> "
        f"{fd.used} bytes")

    def timed(bodies, n, window_s):
        ms, out = [], {}
        start = time.perf_counter()
        while len(ms) < n or (len(ms) < FT_MAX_REPS and
                              time.perf_counter() - start < window_s):
            b = bodies[len(ms) % len(bodies)]
            a = time.perf_counter()
            out[len(ms) % len(bodies)] = node.search(
                "ft", {"query": copy.deepcopy(b), "size": 10})
            ms.append((time.perf_counter() - a) * 1e3)
        return np.array(ms), out

    bm25_topk.LAUNCHES = 0
    lines, answers = [], {}
    for name, bodies, mesh_serves, _slop in groups:
        for b in bodies:  # first use: expansions' sorted dicts, memo
            node.search("ft", {"query": copy.deepcopy(b), "size": 10})
        for route in ("mesh", "host"):
            with (_host_loop() if route == "host"
                  else contextlib.nullcontext()):
                counters.reset()
                ms, out = timed(bodies, FT_MIN_REPS, FT_WINDOW_S)
                snap = counters.snapshot()
                prof = profile_path(torch, lambda: [node.search(
                    "ft", {"query": copy.deepcopy(bodies[i % len(bodies)]),
                           "size": 10}) for i in range(FT_PROFILED)])
            if route == "host":
                _hold(not any(k.startswith("mesh_") for k in snap),
                      f"{name}: the pinned host loop ran the mesh", "5i")
                label = "host loop"
            else:
                want_key = ("mesh_search" if mesh_serves
                            else "mesh_fallback_total")
                _hold(snap.get(want_key) == len(ms),
                      f"{name}: not served by {want_key}: {snap}", "5i")
                label = ("mesh path" if mesh_serves else
                         "mesh route, declined to the host loop "
                         "(MeshCompileError)")
            answers[(name, route)] = out
            lines.append(_ft_line(np, name, label, ms, prof))
        for i in range(len(bodies)):
            a, b = answers[(name, "mesh")][i], answers[(name, "host")][i]
            _hold(json.dumps(dict(a, took=0), sort_keys=True)
                  == json.dumps(dict(b, took=0), sort_keys=True),
                  f"{name} body {i}: the mesh's response differs from the "
                  f"host loop's", "5i")
    b1 = bm25_topk.LAUNCHES
    for ln in lines:
        log(ln)

    # (a) and (b): every doc's phrase frequency against the f64 oracle,
    # and each response's total and hits against the oracle's scores
    t = time.perf_counter()
    n_terms = float(FT_DOCS)
    avg = body_f["avg_len"]
    lengths = body_f["lengths"].astype(np.float64)
    n_checked = n_hits = 0
    for name, bodies, _m, slop in groups:
        if slop is None:
            continue
        for i, b in enumerate(bodies):
            q = b["match_phrase"]["body"]
            words = (q["query"] if isinstance(q, dict) else q).split()
            want = phrase_oracle(np, body_f, words, slop, FT_DOCS)
            got = phrase_freq(inv, [(w, j) for j, w in enumerate(words)],
                              FT_DOCS, slop).cpu().numpy()
            if slop == 0:
                _hold(np.array_equal(got, want.astype(np.float32)),
                      f"{name} {words}: frequencies differ from the "
                      f"oracle's", "5i")
            else:
                _hold(np.allclose(got, want, rtol=1e-6, atol=0)
                      and np.array_equal(got > 0, want > 0),
                      f"{name} {words}: frequencies off the oracle's", "5i")
            resp = answers[(name, "mesh")][i]
            _hold(resp["hits"]["total"] == int((want > 0).sum()),
                  f"{name} {words}: total {resp['hits']['total']} vs "
                  f"{int((want > 0).sum())}", "5i")
            idf = sum(np.log(1.0 + (n_terms - body_f["df"][int(w[1:])] + 0.5)
                             / (body_f["df"][int(w[1:])] + 0.5))
                      for w in dict.fromkeys(words))
            norm = 1.2 * (0.25 + 0.75 * lengths / avg)
            score = np.where(want > 0, idf * want * 2.2 / (want + norm),
                             -np.inf)
            top = top_desc(np, score, 10)
            top = top[np.isfinite(score[top])]
            hits = resp["hits"]["hits"]
            s = np.array([h["_score"] for h in hits])
            _hold(len(hits) == top.size and np.allclose(
                s, score[top], rtol=1e-5, atol=0) and np.allclose(
                [score[int(h["_id"])] for h in hits], s, rtol=1e-5, atol=0),
                f"{name} {words}: hits off the oracle's top 10", "5i")
            n_checked += 1
            n_hits += len(hits)
    body_f.pop("_oracle_entries", None)
    log(f"[5i] {n_checked} phrases (slop 0 and 2): every doc's frequency "
        f"equals the f64 oracle's (exact at slop 0, rtol 1e-6 at slop 2), "
        f"totals exact, {n_hits} hits' scores within rtol 1e-5 of the "
        f"oracle's top 10; {time.perf_counter() - t:.1f} s")

    # every body on the card against a CPU Node of the port on a prefix
    t = time.perf_counter()
    pre = fulltext_arrays(np, doc_len, terms, FT_PREFIX)
    pnodes = []
    for d in (dev, "cpu"):
        n = Node(name=f"ft-prefix-{d}", device=d)
        n.create_index("ftp", {"settings": {"number_of_shards": 1},
                               "mappings": FT_MAPPING})
        n.get_index("ftp").shards[0].engine.add_segment(
            segment_from_arrays(pre, n.residency))
        pnodes.append(n)
    n_bodies = 0
    for name, bodies, _m, _s in groups:
        for b in bodies:
            body = {"query": b, "size": 10}
            want = pnodes[1].search("ftp", copy.deepcopy(body))
            _hold_same_hits(pnodes[0].search("ftp", copy.deepcopy(body)),
                            want, f"{name} prefix, card mesh vs CPU")
            with _host_loop():
                _hold_same_hits(pnodes[0].search("ftp", copy.deepcopy(body)),
                                want, f"{name} prefix, card host vs CPU")
            n_bodies += 1
    log(f"[5i] {n_bodies} bodies on a {FT_PREFIX}-doc prefix: the card's "
        f"mesh path and host loop equal a CPU Node of the port (ids, "
        f"order, totals exact; scores within rtol 1e-5); "
        f"{time.perf_counter() - t:.1f} s")

    b1 += phase_scoring(torch, np, dev, card, node, pnodes, arrays, doc_len,
                        terms)
    b1 += phase_suggest_text(torch, np, dev, card, node, seg, body_f,
                             doc_len, terms)
    for n in pnodes:
        n.close()
    node.close()
    _hold(fd.used == 0, f"fielddata {fd.used} bytes after the index closed "
          f"(the CSR's {csr_bytes} included)", "5i")
    log(f"[5i] after the node closed: fielddata {fd.used} bytes (the "
        f"positional CSR's {csr_bytes} released), segments {segs_br.used}")
    del arrays, pre, doc_len, terms
    log(f"[5i] B1 launched {b1} times in 5i's and 5j's timed runs; phases "
        f"5i and 5j took {time.perf_counter() - t_phase:.1f} s")
    return b1


PUB_END = 1_609_459_200_000   # 2021-01-01T00:00:00Z: published below it
SC_ORIGIN = "2018-06-01"       # (d)'s decay origin
SC_ORIGIN_MS = 1_527_811_200_000
SC_POP_CUT = 100               # (d)'s filtered weight: popularity >= this
SC_BAND = 1e-5                 # the function values' bar against f64


def scoring_bodies(np, doc_len, terms, seed):
    """Phase 5j's groups of FT_VARIANTS request bodies, drawn with a seeded
    rng from the corpus: (name, [bodies], the mesh serves them)."""
    rng = np.random.default_rng(seed + 13)
    start = np.cumsum(doc_len) - doc_len

    def toks(n, head=None):
        """n consecutive tokens of a random doc (within its first
        ``head`` positions)."""
        d = int(rng.integers(doc_len.size))
        s0 = int(rng.integers(0, (head or doc_len[d]) - n + 1))
        return [f"t{t}" for t in terms[start[d] + s0: start[d] + s0 + n]]

    def q(body):
        return {"query": body, "size": 10}

    V = range(FT_VARIANTS)
    factors = [round(float(rng.uniform(0.5, 4.0)), 2) for _ in V]
    recency = [{"function_score": {
        "query": {"match": {"body": " ".join(toks(int(rng.integers(2, 4))))}},
        "functions": [
            {"gauss": {"published": {"origin": SC_ORIGIN, "scale": "30d",
                                     "offset": "1d", "decay": 0.5}}},
            {"filter": {"range": {"popularity": {"gte": SC_POP_CUT}}},
             "weight": 2}],
        "score_mode": "sum", "boost_mode": "multiply"}} for _ in V]

    def fvf(f):
        return {"function_score": {"query": {"match_all": {}},
                                   "field_value_factor": {
                                       "field": "popularity", "factor": f,
                                       "modifier": "log2p", "missing": 1}}}

    def script_score(f):
        return {"function_score": {"query": {"match_all": {}},
                                   "script_score": {"script": {
                                       "inline": "Math.log10(doc['popularity']"
                                                 ".value * params.f + 2)",
                                       "params": {"f": f}}}}}

    def span_terms(ts):
        return [{"span_term": {"body": t}} for t in ts]

    return [
        ("a_field_value", [q(fvf(f)) for f in factors], True),
        ("b_script_score", [q(script_score(f)) for f in factors], False),
        ("c_random", [q({"function_score": {
            "query": {"match_all": {}},
            "random_score": {"seed": int(rng.integers(0, 2 ** 31))},
            "boost_mode": "replace"}}) for _ in V], True),
        ("d_recency", [q(b) for b in recency], True),
        ("e_script_filter", [q({"bool": {
            "must": [{"match": {"body": " ".join(toks(2))}}],
            "filter": [{"script": {"script": {
                "inline": "doc['popularity'].value > params.cut",
                "params": {"cut": int(rng.integers(2, 50))}}}}]}})
            for _ in V], False),
        ("f_near_ordered", [q({"span_near": {
            "clauses": span_terms(toks(int(rng.integers(2, 4)))),
            "slop": 1, "in_order": True}}) for _ in V], False),
        ("f_near_unordered", [q({"span_near": {
            "clauses": span_terms(toks(2)[::-1]), "slop": 3,
            "in_order": False}}) for _ in V], False),
        ("f_first", [q({"span_first": {
            "match": span_terms(toks(1, head=3))[0], "end": 3}})
            for _ in V], False),
        ("f_or", [q({"span_or": {"clauses": span_terms(
            toks(1)[0] for _ in range(3))}}) for _ in V], False),
        ("f_not", [q({"span_not": {"include": span_terms([a])[0],
                                   "exclude": span_terms([b])[0],
                                   "post": 1}})
                   for a, b in (toks(2) for _ in V)], False),
        ("f_multi", [q({"span_multi": {"match": {"prefix": {
            "body": f"t{int(rng.integers(100, 999))}"}}}}) for _ in V],
         False),
        ("g_script_avg", [{"size": 0, "aggs": {"a": {"avg": {"script": {
            "inline": "doc['popularity'].value * params.f",
            "params": {"f": f}}}}}} for f in factors], True),
        ("g_script_histogram", [{"size": 0, "aggs": {"h": {"histogram": {
            "script": {"inline": "doc['popularity'].value % params.m",
                       "params": {"m": int(rng.integers(20, 200))}},
            "interval": 10}}}} for _ in V], True),
        ("g_scripted_metric", [{"size": 0, "aggs": {"m": {"scripted_metric": {
            "map_script": "doc['popularity'].value > params.t ? 1 : 0",
            "params": {"t": int(rng.integers(2, 100))}}}}} for _ in V],
         True),
        ("g_script_fields", [dict(q(b), script_fields={
            "pop2": {"script": "doc['popularity'].value * 2"},
            "days": {"script": "doc['published'].value / 86400000"}})
            for b in recency], True),
    ]


def _top_oracle(np, values, k):
    """(ids, values) of the top k finite values by (-value, doc id)."""
    idx = np.nonzero(np.isfinite(values))[0]
    order = top_desc(np, values[idx], min(k, idx.size))
    return idx[order], values[idx[order]]


def _hold_oracle(np, resp, oracle, what) -> int:
    """A response against an f64 oracle of every doc's value (-inf where
    no match): the exact total, each hit's score within SC_BAND of its
    doc's value, and the top 10 the oracle's outside a tie band of that
    bar at the cut, as phase 5's ``_hold_exact`` holds it. Returns the
    hits checked."""
    total = int(np.isfinite(oracle).sum())
    hits = resp["hits"]["hits"]
    _hold(resp["hits"]["total"] == total,
          f"{what}: total {resp['hits']['total']} vs the oracle's {total}",
          "5j")
    ids = np.array([int(h["_id"]) for h in hits], np.int64)
    s = np.array([h["_score"] for h in hits])
    _hold(ids.size == min(10, total) and np.allclose(
        s, oracle[ids], rtol=SC_BAND, atol=0),
        f"{what}: scores {s[:3]} vs the oracle's {oracle[ids][:3]}", "5j")
    want, wv = _top_oracle(np, oracle, ids.size)
    cut = wv[-1] if wv.size else 0.0
    for d in set(ids.tolist()) ^ set(want.tolist()):
        _hold(abs(oracle[d] - cut) <= 2 * SC_BAND * abs(cut),
              f"{what}: doc {d} at {oracle[d]} is on one side of the top "
              f"10 only, outside the band of the cut {cut}", "5j")
    return int(ids.size)


def _bm25_oracle(np, field, words, n_docs):
    """f64 BM25 of a match (OR) over the host CSR: duplicate terms' idf
    summed, the stored f32 tfnorms as the data; -inf where no term."""
    score = np.zeros(n_docs)
    hit = np.zeros(n_docs, bool)
    n = float(field["num_docs"])
    for w, c in zip(*np.unique(words, return_counts=True)):
        t = int(w[1:])
        df = float(field["df"][t])
        lo, hi = int(field["offsets"][t]), int(field["offsets"][t + 1])
        docs = field["doc_ids_host"][lo:hi]
        idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        score[docs] += c * idf * field["tfnorm_host"][lo:hi].astype(
            np.float64)
        hit[docs] = True
    return np.where(hit, score, -np.inf)


def _span_docs(np, field, kind, spec):
    """The docs of a span body by numpy over the host positional CSR:
    span_or (any of the terms), span_first (a term's first position below
    ``end``), span_not (an include position with no exclude position in
    [p - pre, p + post])."""
    offs, u_doc = field["offsets"], field["doc_ids_host"]
    po, pos = field["pos_offsets"], field["positions"]

    def entries(word):
        t = int(word[1:])
        return int(offs[t]), int(offs[t + 1])

    def occurrences(word):
        lo, hi = entries(word)
        docs = np.repeat(u_doc[lo:hi].astype(np.int64), np.diff(po[lo:hi + 1]))
        return docs, pos[po[lo]: po[hi]].astype(np.int64)

    if kind == "span_or":
        return np.unique(np.concatenate([
            u_doc[slice(*entries(c["span_term"]["body"]))]
            for c in spec["clauses"]]))
    if kind == "span_first":
        lo, hi = entries(spec["match"]["span_term"]["body"])
        firsts = pos[po[lo:hi]]
        return np.unique(u_doc[lo:hi][firsts < spec["end"]])
    ad, ap = occurrences(spec["include"]["span_term"]["body"])
    bd, bp = occurrences(spec["exclude"]["span_term"]["body"])
    keys = np.sort(bd * 2 ** 32 + bp)
    pre, post = spec.get("pre", 0), spec.get("post", 0)
    i = np.searchsorted(keys, ad * 2 ** 32 + ap - pre)
    k = keys[np.minimum(i, keys.size - 1)] if keys.size else np.zeros_like(ad)
    blocked = (i < keys.size) & (k <= ad * 2 ** 32 + ap + post)
    return np.unique(ad[~blocked])


def _close(a, b, rtol=1e-5) -> bool:
    """JSON values equal, floats within rtol."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k], rtol) for k in b)
    if isinstance(b, list):
        return isinstance(a, list) and len(a) == len(b) and all(
            _close(x, y, rtol) for x, y in zip(a, b))
    if isinstance(b, float) and isinstance(a, (int, float)):
        return abs(a - b) <= rtol * abs(b)
    return a == b


def phase_scoring(torch, np, dev, card, node, pnodes, arrays, doc_len,
                  terms) -> int:
    """Phase 5j: the scoring DSL (ROADMAP A9b) on 5i's 2^20-doc index and
    its prefix nodes (module docstring). Returns B1's launches in its
    timed runs (none expected: no function_score or span root takes B1's
    pure-dense route)."""
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import adc, bm25_topk, knn_topk, \
        maxsim_adc

    t_phase = time.perf_counter()
    body_f = arrays["fields"]["body"]
    pop = arrays["numerics"]["popularity"]["exact"]
    pop_ok = arrays["numerics"]["popularity"]["exists"]
    pub = arrays["numerics"]["published"]["exact"]
    groups = scoring_bodies(np, doc_len, terms, SEED)
    log(f"[5j] {FT_DOCS} docs with popularity (Zipf(1.5), {int(pop_ok.sum())}"
        f" present, max {int(pop.max())}) and published (2015-2020); "
        f"{len(groups)} groups of {FT_VARIANTS} bodies")

    def timed(bodies):
        ms, out = [], {}
        start = time.perf_counter()
        while len(ms) < FT_MIN_REPS or (len(ms) < FT_MAX_REPS and
                                        time.perf_counter() - start
                                        < FT_WINDOW_S):
            i = len(ms) % len(bodies)
            a = time.perf_counter()
            out[i] = node.search("ft", copy.deepcopy(bodies[i]))
            ms.append((time.perf_counter() - a) * 1e3)
        return np.array(ms), out

    mods = (bm25_topk, knn_topk, adc, maxsim_adc)
    before = [m.LAUNCHES for m in mods]
    lines, answers = [], {}
    for name, bodies, mesh_serves in groups:
        for b in bodies:  # first use: the CSR's expansions, the memo
            node.search("ft", copy.deepcopy(b))
        for route in ("mesh", "host"):
            with (_host_loop() if route == "host"
                  else contextlib.nullcontext()):
                counters.reset()
                ms, out = timed(bodies)
                snap = counters.snapshot()
                prof = profile_path(torch, lambda: [node.search(
                    "ft", copy.deepcopy(bodies[i % len(bodies)]))
                    for i in range(FT_PROFILED)])
            if route == "host":
                _hold(not any(k.startswith("mesh_") for k in snap),
                      f"{name}: the pinned host loop ran the mesh", "5j")
                label = "host loop"
            else:
                want_key = ("mesh_search" if mesh_serves
                            else "mesh_fallback_total")
                _hold(snap.get(want_key) == len(ms),
                      f"{name}: not served by {want_key}: {snap}", "5j")
                label = ("mesh path" if mesh_serves else
                         "mesh route, declined to the host loop "
                         "(MeshCompileError)")
            if name.startswith("f_"):
                _hold(snap.get("span_device", 0) >= len(ms)
                      and not snap.get("span_host_walk"),
                      f"{name}: spans off the card's programs: {snap}", "5j")
            answers[(name, route)] = out
            lines.append(_ft_line(np, name, label, ms, prof, "5j"))
        for i in range(len(bodies)):
            a, b = answers[(name, "mesh")][i], answers[(name, "host")][i]
            _hold(json.dumps(dict(a, took=0), sort_keys=True)
                  == json.dumps(dict(b, took=0), sort_keys=True),
                  f"{name} body {i}: the mesh's response differs from the "
                  f"host loop's", "5j")
    launched = [m.LAUNCHES - b for m, b in zip(mods, before)]
    for ln in lines:
        log(ln)

    # (a), (c), (d): every returned hit's value and the top 10 against f64
    t = time.perf_counter()
    by = {name: bodies for name, bodies, _m in groups}
    n_hits = 0
    pop_f = np.where(pop_ok, pop, 1).astype(np.float64)  # missing: 1
    for i, b in enumerate(by["a_field_value"]):
        f = b["query"]["function_score"]["field_value_factor"]["factor"]
        oracle = np.log10(pop_f * f + 2.0)
        n_hits += _hold_oracle(np, answers[("a_field_value", "mesh")][i],
                               oracle, f"(a) factor {f}")
        got_b = answers[("b_script_score", "mesh")][i]["hits"]["hits"]
        got_a = answers[("a_field_value", "mesh")][i]["hits"]["hits"]
        _hold([h["_id"] for h in got_b] == [h["_id"] for h in got_a]
              and all(abs(x["_score"] - y["_score"]) <= 1e-6 * y["_score"]
                      for x, y in zip(got_b, got_a)),
              f"(b) factor {f}: script_score's hits differ from (a)'s", "5j")
    for i, b in enumerate(by["c_random"]):
        seed = b["query"]["function_score"]["random_score"]["seed"]
        h = hash32_np(np, np.arange(FT_DOCS, dtype=np.int64) + seed)
        n_hits += _hold_oracle(np, answers[("c_random", "mesh")][i],
                               h.astype(np.float64) / 2.0 ** 32,
                               f"(c) seed {seed}")
    off = np.float32(pub.min())
    pub_f = (np.float32(pub - pub.min()) + off).astype(np.float64)
    origin = float(np.float32(SC_ORIGIN_MS))
    scale = 30.0 * DAY_MS
    dist = np.maximum(np.abs(pub_f - origin) - DAY_MS, 0.0)
    gauss = np.exp(-dist ** 2 / (2.0 * (-scale ** 2 / (2.0 * np.log(0.5)))))
    boost = gauss + 2.0 * (pop_ok & (pop >= SC_POP_CUT))
    for i, b in enumerate(by["d_recency"]):
        words = b["query"]["function_score"]["query"]["match"]["body"].split()
        with np.errstate(invalid="ignore"):  # -inf (no match) times 0
            value = _bm25_oracle(np, body_f, words, FT_DOCS) * boost
        n_hits += _hold_oracle(np, answers[("d_recency", "mesh")][i],
                               np.where(np.isnan(value), -np.inf, value),
                               f"(d) {words}")
    log(f"[5j] (a), (c) and (d): {n_hits} hits' function values within "
        f"rtol {SC_BAND} of f64 numpy oracles, totals exact, top 10 the "
        f"oracles' outside the tie band; (b)'s hits equal (a)'s; "
        f"{time.perf_counter() - t:.1f} s")

    # (f): span_first, span_or and span_not against numpy's match sets
    t = time.perf_counter()
    n_spans = 0
    for name in ("f_first", "f_or", "f_not"):
        for i, b in enumerate(by[name]):
            (kind, spec), = b["query"].items()
            want = _span_docs(np, body_f, kind, spec)
            resp = answers[(name, "mesh")][i]
            got = [int(h["_id"]) for h in resp["hits"]["hits"]]
            _hold(resp["hits"]["total"] == want.size
                  and np.isin(got, want).all(),
                  f"{name} body {i}: total {resp['hits']['total']} vs "
                  f"numpy's {want.size}", "5j")
            n_spans += 1
    log(f"[5j] (f): {n_spans} span_first, span_or and span_not bodies: "
        f"totals equal numpy's match sets over the host positions, every "
        f"hit in them; {time.perf_counter() - t:.1f} s")

    # every body on the card against a CPU Node of the port on the prefix
    t = time.perf_counter()
    n_bodies = 0
    for name, bodies, _m in groups:
        for b in bodies:
            want = pnodes[1].search("ftp", copy.deepcopy(b))
            for route in ("mesh", "host"):
                with (_host_loop() if route == "host"
                      else contextlib.nullcontext()):
                    got = pnodes[0].search("ftp", copy.deepcopy(b))
                what = f"{name} prefix, card {route} vs CPU"
                _hold_same_hits(got, want, what, "5j")
                _hold(_close(got.get("aggregations"),
                             want.get("aggregations"))
                      and _close([h.get("fields") for h in got["hits"]["hits"]],
                                 [h.get("fields") for h in
                                  want["hits"]["hits"]]),
                      f"{what}: aggregations or script fields differ", "5j")
            n_bodies += 1
    log(f"[5j] {n_bodies} bodies on a {FT_PREFIX}-doc prefix: the card's "
        f"mesh path and host loop equal a CPU Node of the port (ids, "
        f"order, totals exact; scores, aggregations and script fields "
        f"within rtol 1e-5); {time.perf_counter() - t:.1f} s")
    log(f"[5j] launches in 5j's timed runs: B1 {launched[0]}, B2 "
        f"{launched[1]}, B3 {launched[2]}, B4 {launched[3]} (none expected: "
        f"no B1-B4 on the scoring DSL's path); phase 5j took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched[0]


# ---------------------------------------------------------------------------
# phase 5k: joins and geo (ROADMAP A9c)
# ---------------------------------------------------------------------------

JG_QUESTIONS = 1 << 17     # Rally nested's StackOverflow questions, cut
JG_MAX_ANSWERS = 6         # 0-6 nested answers a question (PERF.md §4)
JG_USERS = 50_000          # answers.user: Zipf(1.2) over these
JG_TAGS = 100              # tag: Zipf(1.5) over these
JG_SHARDS = 5              # (b): ES 2.0's default index.number_of_shards
JG_POINTS = 1 << 20        # (c): Rally geopoint's geonames locations, cut
JG_CENTRES = 1000          # (c): seeded centres, Zipf(1.1) weights
JG_SHAPES = 4096           # (d): polygons and linestrings via Node.index
JG_PREFIX_Q = 1 << 12      # the CPU comparison's prefix of (a)
JG_PREFIX_PTS = 1 << 14    # and of (c)
JG_BAND = 1e-5             # hazard 2's band: f64 distance within 1e-5 rel
JG_DELETES = 64            # roots deleted after (a)'s groups
JG_WINDOW_S = 0.15         # timed requests per group and route: about this
                           # many seconds, FT_MIN_REPS to FT_MAX_REPS
JG_ANSWER = {"user": {"type": "keyword"}, "date": {"type": "date"},
             "score": {"type": "long"}}
JG_QA_MAPPING = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "votes": {"type": "long"},
    "answers": {"type": "nested", "properties": JG_ANSWER}}}
JG_PC_MAPPING = {
    "question": {"properties": {"title": {"type": "text"},
                                "tag": {"type": "keyword"},
                                "votes": {"type": "long"}}},
    "answer": {"_parent": {"type": "question"},
               "properties": JG_ANSWER}}
JG_GEO_MAPPING = {"properties": {"location": {"type": "geo_point"}}}
JG_SHAPE_MAPPING = {"properties": {"area": {"type": "geo_shape"},
                                   "kind": {"type": "keyword"}}}
JG_MODES = ("avg", "sum", "max", "none")


def qa_corpus(np, n_q, seed):
    """Rally nested's shape from the seed: per question a 10-token title
    over phase 5's vocabulary, a Zipf tag, votes and 0-6 answers; per
    answer a Zipf user, a date over 2015-2019 and a score."""
    rng = np.random.default_rng(seed + 14)
    n_ans = rng.integers(0, JG_MAX_ANSWERS + 1, n_q)
    a = int(n_ans.sum())
    return {"n_ans": n_ans,
            "title": np.minimum(rng.zipf(1.3, (n_q, 10)), VOCAB) - 1,
            "tag": np.minimum(rng.zipf(1.5, n_q), JG_TAGS) - 1,
            "votes": rng.integers(0, 1000, n_q).astype(np.int64),
            "user": np.minimum(rng.zipf(1.2, a), JG_USERS) - 1,
            "date": TAXI_YEAR + rng.integers(0, 5 * 365 * DAY_MS, a),
            "score": rng.integers(-5, 100, a).astype(np.int64)}


def qa_prefix(c, n):
    a = int(c["n_ans"][:n].sum())
    return {k: (v[:a] if k in ("user", "date", "score") else v[:n])
            for k, v in c.items()}


def kw_arrays(np, ids, names, present, D):
    """``segment_from_arrays``'s (fields, keywords) entries of a
    single-valued keyword: doc i holds ``names[ids[i]]`` where
    ``present``; the terms sorted, the ordinals their ranks."""
    docs = np.nonzero(present)[0]
    used, inv = np.unique(ids[docs], return_inverse=True)
    strs = [names(int(u)) for u in used]
    order = sorted(range(len(strs)), key=strs.__getitem__)
    rank = np.empty(len(strs), np.int32)
    rank[order] = np.arange(len(strs), dtype=np.int32)
    terms = [strs[o] for o in order]
    ords = np.full(D, -1, np.int32)
    ords[docs] = rank[inv]
    df = np.bincount(ords[docs], minlength=len(terms)).astype(np.int32)
    offsets = np.zeros(len(terms) + 1, np.int64)
    offsets[1:] = np.cumsum(df)
    post = docs[np.argsort(ords[docs], kind="stable")].astype(np.int32)
    ones = np.ones(post.size, np.float32)
    single = [[t] for t in terms]  # shared: never mutated
    hv = [None] * D
    for d, o in zip(docs.tolist(), ords[docs].tolist()):
        hv[d] = single[o]
    exists = np.zeros(D, bool)
    exists[docs] = True
    return ({"terms": terms, "df": df, "cf": df.astype(np.int64),
             "offsets": offsets, "doc_ids_host": post, "tfnorm_host": ones,
             "tf_host": ones, "avg_len": 1.0, "num_docs": int(docs.size),
             "total_terms": int(docs.size)},
            {"ords": ords, "exists": exists, "host_values": hv})


def _pow2(n):
    return max(64, 1 << (int(n) - 1).bit_length())


def _title_field(np, title, at, D):
    """The title text field: question q's 10 tokens at doc ``at[q]``."""
    n_q = title.shape[0]
    lengths = np.zeros(D)
    lengths[at] = title.shape[1]
    return csr_field(np, title.ravel(), np.repeat(at, title.shape[1]),
                     np.tile(np.arange(title.shape[1]), n_q), D, VOCAB,
                     lengths)


def _num(np, D, at, values, kind):
    exact = np.zeros(D, np.int64)
    exact[at] = values
    exists = np.zeros(D, bool)
    exists[at] = True
    return {"exact": exact, "exists": exists, "kind": kind}


def nested_arrays(np, c):
    """(a)'s one block-join segment: each question's answers then the
    question (Lucene block order), with ``blocks`` and no parsing."""
    n_ans = c["n_ans"]
    n_q, a = n_ans.size, int(n_ans.sum())
    n = n_q + a
    D = _pow2(n)
    start = np.cumsum(n_ans + 1) - (n_ans + 1)
    root = start + n_ans
    first = np.cumsum(n_ans) - n_ans
    j = np.arange(a) - np.repeat(first, n_ans)
    q_of = np.repeat(np.arange(n_q), n_ans)
    ans = np.repeat(start, n_ans) + j
    parent_of = np.full(D, -1, np.int32)
    parent_of[ans] = root[q_of]
    code = np.full(D, -1, np.int32)
    code[ans] = 0
    ordn = np.full(D, -1, np.int32)
    ordn[ans] = j
    fields, keywords = {}, {}
    fields["tag"], keywords["tag"] = kw_arrays(
        np, _at(np, D, root, c["tag"]),
        lambda t: f"tag{t}", _mask(np, D, root), D)
    fields["answers.user"], keywords["answers.user"] = kw_arrays(
        np, _at(np, D, ans, c["user"]), lambda u: f"u{u}",
        _mask(np, D, ans), D)
    fields["title"] = _title_field(np, c["title"], root, D)
    ids = [None] * n
    for i, r in enumerate(root.tolist()):
        ids[r] = f"q{i}"
    for q, jj, d in zip(q_of.tolist(), j.tolist(), ans.tolist()):
        ids[d] = f"q{q}|answers|{jj}"
    users, dates, scores = (c[k].tolist() for k in ("user", "date",
                                                    "score"))
    sources = [None] * n
    lo = 0
    for i, (r, k) in enumerate(zip(root.tolist(), n_ans.tolist())):
        sources[r] = {"tag": f"tag{int(c['tag'][i])}", "answers": [
            {"user": f"u{users[x]}", "date": dates[x], "score": scores[x]}
            for x in range(lo, lo + k)]}
        lo += k
    return {"num_docs": n, "max_docs": D, "ids": ids, "sources": sources,
            "fields": fields, "keywords": keywords,
            "numerics": {"votes": _num(np, D, root, c["votes"], "long"),
                         "answers.date": _num(np, D, ans, c["date"], "date"),
                         "answers.score": _num(np, D, ans, c["score"],
                                               "long")},
            "blocks": {"parent_of": parent_of, "nested_paths": {"answers": 0},
                       "nested_code": code, "nested_ord": ordn}}


def _at(np, D, at, values):
    out = np.zeros(D, np.int64)
    out[at] = values
    return out


def _mask(np, D, at):
    m = np.zeros(D, bool)
    m[at] = True
    return m


def pc_shard_arrays(np, c, shard_of, s):
    """(b)'s shard s: its questions (docs 0..P) then their answers, each
    answer a child doc with ``_type`` answer and ``_parent`` its
    question's id."""
    n_ans = c["n_ans"]
    qs = np.nonzero(shard_of == s)[0]
    first = np.cumsum(n_ans) - n_ans
    cnt = n_ans[qs]
    a_idx = np.repeat(first[qs], cnt) + (np.arange(int(cnt.sum()))
                                         - np.repeat(np.cumsum(cnt) - cnt,
                                                     cnt))
    q_of = np.repeat(qs, cnt)
    j = a_idx - first[q_of]
    P, A = qs.size, a_idx.size
    n = P + A
    D = _pow2(n)
    par, ch = np.arange(P), P + np.arange(A)
    fields, keywords = {}, {}
    fields["tag"], keywords["tag"] = kw_arrays(
        np, _at(np, D, par, c["tag"][qs]), lambda t: f"tag{t}",
        _mask(np, D, par), D)
    fields["user"], keywords["user"] = kw_arrays(
        np, _at(np, D, ch, c["user"][a_idx]), lambda u: f"u{u}",
        _mask(np, D, ch), D)
    fields["_type"], keywords["_type"] = kw_arrays(
        np, _at(np, D, ch, 1), ("question", "answer").__getitem__,
        _mask(np, D, np.arange(n)), D)
    fields["_parent"], keywords["_parent"] = kw_arrays(
        np, _at(np, D, ch, q_of), lambda q: f"q{q}", _mask(np, D, ch), D)
    fields["title"] = _title_field(np, c["title"][qs], par, D)
    ids = [f"q{q}" for q in qs.tolist()] + [
        f"q{q}a{x}" for q, x in zip(q_of.tolist(), j.tolist())]
    return {"num_docs": n, "max_docs": D, "ids": ids,
            "fields": fields, "keywords": keywords,
            "numerics": {"votes": _num(np, D, par, c["votes"][qs], "long"),
                         "date": _num(np, D, ch, c["date"][a_idx], "date"),
                         "score": _num(np, D, ch, c["score"][a_idx],
                                       "long")}}, (qs, a_idx, q_of, j)


def geo_points(np, n, seed):
    """(c)'s points: Zipf(1.1)-weighted seeded centres worldwide, each
    point a centre plus Gaussian noise (2 degrees lat, 3 lon); one doc in
    64 without a point; the last docs exactly on geohash cell edges at
    precisions 3 and 6 and on the boxes' edges (``geo_edges``)."""
    rng = np.random.default_rng(seed + 15)
    cent = np.stack([rng.uniform(-60, 70, JG_CENTRES),
                     rng.uniform(-180, 180, JG_CENTRES)], 1)
    w = 1.0 / np.arange(1, JG_CENTRES + 1) ** 1.1
    k = rng.choice(JG_CENTRES, n, p=w / w.sum())
    lat = np.clip(cent[k, 0] + rng.normal(0, 2, n), -89.9, 89.9)
    lon = (cent[k, 1] + rng.normal(0, 3, n) + 180.0) % 360.0 - 180.0
    edges = geo_edges(np)
    lat[n - len(edges):] = edges[:, 0]
    lon[n - len(edges):] = edges[:, 1]
    ok = np.ones(n, bool)
    ok[: n - len(edges)][::64] = False
    return lat, lon, ok, cent


def geo_edges(np):
    """Points on cell edges (-90 + 180 j / 2^bits and its lon twin are f32
    values) at precisions 3 and 6, and on the edges and corners of
    ``JG_BOXES``."""
    pts = []
    for prec in (3, 6):
        total = prec * 5
        lat_bits, lon_bits = total // 2, (total + 1) // 2
        for j in range(1, 1 << min(lat_bits, 7), 3):
            jj = (j * 9973) % (1 << lat_bits)
            lj = (j * 7919) % (1 << lon_bits)
            pts.append((-90.0 + 180.0 * jj / (1 << lat_bits),
                        -180.0 + 360.0 * lj / (1 << lon_bits)))
    for top, left, bottom, right in JG_BOXES:
        for la in (top, bottom, (top + bottom) / 2):
            for lo in (left, right, 179.5, -179.5):
                pts.append((la, lo))
    return np.asarray(pts, np.float64)


# (top, left, bottom, right); the second crosses the antimeridian
JG_BOXES = [(50.0, -10.0, 35.0, 30.0), (40.0, 170.0, -10.0, -170.0),
            (12.5, 100.0, -8.0, 140.0), (64.0, -130.0, 24.0, -60.0),
            (0.0, -80.0, -40.0, -30.0), (60.0, 60.0, 40.0, 100.0),
            (30.0, -20.0, 5.0, 50.0), (-15.0, 110.0, -45.0, 155.0)]


def geo_arrays(np, lat, lon, ok):
    n = lat.size
    D = _pow2(n)
    num = {}
    for name, v in (("location.lat", lat), ("location.lon", lon)):
        exact = np.zeros(D, np.float64)
        exact[:n] = np.where(ok, v, 0.0)
        exists = np.zeros(D, bool)
        exists[:n] = ok
        num[name] = {"exact": exact, "exists": exists, "kind": "double"}
    return {"num_docs": n, "max_docs": D, "numerics": num}


def jg_bodies(np, c, cent, seed):
    """The groups of bodies of (a), (b) and (c) from the seed: name ->
    (index, bodies, served by the mesh)."""
    rng = np.random.default_rng(seed + 16)
    users = [f"u{u}" for u in rng.integers(0, 30, 8)]
    spans = [(TAXI_YEAR + int(rng.integers(0, 3 * 365)) * DAY_MS,
              int(rng.integers(120, 700)) * DAY_MS) for _ in range(8)]

    def nested(mode, i, inner_hits=None):
        lo, width = spans[i]
        q = {"nested": {"path": "answers", "score_mode": mode, "query": {
            "bool": {"must": [{"term": {"answers.user": users[i]}}],
                     "filter": [{"range": {"answers.date": {
                         "gte": lo, "lt": lo + width}}}]}}}}
        if inner_hits:
            q["nested"]["inner_hits"] = inner_hits
        return {"query": q, "size": 10}

    tags = [f"tag{t}" for t in rng.integers(0, 20, 8)]
    g = {}
    for mode in JG_MODES:
        g[f"a_nested_{mode}"] = ("qa", [nested(mode, i) for i in range(8)],
                                 False)
    g["a_inner_hits"] = ("qa", [nested("max", i, {"size": 3})
                                for i in range(8)], False)
    heads = [f"t{w}" for w in range(8)]  # the title's densest terms
    g["a_match"] = ("qa", [{"query": {"match": {"title": f"{heads[i]} "
                                                f"{heads[(i + 3) % 8]}"}},
                            "size": 10} for i in range(8)], False)
    g["a_tag"] = ("qa", [{"query": {"term": {"tag": t}}, "size": 10}
                         for t in tags], False)
    g["a_nested_agg"] = ("qa", [{"size": 0, "query": {"term": {"tag": t}},
                                 "aggs": {"answers": {
                                     "nested": {"path": "answers"},
                                     "aggs": {"users": {
                                         "terms": {"field": "answers.user",
                                                   "size": 10},
                                         "aggs": {"questions": {
                                             "reverse_nested": {}}}}}}}}
                                for t in tags], False)
    g["a_date_histo"] = ("qa", [{"size": 0, "query": {"term": {"tag": t}},
                                 "aggs": {"answers": {
                                     "nested": {"path": "answers"},
                                     "aggs": {"by_month": {
                                         "date_histogram": {
                                             "field": "answers.date",
                                             "interval": "month"}}}}}}
                                for t in tags], False)
    g["b_has_child_max"] = ("qapc", [{"query": {"has_child": {
        "type": "answer", "score_mode": "max", "min_children": 2,
        "query": {"term": {"user": u}}}}, "size": 10} for u in users], False)
    g["b_has_child_sum"] = ("qapc", [{"query": {"has_child": {
        "type": "answer", "score_mode": "sum", "min_children": 2,
        "query": {"term": {"user": u}}}}, "size": 10} for u in users], False)
    g["b_has_parent"] = ("qapc", [{"query": {"has_parent": {
        "parent_type": "question", "score_mode": "score",
        "query": {"term": {"tag": t}}}}, "size": 10} for t in tags], False)
    g["b_children_agg"] = ("qapc", [{"size": 0, "query": {"term": {
        "_type": "question"}}, "aggs": {"tags": {
            "terms": {"field": "tag", "size": 3 + i % 3}, "aggs": {
                "answers": {"children": {"type": "answer"}}}}}}
        for i in range(8)], True)
    g["b_match"] = ("qapc", [{"query": {"match": {"title": f"{heads[i]} "
                                                  f"{heads[(i + 3) % 8]}"}},
                              "size": 10} for i in range(8)], True)
    pick = cent[rng.integers(0, 50, 8)]

    def star(i):
        m = int(rng.integers(5, 9))
        ang = np.sort(rng.uniform(0, 2 * np.pi, m))
        r = rng.uniform(3, 15, m)
        return [{"lat": float(np.clip(pick[i, 0] + r[x] * np.sin(ang[x]),
                                      -89, 89)),
                 "lon": float(np.clip(pick[i, 1] + r[x] * np.cos(ang[x]),
                                      -179.9, 179.9))} for x in range(m)]

    radii = ("50km", "500km", "2000km")
    g["c_polygon"] = ("geo", [{"query": {"geo_polygon": {"location": {
        "points": star(i)}}}, "size": 10} for i in range(8)], False)
    g["c_bbox"] = ("geo", [{"query": {"geo_bounding_box": {"location": {
        "top": b[0], "left": b[1], "bottom": b[2], "right": b[3]}}},
        "size": 10} for b in JG_BOXES], False)
    g["c_distance"] = ("geo", [{"query": {"geo_distance": {
        "distance": radii[i % 3], "location": {
            "lat": float(pick[i, 0]), "lon": float(pick[i, 1])}}},
        "size": 10} for i in range(8)], False)
    g["c_geohash3"] = ("geo", [{"size": 0, "aggs": {"cells": {
        "geohash_grid": {"field": "location", "precision": 3,
                         "size": 50 + i}}}} for i in range(8)], True)
    g["c_geohash6"] = ("geo", [{"size": 0, "query": {"geo_bounding_box": {
        "location": {"top": b[0], "left": b[1], "bottom": b[2],
                     "right": b[3]}}}, "aggs": {"cells": {"geohash_grid": {
                         "field": "location", "precision": 6,
                         "size": 100}}}} for b in JG_BOXES], False)
    g["c_distance_agg"] = ("geo", [{"size": 0, "aggs": {"rings": {
        "geo_distance": {"field": "location", "unit": "km",
                         "origin": {"lat": float(pick[i, 0]),
                                    "lon": float(pick[i, 1])},
                         "ranges": [{"to": 100}, {"from": 100, "to": 1000},
                                    {"from": 1000, "to": 5000},
                                    {"from": 5000}]}}}} for i in range(8)],
                           True)
    g["c_bounds"] = ("geo", [{"size": 0, "query": {"geo_bounding_box": {
        "location": {"top": b[0], "left": b[1], "bottom": b[2],
                     "right": b[3]}}}, "aggs": {"b": {"geo_bounds": {
                         "field": "location"}}}} for b in JG_BOXES], False)
    for size in (10, 100):
        g[f"c_sort{size}"] = ("geo", [{"query": {"match_all": {}},
                                        "size": size, "sort": [{
                                            "_geo_distance": {"location": {
                                                "lat": float(pick[i, 0]),
                                                "lon": float(pick[i, 1])},
                                                "order": "asc",
                                                "unit": "km"}}]}
                                       for i in range(8)], False)
    g["c_exists"] = ("geo", [{"query": {"exists": {"field": "location"}},
                              "size": 10 + i} for i in range(8)], True)
    return g


def shape_docs(np, n, seed):
    """(d)'s shapes: small seeded polygons (4-7 vertices, under a degree
    across) and two-to-four-point linestrings over Europe."""
    rng = np.random.default_rng(seed + 17)
    out = []
    for i in range(n):
        x, y = rng.uniform(-10, 30), rng.uniform(35, 60)
        if i % 3:
            m = int(rng.integers(4, 8))
            ang = np.sort(rng.uniform(0, 2 * np.pi, m))
            r = rng.uniform(0.1, 0.4, m)
            ring = [[float(x + r[k] * np.cos(ang[k])),
                     float(y + r[k] * np.sin(ang[k]))] for k in range(m)]
            out.append({"type": "polygon", "coordinates": [ring + [ring[0]]]})
        else:
            m = int(rng.integers(2, 5))
            out.append({"type": "linestring", "coordinates": [
                [float(x + rng.uniform(-0.4, 0.4)),
                 float(y + rng.uniform(-0.4, 0.4))] for _ in range(m)]})
    return out


def _jg_f32_cells(np, lat, lon, prec):
    """Geohash cell ids in numpy f32 with true divisions (the reference's
    arithmetic)."""
    total = prec * 5
    lat_bits, lon_bits = total // 2, (total + 1) // 2
    f = np.float32
    la = np.clip(((lat.astype(f) + f(90.0)) / f(180.0) * f(1 << lat_bits))
                 .astype(np.int32), 0, (1 << lat_bits) - 1)
    lo = np.clip(((lon.astype(f) + f(180.0)) / f(360.0) * f(1 << lon_bits))
                 .astype(np.int32), 0, (1 << lon_bits) - 1)
    return (lo.astype(np.int64) << lat_bits) + la


def _jg_f32_polygon(np, lat, lon, pts):
    """The even-odd ray cast in numpy f32, the reference's arithmetic."""
    f = np.float32
    y, x = lat.astype(f), lon.astype(f)
    inside = np.zeros(y.size, bool)
    n = len(pts)
    for i in range(n):
        y1, x1 = pts[i]["lat"], pts[i]["lon"]
        y2, x2 = pts[(i + 1) % n]["lat"], pts[(i + 1) % n]["lon"]
        xs = (f(x2 - x1) * (y - f(y1))) / f((y2 - y1) if y2 != y1 else 1e-12) \
            + f(x1)
        inside ^= ((f(y1) > y) != (f(y2) > y)) & (x < xs)
    return inside


def _jg_f32_box(np, lat, lon, b):
    f = np.float32
    y, x = lat.astype(f), lon.astype(f)
    top, left, bottom, right = b
    m = (y <= f(top)) & (y >= f(bottom))
    if left <= right:
        return m & (x >= f(left)) & (x <= f(right))
    return m & ((x >= f(left)) | (x <= f(right)))


def _jg_idf(np, df, n):
    return float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))


def _jg_topk_valid(np, resp, score_of, total, k, what, rtol=1e-6):
    """A scored page against an oracle's f64 scores (``score_of``: id ->
    score for every match): the total exact, each hit's score within
    rtol, the page in descending order and no match outside it scoring
    above its last hit beyond rtol (ties may order either way)."""
    hits = resp["hits"]["hits"]
    _hold(resp["hits"]["total"] == total,
          f"{what}: total {resp['hits']['total']} vs oracle {total}", "5k")
    _hold(len(hits) == min(k, total), f"{what}: {len(hits)} hits", "5k")
    got = [h["_score"] for h in hits]
    for h in hits:
        w = score_of.get(h["_id"])
        _hold(w is not None and abs(h["_score"] - w) <= rtol * abs(w),
              f"{what}: {h['_id']} scored {h['_score']}, oracle {w}", "5k")
    _hold(all(a >= b for a, b in zip(got, got[1:])), f"{what}: order",
          "5k")
    if hits:
        seen = {h["_id"] for h in hits}
        floor = min(got) * (1 + rtol)
        above = [i for i, s in score_of.items() if s > floor and i not in
                 seen]
        _hold(not above, f"{what}: {above[:3]} score above the page", "5k")


def _jg_buckets(resp_buckets, want, what, sub=None):
    """Terms buckets against oracle counts (``want``: key -> count): each
    returned count exact, no left-out key counting more than the last
    returned one; ``sub(bucket) -> (got, want)`` checks a sub-agg."""
    keys = [b["key"] for b in resp_buckets]
    for b in resp_buckets:
        _hold(b["doc_count"] == want.get(b["key"], -1),
              f"{what}: bucket {b['key']} {b['doc_count']} vs "
              f"{want.get(b['key'])}", "5k")
        if sub is not None:
            g, w = sub(b)
            _hold(g == w, f"{what}: bucket {b['key']} sub {g} vs {w}", "5k")
    if keys:
        low = min(b["doc_count"] for b in resp_buckets)
        _hold(all(v <= low for kk, v in want.items() if kk not in keys),
              f"{what}: a left-out key counts more", "5k")


def phase_joins_geo(torch, np, dev, card) -> int:
    """Phase 5k: joins and geo (ROADMAP A9c; module docstring). Returns
    B1's launches in 5k's timed runs (only (b)'s match, on segments
    without nested docs, takes B1)."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.routing import shard_id_for
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.monitor import kernels as counters
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.search import geo as G

    t_phase = time.perf_counter()
    c = qa_corpus(np, JG_QUESTIONS, SEED)
    lat, lon, ok, cent = geo_points(np, JG_POINTS, SEED)
    groups = jg_bodies(np, c, cent, SEED)
    n_ans = c["n_ans"]
    nq, na = n_ans.size, int(n_ans.sum())
    q_of = np.repeat(np.arange(nq), n_ans)
    lines, answers = [], {}
    b1_0 = bm25_topk.LAUNCHES

    def timed(node, index, bodies):
        ms, out = [], {}
        start = time.perf_counter()
        while len(ms) < max(FT_MIN_REPS, len(bodies)) or (
                len(ms) < FT_MAX_REPS
                and time.perf_counter() - start < JG_WINDOW_S):
            i = len(ms) % len(bodies)
            a = time.perf_counter()
            out[i] = node.search(index, copy.deepcopy(bodies[i]))
            ms.append((time.perf_counter() - a) * 1e3)
        return np.array(ms), out

    def run_group(node, name):
        """Time a group on the host loop (and on the mesh where it
        serves), check the route counters and that both routes answer
        byte for byte; returns the host loop's answers."""
        index, bodies, mesh_serves = groups[name]
        counters.reset()
        first = [node.search(index, copy.deepcopy(b)) for b in bodies]
        snap = counters.snapshot()
        key = "mesh_search" if mesh_serves else "mesh_fallback_total"
        _hold(snap.get(key) == len(bodies),
              f"{name}: {key} not counted once a body: {snap}", "5k")
        for route in (("mesh", "host") if mesh_serves else ("host",)):
            with (_host_loop() if route == "host"
                  else contextlib.nullcontext()):
                counters.reset()
                ms, out = timed(node, index, bodies)
                snap = counters.snapshot()
                prof = profile_path(torch, lambda: [node.search(
                    index, copy.deepcopy(bodies[i % len(bodies)]))
                    for i in range(FT_PROFILED)])
            if route == "host":
                _hold(not any(k.startswith("mesh_") for k in snap),
                      f"{name}: the pinned host loop ran the mesh", "5k")
            label = {"host": "host loop", "mesh": "mesh path"}[route]
            if route == "host" and not mesh_serves:
                label = "host loop (the mesh declines)"
            lines.append(_ft_line(np, name, label, ms, prof, "5k"))
            answers[(name, route)] = out
        for i, f in enumerate(first):
            for route in ("mesh", "host"):
                if (name, route) in answers:
                    _hold(_strip_took(f) == _strip_took(
                        answers[(name, route)][i]),
                          f"{name} body {i}: {route} answers differ from "
                          f"the default route's", "5k")
        return answers[(name, "host")]

    # -- (a) nested ------------------------------------------------------
    t = time.perf_counter()
    arrays = nested_arrays(np, c)
    t_data = time.perf_counter() - t
    node = Node(name="nested", device=dev)
    node.create_index("qa", {"settings": {"number_of_shards": 1},
                             "mappings": JG_QA_MAPPING})
    seg = segment_from_arrays(arrays, node.residency)
    node.get_index("qa").shards[0].engine.add_segment(seg)
    segs_br = node.breakers.breaker("segments")
    blk = seg.block_bytes()
    _hold(seg.has_nested and blk > 0 and segs_br.used >= blk,
          f"block arrays {blk} bytes, segments breaker {segs_br.used}", "5k")
    log(f"[5k] (a) {nq} questions with {na} nested answers in one "
        f"{seg.max_docs}-slot segment ({seg.num_docs} docs); arrays "
        f"{t_data:.1f} s, set-up {time.perf_counter() - t:.1f} s; block "
        f"arrays {blk} bytes on the card, segments breaker {segs_br.used}")
    user_of = c["user"]
    first_a = np.cumsum(n_ans) - n_ans
    root_at = np.cumsum(n_ans + 1) - 1
    idf_cache = {}

    def user_idf(u):
        if u not in idf_cache:
            idf_cache[u] = _jg_idf(np, int(np.sum(user_of == u)), na)
        return idf_cache[u]

    b1_a = bm25_topk.LAUNCHES
    for name in [f"a_nested_{m}" for m in JG_MODES] + [
            "a_inner_hits", "a_match", "a_tag", "a_nested_agg",
            "a_date_histo"]:
        out = run_group(node, name)
        bodies = groups[name][1]
        for i, b in enumerate(bodies):
            resp = out[i]
            what = f"{name} body {i}"
            if "nested" in b["query"]:
                nb = b["query"]["nested"]
                mode = nb["score_mode"]
                u = int(nb["query"]["bool"]["must"][0]["term"][
                    "answers.user"][1:])
                rng_ = nb["query"]["bool"]["filter"][0]["range"][
                    "answers.date"]
                m = (user_of == u) & (c["date"] >= rng_["gte"]) & \
                    (c["date"] < rng_["lt"])
                cnt = np.bincount(q_of[m], minlength=nq)
                idf = user_idf(u)
                hit = np.nonzero(cnt)[0]
                sc = {"sum": cnt[hit] * idf, "none": np.ones(hit.size)}.get(
                    mode, np.full(hit.size, idf))
                _jg_topk_valid(np, resp, dict(zip(
                    [f"q{q}" for q in hit.tolist()], sc.tolist())),
                    int(hit.size), 10, what)
                if mode in ("max", "none"):  # equal scores: local order
                    _hold([h["_id"] for h in resp["hits"]["hits"]] ==
                          [f"q{q}" for q in hit[:10].tolist()],
                          f"{what}: ids not in local order", "5k")
                if name == "a_inner_hits":
                    for h in resp["hits"]["hits"]:
                        q = int(h["_id"][1:])
                        js = np.nonzero(m[first_a[q]: first_a[q]
                                          + n_ans[q]])[0]
                        ih = h["inner_hits"]["answers"]["hits"]
                        root_src = arrays["sources"][int(root_at[q])]
                        _hold(ih["total"] == js.size and
                              [x["_nested"]["offset"] for x in ih["hits"]]
                              == js[:3].tolist() and
                              all(x["_source"] == root_src["answers"][j]
                                  for x, j in zip(ih["hits"], js[:3]))
                              and all(x["_id"] == h["_id"]
                                      for x in ih["hits"]),
                              f"{what}: inner hits of {h['_id']}", "5k")
            elif name == "a_tag":
                k = int(b["query"]["term"]["tag"][3:])
                sel = np.nonzero(c["tag"] == k)[0]
                _hold(resp["hits"]["total"] == sel.size and
                      [h["_id"] for h in resp["hits"]["hits"]] ==
                      [f"q{q}" for q in sel[:10].tolist()],
                      f"{what}: roots only, in local order", "5k")
            elif name == "a_match":
                ws = [int(w[1:]) for w in b["query"]["match"]["title"]
                      .split()]
                has = np.isin(c["title"], ws).any(1)
                _hold(resp["hits"]["total"] == int(has.sum()) and all(
                    "|" not in h["_id"] for h in resp["hits"]["hits"]),
                      f"{what}: total {resp['hits']['total']} vs "
                      f"{int(has.sum())}", "5k")
            else:
                k = int(b["query"]["term"]["tag"][3:])
                selq = c["tag"] == k
                am = selq[q_of]
                agg = resp["aggregations"]["answers"]
                _hold(agg["doc_count"] == int(am.sum()),
                      f"{what}: nested doc_count {agg['doc_count']} vs "
                      f"{int(am.sum())}", "5k")
                if name == "a_nested_agg":
                    us, cn = np.unique(user_of[am], return_counts=True)
                    want = {f"u{u}": int(x) for u, x in zip(us, cn)}

                    def distinct(bk):
                        uu = int(bk["key"][1:])
                        return (bk["questions"]["doc_count"],
                                int(np.unique(q_of[am & (user_of == uu)])
                                    .size))

                    _jg_buckets(agg["users"]["buckets"], want, what,
                                distinct)
                else:
                    mon = c["date"][am].astype("datetime64[ms]").astype(
                        "datetime64[M]")
                    ks, cn = np.unique(mon, return_counts=True)
                    want = [(int(x), int(y)) for x, y in zip(
                        ks.astype("datetime64[ms]").astype(np.int64), cn)]
                    got = [(b_["key"], b_["doc_count"]) for b_ in
                           agg["by_month"]["buckets"] if b_["doc_count"]]
                    _hold(got == want, f"{what}: months differ", "5k")
    b1_nested = bm25_topk.LAUNCHES - b1_a
    _hold(b1_nested == 0, f"(a): B1 launched {b1_nested} times on a nested "
          "segment", "5k")
    # repeats: a sum or avg body's bytes do not change between runs
    for name in ("a_nested_sum", "a_nested_avg"):
        for i, b in enumerate(groups[name][1]):
            again = [node.search("qa", copy.deepcopy(b)) for _ in range(2)]
            _hold(all(_strip_took(x) == _strip_took(answers[(name, "host")]
                                                    [i]) for x in again),
                  f"{name} body {i}: the bytes changed between runs", "5k")
    # the runs sum in index order on the card: bit for bit the CPU's
    # sequential sums (the reference's order) of values of mixed scales
    from elasticsearch_tpu_torch.search.joins import run_reduce

    g = torch.Generator(device=dev).manual_seed(SEED)
    vals = torch.rand(seg.max_docs, generator=g, device=dev) * torch.pow(
        10.0, torch.randint(-3, 4, (seg.max_docs,), generator=g,
                            device=dev).float())
    for mode, init in (("sum", 0.0), ("max", float("-inf"))):
        card_r = run_reduce(vals, seg.root_id_dev, mode, init, seg.max_docs)
        cpu_r = run_reduce(vals.cpu(), seg.root_id_dev.cpu(), mode, init,
                           seg.max_docs)
        _hold(torch.equal(card_r.cpu(), cpu_r),
              f"run_reduce {mode}: the card's runs differ from the CPU's "
              f"sequential ones", "5k")
    log(f"[5k] (a) nested runs' sums and maxima over the {seg.max_docs} "
        f"slots bit for bit the CPU's sequential ones")
    log(f"[5k] (a) every nested body against numpy f64 (totals exact, "
        f"scores rtol 1e-6, max/none ids exact), inner hits, roots only, "
        f"the agg's buckets and months exact; sum and avg bodies "
        f"byte-identical over repeated runs; B1 0 launches on the nested "
        f"segment")
    # a delete of roots cascades into totals and aggs after a refresh
    rng = np.random.default_rng(SEED + 18)
    gone = np.sort(rng.choice(nq, JG_DELETES, replace=False))
    for q in gone.tolist():
        node.delete("qa", f"q{q}")
    node.refresh("qa")
    seg_now = node.get_index("qa").shards[0].engine.segments
    _hold(len(seg_now) == 1 and seg_now[0] is seg,
          "a delete of 64 roots merged the segment", "5k")
    dead = int(JG_DELETES + n_ans[gone].sum())
    r = node.search("qa", {"size": 0, "aggs": {"n": {"nested": {
        "path": "answers"}}}})
    _hold(r["hits"]["total"] == nq - JG_DELETES and
          r["aggregations"]["n"]["doc_count"] == na - int(n_ans[gone].sum())
          and int(seg.live.sum()) == seg.num_docs - dead,
          f"after deleting {JG_DELETES} roots: total {r['hits']['total']}, "
          f"nested {r['aggregations']['n']['doc_count']}", "5k")
    log(f"[5k] (a) {JG_DELETES} roots deleted: {dead} docs off the card's "
        f"live mask, totals and the nested agg down by exactly theirs")
    # the prefix against a CPU Node of the port
    t = time.perf_counter()
    pc_ = qa_prefix(c, JG_PREFIX_Q)
    p_arrays = nested_arrays(np, pc_)
    pnodes = [Node(name="qa-card", device=dev), Node(name="qa-cpu",
                                                    device="cpu")]
    for pn in pnodes:
        pn.create_index("qa", {"settings": {"number_of_shards": 1},
                               "mappings": JG_QA_MAPPING})
        pn.get_index("qa").shards[0].engine.add_segment(
            segment_from_arrays(p_arrays, pn.residency))
    n_cmp = 0
    for name in [g for g in groups if g.startswith("a_")]:
        for b in groups[name][1]:
            b = dict(b, size=10_000)
            got, want = (pn.search("qa", copy.deepcopy(b)) for pn in pnodes)
            _jg_same_set(got, want, f"{name} prefix, card vs CPU")
            n_cmp += 1
    for pn in pnodes:
        pn.close()
    log(f"[5k] (a) {n_cmp} bodies on a {JG_PREFIX_Q}-question prefix: the "
        f"card equals a CPU Node of the port (totals, ids, aggregations; "
        f"scores rtol 1e-6); {time.perf_counter() - t:.1f} s")
    node.close()
    _hold(segs_br.used == 0, f"segments breaker {segs_br.used} bytes after "
          "the close", "5k")
    log(f"[5k] (a) closed: segments breaker {segs_br.used} bytes (the block "
        f"arrays released)")
    del arrays, seg, node

    # -- (b) parent/child ----------------------------------------------
    t = time.perf_counter()
    shard_of = np.array([shard_id_for(f"q{q}", JG_SHARDS)
                         for q in range(nq)])
    node = Node(name="pc", device=dev)
    node.create_index("qapc", {"settings": {"number_of_shards": JG_SHARDS},
                               "mappings": JG_PC_MAPPING})
    shard_meta = []
    for s in range(JG_SHARDS):
        arr, meta = pc_shard_arrays(np, c, shard_of, s)
        node.get_index("qapc").shards[s].engine.add_segment(
            segment_from_arrays(arr, node.residency))
        shard_meta.append(meta)
    log(f"[5k] (b) {nq} questions and {na} answers as parents and children "
        f"over {JG_SHARDS} shards by shard_id_for(parent), one segment a "
        f"shard; set-up {time.perf_counter() - t:.1f} s")
    b1_b = bm25_topk.LAUNCHES
    f32 = np.float32
    for name in ("b_has_child_max", "b_has_child_sum", "b_has_parent",
                 "b_children_agg", "b_match"):
        out = run_group(node, name)
        for i, b in enumerate(groups[name][1]):
            resp, what = out[i], f"{name} body {i}"
            if name.startswith("b_has_child"):
                hc = b["query"]["has_child"]
                u = int(hc["query"]["term"]["user"][1:])
                cands = []
                for s, (qs, a_idx, qo, _j) in enumerate(shard_meta):
                    us = user_of[a_idx]
                    idf32 = f32(_jg_idf(np, int(np.sum(us == u)), a_idx.size))
                    cnt = np.bincount(np.searchsorted(qs, qo[us == u]),
                                      minlength=qs.size)
                    for loc in np.nonzero(cnt >= 2)[0].tolist():
                        v = idf32 if hc["score_mode"] == "max" else f32(
                            cnt[loc] * np.float64(idf32))
                        cands.append((-float(v), s, loc, f"q{qs[loc]}"))
                cands.sort()
                _hold(resp["hits"]["total"] == len(cands) and
                      [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
                      == [(x[3], -x[0]) for x in cands[:10]],
                      f"{what}: hits or scores differ from numpy", "5k")
            elif name == "b_has_parent":
                k = int(b["query"]["has_parent"]["query"]["term"]["tag"][3:])
                cands = []
                for s, (qs, a_idx, qo, jj) in enumerate(shard_meta):
                    tg = c["tag"][qs]
                    idf32 = float(f32(_jg_idf(np, int(np.sum(tg == k)),
                                              qs.size)))
                    kids = np.nonzero(c["tag"][qo] == k)[0]
                    cands += [(-idf32, s, qs.size + x, f"q{qo[x]}a{jj[x]}")
                              for x in kids.tolist()]
                cands.sort()
                _hold(resp["hits"]["total"] == len(cands) and
                      [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
                      == [(x[3], -x[0]) for x in cands[:10]],
                      f"{what}: hits or scores differ from numpy", "5k")
            elif name == "b_children_agg":
                ts, cn = np.unique(c["tag"], return_counts=True)
                want = {f"tag{x}": int(y) for x, y in zip(ts, cn)}
                kids = {f"tag{x}": int(n_ans[c["tag"] == x].sum())
                        for x in ts}
                _jg_buckets(resp["aggregations"]["tags"]["buckets"], want,
                            what, lambda bk: (bk["answers"]["doc_count"],
                                              kids[bk["key"]]))
            else:
                ws = [int(w[1:]) for w in b["query"]["match"]["title"]
                      .split()]
                has = int(np.isin(c["title"], ws).any(1).sum())
                _hold(resp["hits"]["total"] == has,
                      f"{what}: total {resp['hits']['total']} vs {has}",
                      "5k")
    b1_pc = bm25_topk.LAUNCHES - b1_b
    _hold(b1_pc > 0, "(b): the match launched no B1", "5k")
    log(f"[5k] (b) has_child counts, min_children, max and sum scores and "
        f"has_parent sets exact against numpy; children agg buckets exact; "
        f"the match on the mesh and B1 ({b1_pc} launches), byte for byte "
        f"with the host loop")
    node.close()
    del node, shard_meta

    # -- (c) geo points --------------------------------------------------
    t = time.perf_counter()
    node = Node(name="geo", device=dev)
    node.create_index("geo", {"settings": {"number_of_shards": 1},
                              "mappings": JG_GEO_MAPPING})
    node.get_index("geo").shards[0].engine.add_segment(segment_from_arrays(
        geo_arrays(np, lat, lon, ok), node.residency))
    edges = geo_edges(np)
    log(f"[5k] (c) {JG_POINTS} docs, {int(ok.sum())} located around "
        f"{JG_CENTRES} centres, {len(edges)} on cell and box edges; set-up "
        f"{time.perf_counter() - t:.1f} s")
    # hazard 1 on the card: cells of points on cell edges are the exact
    # f64 cells (a product with the reciprocal lands one low)
    et = torch.tensor(edges, dtype=torch.float32, device=dev)
    n_cell = 0
    for prec in (3, 6):
        total = prec * 5
        lat_bits, lon_bits = total // 2, (total + 1) // 2
        got = G.geohash_cell_device(et[:, 0], et[:, 1], prec).cpu().numpy()
        exact = (np.clip(np.floor((edges[:, 1] + 180) / 360 * (1 << lon_bits)),
                         0, (1 << lon_bits) - 1).astype(np.int64)
                 << lat_bits) + np.clip(np.floor((edges[:, 0] + 90) / 180 * (
                     1 << lat_bits)), 0, (1 << lat_bits) - 1).astype(np.int64)
        on_edge = np.arange(len(edges)) < 2 * len(range(1, 128, 3))
        _hold(np.array_equal(got, _jg_f32_cells(np, edges[:, 0], edges[:, 1],
                                                prec))
              and np.array_equal(got[on_edge], exact[on_edge]),
              f"precision {prec}: cells of edge points differ", "5k")
        n_cell += int(on_edge.sum())
    log(f"[5k] (c) {n_cell} cell checks of points exactly on cell edges at "
        f"precisions 3 and 6: the card's cells are the exact ones")
    loc = np.nonzero(ok)[0]
    llat, llon = lat[loc], lon[loc]
    band_total = 0
    for name in ("c_polygon", "c_bbox", "c_distance", "c_geohash3",
                 "c_geohash6", "c_distance_agg", "c_bounds", "c_sort10",
                 "c_sort100", "c_exists"):
        out = run_group(node, name)
        for i, b in enumerate(groups[name][1]):
            resp, what = out[i], f"{name} body {i}"
            q = b.get("query", {})
            member = None
            if "geo_polygon" in q:
                member = _jg_f32_polygon(np, llat, llon, q["geo_polygon"][
                    "location"]["points"])
            elif "geo_bounding_box" in q:
                bx = q["geo_bounding_box"]["location"]
                member = _jg_f32_box(np, llat, llon, (bx["top"], bx["left"],
                                                      bx["bottom"],
                                                      bx["right"]))
            if name in ("c_polygon", "c_bbox"):
                ids = loc[member]
                _hold(resp["hits"]["total"] == ids.size and
                      [h["_id"] for h in resp["hits"]["hits"]] ==
                      [str(x) for x in ids[:10].tolist()],
                      f"{what}: members differ from numpy's f32 "
                      f"{ids.size}", "5k")
            elif name == "c_distance":
                gd = q["geo_distance"]
                r = G.parse_distance(gd["distance"])
                d = G.haversine_np(llat, llon, gd["location"]["lat"],
                                   gd["location"]["lon"])
                band = np.abs(d - r) <= JG_BAND * r
                band_total += int(band.sum())
                inside = int(np.sum(d <= r))
                _hold(abs(resp["hits"]["total"] - inside) <= band.sum()
                      and resp["hits"]["total"] >= inside - band.sum(),
                      f"{what}: total {resp['hits']['total']} vs {inside} "
                      f"(band {int(band.sum())})", "5k")
                pos = {str(x): j for j, x in enumerate(loc.tolist())}
                _hold(all(d[pos[h["_id"]]] <= r or band[pos[h["_id"]]]
                          for h in resp["hits"]["hits"]),
                      f"{what}: a hit outside the radius", "5k")
            elif name in ("c_geohash3", "c_geohash6"):
                prec = b["aggs"]["cells"]["geohash_grid"]["precision"]
                size = b["aggs"]["cells"]["geohash_grid"]["size"]
                sel = member if member is not None else np.ones(loc.size,
                                                                bool)
                cells, cn = np.unique(_jg_f32_cells(np, llat[sel], llon[sel],
                                                    prec),
                                      return_counts=True)
                order = np.lexsort((cells, -cn))[:size]
                want = [{"key": G.geohash_encode_cell(int(cells[j]), prec),
                         "doc_count": int(cn[j])} for j in order]
                _hold(resp["aggregations"]["cells"]["buckets"] == want,
                      f"{what}: cells differ from numpy's f32", "5k")
            elif name == "c_distance_agg":
                o = b["aggs"]["rings"]["geo_distance"]["origin"]
                d = G.haversine_np(llat, llon, o["lat"], o["lon"]) / 1000.0
                edges_km = np.array([100.0, 1000.0, 5000.0])
                band = int(sum(np.sum(np.abs(d - e) <= JG_BAND * e)
                               for e in edges_km))
                band_total += band
                want = np.histogram(d, bins=[0, 100, 1000, 5000, np.inf])[0]
                got = [bk["doc_count"] for bk in
                       resp["aggregations"]["rings"]["buckets"]]
                _hold(sum(abs(g_ - w_) for g_, w_ in zip(got, want))
                      <= 2 * band, f"{what}: rings {got} vs {want.tolist()}"
                      f" (band {band})", "5k")
            elif name == "c_bounds":
                fl, fo = llat[member].astype(f32), llon[member].astype(f32)
                bb = resp["aggregations"]["b"]["bounds"]
                _hold(bb == {"top_left": {"lat": float(fl.max()),
                                          "lon": float(fo.min())},
                             "bottom_right": {"lat": float(fl.min()),
                                              "lon": float(fo.max())}},
                      f"{what}: bounds {bb}", "5k")
            elif name.startswith("c_sort"):
                o = b["sort"][0]["_geo_distance"]["location"]
                d = G.haversine_np(llat, llon, o["lat"], o["lon"]) / 1000.0
                hits = resp["hits"]["hits"]
                pos = {str(x): j for j, x in enumerate(loc.tolist())}
                vals = [h["sort"][0] for h in hits]
                kth = np.partition(d, len(hits))[len(hits)]
                _hold(len(hits) == b["size"] and vals == sorted(vals) and
                      all(abs(v - d[pos[h["_id"]]]) <= 1e-9 * max(v, 1e-9)
                          for v, h in zip(vals, hits)) and
                      vals[-1] <= kth * (1 + 1e-9),
                      f"{what}: not the {b['size']} nearest", "5k")
            else:
                _hold(resp["hits"]["total"] == loc.size,
                      f"{what}: exists total {resp['hits']['total']}", "5k")
    log(f"[5k] (c) polygons, boxes (one across the antimeridian), geohash "
        f"cells and bounds exact against numpy f32; distances, rings and "
        f"the sort's selection against numpy f64, {band_total} docs in "
        f"the band (f64 distance within {JG_BAND} relative of a radius or "
        f"ring edge) over all bodies; exists on the mesh byte for byte")
    # the prefix against a CPU Node of the port
    t = time.perf_counter()
    n = JG_PREFIX_PTS
    p_arrays = geo_arrays(np, lat[:n], lon[:n], ok[:n])
    pnodes = [Node(name="geo-card", device=dev),
              Node(name="geo-cpu", device="cpu")]
    for pn in pnodes:
        pn.create_index("geo", {"settings": {"number_of_shards": 1},
                                "mappings": JG_GEO_MAPPING})
        pn.get_index("geo").shards[0].engine.add_segment(
            segment_from_arrays(p_arrays, pn.residency))
    n_cmp = 0
    for name in [g for g in groups if g.startswith("c_")]:
        for b in groups[name][1]:
            got, want = (pn.search("geo", copy.deepcopy(b)) for pn in pnodes)
            if name in ("c_distance", "c_distance_agg"):
                _hold(abs(got["hits"]["total"] - want["hits"]["total"]) <= 2,
                      f"{name} prefix: totals", "5k")
            else:
                _hold(_close(got.get("aggregations"), want.get(
                    "aggregations"), 1e-12) and _close(
                    [(h["_id"], h.get("sort")) for h in got["hits"]["hits"]],
                    [(h["_id"], h.get("sort")) for h in
                     want["hits"]["hits"]], 1e-12)
                      and got["hits"]["total"] == want["hits"]["total"],
                      f"{name} prefix: card vs CPU differ", "5k")
            n_cmp += 1
    for pn in pnodes:
        pn.close()
    log(f"[5k] (c) {n_cmp} bodies on a {n}-doc prefix: the card equals a "
        f"CPU Node of the port (distance totals within 2 docs); "
        f"{time.perf_counter() - t:.1f} s")
    node.close()
    del node

    # -- (d) geo shapes through Node.index ---------------------------------
    t = time.perf_counter()
    shapes = shape_docs(np, JG_SHAPES, SEED)
    node = Node(name="shapes", device=dev)
    node.create_index("shapes", {"settings": {"number_of_shards": 1},
                                 "mappings": JG_SHAPE_MAPPING})
    for i, sh in enumerate(shapes):
        node.index("shapes", str(i), {"area": sh, "kind": sh["type"]})
    node.refresh("shapes")
    t_index = time.perf_counter() - t
    queries = [{"type": "envelope", "coordinates": [[2.0, 52.0], [9.0, 46.0]]},
               {"type": "polygon", "coordinates": [[[10, 40], [20, 42],
                                                    [24, 50], [15, 55],
                                                    [8, 48], [10, 40]]]}]
    bodies = [{"query": {"geo_shape": {"area": {"shape": qs, "relation": r}}},
               "size": 5000} for qs in queries
              for r in ("intersects", "within", "disjoint")]
    bodies += [dict(bodies[0], size=10), dict(bodies[4], size=10)]
    groups["d_shapes"] = ("shapes", bodies, False)
    out = run_group(node, "d_shapes")
    prims = [G._shape_prims(s) for s in shapes]
    for i, b in enumerate(bodies):
        spec = b["query"]["geo_shape"]["area"]
        qp = G._shape_prims(spec["shape"])
        hit = [G.shape_within(p, qp) if spec["relation"] == "within"
               else G.shape_intersects(p, qp) for p in prims]
        if spec["relation"] == "disjoint":
            hit = [not x for x in hit]
        want = [str(j) for j, x in enumerate(hit) if x]
        got = [h["_id"] for h in out[i]["hits"]["hits"]]
        _hold(out[i]["hits"]["total"] == len(want) and
              got == want[: b["size"]],
              f"d_shapes body {i}: {out[i]['hits']['total']} vs brute "
              f"force {len(want)}", "5k")
    log(f"[5k] (d) {JG_SHAPES} shapes through Node.index in {t_index:.1f} s;"
        f" envelope and polygon under intersects, within and disjoint equal "
        f"a brute-force refinement of every shape (no cell prefilter)")
    node.close()
    for ln in lines:
        log(ln)
    b1 = bm25_topk.LAUNCHES - b1_0
    log(f"[5k] launches in 5k's runs: B1 {b1} ((b)'s match only); phase 5k "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return b1


def _jg_same_set(got, want, what):
    """Two responses of one body on two devices: totals, the hit ids as a
    set and each hit's score within rtol 1e-6 (scores that tie to the
    last bits may order either way), the aggregations equal."""
    gh = {h["_id"]: h for h in got["hits"]["hits"]}
    wh = {h["_id"]: h for h in want["hits"]["hits"]}
    _hold(got["hits"]["total"] == want["hits"]["total"] and gh.keys() ==
          wh.keys(), f"{what}: total {got['hits']['total']} vs "
          f"{want['hits']['total']} or the ids differ", "5k")
    for k, h in gh.items():
        a, b = h["_score"], wh[k]["_score"]
        _hold((a is None and b is None) or abs(a - b) <= 1e-6 * abs(b),
              f"{what}: {k} scored {a} vs {b}", "5k")
        _hold(h.get("inner_hits") is None or _close(h["inner_hits"],
                                                    wh[k]["inner_hits"],
                                                    1e-6),
              f"{what}: inner hits of {k}", "5k")
    _hold(_close(got.get("aggregations"), want.get("aggregations")),
          f"{what}: aggregations differ", "5k")


# ---------------------------------------------------------------------------
# phase 5l: suggesters, the percolator and by-query (ROADMAP A9d)
# ---------------------------------------------------------------------------

SG_VARIANTS = 8            # bodies of each suggest group, run in turn
SG_WINDOW_S = 0.15         # timed requests per group: about this many
CP_DOCS = 1 << 17          # (b): Rally geonames' places, cut from 11.4M
CP_SHARDS = 5              # ES 2.0's default index.number_of_shards
CP_COUNTRIES = 250         # country_code: Zipf(1.3) over these
CP_GEO_PRECISION = "100km"  # the geo context's cells (geohash length 4)
PC_QUERIES = 1000          # (c): registered queries, four shapes
PC_DOCS = 64               # (c): docs percolated
PC_WORDS = 60              # (c): the docs' vocabulary
PC_OPT_DOCS = 2            # (c): docs each request option runs over
PC_PROFILED = 2            # (c): one-doc percolates under the profiler
WT_OPS = 8192              # (d): bulk items into five shards
WT_SHARDS = 5
WT_MGET = 1000
#: (c)'s vocabulary: standard-analyzed as they are
PC_VOCAB = [f"w{i}" for i in range(PC_WORDS)]
CP_MAPPING = {"properties": {"suggest": {"type": "completion", "context": {
    "country": {"type": "category"},
    "location": {"type": "geo", "precision": CP_GEO_PRECISION}}}}}
PC_MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                             "shape": {"type": "keyword"}}}
WT_MAPPING = {"properties": {"body": {"type": "text"},
                             "tag": {"type": "keyword"},
                             "n": {"type": "long"}}}
WT_TAGS = ["a", "b", "c", "d", "e", "f", "g", "h", "rare", "hot"]
#: by-query's two tags match about 5% of the docs each
WT_TAG_P = [0.1125] * 8 + [0.05, 0.05]
#: a by-query window shorter than this gives its time a doc, not a rate
WT_RATE_MIN_S = 0.5


def _sg_line(np, name, ms, prof, card, per=FT_PROFILED):
    """A 5l group's p50, p99 (or the slowest), device time, kernels and
    copies a request, busy share, and the card. ``prof`` None: the
    profiler recorded no device activity in two sessions (a host-only
    path); ``False``: the group was not profiled."""
    tail = (f"p99 {np.percentile(ms, 99):.3f} ms"
            if len(ms) >= TAXI_TAIL_REPS else
            f"slowest {ms.max():.3f} ms (too few for a p99)")
    dev = ("device not profiled (the one-doc line's device time applies)"
           if prof is False else
           "no device activity recorded in two profiled sessions (host "
           "only)" if prof is None else _dev_line(np, prof, per, ms))
    return (f"[5l] {name}: p50 {np.percentile(ms, 50):.3f} ms, {tail} over "
            f"{len(ms)} requests, {dev}; {card}")


def _sg_timed(np, fn, bodies, window_s=SG_WINDOW_S, min_reps=FT_MIN_REPS):
    """ms of ``fn(body)`` over ``bodies`` in turn for about ``window_s``
    (at least ``min_reps`` and every body once), and the last answer of
    each body."""
    ms, out = [], {}
    start = time.perf_counter()
    while len(ms) < max(min_reps, len(bodies)) or (
            len(ms) < FT_MAX_REPS and time.perf_counter() - start < window_s):
        i = len(ms) % len(bodies)
        a = time.perf_counter()
        out[i] = fn(copy.deepcopy(bodies[i]))
        ms.append((time.perf_counter() - a) * 1e3)
    return np.array(ms), out


def sg_edit_np(np, query, mat, lens):
    """The textbook Levenshtein DP, row by row and cell by cell, across
    every packed term at once (numpy int64): the oracle of the port's
    ``batched_edit_distance``."""
    n, L = mat.shape
    prev = np.tile(np.arange(L + 1, dtype=np.int64), (n, 1))
    for i, ch in enumerate(query, start=1):
        qc = ord(ch)
        cur = np.empty_like(prev)
        cur[:, 0] = i
        for j in range(1, L + 1):
            cur[:, j] = np.minimum(np.minimum(prev[:, j] + 1,
                                              cur[:, j - 1] + 1),
                                   prev[:, j - 1] + (mat[:, j - 1] != qc))
        prev = cur
    return prev[np.arange(n), lens]


def sg_pack(np, words):
    lens = np.array([len(w) for w in words], np.int64)
    mat = np.zeros((len(words), max(1, int(lens.max()) if len(words) else 1)),
                   np.int64)
    for i, w in enumerate(words):
        mat[i, :len(w)] = [ord(c) for c in w]
    return mat, lens


class SgOracle:
    """The term and phrase suggesters of ES 2.0 as the reference defines
    them, over the host arrays of 5i's body field: df, cf, the packed
    vocabulary, and bigram counts from ``np.unique`` over consecutive
    tokens of a doc (5i's token stream is in (doc, position) order, one
    token a position)."""

    def __init__(self, np, body_f, doc_len, terms):
        self.np = np
        self.words = list(body_f["terms"])
        self.V = len(self.words)
        self.df = body_f["df"].astype(np.int64)
        self.cf = body_f["cf"].astype(np.int64)
        self.num_docs = int(body_f["num_docs"])
        self.total = int(body_f["total_terms"])
        self.tid = {w: i for i, w in enumerate(self.words)}
        self.mat, self.lens = sg_pack(np, self.words)
        t = time.perf_counter()
        n_tok = int(doc_len.sum())
        tok = terms[:n_tok]
        same = np.ones(n_tok - 1, bool)
        same[np.cumsum(doc_len)[:-1] - 1] = False
        pairs = (tok[:-1] * self.V + tok[1:])[same]
        self.keys, self.counts = np.unique(pairs, return_counts=True)
        self.seconds = time.perf_counter() - t

    def bigram(self, a, b):
        if a not in self.tid or b not in self.tid:
            return 0
        k = self.tid[a] * self.V + self.tid[b]
        i = int(self.np.searchsorted(self.keys, k))
        return int(self.counts[i]) if i < self.keys.size and \
            self.keys[i] == k else 0

    def candidates(self, token, o):
        np = self.np
        max_edits = int(o.get("max_edits", 2))
        prefix = int(o.get("prefix_length", 1))
        min_len = int(o.get("min_word_length", 4))
        max_tf = float(o.get("max_term_freq", 0.01))
        mode = o.get("suggest_mode", "missing")
        tdf = int(self.df[self.tid[token]]) if token in self.tid else 0
        if mode == "missing" and tdf > 0:
            return []
        if tdf and mode != "always" and tdf > (
                max_tf * self.num_docs if max_tf < 1.0 else max_tf):
            return []
        if len(token) < min_len:
            return []
        d = sg_edit_np(np, token, self.mat, self.lens)
        out = []
        for i in np.nonzero((d <= max_edits) & (d > 0))[0].tolist():
            w = self.words[i]
            if prefix and w[:prefix] != token[:prefix]:
                continue
            if mode == "popular" and self.df[i] <= tdf:
                continue
            score = 1.0 - int(d[i]) / max(1, min(len(w), len(token)))
            out.append({"text": w, "score": round(score, 6),
                        "freq": int(self.df[i])})
        if o.get("sort", "score") == "frequency":
            out.sort(key=lambda x: (-x["freq"], -x["score"], x["text"]))
        else:
            out.sort(key=lambda x: (-x["score"], -x["freq"], x["text"]))
        return out[: int(o.get("size", 5))]

    def term(self, text, o):
        out, at = [], 0
        for tok in text.split():
            out.append({"text": tok, "offset": at, "length": len(tok),
                        "options": self.candidates(tok, o)})
            at += len(tok) + 1
        return out

    def logp(self, prev, w):
        np = self.np
        uni = int(self.cf[self.tid[w]]) if w in self.tid else 0
        total = max(1, self.total)
        if prev is not None:
            bi = self.bigram(prev, w)
            cp = int(self.cf[self.tid[prev]]) if prev in self.tid else 0
            if bi > 0 and cp > 0:
                return float(np.log(bi / cp))
            return float(np.log(0.4 * max(uni, 0.5) / total))
        return float(np.log(max(uni, 0.5) / total))

    def phrase(self, text, o):
        np = self.np
        toks = text.split()
        gen = dict(o, suggest_mode="always", max_term_freq=1e18,
                   min_word_length=2, size=5)
        sets = []
        for t in toks:
            sets.append(([t] + [c["text"] for c in
                                self.candidates(t, gen)])[:5])
        me = float(o.get("max_errors", 1.0))
        max_changes = int(me) if me >= 1 else max(1, int(round(me * len(toks))))
        keep, change = float(np.log(0.95)), float(np.log(1.0 - 0.95))
        beams = [(0.0, [], 0)]
        for pos, cands in enumerate(sets):
            nxt = []
            for lp, seq, nch in beams:
                prev = seq[-1] if seq else None
                for w in cands:
                    ch = w != toks[pos]
                    if ch and nch >= max_changes:
                        continue
                    nxt.append((lp + self.logp(prev, w) + (change if ch
                                                           else keep),
                                seq + [w], nch + ch))
            nxt.sort(key=lambda b: -b[0])
            beams = nxt[:32]
        base = 0.0
        prev = None
        for t in toks:
            base += self.logp(prev, t)
            prev = t
        base = base / len(toks) + keep
        conf = float(o.get("confidence", 1.0))
        hl = o.get("highlight")
        seen, opts = set(), []
        for lp, seq, _n in beams:
            p = " ".join(seq)
            if p in seen:
                continue
            seen.add(p)
            score = lp / len(seq)
            if seq == toks or (conf > 0 and np.exp(score)
                               <= conf * np.exp(base)):
                continue
            opt = {"text": p, "score": round(float(np.exp(score)), 8)}
            if hl:
                opt["highlighted"] = " ".join(
                    f"{hl['pre_tag']}{w}{hl['post_tag']}" if w != t else w
                    for w, t in zip(seq, toks))
            opts.append(opt)
            if len(opts) >= int(o.get("size", 5)):
                break
        return [{"text": text, "offset": 0, "length": len(text),
                 "options": opts}]


def _misspell(rng, word):
    """One or two seeded edits of a ``t<digits>`` term: substitute,
    delete or insert a digit (the leading letter kept)."""
    w = list(word)
    for _ in range(int(rng.integers(1, 3))):
        op = int(rng.integers(0, 3))
        j = int(rng.integers(1, len(w))) if len(w) > 1 else 1
        if op == 0 and len(w) > 1:
            w[j] = str(int(rng.integers(0, 10)))
        elif op == 1 and len(w) > 2:
            del w[j]
        else:
            w.insert(j, str(int(rng.integers(0, 10))))
    return "".join(w)


def suggest_bodies(np, doc_len, terms, seed):
    """(term bodies, phrase bodies): 2-3 body tokens of random docs with
    one or two seeded edits, in every suggest_mode and both sorts; 2-4
    consecutive tokens of random docs with one token misspelt, with
    highlight, confidence and max_errors varied."""
    rng = np.random.default_rng(seed + 15)
    starts = np.cumsum(doc_len) - doc_len
    term_b, phrase_b = [], []
    modes = ("missing", "popular", "always")
    for i in range(SG_VARIANTS):
        d = int(rng.integers(0, doc_len.size))
        k = int(rng.integers(2, 4))
        toks = [f"t{int(t)}" for t in terms[starts[d]: starts[d] + k]]
        text = " ".join(_misspell(rng, t) for t in toks)
        term_b.append({"t": {"text": text, "term": {
            "field": "body", "suggest_mode": modes[i % 3],
            "sort": ("score", "frequency")[(i // 3) % 2]}}})
    for i in range(SG_VARIANTS):
        d = int(rng.integers(0, doc_len.size))
        k = int(rng.integers(2, 5))
        o = int(rng.integers(0, max(1, int(doc_len[d]) - k)))
        toks = [f"t{int(t)}" for t in terms[starts[d] + o: starts[d] + o + k]]
        j = int(rng.integers(0, k))
        toks[j] = _misspell(rng, toks[j])
        spec = {"field": "body", "confidence": (1.0, 0.0, 0.5)[i % 3],
                "max_errors": (1, 2, 0.5)[(i // 3) % 3]}
        if i % 2:
            spec["highlight"] = {"pre_tag": "<em>", "post_tag": "</em>"}
        phrase_b.append({"p": {"text": " ".join(toks), "phrase": spec}})
    return term_b, phrase_b


def phase_suggest_text(torch, np, dev, card, node, seg, body_f, doc_len,
                       terms) -> int:
    """Phase 5l (a): the term and phrase suggesters on 5i's live 2^20-doc
    index: through ``IndexService.suggest`` (the ``_suggest`` API) and
    embedded in a ``_search`` on the mesh path and the host loop, every
    option against ``SgOracle`` (texts, rounded scores and freqs exact),
    the bigram table on the card against the oracle's ``np.unique``."""
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.search import suggest as S

    t_phase = time.perf_counter()
    b1_0 = bm25_topk.LAUNCHES
    svc = node.get_index("ft")
    oracle = SgOracle(np, body_f, doc_len, terms)
    term_b, phrase_b = suggest_bodies(np, doc_len, terms, SEED)
    fd = node.breakers.breaker("fielddata")
    fd0 = fd.used
    torch.cuda.synchronize()
    t = time.perf_counter()
    keys, counts, V = S.segment_bigrams(seg, "body")
    torch.cuda.synchronize()
    t_build = (time.perf_counter() - t) * 1e3
    nbytes = int(keys.numel() * 8 + counts.numel() * 8)
    _hold(V == oracle.V and np.array_equal(keys.cpu().numpy(), oracle.keys)
          and np.array_equal(counts.cpu().numpy(), oracle.counts),
          "the card's bigram table differs from np.unique's", "5l")
    _hold(fd.used - fd0 == nbytes, f"bigram bytes {nbytes} not charged "
          f"({fd.used - fd0})", "5l")
    log(f"[5l] (a) bigrams of 5i's body: {keys.numel()} distinct over "
        f"{int(body_f['positions'].size)} positions, built on the card in "
        f"{t_build:.1f} ms, {nbytes} bytes kept (charged to fielddata), "
        f"equal to np.unique's table ({oracle.seconds:.1f} s on the host); "
        f"{card}")

    n_opts = 0
    for b in term_b:
        spec = b["t"]
        want = oracle.term(spec["text"], spec["term"])
        got = svc.suggest(copy.deepcopy(b))["t"]
        _hold(got == want, f"term {spec}: {got} vs the oracle's {want}",
              "5l")
        n_opts += sum(len(e["options"]) for e in got)
    for b in phrase_b:
        spec = b["p"]
        want = oracle.phrase(spec["text"], spec["phrase"])
        got = svc.suggest(copy.deepcopy(b))["p"]
        _hold(got == want, f"phrase {spec}: {got} vs the oracle's {want}",
              "5l")
        n_opts += len(got[0]["options"])
    _hold(n_opts > 0, "no suggest option at all", "5l")
    embedded = [{"query": {"match": {"body": pb["p"]["text"]}}, "size": 10,
                 "suggest": dict(tb, **pb)}
                for tb, pb in zip(term_b, phrase_b)]
    lines = []
    for name, bodies, fn in (
            ("term suggester (missing, popular, always; by score and by "
             "frequency), _suggest", term_b, svc.suggest),
            ("phrase suggester (2-4 terms, one misspelt; highlight, "
             "confidence, max_errors), _suggest", phrase_b, svc.suggest)):
        ms, _out = _sg_timed(np, fn, bodies)
        prof = profile_path(torch, lambda: [fn(copy.deepcopy(
            bodies[i % len(bodies)])) for i in range(FT_PROFILED)])
        lines.append(_sg_line(np, name, ms, prof, card))
    answers = {}
    for route in ("mesh", "host"):
        with (_host_loop() if route == "host" else contextlib.nullcontext()):
            ms, out = _sg_timed(np, lambda b: node.search("ft", b), embedded)
            prof = profile_path(torch, lambda: [node.search(
                "ft", copy.deepcopy(embedded[i % len(embedded)]))
                for i in range(FT_PROFILED)])
        answers[route] = out
        lines.append(_sg_line(
            np, f"term + phrase embedded in a match _search, "
            f"{'mesh path' if route == 'mesh' else 'host loop'}", ms, prof,
            card))
    for i, b in enumerate(embedded):
        a, h = answers["mesh"][i], answers["host"][i]
        _hold(_strip_took(a) == _strip_took(h),
              f"embedded body {i}: the routes differ", "5l")
        want = {"t": oracle.term(b["suggest"]["t"]["text"],
                                 b["suggest"]["t"]["term"]),
                "p": oracle.phrase(b["suggest"]["p"]["text"],
                                   b["suggest"]["p"]["phrase"])}
        _hold(a["suggest"] == want, f"embedded body {i}: suggest differs "
              f"from the oracle's", "5l")
    for ln in lines:
        log(ln)
    b1 = bm25_topk.LAUNCHES - b1_0
    log(f"[5l] (a) {len(term_b)} term and {len(phrase_b)} phrase bodies "
        f"and {len(embedded)} embedded ones equal the oracle ({n_opts} "
        f"options: text, rounded score, freq exact), the mesh's and the "
        f"host loop's responses byte-identical; B1 launched {b1} times "
        f"(the embedded match); {time.perf_counter() - t_phase:.1f} s")
    return b1


# -- (b) completion ---------------------------------------------------------

_CP_SYL = ("ka", "lo", "mi", "san", "ta", "ri", "bel", "do", "ven", "por",
           "ha", "nu", "ost", "gar", "le", "mon", "ar", "is", "qu", "ze",
           "bra", "chi", "fu", "ya", "we", "ox", "ti", "ne", "ro", "sa")


def cp_places(np, n, seed):
    """Rally geonames' shape: a place name of 2-4 syllables (a tenth with
    an alternate name), a population Zipf(1.4), a country code Zipf(1.3)
    over CP_COUNTRIES, a location around its country's centre."""
    rng = np.random.default_rng(seed + 16)
    k = rng.integers(2, 5, n)
    syl = rng.integers(0, len(_CP_SYL), (n, 4))
    names = ["".join(_CP_SYL[s] for s in row[:kk]).capitalize()
             for row, kk in zip(syl.tolist(), k.tolist())]
    alt = rng.random(n) < 0.1
    pop = np.minimum(rng.zipf(1.4, n), 10_000_000).astype(np.int64)
    cc = np.minimum(rng.zipf(1.3, n), CP_COUNTRIES) - 1
    clat = rng.uniform(-60, 70, CP_COUNTRIES)
    clon = rng.uniform(-180, 180, CP_COUNTRIES)
    lat = np.clip(clat[cc] + rng.normal(0, 3, n), -89.9, 89.9)
    lon = (clon[cc] + rng.normal(0, 3, n) + 180) % 360 - 180
    entries = []
    for i in range(n):
        e = {"input": [names[i]] + ([names[(i * 7919) % n]] if alt[i]
                                    else []),
             "output": names[i], "weight": int(pop[i]),
             "context": {"country": f"C{int(cc[i]):03d}",
                         "location": {"lat": float(lat[i]),
                                      "lon": float(lon[i])}}}
        entries.append(e)
    return entries


def _cp_geohash(lat, lon, length):
    """Base-32 interleaved bisection (the geohash the context matches)."""
    alphabet = "0123456789bcdefghjkmnpqrstuvwxyz"
    la, lo = [-90.0, 90.0], [-180.0, 180.0]
    out, bits, nb, even = [], 0, 0, True
    while len(out) < length:
        rng_, v = (lo, lon) if even else (la, lat)
        mid = (rng_[0] + rng_[1]) / 2
        if v >= mid:
            bits, rng_[0] = (bits << 1) | 1, mid
        else:
            bits, rng_[1] = bits << 1, mid
        even, nb = not even, nb + 1
        if nb == 5:
            out.append(alphabet[bits])
            bits, nb = 0, 0
    return "".join(out)


class CpOracle:
    """Completion over a sorted Python list of (lowercased input, entry):
    a prefix's range by ``bisect`` and a walk, fuzzy by ``sg_edit_np`` over
    the distinct inputs cut to the prefix's length, the contexts by the
    category and a geohash of length 4 (the 100km precision)."""

    def __init__(self, np, entries):
        import bisect

        self.np, self.bisect = np, bisect
        pairs = sorted((s.lower(), i) for i, e in enumerate(entries)
                       for s in e["input"])
        self.inputs = [p[0] for p in pairs]
        self.owner = [p[1] for p in pairs]
        self.entries = entries

    def query(self, prefix, size=5, fuzzy=None, ctx=None):
        np = self.np
        p = prefix.lower()
        if fuzzy:
            cut = {}
            for j, s in enumerate(self.inputs):
                cut.setdefault(s[:len(p)], []).append(j)
            keys = list(cut)
            mat, lens = sg_pack(np, keys)
            d = sg_edit_np(np, p, mat, lens)
            idx = [j for i in np.nonzero(d <= fuzzy)[0].tolist()
                   for j in cut[keys[i]]]
        else:
            lo = self.bisect.bisect_left(self.inputs, p)
            hi = lo
            while hi < len(self.inputs) and self.inputs[hi].startswith(p):
                hi += 1
            idx = range(lo, hi)
        best = {}
        for j in idx:
            e = self.entries[self.owner[j]]
            if ctx and "country" in ctx and \
                    e["context"]["country"] != ctx["country"]:
                continue
            if ctx and "location" in ctx:
                w, h = ctx["location"], e["context"]["location"]
                if _cp_geohash(w["lat"], w["lon"], 4) != \
                        _cp_geohash(h["lat"], h["lon"], 4):
                    continue
            sc = float(e["weight"])
            if best.get(e["output"], -1.0) < sc:
                best[e["output"]] = sc
        opts = sorted(({"text": t, "score": s} for t, s in best.items()),
                      key=lambda o: (-o["score"], o["text"]))[:size]
        return [{"text": prefix, "offset": 0, "length": len(prefix),
                 "options": opts}]


def cp_bodies(np, entries, seed):
    """Groups of SG_VARIANTS (name, body, oracle kwargs): prefixes of 1-4
    characters of random names, 3-4 with one edit and fuzzy 1, 2-3 under
    a country, 4 under a location's cell (each candidate's cell is a
    geohash computed in Python, as the reference's context check does)."""
    rng = np.random.default_rng(seed + 17)
    pick = lambda: entries[int(rng.integers(0, len(entries)))]
    groups = {"prefix": [], "fuzzy": [], "country": [], "location": []}
    for i in range(SG_VARIANTS):
        e = pick()
        p = e["output"][:1 + i % 4]
        groups["prefix"].append(({"c": {"text": p, "completion": {
            "field": "suggest", "size": 10}}}, {"size": 10}))
        e = pick()
        p = list(e["output"][:3 + i % 2].lower())
        p[int(rng.integers(1, len(p)))] = "xq"[i % 2]
        groups["fuzzy"].append(({"c": {"text": "".join(p), "completion": {
            "field": "suggest", "fuzzy": {"fuzziness": 1}}}},
            {"fuzzy": 1}))
        e = pick()
        cc = e["context"]["country"]
        groups["country"].append(({"c": {"text": e["output"][:2 + i % 2],
                                         "completion": {
            "field": "suggest", "size": 10, "context": {"country": cc}}}},
            {"size": 10, "ctx": {"country": cc}}))
        e = pick()
        loc = dict(e["context"]["location"])
        groups["location"].append(({"c": {"text": e["output"][:4],
                                          "completion": {
            "field": "suggest", "context": {"location": loc}}}},
            {"ctx": {"location": loc}}))
    return groups


def phase_completion(torch, np, dev, card):
    """Phase 5l (b): the completion suggester over CP_DOCS places in five
    shards, one segment each, loaded through ``segment_from_arrays``
    with each doc's stored entry; every body against ``CpOracle``."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.routing import shard_id_for
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays

    t_phase = time.perf_counter()
    entries = cp_places(np, CP_DOCS, SEED)
    ids = [f"g{i}" for i in range(CP_DOCS)]
    shard_of = np.array([shard_id_for(i, CP_SHARDS) for i in ids])
    node = Node(name="completion", device=dev)
    node.create_index("geonames", {"settings": {
        "number_of_shards": CP_SHARDS}, "mappings": CP_MAPPING})
    svc = node.get_index("geonames")
    for s in range(CP_SHARDS):
        at = np.nonzero(shard_of == s)[0].tolist()
        n = len(at)
        svc.shards[s].engine.add_segment(segment_from_arrays({
            "num_docs": n, "max_docs": max(64, 1 << (n - 1).bit_length()),
            "ids": [ids[i] for i in at],
            "stored": [{"suggest": [entries[i]]} for i in at]},
            node.residency))
    oracle = CpOracle(np, entries)
    groups = cp_bodies(np, entries, SEED)
    log(f"[5l] (b) {CP_DOCS} places in {CP_SHARDS} shards "
        f"({len(oracle.inputs)} inputs), a country and a {CP_GEO_PRECISION} "
        f"geo context; set-up {time.perf_counter() - t_phase:.1f} s")
    t = time.perf_counter()
    svc.suggest({"c": {"text": "a", "completion": {"field": "suggest"}}})
    log(f"[5l] (b) the first request builds each segment's sorted inputs: "
        f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    n_opts = 0
    lines = []
    for name, cases in groups.items():
        bodies = [b for b, _ in cases]
        for b, kw in cases:
            spec = b["c"]
            want = oracle.query(spec["text"], **kw)
            got = svc.suggest(copy.deepcopy(b))["c"]
            _hold(got == want, f"completion {name} {spec}: {got} vs the "
                  f"oracle's {want}", "5l")
            n_opts += len(got[0]["options"])
        ms, _out = _sg_timed(np, svc.suggest, bodies)
        prof = profile_path(torch, lambda: [svc.suggest(copy.deepcopy(
            bodies[i % len(bodies)])) for i in range(FT_PROFILED)])
        lines.append(_sg_line(np, f"completion, {name}", ms, prof, card))
    for ln in lines:
        log(ln)
    _hold(n_opts > 0, "no completion option at all", "5l")
    node.close()
    log(f"[5l] (b) {sum(len(c) for c in groups.values())} bodies equal "
        f"the oracle ({n_opts} options); "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- (c) percolator ---------------------------------------------------------

def pc_queries(np, seed):
    """PC_QUERIES (id, source) in four shapes: a term, a 2-3-term match, a
    2-term match_phrase, a bool of a term and a range on ``n``."""
    rng = np.random.default_rng(seed + 18)
    p = 1.0 / np.arange(1, PC_WORDS + 1) ** 0.8
    p /= p.sum()
    out = []
    for i in range(PC_QUERIES):
        shape = ("term", "match", "phrase", "bool")[i % 4]
        w = [PC_VOCAB[j] for j in rng.choice(PC_WORDS, size=3, p=p)]
        if shape == "term":
            q = {"term": {"body": w[0]}}
        elif shape == "match":
            q = {"match": {"body": " ".join(w[: 2 + i % 2])}}
        elif shape == "phrase":
            q = {"match_phrase": {"body": " ".join(w[:2])}}
        else:
            q = {"bool": {"must": [{"term": {"body": w[0]}}, {"range": {
                "n": {"gte": int(rng.integers(0, 100))}}}]}}
        out.append((f"q{i:04d}", {"query": q, "shape": shape}))
    return out


def pc_docs(np, seed):
    rng = np.random.default_rng(seed + 19)
    p = 1.0 / np.arange(1, PC_WORDS + 1) ** 0.8
    p /= p.sum()
    return [{"body": " ".join(PC_VOCAB[j] for j in rng.choice(
        PC_WORDS, size=int(rng.integers(6, 15)), p=p)),
        "n": int(rng.integers(0, 100))} for _ in range(PC_DOCS)]


def pc_oracle(queries, doc):
    """The ids of the queries that match ``doc``, decided on its tokens
    (lowercase words split on spaces, as the standard analyzer gives
    them here)."""
    toks = doc["body"].split()
    have, pairs = set(toks), set(zip(toks, toks[1:]))
    out = []
    for qid, src in queries:
        q = src["query"]
        if "term" in q:
            ok = q["term"]["body"] in have
        elif "match" in q:
            ok = bool(have & set(q["match"]["body"].split()))
        elif "match_phrase" in q:
            ok = tuple(q["match_phrase"]["body"].split()) in pairs
        else:
            must = q["bool"]["must"]
            ok = must[0]["term"]["body"] in have and \
                doc["n"] >= must[1]["range"]["n"]["gte"]
        if ok:
            out.append(qid)
    return sorted(out)


def phase_percolate(torch, np, dev, card):
    """Phase 5l (c): PC_QUERIES registered queries, PC_DOCS docs
    percolated one at a time and as one batch against ``pc_oracle``, the
    ``query`` restriction, ``size``, ``highlight`` and ``aggs``; the
    breakers back at their bytes after every call."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.search.percolator import percolate

    t_phase = time.perf_counter()
    node = Node(name="percolate", device=dev)
    node.create_index("alerts", {"settings": {"number_of_shards": 1},
                                 "mappings": PC_MAPPING})
    svc = node.get_index("alerts")
    queries = pc_queries(np, SEED)
    for qid, src in queries:
        svc.index_doc(qid, copy.deepcopy(src), doc_type=".percolator")
    svc.refresh()
    docs = pc_docs(np, SEED)
    want = [pc_oracle(queries, d) for d in docs]
    opts = [{"query": {"term": {"shape": "phrase"}}}, {"size": 5},
            {"highlight": {"fields": {"body": {}}}, "size": 10},
            {"aggs": {"shapes": {"terms": {"field": "shape"}}}}]
    for o in (opts[0], opts[3]):
        # the restriction's and the aggs' searches over the registered
        # docs place that index's own columns and caches once
        svc.percolate(dict(copy.deepcopy(o), doc=docs[0]))
    br = node.breakers

    def held():
        """(segments, fielddata less the mesh executor's caches): the
        restriction's and the aggs' searches keep prepared rounds in the
        index's memo, charged to fielddata; the percolate segments must
        leave nothing."""
        ex = svc._mesh_executor
        cache = 0 if ex is None else ex.data_bytes() + sum(
            rd.nbytes for rd in ex._prep.values())
        return (br.breaker("segments").used,
                br.breaker("fielddata").used - cache)

    before = held()
    log(f"[5l] (c) {len(queries)} queries registered through Node.index "
        f"in {time.perf_counter() - t_phase:.1f} s; breakers: segments "
        f"{before[0]}, fielddata {before[1]} bytes (the mesh executor's "
        f"caches aside)")
    ms, out = _sg_timed(np, svc.percolate, [{"doc": d} for d in docs],
                        window_s=0.0, min_reps=len(docs))
    for i, d in enumerate(docs):
        got = out[i]
        _hold([m["_id"] for m in got["matches"]] == want[i]
              and got["total"] == len(want[i]),
              f"doc {i}: {got['total']} matches vs the oracle's "
              f"{len(want[i])}", "5l")
    prof = profile_path(torch, lambda: [svc.percolate({"doc": docs[i]})
                                        for i in range(PC_PROFILED)])
    lines = [_sg_line(np, f"percolate one doc against {len(queries)} "
                      f"queries", ms, prof, card, per=PC_PROFILED)]
    t = time.perf_counter()
    batch, total = percolate(svc.percolator, docs, svc.mappings,
                             svc.analysis, svc.residency)
    torch.cuda.synchronize()
    t_batch = (time.perf_counter() - t) * 1e3
    _hold(batch == want and total == len(queries),
          "the batch differs from the one-at-a-time answers", "5l")
    prof = profile_path(torch, lambda: percolate(
        svc.percolator, docs, svc.mappings, svc.analysis, svc.residency))
    lines.append(f"[5l] percolate {len(docs)} docs as one batch: "
                 f"{t_batch:.1f} ms, "
                 + _dev_line(np, prof, 1, np.array([t_batch])) + f"; {card}")
    shape_of = dict((qid, src["shape"]) for qid, src in queries)
    n_hl = 0
    for o in opts:
        bodies = [dict(copy.deepcopy(o), doc=d) for d in docs[:PC_OPT_DOCS]]
        ms, out = _sg_timed(np, svc.percolate, bodies, window_s=0.0,
                            min_reps=len(bodies))
        for i, b in enumerate(bodies):
            got, w = out[i], want[i]
            if "query" in o:
                w = [q for q in w if shape_of[q] == "phrase"]
            _hold(got["total"] == len(w), f"{o}: total {got['total']} vs "
                  f"{len(w)}", "5l")
            listed = w[: o.get("size", len(w))]
            _hold([m["_id"] for m in got["matches"]] == listed,
                  f"{o}: matches differ", "5l")
            if "aggs" in o:
                cnt = {}
                for q in w:
                    cnt[shape_of[q]] = cnt.get(shape_of[q], 0) + 1
                got_c = {bk["key"]: bk["doc_count"] for bk in
                         got["aggregations"]["shapes"]["buckets"]}
                _hold(got_c == cnt, f"aggs {got_c} vs {cnt}", "5l")
            if "highlight" in o:
                for m in got["matches"]:
                    q = dict(queries)[m["_id"]]["query"]
                    if "term" in q:
                        frag = m["highlight"]["body"][0]
                        _hold(f"<em>{q['term']['body']}</em>" in frag,
                              f"{m['_id']}: highlight {frag}", "5l")
                        n_hl += 1
        lines.append(_sg_line(np, f"percolate with {sorted(o)[0]}", ms,
                              False, card))
    after = held()
    _hold(after == before, f"breakers {after} after percolating, "
          f"{before} before (the executor's caches aside)", "5l")
    for ln in lines:
        log(ln)
    node.close()
    log(f"[5l] (c) {len(docs)} docs one at a time and as a batch equal the "
        f"oracle ({sum(map(len, want))} matches); the query restriction, "
        f"size, highlight ({n_hl} term highlights checked) and aggs held; "
        f"breakers (segments, fielddata) {after} bytes after, as before; "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- (d) the write tail -----------------------------------------------------

def wt_ops(np, seed):
    """WT_OPS bulk items and the dict model's expected item of each: about
    half index, a sixth create, a seventh update by doc, a tenth update by
    script, the rest delete; about 5% fail by design (a create of a live
    id, an update or a delete of a missing one)."""
    rng = np.random.default_rng(seed + 20)
    live, version, pool = {}, {}, []
    ops, want = [], []
    words = [f"w{i}" for i in range(200)]
    for k in range(WT_OPS):
        r = float(rng.random())
        fail = float(rng.random()) < 0.05
        doc = {"body": " ".join(rng.choice(words, size=int(
            rng.integers(5, 16)))), "tag": str(rng.choice(WT_TAGS, p=WT_TAG_P)),
            "n": int(rng.integers(0, 1000))}
        if r < 0.5 or not pool:
            did = f"x{k}" if not pool or rng.random() < 0.7 else \
                pool[int(rng.integers(0, len(pool)))]
            ops += [{"index": {"_index": "logs", "_id": did}}, doc]
            created = did not in live
            version[did] = version.get(did, 0) + 1
            live[did] = doc
            pool.append(did)
            want.append(("index", 201 if created else 200, None,
                         version[did]))
            continue
        if fail:
            did = f"missing{k}"
            if r < 0.65 and live:
                did = list(live)[int(rng.integers(0, len(live)))]
        else:
            did = pool[int(rng.integers(0, len(pool)))]
        if r < 0.65:
            if not fail:
                did = f"c{k}"
            ops += [{"create": {"_index": "logs", "_id": did}}, doc]
            if did in live:
                want.append(("create", 409, "version_conflict_exception",
                             None))
            else:
                version[did] = version.get(did, 0) + 1
                live[did] = doc
                pool.append(did)
                want.append(("create", 201, None, version[did]))
        elif r < 0.79:
            ops += [{"update": {"_index": "logs", "_id": did}},
                    {"doc": {"tag": doc["tag"], "extra": k}}]
            if did in live:
                version[did] += 1
                live[did] = dict(live[did], tag=doc["tag"], extra=k)
                want.append(("update", 200, None, version[did]))
            else:
                want.append(("update", 404, "document_missing_exception",
                             None))
        elif r < 0.9:
            ops += [{"update": {"_index": "logs", "_id": did}},
                    {"script": "ctx._source.n = ctx._source.n + 1"}]
            if did in live:
                version[did] += 1
                live[did] = dict(live[did], n=live[did]["n"] + 1)
                want.append(("update", 200, None, version[did]))
            else:
                want.append(("update", 404, "document_missing_exception",
                             None))
        else:
            ops += [{"delete": {"_index": "logs", "_id": did}}]
            if did in live:
                version[did] += 1
                del live[did]
                want.append(("delete", 200, None, version[did]))
            else:
                want.append(("delete", 404, "document_missing_exception",
                             None))
    return ops, want, live, version


def phase_write_tail(torch, np, dev, card) -> int:
    """Phase 5l (d): ``Node.bulk`` of WT_OPS items into five shards held
    item by item against a dict model, then ``mget``, ``count`` and
    delete-by-query and update-by-query through ``run_by_query`` over a
    term on about 5% of the docs each, the totals after them against the
    model. Returns B1's launches in its searches."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.ops import bm25_topk
    from elasticsearch_tpu_torch.search.byquery import run_by_query

    t_phase = time.perf_counter()
    b1_0 = bm25_topk.LAUNCHES
    ops, want, live, version = wt_ops(np, SEED)
    node = Node(name="writetail", device=dev)
    node.create_index("logs", {"settings": {"number_of_shards": WT_SHARDS},
                               "mappings": WT_MAPPING})
    svc = node.get_index("logs")
    t = time.perf_counter()
    resp = node.bulk(ops)
    t_bulk = time.perf_counter() - t
    n_fail = 0
    for i, (item, (op, status, err, ver)) in enumerate(zip(resp["items"],
                                                           want)):
        (got_op, r), = item.items()
        _hold(got_op == op and r["status"] == status
              and (r.get("error") or {}).get("type") == err
              and (ver is None or r["_version"] == ver),
              f"bulk item {i}: {item} vs {(op, status, err, ver)}", "5l")
        n_fail += err is not None
    _hold(len(resp["items"]) == len(want) and resp["errors"] == (n_fail > 0),
          "bulk item count or errors flag", "5l")
    t = time.perf_counter()
    svc.refresh()
    t_refresh = time.perf_counter() - t
    lines = [f"[5l] bulk of {len(want)} items ({n_fail} failed by design) "
             f"into {WT_SHARDS} shards: {len(want) / t_bulk:.1f} ops/s "
             f"({t_bulk:.2f} s), then a refresh {t_refresh * 1e3:.1f} ms; "
             f"{card}"]
    rng = np.random.default_rng(SEED + 21)
    names = sorted(version)
    mget_ids = [names[int(i)] for i in rng.integers(0, len(names), WT_MGET)]
    got = svc.mget(mget_ids)["docs"]
    for did, g in zip(mget_ids, got):
        if did in live:
            _hold(g["found"] and g["_source"] == live[did]
                  and g["_version"] == version[did],
                  f"mget {did}: {g} vs {live[did]}", "5l")
        else:
            _hold(not g["found"], f"mget {did}: a deleted doc found", "5l")
    chunks = [{"ids": mget_ids[i: i + 100]} for i in range(0, WT_MGET, 100)]
    ms, _o = _sg_timed(np, lambda b: svc.mget(b["ids"]), chunks)
    prof = profile_path(torch, lambda: [svc.mget(c["ids"])
                                        for c in chunks[:FT_PROFILED]])
    lines.append(_sg_line(np, "mget of 100 ids", ms, prof, card))

    def model_count(tag=None, n_min=None):
        return sum(1 for d in live.values()
                   if (tag is None or d["tag"] == tag)
                   and (n_min is None or d["n"] >= n_min))

    count_b = [{"query": {"term": {"tag": t}}} for t in WT_TAGS[:SG_VARIANTS]]
    for b in count_b + [{}]:
        tag = b["query"]["term"]["tag"] if b else None
        _hold(svc.count(b)["count"] == model_count(tag),
              f"count {b}", "5l")
    ms, _o = _sg_timed(np, svc.count, count_b)
    prof = profile_path(torch, lambda: [svc.count(b)
                                        for b in count_b[:FT_PROFILED]])
    lines.append(_sg_line(np, "count of a tag", ms, prof, card))

    # delete-by-query and update-by-query as the REST handlers drive them
    done = {"deleted": 0, "updated": 0}

    def delete(doc_id, loc):
        svc.delete_doc(doc_id, routing=loc.routing if loc else None)
        done["deleted"] += 1

    def update(doc_id, loc):
        svc.update_doc(doc_id, {"script": "ctx._source.n = ctx._source.n "
                                          "+ 1000"},
                       routing=loc.routing if loc else None)
        done["updated"] += 1

    n_rare, n_hot = model_count("rare"), model_count("hot")
    t = time.perf_counter()
    ids = run_by_query(svc, {"term": {"tag": "rare"}}, delete)
    t_del = time.perf_counter() - t
    for did in ids:
        del live[did]
    t = time.perf_counter()
    ids = run_by_query(svc, {"term": {"tag": "hot"}}, update)
    t_upd = time.perf_counter() - t
    for did in ids:
        live[did] = dict(live[did], n=live[did]["n"] + 1000)
    svc.refresh()
    _hold(done["deleted"] == n_rare and done["updated"] == n_hot,
          f"by-query touched {done} vs {n_rare} and {n_hot}", "5l")
    for b, (tag, n_min) in (({}, (None, None)),
                            ({"query": {"term": {"tag": "rare"}}},
                             ("rare", None)),
                            ({"query": {"range": {"n": {"gte": 1000}}}},
                             (None, 1000))):
        c = svc.count(b)["count"]
        s = node.search("logs", dict(b, size=0))["hits"]["total"]
        _hold(c == s == model_count(tag, n_min),
              f"after by-query {b}: count {c}, search {s}, model "
              f"{model_count(tag, n_min)}", "5l")
    def rate(n, secs):
        per = (f"{n} docs in {secs:.4f} s, "
               f"{1e3 * secs / max(n, 1):.3f} ms a doc")
        return per + (f", {n / secs:.1f} docs/s" if secs >= WT_RATE_MIN_S
                      else f"; no rate (window < {WT_RATE_MIN_S} s)")

    lines.append(f"[5l] delete-by-query over tag:rare: {rate(n_rare, t_del)}; "
                 f"update-by-query over tag:hot: {rate(n_hot, t_upd)}; "
                 f"count and the search totals equal the model's; {card}")
    for ln in lines:
        log(ln)
    node.close()
    b1 = bm25_topk.LAUNCHES - b1_0
    log(f"[5l] (d) {len(live)} live docs after; B1 launched {b1} times; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1


def phase_a9d(torch, np, dev, card) -> int:
    """Phase 5l's groups (b)-(d) (module docstring); returns B1's
    launches."""
    t = time.perf_counter()
    phase_completion(torch, np, dev, card)
    torch.cuda.empty_cache()
    phase_percolate(torch, np, dev, card)
    torch.cuda.empty_cache()
    b1 = phase_write_tail(torch, np, dev, card)
    log(f"[5l] groups (b)-(d) took {time.perf_counter() - t:.1f} s")
    return b1


# ---------------------------------------------------------------------------
# phase 5m: durability and the index lifecycle (ROADMAP A10b)
# ---------------------------------------------------------------------------

DM_DOCS = 1 << 13          # (a): 5h's log recipe, cut from 2^16 (PERF.md §4)
DM_SHARDS = 5              # ES 2.0's default index.number_of_shards
DM_TTL_EVERY = 20          # every 20th doc stamped two days ago: ~5% expire
DM_VECS = 1 << 13          # (b): SIFT-shaped 128-d vectors, one shard,
                           # cut from 2^16 (PERF.md §4)
DM_QUERIES = 32            # (a)'s match bodies
DM_KNN = 8                 # (b)'s brute and IVF-PQ bodies each
DM_NEW = 100               # (c): 1/DM_NEW more writes before the increment
DM_GROUPS = ("ga", "gb")   # (d): the stats groups
DM_CODEC = 1 << 16         # postings-shaped values the host codec encodes
DM_MAPPING = dict(WP_MAPPING, _ttl={"enabled": True, "default": "1d"},
                  _timestamp={"enabled": True})
DM_VEC_MAPPING = {"properties": {
    "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine",
            "index_options": {"type": "ivf_pq"}}}}


def dm_text_ops(np, docs, now_ms):
    """``Node.bulk`` lines for (a): every DM_TTL_EVERY-th doc carries a
    ``_timestamp`` two days back, so the mapping's 1d ``_ttl`` has
    expired it; the rest are stamped now. Returns (ops, expired ids)."""
    ops, expired = [], []
    for i, (doc_id, src) in enumerate(docs):
        meta = {"_index": "logs", "_id": doc_id}
        if i % DM_TTL_EVERY == 0:
            meta["_timestamp"] = now_ms - 2 * DAY_MS
            expired.append(doc_id)
        ops += [{"index": meta}, src]
    return ops, expired


def dm_vectors(np, n, seed):
    """f32[n, DIMS] around 256 Gaussian centres (make_sift's recipe at
    (b)'s size)."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((256, DIMS)).astype(np.float32) * 3
    return (cents[rng.integers(0, 256, n)]
            + rng.standard_normal((n, DIMS)).astype(np.float32))


def dm_text_bodies(np, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.1
    p /= p.sum()
    out = []
    for i in range(DM_QUERIES):
        words = " ".join(f"t{int(t)}" for t in rng.choice(
            VOCAB, size=int(rng.integers(2, 5)), p=p))
        out.append({"query": {"match": {"body": words}}, "size": 10,
                    "version": True})
    return out


def dm_knn_bodies(np, vecs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(DM_KNN):
        q = (vecs[int(rng.integers(0, len(vecs)))]
             + 0.3 * rng.standard_normal(DIMS)).astype(np.float32)
        knn = {"field": "emb", "query_vector": [float(x) for x in q],
               "k": 10}
        out.append({"query": {"knn": dict(knn, ann=False)}})
        out.append({"query": {"knn": dict(knn, num_candidates=1000)}})
    return out


def dm_answers(torch, node, index, bodies):
    """Each body's (total, [(id, score, version)]), and the time of the
    first answer from the call."""
    out, t0, first = [], time.perf_counter(), None
    for b in bodies:
        r = node.search(index, copy.deepcopy(b))
        if first is None:
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        out.append((r["hits"]["total"], [(h["_id"], h["_score"],
                                          h.get("_version"))
                                         for h in r["hits"]["hits"]]))
    return out, first


def dm_open(torch, path, dev, index, bodies, name):
    """A restart: the blob cache's memory layer dropped, a new ``Node``
    over ``path`` (the gateway replays every shard), then ``bodies``.
    Returns (node, answers, seconds to the first answer, ops replayed,
    seconds of the replay spent in segment freezes: the IVF/PQ load or
    build among them)."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index import ivf_cache
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder

    freeze, spent = SegmentBuilder.freeze, [0.0]

    def timed_freeze(self):
        t = time.perf_counter()
        try:
            return freeze(self)
        finally:
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t

    ivf_cache.reset()
    SegmentBuilder.freeze = timed_freeze
    try:
        t = time.perf_counter()
        node = Node(name=name, data_path=path, device=dev)
        t_open = time.perf_counter() - t
    finally:
        SegmentBuilder.freeze = freeze
    ans, first = dm_answers(torch, node, index, bodies)
    ops = sum(e["ops_replayed"]
              for e in node.indices[index].recoveries.entries())
    return node, ans, t_open + first, ops, spent[0]


def dm_codec(np):
    """Which host codec serves (the ``g++`` build of ``csrc/codec.cpp``
    or its numpy/zlib twins), and its varint encode and decode against
    the twins' on DM_CODEC sorted doc ids, the bytes held equal."""
    from elasticsearch_tpu_torch import native

    ids = np.cumsum(np.random.default_rng(SEED + 56).integers(
        1, 300, DM_CODEC)).astype(np.int64)
    ran = "native (g++)" if native.native_available() else \
        "the numpy/zlib twins (no compiler)"
    out = []
    for name, enc, dec, tenc, tdec in (
            ("vbyte", native.vbyte_encode, native.vbyte_decode,
             native._py_vbyte_encode, native._py_vbyte_decode),
            ("delta", native.delta_encode, native.delta_decode,
             native._py_delta_encode, native._py_delta_decode)):
        t = time.perf_counter()
        blob = enc(ids)
        back = dec(blob, ids.size)
        t_run = time.perf_counter() - t
        t = time.perf_counter()
        twin = tenc(ids)
        tback = tdec(twin, ids.size)
        t_twin = time.perf_counter() - t
        _hold(blob == twin and np.array_equal(back, ids)
              and np.array_equal(tback, ids),
              f"the {name} codec and its twin disagree", "5m")
        out.append(f"{name} {t_run * 1e3:.3f} ms against the twins' "
                   f"{t_twin * 1e3:.3f} ms")
    return (f"[5m] host codec: {ran}; encode and decode of {DM_CODEC} "
            f"doc ids, bytes equal: " + ", ".join(out))


def _du(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, files in os.walk(path) for f in files)


def phase_durability(torch, np, dev, card):
    """Phase 5m (module docstring); returns the launches of B1, B2, B3."""
    import tempfile

    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.metadata import IndexClosedException
    from elasticsearch_tpu_torch.index import ivf_cache
    from elasticsearch_tpu_torch.index import snapshots
    from elasticsearch_tpu_torch.monitor import kernels
    from elasticsearch_tpu_torch.ops import adc, bm25_topk, knn_topk

    t_phase = time.perf_counter()
    launches0 = (bm25_topk.LAUNCHES, knn_topk.LAUNCHES, adc.LAUNCHES)
    root = tempfile.mkdtemp(prefix="chip_smoke_5m_")
    da, db = os.path.join(root, "a"), os.path.join(root, "b")
    lines = [dm_codec(np)]
    try:
        # (a) text: bulk into five shards, TTL purged at the refresh
        docs = wp_docs(np, DM_DOCS, SEED)
        now_ms = int(time.time() * 1000)
        ops, expired = dm_text_ops(np, docs, now_ms)
        ivf_cache.reset()
        node = Node(name="durable-a", data_path=da, device=dev)
        node.create_index("logs", {"settings": {
            "number_of_shards": DM_SHARDS}, "mappings": DM_MAPPING})
        t = time.perf_counter()
        resp = node.bulk(ops)
        t_bulk = time.perf_counter() - t
        _hold(not resp["errors"], "a bulk item failed", "5m")
        svc = node.indices["logs"]
        svc.refresh()
        purged = sum(s.engine.stats.delete_total for s in svc.shards)
        live = DM_DOCS - len(expired)
        _hold(purged == len(expired), f"TTL purged {purged}, "
              f"{len(expired)} expired", "5m")
        _hold(node.search("logs", {"size": 0})["hits"]["total"] == live,
              "the TTL-purged total", "5m")
        _hold(not any(svc.get_doc(d)["found"] for d in expired[:200]),
              "an expired doc is found", "5m")
        bodies = dm_text_bodies(np, SEED + 51)
        want, _ = dm_answers(torch, node, "logs", bodies)
        _hold(sum(t for t, _h in want) > 0, "no (a) body matched", "5m")
        node.close()
        lines.append(f"[5m] (a) {DM_DOCS} docs by Node.bulk into "
                     f"{DM_SHARDS} shards: {DM_DOCS / t_bulk:.1f} docs/s; "
                     f"the refresh purged {purged} docs past their _ttl "
                     f"(exact); {card}")
        # restart 1: the translog replay
        node, got, t_first, n_ops, _f = dm_open(torch, da, dev, "logs",
                                                bodies, "durable-a1")
        _hold(got == want, "(a) the answers after the translog replay "
              "differ", "5m")
        _hold(n_ops == DM_DOCS + len(expired), f"replayed {n_ops} ops", "5m")
        lines.append(f"[5m] (a) restart with no flush: {n_ops} translog ops "
                     f"replayed, first answer after {t_first:.3f} s "
                     f"({n_ops / t_first:.1f} ops/s); {DM_QUERIES} bodies "
                     f"equal (hits, scores, totals, _version)")
        t = time.perf_counter()
        node.flush("logs")
        t_flush = time.perf_counter() - t
        commit_bytes = sum(_du(os.path.join(da, "logs", str(s), "_commit"))
                           for s in range(DM_SHARDS))
        node.close()
        # restart 2: the committed blocks
        node, got, t_first, n_docs, _f = dm_open(torch, da, dev, "logs",
                                                 bodies, "durable-a2")
        _hold(got == want, "(a) the answers after the commit replay "
              "differ", "5m")
        _hold(n_docs == live, f"replayed {n_docs} committed docs", "5m")
        lines.append(f"[5m] (a) flush {t_flush:.3f} s ({commit_bytes} "
                     f"bytes of commit); restart after it: {n_docs} "
                     f"committed docs replayed, first answer after "
                     f"{t_first:.3f} s ({n_docs / t_first:.1f} docs/s); "
                     f"bodies equal")
        node_a = node

        # (b) vectors: one ivf_pq shard, the quantizer cold and from blobs
        vecs = dm_vectors(np, DM_VECS, SEED + 52)
        ivf_cache.reset()
        node = Node(name="durable-b", data_path=db, device=dev)
        node.create_index("vecs", {"settings": {"number_of_shards": 1},
                                   "mappings": DM_VEC_MAPPING})
        vops = []
        for i in range(DM_VECS):
            vops += [{"index": {"_index": "vecs", "_id": f"v{i}"}},
                     {"emb": vecs[i].tolist()}]
        t = time.perf_counter()
        _hold(not node.bulk(vops)["errors"], "a vector bulk item failed",
              "5m")
        t_vbulk = time.perf_counter() - t
        del vops
        k0 = kernels.snapshot()
        t = time.perf_counter()
        node.refresh("vecs")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t
        k1 = kernels.snapshot()
        for c in ("ivf_build", "pq_build"):
            _hold(k1.get(c, 0) - k0.get(c, 0) == 1, f"(b) {c} at freeze",
                  "5m")
        kbodies = dm_knn_bodies(np, vecs, SEED + 53)
        vwant, _ = dm_answers(torch, node, "vecs", kbodies)
        ivf = node.indices["vecs"].shards[0].segments[0].vectors["emb"]._ivf
        lists_per = DM_VECS / ivf.C
        node.close()
        lines.append(f"[5m] (b) {DM_VECS} x {DIMS} vectors by Node.bulk: "
                     f"{DM_VECS / t_vbulk:.1f} docs/s; the refresh with "
                     f"k-means (C = {ivf.C}, {lists_per:.0f} a list) and "
                     f"the PQ encode took {t_build:.3f} s")
        restarts = {}
        for how in ("hit", "cold"):
            if how == "cold":
                shutil.rmtree(os.path.join(db, "_ivf"))
            k0 = kernels.snapshot()
            node, got, t_first, n_ops, t_freeze = dm_open(
                torch, db, dev, "vecs", kbodies, f"durable-b-{how}")
            k1 = kernels.snapshot()
            moved = {c: k1.get(c, 0) - k0.get(c, 0)
                     for c in ("ivf_cache_hit", "pq_cache_hit", "ivf_build",
                               "pq_build")}
            want_moved = {"ivf_cache_hit": int(how == "hit"),
                          "pq_cache_hit": int(how == "hit"),
                          "ivf_build": int(how == "cold"),
                          "pq_build": int(how == "cold")}
            _hold(moved == want_moved, f"(b) {how} restart counters "
                  f"{moved}", "5m")
            _hold(got == vwant, f"(b) the knn answers after the {how} "
                  "restart differ", "5m")
            restarts[how] = (t_first, t_freeze)
            if how == "hit":
                node.close()
        node_b = node
        (hit, hit_f), (cold, cold_f) = restarts["hit"], restarts["cold"]
        lines.append(f"[5m] (b) restart over {n_ops} translog ops: blob "
                     f"hit {hit:.3f} s to the first answer ({hit_f:.3f} s "
                     f"of it freezing the segment, the quantizer loaded), "
                     f"cold k-means {cold:.3f} s ({cold_f:.3f} s freezing, "
                     f"the quantizer built): the freeze's gap "
                     f"{cold_f - hit_f:.3f} s; {2 * DM_KNN} brute and "
                     f"IVF-PQ bodies equal; {card}")

        # (c) snapshots: full, incremental after 1% more writes, restore
        repo_dir = os.path.join(root, "repo")
        repo = snapshots.FsRepository("backup", repo_dir)
        for nd, index, tag in ((node_a, "logs", "a"), (node_b, "vecs", "b")):
            t = time.perf_counter()
            snapshots.create_snapshot(nd, repo, f"{tag}1", indices=[index])
            lines.append(f"[5m] (c) full snapshot of {index}: "
                         f"{time.perf_counter() - t:.3f} s, repository "
                         f"{_du(repo_dir)} bytes")
        new_docs = wp_docs(np, DM_DOCS // DM_NEW, SEED + 54, start=DM_DOCS)
        for doc_id, src in new_docs:
            node_a.index("logs", doc_id, src)
        nvecs = dm_vectors(np, DM_VECS // DM_NEW, SEED + 55)
        for i, v in enumerate(nvecs):
            node_b.index("vecs", f"n{i}", {"emb": v.tolist()})
        for nd, index, tag in ((node_a, "logs", "a"), (node_b, "vecs", "b")):
            nd.refresh(index)
            before = set(os.listdir(repo.blob_dir))
            t = time.perf_counter()
            snapshots.create_snapshot(nd, repo, f"{tag}2", indices=[index])
            wrote = len(set(os.listdir(repo.blob_dir)) - before)
            n_blobs = sum(len(s["blobs"]) for s in repo.get_manifest(
                f"{tag}2")["indices"][index]["shards"])
            _hold(0 < wrote < n_blobs, f"(c) the increment of {index} wrote "
                  f"{wrote} of {n_blobs} blobs", "5m")
            lines.append(f"[5m] (c) incremental snapshot of {index} after "
                         f"1/{DM_NEW} more writes: "
                         f"{time.perf_counter() - t:.3f} s, {wrote} of "
                         f"{n_blobs} blobs written")
        ivf_cache.reset()
        fresh = Node(name="restored", device=dev)
        k0 = kernels.snapshot()
        t = time.perf_counter()
        for tag in ("a1", "b1"):
            snapshots.restore_snapshot(fresh, repo, tag)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t
        k1 = kernels.snapshot()
        _hold(k1.get("ivf_cache_hit", 0) - k0.get("ivf_cache_hit", 0) == 1
              and k1.get("ivf_build", 0) == k0.get("ivf_build", 0),
              "(c) the restore ran k-means instead of its seeded blob", "5m")
        got, _ = dm_answers(torch, fresh, "logs", bodies)
        _hold(got == want, "(c) the restored text answers differ", "5m")
        got, _ = dm_answers(torch, fresh, "vecs", kbodies)
        _hold(got == vwant, "(c) the restored knn answers differ", "5m")
        fresh.close()
        lines.append(f"[5m] (c) restore of both full snapshots into a fresh "
                     f"node: {t_restore:.3f} s ({live + DM_VECS} docs, the "
                     f"quantizer from the seeded blobs); hits, totals and "
                     f"versions equal the source's")
        node_b.close()

        # (d) the admin surface on (a)'s index
        node = node_a
        node.close_index("logs")
        try:
            node.search("logs", {"size": 0})
            _hold(False, "(d) a closed index answered", "5m")
        except IndexClosedException:
            pass
        node.open_index("logs")
        node.update_aliases([{"add": {"index": "logs", "alias": "g3",
                                      "filter": {"term": {"tag": "g3"}}}}])
        for b in bodies[:8]:
            via = node.search("g3", copy.deepcopy(b))
            direct = node.search("logs", {"query": {"bool": {
                "must": [b["query"]], "filter": [{"term": {"tag": "g3"}}]}},
                "size": 10})
            _hold([h["_id"] for h in via["hits"]["hits"]]
                  == [h["_id"] for h in direct["hits"]["hits"]]
                  and via["hits"]["total"] == direct["hits"]["total"],
                  "(d) the alias filter", "5m")
        node.put_template("t", {"template": "tmpl-*", "order": 1,
                                "settings": {"number_of_shards": 2},
                                "mappings": {"properties": {
                                    "k": {"type": "keyword"}}}})
        node.create_index("tmpl-1")
        _hold(node.indices["tmpl-1"].num_shards == 2
              and node.indices["tmpl-1"].mappings.get("k") is not None,
              "(d) the template at create", "5m")
        node.put_mapping("logs", {"properties": {"extra": {
            "type": "keyword"}}})
        node.index("logs", "x1", {"body": "t0", "extra": "put"})
        node.refresh("logs")
        _hold(node.search("logs", {"query": {"term": {"extra": "put"}}})[
            "hits"]["total"] == 1, "(d) the mappings PUT", "5m")
        before = node.indices["logs"].stats()["primaries"]["search"].get(
            "groups", {})
        for i, b in enumerate(bodies):
            groups = list(DM_GROUPS[: 1 + i % 2])
            node.search("logs", dict(copy.deepcopy(b), stats=groups))
        after = node.indices["logs"].stats()["primaries"]["search"]["groups"]
        for g, n_req in ((DM_GROUPS[0], DM_QUERIES),
                         (DM_GROUPS[1], DM_QUERIES // 2)):
            got_q = after[g]["query_total"] - before.get(g, {}).get(
                "query_total", 0)
            _hold(got_q == n_req * DM_SHARDS, f"(d) group {g}: {got_q} "
                  f"queries, {n_req * DM_SHARDS} sent", "5m")
        lines.append(f"[5m] (d) close/open, an alias with a filter, a "
                     f"template at create, a mappings PUT and the stats "
                     f"groups ({DM_QUERIES} and {DM_QUERIES // 2} bodies, "
                     f"x{DM_SHARDS} shards) exact")
        node.close()
    finally:
        ivf_cache.reset()
        shutil.rmtree(root, ignore_errors=True)
    for ln in lines:
        log(ln)
    b1, b2, b3 = (bm25_topk.LAUNCHES - launches0[0],
                  knn_topk.LAUNCHES - launches0[1],
                  adc.LAUNCHES - launches0[2])
    _hold(b1 > 0 and b2 > 0 and b3 > 0, f"5m launched B1 {b1}, B2 {b2}, "
          f"B3 {b3} times", "5m")
    log(f"[5m] B1 launched {b1}, B2 {b2}, B3 {b3} times; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1, b2, b3


RP_DOCS = 1 << 13          # (a): 5h's log recipe with a 128-d vector,
                           # cut from 2^15 (PERF.md §4)
RP_SHARDS = 5              # ES 2.0's default layout: five primaries
RP_REPLICAS = 1            # and one replica each
RP_CHUNK = RP_DOCS // 8    # docs a Node.bulk call, a refresh after each:
                           # the eighth refresh folds a shard's eight
                           # fresh segments into one (the merge policy's
                           # tier of 8), so (b) reads one merged segment a
                           # shard whatever RP_DOCS is
RP_DURABLE = 1 << 10       # (c): docs of the failover on a data path
RP_QUERIES = 32            # (b)'s match bodies
RP_KNN = 8                 # (b)'s brute-force knn bodies
RP_NEW = 100               # (d): 1/RP_NEW more docs while a copy is out
RP_MAPPING = {"properties": dict(WP_MAPPING["properties"], emb={
    "type": "dense_vector", "dims": DIMS, "similarity": "cosine"})}
RP_PREFS = ("_primary", "_replica", None)  # None: round-robin


def rp_sources(np, n, seed):
    """[(id, source)]: ``wp_docs``' text fields and a 128-d vector around
    256 seeded centres (``dm_vectors``); ids are row numbers, so the
    oracles index their arrays by ``int(_id)``. Returns (docs, vectors)."""
    vecs = dm_vectors(np, n, seed + 1)
    docs = [(str(i), dict(src, emb=vecs[i].tolist()))
            for i, (_d, src) in enumerate(wp_docs(np, n, seed))]
    return docs, vecs


def rp_bodies(np, vecs, seed):
    """RP_QUERIES ``match`` bodies of 2-4 distinct Zipf(1.1) terms and
    RP_KNN brute-force ``knn`` bodies near seeded rows."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.1
    p /= p.sum()
    match = [{"query": {"match": {"body": " ".join(
        f"t{int(t)}" for t in rng.choice(VOCAB, size=int(rng.integers(2, 5)),
                                         replace=False, p=p))}},
              "size": 10} for _ in range(RP_QUERIES)]
    qv = (vecs[rng.integers(0, len(vecs), RP_KNN)]
          + 0.3 * rng.standard_normal((RP_KNN, DIMS))).astype(np.float32)
    knn = [{"query": {"knn": {"field": "emb", "ann": False, "query_vector":
                              [float(x) for x in q]}}, "size": 10}
           for q in qv]
    return match, knn, qv


def rp_table(engine) -> dict:
    """A copy's location table: id → (version, seq no, term, deleted)."""
    return {d: (loc.version, loc.seq_no, loc.term, loc.deleted)
            for d, loc in engine._locations.items()}


def rp_bm25_exact(np, copies, body, k=10):
    """The want-answer of a ``match`` body over ``copies`` (one copy of
    each shard, in shard order) in f64: BM25 with each segment's own doc
    count, doc freqs and average length, as the engine scores a segment.
    Returns (ids, scores, total) in ``_hold_exact``'s form."""
    from elasticsearch_tpu_torch.index.segment import B, K1

    terms = body["query"]["match"]["body"].split()
    cands, total = [], 0
    for pos, c in enumerate(copies):
        for seg in c.segments:
            inv = seg.inverted.get("body")
            if inv is None:
                continue
            dl = seg.field_lengths["body"].cpu().numpy().astype(np.float64)
            score = np.zeros(seg.max_docs, np.float64)
            hit = np.zeros(seg.max_docs, bool)
            for t in terms:
                if t not in inv.vocab:
                    continue
                tid = inv.vocab[t]
                lo, hi = int(inv.offsets[tid]), int(inv.offsets[tid + 1])
                docs = inv.doc_ids_host[lo:hi].astype(np.int64)
                tf = inv.tf_host[lo:hi].astype(np.float64)
                df = float(inv.df[tid])
                idf = np.log(1.0 + (inv.num_docs - df + 0.5) / (df + 0.5))
                score[docs] += idf * tf * (K1 + 1.0) / (
                    tf + K1 * (1.0 - B + B * dl[docs] / inv.avg_len))
                hit[docs] = True
            hit &= seg.live_host
            total += int(hit.sum())
            cands += [(-score[i], pos, int(seg.ids[i]))
                      for i in np.nonzero(hit)[0].tolist()]
    cands.sort()
    top = cands[:k]
    return (np.array([c[2] for c in top], np.int64),
            np.array([-c[0] for c in top], np.float64), total)


def _rp_run(np, torch, node, index, bodies, pref):
    """Each body once through ``Node.search`` (synchronized): the ms of
    each and the responses."""
    ms, out = [], []
    for b in bodies:
        t = time.perf_counter()
        out.append(node.search(index, copy.deepcopy(b), preference=pref))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return np.array(ms), out


def _rp_durable_failover(np, torch, dev, docs):
    """5n(c) on a data path: ``fail_shard`` hands each promoted copy the
    shard's translog and commit and fails the old primary's engine. Every
    write acknowledged after it survives a restart under term 2; a stale
    group's write is refused. Returns the report line."""
    import tempfile

    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.replication import ReplicationGroup
    from elasticsearch_tpu_torch.utils.errors import EngineFailedException

    root = tempfile.mkdtemp(prefix="chip_smoke_5n_")
    try:
        node = Node(name="durable-r", data_path=root, device=dev)
        try:
            node.create_index("dur", {"settings": {
                "number_of_shards": RP_SHARDS, "number_of_replicas": 1},
                "mappings": RP_MAPPING})
            ops = []
            for doc_id, src in docs[:RP_DURABLE]:
                ops += [{"index": {"_index": "dur", "_id": doc_id}}, src]
            _hold(not node.bulk(ops)["errors"], "(c) the durable bulk",
                  "5n")
            svc = node.indices["dur"]
            t_prom, olds = [], []
            for sid in range(RP_SHARDS):
                g = svc.groups[sid]
                olds.append((g.primary, list(g.replicas)))
                t = time.perf_counter()
                svc.fail_shard(sid)
                torch.cuda.synchronize()
                t_prom.append(time.perf_counter() - t)
            post = [f"post{i}" for i in range(RP_SHARDS * 8)]
            for doc_id in post:
                _hold(node.index("dur", doc_id, {"body": "t1 t2"})[
                    "_primary_term"] == 2, "(c) a durable write's term", "5n")
            try:
                ReplicationGroup(0, *olds[0]).index("zombie", {"body": "t1"})
                _hold(False, "(c) a stale group's write was acknowledged "
                      "on a data path", "5n")
            except EngineFailedException:
                pass
        finally:
            node.close()
        again = Node(name="durable-r2", data_path=root, device=dev)
        try:
            tot = again.search("dur", {"size": 0})["hits"]["total"]
            got = again.search("dur", {"query": {"ids": {
                "values": post + ["zombie"]}}, "size": len(post) + 1})
            terms = {again.indices["dur"].route(h["_id"]).engine
                     ._locations[h["_id"]].term
                     for h in got["hits"]["hits"]}
            _hold(tot == RP_DURABLE + len(post)
                  and sorted(h["_id"] for h in got["hits"]["hits"])
                  == sorted(post) and terms == {2},
                  f"(c) after the restart: {tot} docs of "
                  f"{RP_DURABLE + len(post)}, terms {terms}", "5n")
        finally:
            again.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return (f"[5n] (c) on a data path ({RP_DURABLE} docs, {RP_SHARDS} "
            f"shards x 2 copies): fail_shard with the store handed over "
            f"and committed {1e3 * np.mean(t_prom):.3f} ms mean "
            f"({1e3 * max(t_prom):.3f} max); {len(post)} writes after it "
            f"and every earlier doc found after a restart under term 2; "
            f"a stale group's write raised EngineFailedException")


def phase_replicas(torch, np, dev, card):
    """Phase 5n (module docstring); returns the launches of B1 and B2."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.replication import ReplicationGroup
    from elasticsearch_tpu_torch.monitor import kernels
    from elasticsearch_tpu_torch.ops import bm25_topk, knn_topk
    from elasticsearch_tpu_torch.utils.errors import StalePrimaryException
    from elasticsearch_tpu_torch.utils.faults import FAULTS

    t_phase = time.perf_counter()
    launches0 = (bm25_topk.LAUNCHES, knn_topk.LAUNCHES)
    lines = []
    docs, vecs = rp_sources(np, RP_DOCS, SEED + 60)
    node = Node(name="replicas", device=dev)
    segs_br = node.breakers.breaker("segments")
    fd_br = node.breakers.breaker("fielddata")
    try:
        # (a) the replicated write rate against one copy, same docs
        rates = {}
        for name, reps in (("rep0", 0), ("rep1", RP_REPLICAS)):
            gc.collect()  # earlier phases' garbage must not free inside (a)
            torch.cuda.synchronize()
            m0, s0, f0 = (torch.cuda.memory_allocated(), segs_br.used,
                          fd_br.used)
            node.create_index(name, {"settings": {
                "number_of_shards": RP_SHARDS, "number_of_replicas": reps},
                "mappings": RP_MAPPING})
            want_shards = {"total": 1 + reps, "successful": 1 + reps,
                           "failed": 0}
            t = time.perf_counter()
            for a in range(0, RP_DOCS, RP_CHUNK):
                ops = []
                for doc_id, src in docs[a: a + RP_CHUNK]:
                    ops += [{"index": {"_index": name, "_id": doc_id}}, src]
                resp = node.bulk(ops)
                _hold(not resp["errors"] and all(
                    it["index"]["_shards"] == want_shards
                    for it in resp["items"]), f"(a) a {name} bulk item",
                    "5n")
                node.refresh(name)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            rates[name] = RP_DOCS / dt
            mem = (torch.cuda.memory_allocated() - m0, segs_br.used - s0,
                   fd_br.used - f0)
            segs = sorted({len(c.segments) for g in node.indices[name]
                           .groups for c in g.copies})
            lines.append(f"[5n] (a) {name}: {RP_DOCS} docs by Node.bulk "
                         f"into {RP_SHARDS} shards x {1 + reps} copies "
                         f"({RP_DOCS // RP_CHUNK} bulks, a refresh each; "
                         f"segments a copy {segs}): "
                         f"{rates[name]:.1f} docs/s; device "
                         f"{mem[0]} bytes allocated, breakers segments "
                         f"{mem[1]} and fielddata {mem[2]} bytes; {card}")
        rep0, svc = node.indices["rep0"], node.indices["rep1"]
        for g0, g in zip(rep0.groups, svc.groups):
            want = rp_table(g.primary.engine)
            _hold(rp_table(g0.primary.engine) == want
                  and all(rp_table(r.engine) == want for r in g.replicas)
                  and all([s.num_docs for s in r.segments]
                          == [s.num_docs for s in g.primary.segments]
                          for r in g.replicas),
                  f"(a) shard {g.shard_id}: a copy's (version, seq no, "
                  f"term) or segment layout differs", "5n")
        lines.append(f"[5n] (a) the replicated rate is "
                     f"{rates['rep1'] / rates['rep0']:.3f} of one copy's; "
                     f"every doc's (version, seq no, term) equal on every "
                     f"copy, and the copies' segment layouts")

        # (b) reads under each preference, on the mesh and the host loop
        match, knn, qv = rp_bodies(np, vecs, SEED + 62)
        bodies = match + knn
        exact = [rp_bm25_exact(np, svc.shards, b) for b in match]
        k_ids, k_sc, k_full = exact_cosine_top(
            np, vecs, np.ones(RP_DOCS, bool), qv, 10)
        seen = {}
        for route in ("mesh", "host"):
            ctx = contextlib.nullcontext() if route == "mesh" \
                else _host_loop()
            with ctx:
                for pref in RP_PREFS:
                    tag = f"{route} {pref or 'round-robin'}"
                    _rp_run(np, torch, node, "rep1", bodies, pref)  # warm
                    l0 = (bm25_topk.LAUNCHES, knn_topk.LAUNCHES)
                    c0 = kernels.snapshot()
                    ms, got = _rp_run(np, torch, node, "rep1", bodies, pref)
                    c1 = kernels.snapshot()
                    b1 = bm25_topk.LAUNCHES - l0[0]
                    b2 = knn_topk.LAUNCHES - l0[1]
                    prof = profile_path(torch, lambda: _rp_run(
                        np, torch, node, "rep1", bodies, pref))
                    for n, (b, r) in enumerate(zip(match, got)):
                        _hold_exact(np, r, exact[n], BF16_BAND,
                                    f"5n (b) {tag} match {n} vs f64")
                    for n, r in enumerate(got[RP_QUERIES:]):
                        check_oracle(np, r, k_ids[n], k_sc[n], k_full[n],
                                     f"5n (b) {tag} knn {n} vs f64")
                    seen[(route, pref)] = [_strip_took(r) for r in got]
                    if pref == "_replica":
                        _hold(b1 > 0 and b2 > 0, f"(b) {tag}: B1 {b1}, "
                              f"B2 {b2} launches on replica reads", "5n")
                    extra = ""
                    if pref is None and route == "mesh":
                        hit = c1.get("executor_data_hit", 0) - c0.get(
                            "executor_data_hit", 0)
                        miss = c1.get("executor_data_miss", 0) - c0.get(
                            "executor_data_miss", 0)
                        extra = (f"; the executor's stacked data {hit} "
                                 f"hits, {miss} misses")
                    lines.append(
                        f"[5n] (b) {tag}: {_pcts(np, ms)}; "
                        f"{_dev_line(np, prof, len(bodies), ms)}; B1 {b1}, "
                        f"B2 {b2} launches{extra}")
            for pref in RP_PREFS[1:]:
                _hold(seen[(route, pref)] == seen[(route, "_primary")],
                      f"(b) {route}: {pref} answers differ from the "
                      f"primaries' (fan-out copies)", "5n")
        lines.append(f"[5n] (b) {RP_QUERIES} match bodies within 2^-7 of "
                     f"the f64 BM25 oracle and {RP_KNN} knn bodies on the "
                     f"f64 cosine oracle under every preference and "
                     f"route; _primary, _replica and round-robin "
                     f"responses byte-identical on each route")

        # (c) failover of every shard, the fence, every doc found
        body = match[0]
        t_prom, t_first, olds = [], [], []
        for sid in range(RP_SHARDS):
            olds.append((svc.groups[sid].primary,
                         list(svc.groups[sid].replicas)))
            t = time.perf_counter()
            svc.fail_shard(sid)
            t_prom.append(time.perf_counter() - t)
            node.search("rep1", copy.deepcopy(body), preference="_primary")
            torch.cuda.synchronize()
            t_first.append(time.perf_counter() - t)
        post = []
        for i in range(RP_SHARDS * 8):
            r = node.index("rep1", f"post{i}", {"body": "t1 t2",
                                                "tag": "g1"})
            _hold(r["_primary_term"] == 2 and r["_shards"] == {
                "total": 2, "successful": 1, "failed": 0},
                f"(c) a write after the failover: {r}", "5n")
            post.append(f"post{i}")
        zombie = ReplicationGroup(0, olds[0][0], list(olds[0][1]))
        try:
            zombie.index("zombie", {"body": "t1"})
            _hold(False, "(c) a stale group's write was acknowledged", "5n")
        except StalePrimaryException:
            pass
        _hold(not any(c.engine.exists("zombie") for g in svc.groups
                      for c in g.copies),
              "(c) the stale group's write reached a live copy", "5n")
        node.refresh("rep1")
        n_ack = RP_DOCS + len(post)
        for route in ("mesh", "host"):
            ctx = contextlib.nullcontext() if route == "mesh" \
                else _host_loop()
            with ctx:
                tot = node.search("rep1", {"size": 0})["hits"]["total"]
                ids = node.search("rep1", {"query": {"ids": {
                    "values": post}}, "size": len(post)})
            _hold(tot == n_ack and sorted(h["_id"] for h in ids["hits"][
                "hits"]) == sorted(post), f"(c) {route}: {tot} docs "
                  f"found of {n_ack} acknowledged", "5n")
        lines.append(f"[5n] (c) fail_shard on each of {RP_SHARDS} shards: "
                     f"promotion {1e3 * np.mean(t_prom):.3f} ms mean "
                     f"({1e3 * max(t_prom):.3f} max), first answer after "
                     f"{1e3 * np.mean(t_first):.3f} ms mean "
                     f"({1e3 * max(t_first):.3f} max); writes after carry "
                     f"term 2; a stale group's write raised "
                     f"StalePrimaryException and reached no live copy; "
                     f"all {n_ack} acknowledged docs found on both routes")
        lines.append(_rp_durable_failover(np, torch, dev, docs))

        # (d) peer recovery: two full copies, then an ops-based re-sync
        from elasticsearch_tpu_torch.cluster import metadata

        n0 = len(svc.recoveries.entries())
        t = time.perf_counter()
        metadata.update_index_settings(svc, {"number_of_replicas": 2})
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t
        full = svc.recoveries.entries()[n0:]
        copied = sum(e["docs_copied"] for e in full)
        _hold(len(full) == 2 * RP_SHARDS
              and all(e["mode"] == "full" for e in full)
              and copied == 2 * n_ack, f"(d) the scale to 2 replicas: "
              f"{[(e['mode'], e['docs_copied']) for e in full]}", "5n")
        g0 = svc.groups[0]
        FAULTS.inject("replication.fanout", error=OSError, count=1,
                      match=lambda ctx: ctx["shard"] == 0)
        try:
            new = wp_docs(np, RP_DOCS // RP_NEW, SEED + 63, start=RP_DOCS)
            ops = []
            for doc_id, src in new:
                ops += [{"index": {"_index": "rep1", "_id": doc_id}}, src]
            resp = node.bulk(ops)
        finally:
            FAULTS.clear()
        _hold(not resp["errors"] and len(g0.failed_replicas) == 2
              and len(g0.replicas) == 1, "(d) the fan-out fault did not "
              "fail one copy of shard 0", "5n")
        out = g0.failed_replicas[-1]
        behind = g0.primary.engine.max_seq_no - out.engine.local_checkpoint
        entry = svc.recoveries.start(0, "replica")
        t = time.perf_counter()
        g0.add_replica(out, entry)
        torch.cuda.synchronize()
        t_ops = time.perf_counter() - t
        svc.recoveries.finish(entry)
        _hold(entry["mode"] == "ops" and entry["ops_replayed"] == behind
              and rp_table(out.engine) == rp_table(g0.primary.engine),
              f"(d) the re-added copy: {entry}, {behind} ops behind", "5n")
        node.refresh("rep1")
        for g in svc.groups:
            _hold(g.global_checkpoint == g.primary.engine.max_seq_no
                  and len(g.replicas) == 2, f"(d) shard {g.shard_id}: "
                  f"global checkpoint {g.global_checkpoint}, max seq no "
                  f"{g.primary.engine.max_seq_no}", "5n")
        lines.append(f"[5n] (d) scale to 2 replicas: {len(full)} full "
                     f"copies, {copied} docs in {t_full:.3f} s "
                     f"({copied / t_full:.1f} docs/s); a copy of shard 0 "
                     f"failed by the replication.fanout fault point, "
                     f"{len(new)} more docs written, the copy re-added: "
                     f"mode ops, {entry['ops_replayed']} ops in "
                     f"{t_ops:.3f} s ({entry['ops_replayed'] / t_ops:.1f} "
                     f"ops/s); the global checkpoint equals the max seq no "
                     f"on every group")
    finally:
        node.close()
    for ln in lines:
        log(ln)
    b1, b2 = (bm25_topk.LAUNCHES - launches0[0],
              knn_topk.LAUNCHES - launches0[1])
    log(f"[5n] B1 launched {b1}, B2 {b2} times; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1, b2


# ---------------------------------------------------------------------------
# phase 5o: fielddata under pressure (ROADMAP A10d)
# ---------------------------------------------------------------------------

FD_COLS = 8                # (c): numeric columns sorted and aggregated
FD_ROTATION = 16           # (b): brute-force knn bodies, emb and emb2 in turn
FD_IVF_BODIES = 8          # (c): IVF-PQ bodies after evict_all
FD_READ_BODIES = 8         # (c): match bodies on phase 5's node
FD_PARTIAL_DOCS = 1024     # (d): docs a shard of the partial-results index
FD_MAPPING = {"properties": dict(
    VEC_MAPPING["properties"],
    emb2={"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
    **{f"c{i}": {"type": "double"} for i in range(FD_COLS)})}


def _fd_copy_rate(torch, np, dev, nbytes, pinned, reps=3):
    """GB/s of host-to-device copies of ``nbytes`` from pinned or pageable
    host memory into one device buffer (the best of ``reps``)."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned) \
        if pinned else torch.from_numpy(np.ones(nbytes, np.uint8))
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst.copy_(src)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    del src, dst
    return nbytes / best / 1e9


def _fd_answers(resps):
    """Responses without their ``took``, serialised: byte-equality."""
    return [json.dumps({k: v for k, v in r.items() if k != "took"},
                       sort_keys=True) for r in resps]


def _fd_mem(torch):
    return (f"memory_allocated {torch.cuda.memory_allocated()} B, "
            f"memory_reserved {torch.cuda.memory_reserved()} B")


def sift_arrays(sift, ivf_index, pq_parts) -> dict:
    """``segment_from_arrays``' input for phase 5b's slab as field
    ``emb`` with the IVF and PQ phase 5b built (carried across, no
    k-means), and its ``bucket`` column."""
    vpad, exists, bucket, D, _make_q = sift
    ivf = {"centroids": ivf_index.centroids.cpu().numpy(),
           "lists": ivf_index.lists.cpu().numpy(),
           "list_lens": ivf_index.list_lens.cpu().numpy(),
           "C": ivf_index.C, "Lmax": ivf_index.Lmax,
           "avg_len": ivf_index.avg_len, "metric": ivf_index.metric}
    pq = {"codebooks": pq_parts.codebooks.cpu().numpy(),
          "codes": pq_parts.codes.cpu().numpy(), "M": pq_parts.M,
          "K": pq_parts.K, "dsub": pq_parts.dsub, "metric": pq_parts.metric}
    return {"num_docs": N_VECS, "max_docs": D,
            "numerics": {"bucket": {"exact": bucket, "exists": exists,
                                    "kind": "long"}},
            "vectors": {"emb": {"vecs": vpad, "exists": exists,
                                "dims": DIMS, "similarity": "cosine",
                                "ivf": ivf, "pq": pq}}}


def phase_fielddata(torch, np, dev, card, sift, ivf_index, pq_parts,
                    read_node, read_bodies):
    """Phase 5o (module docstring); returns the launches of B1, B2, B3."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.cluster.routing import shard_id_for
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import adc, bm25_topk, knn_topk
    from elasticsearch_tpu_torch.resources.residency import Residency
    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException
    from elasticsearch_tpu_torch.utils.faults import FAULTS

    t_phase = time.perf_counter()
    launches0 = (bm25_topk.LAUNCHES, knn_topk.LAUNCHES, adc.LAUNCHES)
    lines = []
    vpad, exists, bucket, D, make_q = sift
    slab_bytes = vpad.nbytes
    rng = np.random.default_rng(SEED + 80)
    emb2 = rng.standard_normal((D, DIMS), dtype=np.float32)
    cols = {f"c{i}": rng.integers(0, 1000, D).astype(np.float64)
            for i in range(FD_COLS)}
    node = Node(name="fielddata", device=dev)
    br = node.breakers
    start = {n: br.breaker(n).used for n in
             ("fielddata", "request", "in_flight_requests", "segments")}
    loads = []
    real_put = Residency.put_array

    def timed_put(self, host, **kw):  # (a): the lazy placements, timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        h = real_put(self, host, **kw)
        torch.cuda.synchronize()
        loads.append((kw.get("label"), 0 if h is None else h.nbytes,
                      time.perf_counter() - t))
        return h

    try:
        node.create_index("fd", {"settings": {"number_of_shards": 1},
                                 "mappings": FD_MAPPING})
        arrays = sift_arrays(sift, ivf_index, pq_parts)
        pq = arrays["vectors"]["emb"]["pq"]
        arrays["numerics"].update(
            {c: {"exact": v, "exists": exists, "kind": "double"}
             for c, v in cols.items()})
        arrays["vectors"]["emb2"] = {"vecs": emb2, "exists": exists,
                                     "dims": DIMS, "similarity": "cosine"}
        seg = segment_from_arrays(arrays, node.residency)
        svc = node.get_index("fd")
        svc.shards[0].engine.add_segment(seg)
        fd0 = br.breaker("fielddata").used
        _hold(fd0 == pq["codes"].nbytes, f"(a) at conversion fielddata "
              f"holds {fd0} B, not the PQ codes alone", "5o")

        # (a) first touch: the lazy placement of a 512 MiB slab
        qs = make_q(FD_ROTATION // 2 + FD_IVF_BODIES)
        q2 = rng.standard_normal((FD_ROTATION // 2, DIMS)).astype(np.float32)
        rot = []
        for i in range(FD_ROTATION):
            field, q = ("emb", qs[i // 2]) if i % 2 == 0 else \
                ("emb2", q2[i // 2])
            rot.append((field, {"query": {"knn": {
                "field": field, "query_vector": [float(a) for a in q],
                "ann": False}}, "size": 10}))
        Residency.put_array = timed_put
        try:
            t = time.perf_counter()
            node.search("fd", copy.deepcopy(rot[0][1]))
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t
            node.search("fd", copy.deepcopy(rot[1][1]))
        finally:
            Residency.put_array = real_put
        slab_loads = [(lb, n, s) for lb, n, s in loads if n == slab_bytes]
        _hold(len(slab_loads) == 2, f"(a) slab placements {loads}", "5o")
        pin = _fd_copy_rate(torch, np, dev, slab_bytes, True)
        page = _fd_copy_rate(torch, np, dev, slab_bytes, False)
        lines.append(
            f"[5o] (a) first touch of a {slab_bytes} B slab through "
            f"Node.search: placed in "
            + ", ".join(f"{lb} {s * 1e3:.3f} ms ({n / s / 1e9:.3f} GB/s)"
                        for lb, n, s in slab_loads)
            + f"; the first knn body {t_first * 1e3:.3f} ms with it; "
            f"yardstick: a {slab_bytes} B copy_ from pinned memory "
            f"{pin:.3f} GB/s, from pageable memory {page:.3f} GB/s; "
            f"{_fd_mem(torch)}; {card}")

        # (b) rotation: one slab fits, two do not
        def run(bodies):
            got, ms = [], []
            for _f, body in bodies:
                torch.cuda.synchronize()
                t = time.perf_counter()
                got.append(node.search("fd", copy.deepcopy(body)))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            return got, np.array(ms)

        free, _ = run(rot)
        free, free_ms = run(rot)  # both slabs resident: the default limit
        limit = int(1.03 * 1.5 * slab_bytes)  # one slab and its codes
        br.apply_cluster_settings({"indices.breaker.fielddata.limit": limit})
        node.residency.evict_all()  # nothing over the limit stays resident
        tier0 = dict(node.residency.stats()["tiers"]["fielddata"])
        n_spans = node.tracer.stats()["finished_total"]
        b2 = knn_topk.LAUNCHES
        got, rot_ms = run(rot)
        b2 = knn_topk.LAUNCHES - b2
        tier1 = node.residency.stats()["tiers"]["fielddata"]
        mem_rot = _fd_mem(torch)
        ev = tier1["evictions"] - tier0["evictions"]
        rh = tier1["rehydrations"] - tier0["rehydrations"]
        # each slab's rehydration from its span: bytes over its duration
        slab_sp = [sp for sp in node.tracer.spans()[-(
            node.tracer.stats()["finished_total"] - n_spans):]
            if sp.name == "tpu.rehydrate" and sp.tags["bytes"] == slab_bytes]
        _hold(_fd_answers(got) == _fd_answers(free),
              "(b) hits under rotation differ from the unlimited run", "5o")
        _hold(len(slab_sp) == FD_ROTATION and ev >= FD_ROTATION - 1
              and b2 == FD_ROTATION, f"(b) {ev} evictions, {rh} "
              f"rehydrations ({len(slab_sp)} of a slab), {b2} B2 launches "
              f"over {FD_ROTATION} bodies", "5o")
        sp_ms = np.array([sp.duration * 1e3 for sp in slab_sp])
        for field, slab, qq in (("emb", vpad, qs[:FD_ROTATION // 2]),
                                ("emb2", emb2, q2)):
            ids, sc, full = exact_cosine_top(np, slab, exists, qq, 10)
            idx = [n for n, (f, _b) in enumerate(rot) if f == field]
            for r, n in enumerate(idx):
                check_oracle(np, got[n], ids[r], sc[r], full[r],
                             f"5o (b) {field} body {n}")
        lines.append(
            f"[5o] (b) {FD_ROTATION} brute-force knn bodies, emb and emb2 "
            f"in turn, fielddata limit {limit} B (one slab fits): "
            f"{_pcts(np, rot_ms)}; at the default limit (both resident) "
            f"{_pcts(np, free_ms)}; {ev} evictions, {rh} rehydrations, "
            f"{len(slab_sp)} of a {slab_bytes} B slab: p50 "
            f"{np.percentile(sp_ms, 50):.3f} ms "
            f"({slab_bytes / np.percentile(sp_ms, 50) / 1e6:.3f} GB/s), "
            f"mean {sp_ms.mean():.3f} ms "
            f"({slab_bytes / sp_ms.mean() / 1e6:.3f} GB/s) from pageable "
            f"memory; B2 launched {b2} times; {mem_rot}; hits byte-equal "
            f"to the unlimited run and held against the f64 cosine oracle; "
            f"{card}")

        # (c) columns round-robin under a limit holding three of them
        col_bodies = []
        for i in range(FD_COLS):
            col_bodies.append(("sort", {"query": {"match_all": {}},
                                        "sort": [{f"c{i}": "desc"}],
                                        "size": 10}))
            col_bodies.append(("terms", {"size": 0, "aggs": {"t": {
                "terms": {"field": f"c{i}", "size": 5}}}}))
        br.apply_cluster_settings({})
        node.residency.evict_all()
        free_cols, _ = run(col_bodies)
        per_col = sum(h.nbytes for h in seg.fielddata_handles()
                      if h.label.startswith(("column:c0.", "sort:c0")))
        limit_c = int(1.03 * 3.5 * per_col)
        br.apply_cluster_settings({"indices.breaker.fielddata.limit":
                                   limit_c})
        node.residency.evict_all()
        tier0 = dict(node.residency.stats()["tiers"]["fielddata"])
        got_cols, cols_ms = run(col_bodies)
        tier1 = node.residency.stats()["tiers"]["fielddata"]
        _hold(_fd_answers(got_cols) == _fd_answers(free_cols),
              "(c) column answers under the limit differ", "5o")
        ev_c = tier1["evictions"] - tier0["evictions"]
        rh_c = tier1["rehydrations"] - tier0["rehydrations"]
        _hold(ev_c > 0 and rh_c > 0, f"(c) columns: {ev_c} evictions, "
              f"{rh_c} rehydrations", "5o")
        lines.append(
            f"[5o] (c) {len(col_bodies)} sort and terms-agg bodies over "
            f"{FD_COLS} columns ({per_col} B each with its sort mirror) "
            f"round-robin, fielddata limit {limit_c} B: {_pcts(np, cols_ms)};"
            f" {ev_c} evictions, {rh_c} rehydrations; answers byte-equal to "
            f"the unlimited run; {card}")

        # (c) IVF-PQ on rehydrated codes
        br.apply_cluster_settings({})
        node.residency.evict_all("fielddata")
        vc = seg.vectors["emb"]
        _hold(not vc._pq.codes.resident, "(c) the codes stayed resident",
              "5o")
        ivf_bodies = [{"query": {"knn": {
            "field": "emb", "query_vector": [float(a) for a in q],
            "num_candidates": PQ_CANDIDATES}}, "size": 10}
            for q in qs[FD_ROTATION // 2:]]
        b3 = adc.LAUNCHES
        got_ivf = [node.search("fd", copy.deepcopy(b)) for b in ivf_bodies]
        b3 = adc.LAUNCHES - b3
        codes = vc._pq.codes_dev()
        _hold(torch.equal(codes.cpu(), torch.from_numpy(vc._pq.codes_host))
              and np.array_equal(vc._pq.codes_host, pq["codes"]),
              "(c) the rehydrated PQ codes differ from the host mirror",
              "5o")
        _hold(b3 == FD_IVF_BODIES, f"(c) B3 launched {b3} times over "
              f"{FD_IVF_BODIES} IVF-PQ bodies", "5o")
        ids, _sc, _full = exact_cosine_top(np, vpad, exists,
                                           qs[FD_ROTATION // 2:], 10)
        recall = float(np.mean([
            len({int(h["_id"]) for h in g["hits"]["hits"]}
                & set(ids[r].tolist())) / 10 for r, g in enumerate(got_ivf)]))
        lines.append(
            f"[5o] (c) evict_all(\"fielddata\"), then {FD_IVF_BODIES} IVF-PQ "
            f"bodies: B3 launched {b3} times on the rehydrated codes (bit-"
            f"equal to the host mirror), recall@10 vs exact {recall}")

        # (c) B1 on phase 5's node, its dense block rehydrated
        before = [read_node.search("msmarco", copy.deepcopy(b))
                  for b in read_bodies]
        st0 = dict(read_node.residency.stats()["tiers"]["fielddata"])
        n_ev = read_node.residency.evict_all()
        b1 = bm25_topk.LAUNCHES
        after = [read_node.search("msmarco", copy.deepcopy(b))
                 for b in read_bodies]
        b1 = bm25_topk.LAUNCHES - b1
        st1 = read_node.residency.stats()["tiers"]["fielddata"]
        _hold(_fd_answers(after) == _fd_answers(before),
              "(c) match hits after the eviction differ", "5o")
        _hold(n_ev >= 1 and b1 > 0
              and st1["rehydrations"] > st0["rehydrations"],
              f"(c) read node: {n_ev} evicted, B1 {b1}, rehydrations "
              f"{st0['rehydrations']} -> {st1['rehydrations']}", "5o")
        lines.append(
            f"[5o] (c) phase 5's node: evict_all() evicted {n_ev} handles, "
            f"then {len(read_bodies)} match bodies: B1 launched {b1} times "
            f"on the rehydrated dense impact block "
            f"({st1['rehydrations'] - st0['rehydrations']} rehydrations in "
            f"{(st1['rehydrate_time_in_nanos'] - st0['rehydrate_time_in_nanos']) / 1e6:.3f}"
            f" ms), hits byte-equal to those before the eviction")

        # (d) partial results on a breaker trip (the host loop)
        pnode = Node(name="partial", device=dev)
        pbr = pnode.breakers
        pstart = {n: pbr.breaker(n).used for n in start}
        try:
            two = {"settings": {"index": {"number_of_shards": 2,
                                          "search": {"mesh": False}}},
                   "mappings": {"properties": {"n": {"type": "long"},
                                               "body": {"type": "text"}}}}
            one = copy.deepcopy(two)
            one["settings"]["index"]["number_of_shards"] = 1
            pnode.create_index("two", two)
            pnode.create_index("one", one)
            r0, r1 = [next(r for r in map(str, range(64))
                           if shard_id_for("x", 2, r) == s) for s in (0, 1)]
            psvc = pnode.get_index("two")
            for i in range(FD_PARTIAL_DOCS):
                psvc.index_doc(f"n{i}", {"body": "w", "n": i}, routing=r0)
                psvc.index_doc(f"t{i}", {"body": "w"}, routing=r1)
                pnode.get_index("one").index_doc(str(i), {"body": "w", "n": i})
            pnode.refresh("two")
            pnode.refresh("one")
            body = {"query": {"match_all": {}}, "sort": [{"n": "desc"}],
                    "size": 2 * FD_PARTIAL_DOCS}
            pbr.apply_cluster_settings({"indices.breaker.fielddata.limit": 1})
            part = pnode.search("two", copy.deepcopy(body))
            f = part["_shards"].get("failures", [])
            _hold(part["_shards"]["failed"] == 1 and len(f) == 1
                  and f[0]["status"] == 429 and f[0]["shard"] == 0
                  and f[0]["reason"]["type"] == "circuit_breaking_exception"
                  and len(part["hits"]["hits"]) == FD_PARTIAL_DOCS
                  and all(h["_id"].startswith("t") for h in part["hits"]["hits"]),
                  f"(d) the partial answer: {part['_shards']}, "
                  f"{len(part['hits']['hits'])} hits", "5o")
            try:
                pnode.search("one", copy.deepcopy(body))
                raise AssertionError("phase 5o: (d) a one-shard index answered "
                                     "past a 1-byte fielddata limit")
            except CircuitBreakingException as e:
                one_err = str(e)[:60]
            pbr.apply_cluster_settings({})
            healed = pnode.search("two", copy.deepcopy(body))
            _hold(healed["_shards"] == {"total": 2, "successful": 2, "failed": 0}
                  and len(healed["hits"]["hits"]) == 2 * FD_PARTIAL_DOCS,
                  f"(d) healed: {healed['_shards']}", "5o")
            pnode.residency.evict_all()
            FAULTS.inject("resources.reserve", CircuitBreakingException, count=1)
            try:
                chaos = pnode.search("two", copy.deepcopy(body))
            finally:
                FAULTS.clear()
            _hold(chaos["_shards"]["failed"] == 1
                  and len(chaos["_shards"]["failures"]) == 1,
                  f"(d) the armed reserve point: {chaos['_shards']}", "5o")
            lines.append(
                f"[5o] (d) a 2-shard index, the column on shard 0 only, "
                f"fielddata limit 1 B: _shards {{total 2, successful 1, failed "
                f"1}}, the entry {f[0]['status']} {f[0]['reason']['type']}, "
                f"{len(part['hits']['hits'])} hits of shard 1; a 1-shard index "
                f"raises ({one_err}...); the default limit heals it "
                f"({len(healed['hits']['hits'])} hits); resources.reserve armed "
                f"once gives one failure entry")
        finally:
            pnode.close()
        pend = {n: pbr.breaker(n).used for n in pstart}
        _hold(pend == pstart, f"(d) breakers after close {pend}", "5o")
        # (e) the stats surface
        node.residency.evict_all()
        prof = node.search("fd", dict(copy.deepcopy(rot[1][1]),
                                      profile=True))
        rh_ns_prof = prof["profile"]["shards"][0]["tpu"]["phases"][
            "rehydrate_nanos"]
        ns = node.nodes_stats()["nodes"][node.node_id]
        acc = ns["accelerator"]
        free_b, total_b = torch.cuda.mem_get_info()
        spans = [s for s in node.tracer.spans() if s.name == "tpu.rehydrate"]
        fdst = ns["indices"]["fielddata"]
        _hold(acc["platform"] == "gpu"
              and acc["device_kind"] == torch.cuda.get_device_name()
              and acc["hbm"]["bytes_limit"] == total_b
              and fdst["evictions"] > 0 and fdst["rehydrations"] > 0
              and spans and rh_ns_prof > 0,
              f"(e) accelerator {acc}, fielddata {fdst}, {len(spans)} "
              f"tpu.rehydrate spans, rehydrate_nanos {rh_ns_prof}", "5o")
        lines.append(
            f"[5o] (e) nodes_stats: accelerator {acc['device_kind']}, hbm "
            f"{acc['hbm']['bytes_in_use']} of {acc['hbm']['bytes_limit']} "
            f"B in use, allocated {acc['memory_allocated']} B, reserved "
            f"{acc['memory_reserved']} B; fielddata evictions "
            f"{fdst['evictions']}, rehydrations {fdst['rehydrations']}, "
            f"{fdst['memory_size_in_bytes']} B resident; "
            f"{len(spans)} tpu.rehydrate spans; a profiled knn body's "
            f"rehydrate phase {rh_ns_prof / 1e6:.3f} ms")
    finally:
        node.close()
    end = {n: br.breaker(n).used for n in start}
    _hold(end == start, f"(e) breakers after close {end}, at start {start}",
          "5o")
    lines.append(f"[5o] (e) after the index closed: breakers {end} B, as at "
                 f"the start; {_fd_mem(torch)}")
    del emb2, cols, seg

    for ln in lines:
        log(ln)
    b1, b2, b3 = (bm25_topk.LAUNCHES - launches0[0],
                  knn_topk.LAUNCHES - launches0[1],
                  adc.LAUNCHES - launches0[2])
    log(f"[5o] B1 launched {b1}, B2 {b2}, B3 {b3} times; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1, b2, b3


def _cprofile_rows(st, key, n, per=1):
    """The top ``n`` of a pstats.Stats by ``key`` ("cum" or "own") as
    lines of calls, own ms, cumulative ms (each divided by ``per``) and
    the function."""
    rows = [(ct if key == "cum" else tt, nc, tt, ct, fn)
            for fn, (cc, nc, tt, ct, _callers) in st.stats.items()]
    rows.sort(key=lambda r: -r[0])
    out = []
    for _, nc, tt, ct, (path, line, name) in rows[:n]:
        path = re.sub(r".*/(elasticsearch_tpu_torch|torch)/", r"\1/", path)
        out.append(f"{nc / per:7.1f} {tt * 1e3 / per:8.3f} "
                   f"{ct * 1e3 / per:8.3f}  {path}:{line}({name})")
    return out


def mesh_host_profile(node, on_mesh, bodies):
    """Where the host time of phase 5d goes: cProfile's top 10 by
    cumulative time of one five-shard match query on the mesh path and
    on the host loop, and the top 10 by own time over all the queries
    (each new to the prepared-query memo)."""
    import cProfile
    import pstats

    for flag, name in ((True, "mesh path"), (False, "host loop")):
        on_mesh(flag)
        fresh = [dict(b, _source=True) for b in bodies]  # memo misses
        pr = cProfile.Profile()
        pr.enable()
        node.search("mesh5", copy.deepcopy(fresh[0]))
        pr.disable()
        one = pstats.Stats(pr)
        pr = cProfile.Profile()
        pr.enable()
        for b in fresh[1:]:
            node.search("mesh5", copy.deepcopy(b))
        pr.disable()
        many = pstats.Stats(pr)
        n = len(fresh) - 1
        log(f"[mesh] cProfile on the {name} (calls, own ms, cumulative ms, "
            f"function): one match query, {one.total_tt * 1e3:.3f} ms under "
            f"the profiler, top 10 by cumulative time:\n  "
            + "\n  ".join(_cprofile_rows(one, "cum", 10))
            + f"\n  {n} other queries, per query "
              f"{many.total_tt * 1e3 / n:.3f} ms, top 10 by own time:\n  "
            + "\n  ".join(_cprofile_rows(many, "own", 10, per=n)))
    on_mesh(True)


def _p50(np, ms) -> str:
    return f"{np.percentile(ms, 50):.3f} ms" if ms.size else "no queries"


# ---------------------------------------------------------------------------
# phase 5p: the REST front door (ROADMAP A10e)
# ---------------------------------------------------------------------------

REST_LOG_DOCS = 4096       # (a): 5h's log docs the launcher's index takes
REST_LOG_CHECKED = 64      # (a): acknowledged ids read back by GET
REST_KNN_BODIES = 8        # (b): brute-force and IVF-PQ bodies, each
REST_REPS = 3              # (b): timed passes over phase 5's match bodies
REST_BOOT_S = 120.0        # (a): the launcher's bind, its first import
REST_STOP_S = 10.0         # (a): SIGTERM to exit


class _Rest:
    """HTTP to one server, each request counted (``sent``)."""

    def __init__(self, port):
        self.port = port
        self.sent = 0

    def __call__(self, method, path, body=None, ndjson=None, headers=None):
        """(status, raw bytes, parsed JSON or text or None)."""
        import urllib.error
        import urllib.request

        data, hdrs = None, {"Content-Type": "application/json"}
        if ndjson is not None:
            data = ndjson.encode()
            hdrs["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
        hdrs.update(headers or {})
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                     data=data, method=method, headers=hdrs)
        self.sent += 1
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                st, raw = resp.status, resp.read()
                ctype = resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            st, raw = e.code, e.read()
            ctype = e.headers.get("Content-Type", "")
        if not raw:
            return st, raw, None
        if ctype.startswith("application/json"):
            return st, raw, json.loads(raw)
        return st, raw, raw.decode()


def _nd(lines) -> str:
    return "".join(json.dumps(x) + "\n" for x in lines)


_TOOK = re.compile(rb'"took": \d+')


def _hold_bytes(raw: bytes, want, what: str) -> None:
    """An HTTP answer against the in-process answer to the same body,
    byte for byte once ``took`` is masked on both."""
    from elasticsearch_tpu_torch.rest.server import _json_default

    w = json.dumps(want, default=_json_default).encode()
    if _TOOK.sub(b'"took": 0', raw) != _TOOK.sub(b'"took": 0', w):
        raise AssertionError(f"5p {what}: the HTTP answer differs from the "
                             f"in-process answer")


#: a client in a process of its own: ``threads`` keep-alive connections
#: send the requests of a JSON file, each thread the next unsent one, and
#: write the wall time, each request's latency and each answer
_CLIENT = r"""
import http.client, json, sys, threading, time
port, threads, src, dst = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
with open(src) as f:
    reqs = json.load(f)
res, lat, it, lock = [None] * len(reqs), [0.0] * len(reqs), \
    iter(range(len(reqs))), threading.Lock()
def worker():
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    while True:
        with lock:
            i = next(it, None)
        if i is None:
            break
        method, path, body = reqs[i]
        t = time.perf_counter()
        c.request(method, path, body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        data = r.read()
        lat[i] = time.perf_counter() - t
        res[i] = [r.status, data.decode()]
    c.close()
ths = [threading.Thread(target=worker) for _ in range(threads)]
t = time.perf_counter()
for th in ths:
    th.start()
for th in ths:
    th.join()
wall = time.perf_counter() - t
with open(dst, "w") as f:
    json.dump({"wall": wall, "lat": lat, "res": res}, f)
"""


def _client_run(port, reqs, threads):
    """``reqs`` [(method, path, body)] sent by ``_CLIENT`` in a process of
    its own (the server's process runs no client code): (wall s,
    latencies s, [(status, parsed answer)])."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "reqs.json"), os.path.join(d, "out.json")
        with open(src, "w") as f:
            json.dump(reqs, f)
        subprocess.run([sys.executable, "-c", _CLIENT, str(port),
                        str(threads), src, dst], check=True, timeout=600)
        with open(dst) as f:
            out = json.load(f)
    return out["wall"], out["lat"], [(st, json.loads(b))
                                     for st, b in out["res"]]


def _launcher(np, card):
    """(a) and (d): ``python -m elasticsearch_tpu_torch.server --port 0``
    on the card, driven over HTTP, stopped by SIGTERM. Returns its B1
    launches, read from its own ``_nodes/stats``."""
    import queue
    import signal
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticsearch_tpu_torch.server", "--port",
         "0", "--name", "front-door"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [out.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        port, seen = None, []
        deadline = time.monotonic() + REST_BOOT_S
        while port is None:
            try:
                line = out.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"5p(a): the launcher did not bind in "
                                     f"{REST_BOOT_S} s: {seen}")
            seen.append(line.rstrip())
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        boot_s = time.perf_counter() - t
        http = _Rest(port)
        st, _, info = http("GET", "/")
        _hold(st == 200 and info["version"]["build_flavor"] == "gpu"
              and info["devices"][0].startswith("cuda"),
              f"(a) GET / answered {st} {info}", "5p")
        st, _, _ = http("PUT", "/logs", {"settings": {"number_of_shards": 1},
                                         "mappings": WP_MAPPING})
        _hold(st == 200, f"(a) the index create answered {st}", "5p")
        docs = wp_docs(np, REST_LOG_DOCS, SEED + 90)
        t = time.perf_counter()
        st, _, bulk = http("POST", "/_bulk?refresh=true", ndjson=_nd(
            x for d, src in docs
            for x in ({"index": {"_index": "logs", "_id": d}}, src)))
        bulk_s = time.perf_counter() - t
        _hold(st == 200 and not bulk["errors"]
              and [i["index"]["status"] for i in bulk["items"]]
              == [201] * REST_LOG_DOCS, f"(a) _bulk answered {st}", "5p")

        def launches():
            st, _, ns = http("GET", "/_nodes/stats")
            node = next(iter(ns["nodes"].values()))
            return node["indices"]["search"]["launches"]["bm25_dense_topk"]

        b0 = launches()
        st, _, res = http("POST", "/logs/_search",
                          {"query": {"match": {"body": "t1 t2 t3"}}})
        b1 = launches() - b0
        _hold(st == 200 and res["hits"]["total"] > 0 and b1 >= 1,
              f"(a) a match body answered {st} with {b1} B1 launches in "
              f"the server", "5p")
        want = dict(docs)
        for d in sorted(want)[:: REST_LOG_DOCS // REST_LOG_CHECKED]:
            st, _, got = http("GET", f"/logs/_doc/{d}")
            _hold(st == 200 and got["found"] and got["_source"] == want[d],
                  f"(a) GET of acknowledged id {d} answered {st}", "5p")

        # (d) a by-query listed by GET /_tasks and stopped by _cancel
        res = {}
        th = threading.Thread(target=lambda: res.update(r=http(
            "POST", "/logs/_update_by_query",
            {"query": {"match_all": {}}, "script": "ctx._source.n += 1"})))
        th.start()
        task, deadline = None, time.monotonic() + 60
        while task is None and time.monotonic() < deadline:
            st, _, ls = http("GET", "/_tasks?actions=*byquery")
            task = next((x for n in ls["nodes"].values()
                         for x in n["tasks"].values()), None)
        _hold(task is not None, "(d) the by-query never showed in /_tasks",
              "5p")

        def indexed():
            st, _, ist = http("GET", "/logs/_stats/indexing")
            return ist["_all"]["primaries"]["indexing"]["index_total"]

        # cancel once its first update has landed (the bulk indexed
        # REST_LOG_DOCS), so the run stops between docs, not before them
        while indexed() <= REST_LOG_DOCS and time.monotonic() < deadline:
            time.sleep(0.001)
        tid = f"{task['node']}:{task['id']}"
        st, _, cancelled = http("POST", f"/_tasks/{tid}/_cancel")
        th.join(600)
        st2, _, upd = res["r"]
        _hold(st == 200 and cancelled["nodes"] and st2 == 200
              and "canceled" in upd
              and 0 < upd["updated"] < REST_LOG_DOCS,
              f"(d) _cancel answered {st}, the by-query {st2} "
              f"{ {k: upd.get(k) for k in ('updated', 'canceled')} }", "5p")
        sent = http.sent
        st, _, text = http("GET", "/_prometheus/metrics")
        counted = sum(int(float(x.rsplit(" ", 1)[1]))
                      for x in text.splitlines()
                      if x.startswith("estpu_rest_requests_total{"))
        _hold(counted == sent, f"(d) estpu_rest_requests_total {counted}, "
              f"requests sent {sent}", "5p")
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=REST_STOP_S)
        stop_s = time.perf_counter() - t
        _hold(code == 0, f"(a) SIGTERM: exit {code}", "5p")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"[5p] (a) python -m elasticsearch_tpu_torch.server on {card}: "
        f"bound in {boot_s:.3f} s; _bulk of {REST_LOG_DOCS} log docs with "
        f"refresh {bulk_s * 1e3:.3f} ms ({REST_LOG_DOCS / bulk_s:.1f} "
        f"docs/s); a match body launched B1 {b1} times (the server's "
        f"_nodes/stats); {REST_LOG_CHECKED} acknowledged ids read back; "
        f"(d) an update-by-query listed by /_tasks and cancelled after "
        f"{upd['updated']} of {REST_LOG_DOCS} docs; "
        f"estpu_rest_requests_total {counted} = requests sent; SIGTERM to "
        f"exit 0 in {stop_s:.3f} s")
    return b1


def phase_rest(torch, np, dev, card, sift, ivf_index, pq_parts, read_node,
               match_bodies, dense_bodies):
    """Phase 5p (module docstring); returns the launches of B1, B2, B3
    over HTTP."""
    import threading

    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.ops import adc, bm25_topk, knn_topk
    from elasticsearch_tpu_torch.rest.server import RestServer
    from elasticsearch_tpu_torch.utils.threadpool import FixedThreadPool

    t_phase = time.perf_counter()
    b1_sub = _launcher(np, card)

    node = read_node
    node.create_index("vec", {"settings": {"number_of_shards": 1},
                              "mappings": VEC_MAPPING})
    node.get_index("vec").shards[0].engine.add_segment(segment_from_arrays(
        sift_arrays(sift, ivf_index, pq_parts), node.residency))
    srv = RestServer(node, host="127.0.0.1", port=0)
    srv.start(background=True)
    http = _Rest(srv.port)
    counts = {"b1": 0, "b2": 0, "b3": 0}

    def counted(fn):
        before = (bm25_topk.LAUNCHES, knn_topk.LAUNCHES, adc.LAUNCHES)
        out = fn()
        for k, a, b in zip(counts, before, (bm25_topk.LAUNCHES,
                                            knn_topk.LAUNCHES, adc.LAUNCHES)):
            counts[k] += b - a
        return out

    try:
        # (b) phase 5's match bodies: B1, each answer the in-process one
        http("POST", "/msmarco/_search", match_bodies[0])  # first use
        b1 = bm25_topk.LAUNCHES
        for n, body in enumerate(match_bodies):
            st, raw, _ = counted(lambda: http("POST", "/msmarco/_search",
                                              body))
            _hold(st == 200, f"(b) match body {n} answered {st}", "5p")
            _hold_bytes(raw, node.search("msmarco", copy.deepcopy(body)),
                        f"(b) match body {n}")
        _hold(bm25_topk.LAUNCHES > b1, "(b) no B1 launch over HTTP", "5p")

        seq = [("POST", "/msmarco/_search", b)
               for _ in range(REST_REPS) for b in match_bodies]
        _client_run(srv.port, seq[:len(match_bodies)], 1)  # warm
        ms_proc, ms_disp = [], []
        for _m, _p, body in seq:
            torch.cuda.synchronize()
            t = time.perf_counter()
            node.search("msmarco", copy.deepcopy(body))
            torch.cuda.synchronize()
            ms_proc.append((time.perf_counter() - t) * 1e3)
            raw = json.dumps(body).encode()
            t = time.perf_counter()
            srv.controller.dispatch("POST", "/msmarco/_search", {}, raw)
            torch.cuda.synchronize()
            ms_disp.append((time.perf_counter() - t) * 1e3)
        busy = None
        for _ in range(2):
            with _profiled(torch) as prof:
                wall1, lat1, got1 = counted(
                    lambda: _client_run(srv.port, seq, 1))
            dev_ms = sum(e.self_device_time_total
                         for e in _device_rows(prof)) / 1e3
            if dev_ms > 0:
                busy = (dev_ms, wall1 * 1e3)
                break
        _hold(all(st == 200 for st, _r in got1), "(b) a timed match body "
              "failed", "5p")
        ms_http = np.array(lat1) * 1e3
        ms_proc, ms_disp = np.array(ms_proc), np.array(ms_disp)
        pct = {k: (float(np.percentile(v, 50)), float(np.percentile(v, 99)))
               for k, v in (("http", ms_http), ("proc", ms_proc),
                            ("disp", ms_disp))}
        qps1 = len(seq) / wall1
        lines = [
            f"[5p] (b) {len(match_bodies)} match bodies x {REST_REPS} "
            f"through POST /msmarco/_search from one keep-alive client in "
            f"a process of its own, on {card}: HTTP p50 {pct['http'][0]:.3f}"
            f" ms p99 {pct['http'][1]:.3f} ms; in-process Node.search p50 "
            f"{pct['proc'][0]:.3f} ms p99 {pct['proc'][1]:.3f} ms; "
            f"RestController.dispatch without a socket (route, admission, "
            f"the pool's hand-off, task, span, metrics) p50 "
            f"{pct['disp'][0]:.3f} ms p99 {pct['disp'][1]:.3f} ms; REST "
            f"overhead {pct['http'][0] - pct['proc'][0]:.3f} ms a request "
            f"at p50 ({pct['http'][1] - pct['proc'][1]:.3f} at p99), "
            f"{pct['disp'][0] - pct['proc'][0]:.3f} of it in dispatch; "
            f"{qps1:.1f} queries/s at 1 client thread; device busy "
            + ("not measured (the profiler recorded no device time twice)"
               if busy is None else
               f"{busy[0]:.3f} ms of {busy[1]:.3f} ms "
               f"({100 * busy[0] / busy[1]:.1f}%)")
            + "; every answer byte-equal to Node.search's"]

        # brute-force kNN (B2) and IVF-PQ (B3) bodies on phase 5b's slab
        qs = sift[4](2 * REST_KNN_BODIES)
        knn = [{"query": {"knn": {"field": "emb", "query_vector": [
            float(a) for a in q], "ann": False}}, "size": 10}
            for q in qs[:REST_KNN_BODIES]]
        ivf = [{"query": {"knn": {"field": "emb", "query_vector": [
            float(a) for a in q], "num_candidates": PQ_CANDIDATES}},
            "size": 10} for q in qs[REST_KNN_BODIES:]]
        http("POST", "/vec/_search", knn[0])  # the slab's first touch
        http("POST", "/vec/_search", ivf[0])
        kms = {}
        for name, bodies, key in (("brute-force", knn, "b2"),
                                  ("IVF-PQ", ivf, "b3")):
            k0, ms = counts[key], []
            for n, body in enumerate(bodies):
                t = time.perf_counter()
                st, raw, _ = counted(lambda: http("POST", "/vec/_search",
                                                  body))
                ms.append((time.perf_counter() - t) * 1e3)
                _hold(st == 200, f"(b) {name} body {n} answered {st}", "5p")
                _hold_bytes(raw, node.search("vec", copy.deepcopy(body)),
                            f"(b) {name} body {n}")
            _hold(counts[key] - k0 == len(bodies),
                  f"(b) {counts[key] - k0} launches over {len(bodies)} "
                  f"{name} bodies", "5p")
            kms[name] = float(np.percentile(ms, 50))
        lines.append(
            f"[5p] (b) {REST_KNN_BODIES} brute-force knn bodies (B2 once "
            f"each) p50 {kms['brute-force']:.3f} ms and {REST_KNN_BODIES} "
            f"IVF-PQ bodies (B3 once each) p50 {kms['IVF-PQ']:.3f} ms "
            f"through POST /vec/_search on phase 5b's {N_VECS} x {DIMS} "
            f"slab, each byte-equal to Node.search's")

        # 5e(a)'s pure-dense bodies as one _msearch: one batched B1
        pairs = [({"index": "msmarco"}, b) for b in dense_bodies]
        nd = _nd(x for hb in pairs for x in hb)
        http("POST", "/_msearch", ndjson=nd)  # first use
        b1 = bm25_topk.LAUNCHES
        t = time.perf_counter()
        st, raw, got_ms = counted(lambda: http("POST", "/_msearch",
                                               ndjson=nd))
        ms_wall = (time.perf_counter() - t) * 1e3
        b1 = bm25_topk.LAUNCHES - b1
        _hold(st == 200 and b1 == 1, f"(b) _msearch answered {st} with "
              f"{b1} B1 launches", "5p")
        inproc = node.msearch(copy.deepcopy(pairs))
        _hold_bytes(raw, inproc, "(b) _msearch")
        lines.append(
            f"[5p] (b) {len(dense_bodies)} pure-dense bodies in one POST "
            f"/_msearch: {ms_wall:.3f} ms, "
            f"{len(dense_bodies) / ms_wall * 1e3:.1f} queries/s, B1 once, "
            f"byte-equal to Node.msearch's")

        # the same bodies as single searches from 64 client threads (one
        # keep-alive connection each, in a process of their own), through
        # the coalescer (adaptive, its default)
        coal = node.serving.coalescer
        reqs = [("POST", "/msmarco/_search", b) for b in dense_bodies]
        _client_run(srv.port, reqs, COALESCE_THREADS)  # warm
        before = coal.stats()
        wall64, _lat, got = counted(
            lambda: _client_run(srv.port, reqs, COALESCE_THREADS))
        after = coal.stats()
        for n, (st, res) in enumerate(got):
            _hold(st == 200, f"(b) coalesced body {n} answered {st}", "5p")
            # a request's batch, and so its B1 form, depends on when it
            # arrived: held at phase 5e(e)'s bar against the msearch
            check_hits(res, inproc["responses"][n],
                       f"5p (b) coalesced body {n} vs Node.msearch",
                       rtol=1e-6)
        batches = after["batch_size"]["count"] - before["batch_size"]["count"]
        sizes = after["batch_size"]["sum"] - before["batch_size"]["sum"]
        solo = after["bypass"].get("solo", 0) - before["bypass"].get("solo", 0)
        qps64 = len(dense_bodies) / wall64
        lines.append(
            f"[5p] (b) the same {len(dense_bodies)} bodies as single POST "
            f"/msmarco/_search from {COALESCE_THREADS} client threads "
            f"through the coalescer: {qps64:.1f} queries/s ({wall64 * 1e3:.3f}"
            f" ms), {batches} batches of {sizes / max(batches, 1):.1f} on "
            f"average, {solo} solo; every answer held against "
            f"Node.msearch's at 5e(e)'s bar; {qps1:.1f} queries/s at 1 "
            f"client thread, {qps64:.1f} at {COALESCE_THREADS}")

        # (c) shedding: a tenant over its share, a saturated pool
        settings = {"network.breaker.inflight_requests.limit": "64kb",
                    "serving.qos.tenant.greedy.weight": 1,
                    "serving.qos.tenant.calm.weight": 1}
        st, _, _ = http("PUT", "/_cluster/settings",
                        {"transient": settings})
        held = node.serving.qos.admit("greedy", 32 * 1024)
        try:
            st_g, _, res_g = http("POST", "/msmarco/_search",
                                  match_bodies[1],
                                  headers={"X-Tenant-Id": "greedy"})
            st_c, _, _ = http("POST", "/msmarco/_search", match_bodies[1],
                              headers={"X-Tenant-Id": "calm"})
        finally:
            node.serving.qos.release(held)
            http("PUT", "/_cluster/settings",
                 {"transient": {k: None for k in settings}})
        _hold(st == 200 and st_g == 429 and st_c == 200
              and res_g["error"]["type"] == "circuit_breaking_exception",
              f"(c) tenant shares: greedy {st_g}, calm {st_c}", "5p")
        pools = node.thread_pool.pools
        old = pools["search"]
        pools["search"] = FixedThreadPool("search", 1, 1)
        gate = threading.Event()
        holders = [threading.Thread(target=pools["search"].execute,
                                    args=(gate.wait, 60)) for _ in range(2)]
        try:
            for th in holders:
                th.start()
                time.sleep(0.05)
            st_p, _, res_p = http("POST", "/msmarco/_search",
                                  match_bodies[2])
        finally:
            gate.set()
            for th in holders:
                th.join()
            pools["search"].shutdown()
            pools["search"] = old
        _hold(st_p == 429 and res_p["error"]["type"]
              == "es_rejected_execution_exception",
              f"(c) a saturated search pool answered {st_p}", "5p")
        st, _, _ = http("POST", "/msmarco/_search", match_bodies[2])
        _hold(st == 200, f"(c) the restored pool answered {st}", "5p")
        lines.append(
            "[5p] (c) a tenant over its share of the in_flight_requests "
            "breaker got 429 circuit_breaking_exception while another "
            "tenant got 200; a saturated search pool (1 worker, 1 queue "
            "slot) answered 429 es_rejected_execution_exception, a whole "
            "HTTP answer, and served again once drained")
    finally:
        srv.stop()
        node.delete_index("vec")
    for line in lines:
        log(line)
    b1 = counts["b1"] + b1_sub
    log(f"[5p] launches over HTTP: B1 {b1} ({b1_sub} in the launcher's "
        f"process), B2 {counts['b2']}, B3 {counts['b3']}; phase 5p took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return b1, counts["b2"], counts["b3"]


# ---------------------------------------------------------------------------
# phase 5r: the flight recorder and the stall watchdog (ROADMAP A10g)
# ---------------------------------------------------------------------------

WD_STALL_S = 0.5           # (a): spin queued on the stream ahead of B1
WD_FLOOR_S = 0.05          # (a): the watchdog's program floor and bound
WD_P99_MULT = 2.0          # (a): the bound's multiple of the key's p99
WD_TRIP_S = 5.0            # (a): the trip must come within this
WD_DOCS = 2048             # (b): 5h's log docs with a 128-d vector
WD_MATCH = 64              # (b), (c): match bodies
WD_KNN = 8                 # (b): brute-force knn bodies
WD_SERVE_S = 2.2           # (b): seconds of bodies, two ticks at least
WD_COST_S = 1.5            # (c): seconds of bodies an arm, two arms each
WD_SLOTS = 4               # (d): term-range slots of phase 5's field
WD_GENERIC = 32            # (d): tail-term (generic) match bodies


def _wd_launch(root, env, data, card):
    """One launcher on the card over ``data``: (process, http)."""
    import queue
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticsearch_tpu_torch.server", "--port",
         "0", "--name", "watched", "--data-path", data], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [out.put(x) for x in proc.stdout],
                     daemon=True).start()
    deadline, seen = time.monotonic() + REST_BOOT_S, []
    while True:
        try:
            line = out.get(timeout=max(0.1, deadline - time.monotonic()))
        except Exception:
            proc.kill()
            proc.wait()
            raise AssertionError(f"5r(b): the launcher did not bind in "
                                 f"{REST_BOOT_S} s: {seen}")
        seen.append(line.rstrip())
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
        if m:
            return proc, _Rest(int(m.group(1)))


def _wd_stop(proc) -> None:
    import signal

    proc.send_signal(signal.SIGTERM)
    code = proc.wait(timeout=REST_STOP_S)
    _hold(code == 0, f"(b) SIGTERM: exit {code}", "5r")


def _wd_injected(np, card):
    """(b): an injected stall in a launcher process, its incident listed
    before and after a restart on the same data path. Returns (B1, B2)
    launches in the launcher's processes, the incident id, and the
    flight ring counts."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    docs, vecs = rp_sources(np, WD_DOCS, SEED + 130)
    match, knn, _qv = rp_bodies(np, vecs, SEED + 131)
    rng = np.random.default_rng(SEED + 132)
    match = [match[i % len(match)] for i in range(WD_MATCH)]
    knn = knn[:WD_KNN]

    def launches(http):
        st, _, ns = http("GET", "/_nodes/stats")
        got = next(iter(ns["nodes"].values()))["indices"]["search"][
            "launches"]
        return got["bm25_dense_topk"], got["knn_topk"]

    with tempfile.TemporaryDirectory() as data:
        proc, http = _wd_launch(root, dict(
            env, ESTPU_FAULTS="watchdog.program_stall:count=1"), data, card)
        try:
            st, _, _ = http("PUT", "/wd", {"settings": {
                "number_of_shards": 1}, "mappings": RP_MAPPING})
            _hold(st == 200, f"(b) the create answered {st}", "5r")
            st, _, bulk = http("POST", "/_bulk?refresh=true", ndjson=_nd(
                x for d, src in docs
                for x in ({"index": {"_index": "wd", "_id": d}}, src)))
            _hold(st == 200 and not bulk["errors"], f"(b) _bulk {st}", "5r")
            b0 = launches(http)
            t_end = time.monotonic() + WD_SERVE_S
            order = rng.permutation(WD_MATCH + WD_KNN)
            while True:
                for i in order:
                    body = match[i] if i < WD_MATCH else knn[i - WD_MATCH]
                    st, _, res = http("POST", "/wd/_search", body)
                    _hold(st == 200 and res["hits"]["hits"],
                          f"(b) a search answered {st}", "5r")
                if time.monotonic() >= t_end:
                    break
            b1, b2 = (a - b for a, b in zip(launches(http), b0))
            _hold(b1 > 0 and b2 > 0, f"(b) launches B1 {b1}, B2 {b2}", "5r")
            st, _, rows = http("GET", "/_cat/incidents?format=json"
                               "&h=id,detector,persisted")
            inc = [r for r in rows if r["detector"] == "program_stall"]
            _hold(st == 200 and len(inc) == 1, f"(b) /_cat/incidents "
                  f"{rows}", "5r")
            iid = inc[0]["id"]
            st, _, fl = http("GET", "/_nodes/_local/flight")
            counts = fl["flight"]["counts"]
            _hold(st == 200 and counts["trips"] >= 1
                  and counts["metrics"] >= 1
                  and fl["watchdog"]["trips"].get("program_stall") == 1
                  and fl["watchdog"]["running"]
                  and any(e["detector"] == "program_stall"
                          for e in fl["flight"]["rings"]["trips"]),
                  f"(b) /_nodes/_local/flight counts {counts}, watchdog "
                  f"{fl['watchdog']['trips']}", "5r")
            _wd_stop(proc)
            proc, http = _wd_launch(root, {k: v for k, v in env.items()
                                           if k != "ESTPU_FAULTS"}, data,
                                    card)
            st, _, rows = http("GET", "/_cat/incidents?format=json"
                               "&h=id,detector,persisted")
            _hold(st == 200 and [r["id"] for r in rows] == [iid]
                  and rows[0]["persisted"] == "true",
                  f"(b) after the restart /_cat/incidents {rows}", "5r")
            st, _, payload = http(
                "GET", f"/_cluster/diagnostics/incidents/{iid}")
            _hold(st == 200 and payload["id"] == iid
                  and payload["detector"] == "program_stall"
                  and payload["hot_threads"]
                  and set(payload["flight"]["rings"]) == {
                      "metrics", "slow_ops", "breaker_trips", "compiles",
                      "cluster", "engine_failures", "trips"},
                  f"(b) the incident's payload answered {st}", "5r")
            st, _, res = http("POST", "/wd/_search", match[0])
            _hold(st == 200 and res["hits"]["hits"],
                  f"(b) a search after the restart answered {st}", "5r")
            _wd_stop(proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return b1, b2, iid, counts


def _wd_stall(torch, node, body):
    """(a): ``body`` (a pure-dense match, B1 in the mesh round) searched
    on another thread behind a spin on the stream, while this thread
    ticks a watchdog with a low bound. The spin lasts WD_STALL_S, or four
    times the key's adaptive bound where that is longer (the bound is
    twice the key's execute p99, which earlier phases' concurrent
    searches may have raised). Returns (the trip, seconds from the
    spin's launch to the trip, the search's ms, the growth of its key's
    execute seconds, the spin's seconds, the key's bound)."""
    import threading

    from elasticsearch_tpu_torch.monitor import programs
    from elasticsearch_tpu_torch.monitor.watchdog import WatchdogService

    calls = {r["shapes"]: r["calls"] for r in programs.REGISTRY.snapshot()
             if r["program"] == "mesh_dsl"}
    want = node.search("msmarco", dict(body))  # the memo's entry
    node.search("msmarco", dict(body))
    keys = [r["shapes"] for r in programs.REGISTRY.snapshot()
            if r["program"] == "mesh_dsl"
            and r["calls"] > calls.get(r["shapes"], 0)]
    torch.cuda.synchronize()
    s0, s1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(10_000_000)
    s1.record()
    torch.cuda.synchronize()
    wd = WatchdogService(node, program_floor_s=WD_FLOOR_S,
                         program_default_bound_s=WD_FLOOR_S,
                         program_p99_mult=WD_P99_MULT, cooldown_s=0.0)
    bound = max([wd._program_bound("mesh_dsl", k) for k in keys],
                default=WD_FLOOR_S)
    stall_s = max(WD_STALL_S, 4 * bound)
    cycles = int(10_000_000 * stall_s * 1e3 / s0.elapsed_time(s1))
    calls0 = {r["shapes"]: r["execute_seconds"]
              for r in programs.REGISTRY.snapshot()
              if r["program"] == "mesh_dsl"}
    got, trip, trip_s = {}, None, None
    th = threading.Thread(target=lambda: got.update(
        r=node.search("msmarco", dict(body))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    th.start()
    while trip is None and time.perf_counter() - t0 < WD_TRIP_S + stall_s:
        time.sleep(0.01)
        trip = next((x for x in wd.run_once()
                     if x["detector"] == "program_stall"
                     and x["detail"]["program"] == "mesh_dsl"), None)
    trip_s = time.perf_counter() - t0
    th.join(60)
    stall_ms = (time.perf_counter() - t0) * 1e3
    _hold(trip is not None, f"(a) no program_stall trip in "
          f"{WD_TRIP_S + stall_s:.3f} s of a {stall_s:.3f} s stall (the "
          f"key's bound {bound:.3f} s, keys {keys})", "5r")
    _hold(trip["incident_id"] and wd.incidents.load(trip["incident_id"]),
          "(a) the trip captured no incident", "5r")
    check_hits(got["r"], want, "5r(a) the stalled search")
    rows = {r["shapes"]: r for r in programs.REGISTRY.snapshot()
            if r["program"] == "mesh_dsl"}
    grew = rows[trip["detail"]["shapes"]]["execute_seconds"] - calls0.get(
        trip["detail"]["shapes"], 0.0)
    _hold(grew >= 0.8 * stall_s, f"(a) the dispatch's execute time grew "
          f"{grew:.3f} s, under the stall's device time", "5r")
    return trip, trip_s, stall_ms, grew, stall_s, bound


def phase_watchdog(torch, np, dev, card, node, corpus_df):
    """Phase 5r (module docstring) on phase 5's node; returns the B1 and
    B2 launches it made."""
    from elasticsearch_tpu_torch.monitor import kernels
    from elasticsearch_tpu_torch.ops import bm25_topk, knn_topk
    from elasticsearch_tpu_torch.parallel import postings_shard

    t_phase = time.perf_counter()
    b1_0, b2_0 = bm25_topk.LAUNCHES, knn_topk.LAUNCHES
    inv = node.get_index("msmarco").shards[0].segments[0].inverted["body"]
    dense = inv.dense_block()[0]

    # (a) a real stall: spin queued ahead of one B1 search
    body = {"query": {"match": {"body": " ".join(f"t{t}" for t in next(
        q for q in make_queries(np, 64, VOCAB, corpus_df, SEED + 133,
                                dense_only=dense[:VOCAB] >= 0)))}},
        "size": 10}
    trip, trip_s, stall_ms, grew, stall_s, bound = _wd_stall(torch, node,
                                                             body)

    # (b) an injected stall that survives a restart
    b1_b, b2_b, iid, counts = _wd_injected(np, card)

    # (c) the cost: the same bodies with the watchdog ticking and closed
    bodies = [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
               "size": 10} for q in make_queries(np, WD_MATCH, VOCAB,
                                                 corpus_df, SEED + 134)]
    for b in bodies:
        node.search("msmarco", dict(b))  # memo entries, untimed
    arms = {"ticking": [], "closed": []}
    ticks0 = node.watchdog.ticks
    for arm in ("ticking", "closed", "ticking", "closed"):
        if arm == "ticking":
            node.watchdog.ensure_started()
        else:
            node.watchdog.close()
        t_end = time.perf_counter() + WD_COST_S
        while time.perf_counter() < t_end:
            for b in bodies:
                t = time.perf_counter()
                node.search("msmarco", dict(b))
                arms[arm].append((time.perf_counter() - t) * 1e3)
    node.watchdog.close()
    ticks = node.watchdog.ticks - ticks0
    _hold(ticks >= 2, f"(c) the watchdog ticked {ticks} times", "5r")
    p50 = {k: float(np.percentile(v, 50)) for k, v in arms.items()}

    # (d) phase 5's field split into WD_SLOTS term-range slots on the card
    tail = np.asarray(dense[:VOCAB]) < 0
    tail &= np.asarray(corpus_df[:tail.size]) > 0
    generic = [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
                "size": 10} for q in make_queries(
                    np, WD_GENERIC, VOCAB, corpus_df, SEED + 135,
                    dense_only=tail)]
    unsplit = [node.search("msmarco", dict(b)) for b in generic]
    saved, split = postings_shard.POSTINGS_SHARD_NNZ, None
    postings_shard.POSTINGS_SHARD_NNZ = inv.nnz
    try:
        t = time.perf_counter()
        split = inv.postings_split(n_devices=WD_SLOTS)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t) * 1e3
        regs = inv.residency.node_registries
        _hold(split is not None and split.S == WD_SLOTS and len(regs) == 1
              and all(split.registry_of(r) is regs[0]
                      for r in range(split.S)),
              f"(d) the split {split} over {len(regs)} registries", "5r")
        k0 = kernels.snapshot().get("bm25_postings_sharded", 0)
        worst = 0.0
        for b, u in zip(generic, unsplit):
            r = node.search("msmarco", dict(b))
            _hold([h["_id"] for h in r["hits"]["hits"]]
                  == [h["_id"] for h in u["hits"]["hits"]]
                  and r["hits"]["total"] == u["hits"]["total"],
                  f"(d) the split's hits differ for {b}", "5r")
            for x, y in zip(r["hits"]["hits"], u["hits"]["hits"]):
                worst = max(worst, abs(x["_score"] - y["_score"])
                            / max(abs(y["_score"]), 1e-30))
        sharded = kernels.snapshot().get("bm25_postings_sharded", 0) - k0
        _hold(sharded >= WD_GENERIC, f"(d) the split served {sharded} "
              f"term groups", "5r")
        _hold(worst <= 1e-5, f"(d) scores off by {worst:.3e}", "5r")
    finally:
        postings_shard.POSTINGS_SHARD_NNZ = saved
        if split is not None:
            split.close()
        inv._pshard = None
        del split
        torch.cuda.empty_cache()
    b1 = bm25_topk.LAUNCHES - b1_0 + b1_b
    b2 = knn_topk.LAUNCHES - b2_0 + b2_b
    log(f"[5r] (a) a {stall_s:.3f} s spin (at least {WD_STALL_S} s, four "
        f"times the key's bound of {bound:.3f} s) queued ahead of one B1 "
        f"search on "
        f"{card}: program_stall tripped on [mesh_dsl|"
        f"{trip['detail']['shapes']}] {trip_s * 1e3:.3f} ms after the "
        f"stall began (bound {trip['detail']['bound_seconds']} s, the "
        f"dispatch {trip['detail']['age_seconds']:.3f} s in flight), "
        f"incident {trip['incident_id']}; the search answered in "
        f"{stall_ms:.3f} ms, its hits unchanged, its execute time "
        f"{grew:.3f} s")
    log(f"[5r] (b) python -m elasticsearch_tpu_torch.server with "
        f"ESTPU_FAULTS=watchdog.program_stall:count=1: {WD_MATCH} match and "
        f"{WD_KNN} knn bodies a round for {WD_SERVE_S} s (B1 {b1_b}, B2 "
        f"{b2_b} in "
        f"its process); incident {iid} listed, flight counts {counts}; "
        f"after SIGTERM and a restart on the same path it is listed as "
        f"persisted and its payload answers")
    log(f"[5r] (c) {WD_MATCH} match bodies on phase 5's node, "
        f"{WD_COST_S} s an arm, twice: p50 {p50['ticking']:.4f} ms with the "
        f"watchdog ticking ({ticks} ticks) against {p50['closed']:.4f} ms "
        f"closed ({(p50['ticking'] / p50['closed'] - 1) * 100:+.2f}%; "
        f"{len(arms['ticking'])} and {len(arms['closed'])} searches)")
    log(f"[5r] (d) phase 5's body field ({inv.nnz} postings) split into "
        f"{WD_SLOTS} term-range slots on {dev} in {build_ms:.3f} ms: "
        f"{WD_GENERIC} generic bodies through the split, the same top 10 "
        f"and totals as the unsplit path, scores within {worst:.3e} "
        f"relative; phase 5r took {time.perf_counter() - t_phase:.1f} s")
    return b1, b2


# ---------------------------------------------------------------------------
# phase 5s: the compile/warm layer (ROADMAP A11)
# ---------------------------------------------------------------------------

WS_DOCS = 1024             # 5h's log docs with a 128-d vector, each index
WS_HEAD = 16               # body terms from t0..t15: dense rows at 1,024 docs
WS_MATCH = 4               # head-term match bodies (B1's dense rows)
WS_KNN = 2                 # brute-force (B2) and IVF-PQ (B3) knn bodies each
WS_HYBRID = 2              # hybrid bodies with a PQ re-rank (B4)
WS_TOKENS = 4              # the re-rank's query vectors
WS_PROC_S = 240.0          # one process's limit
WS_MAPPING = {"properties": dict(WP_MAPPING["properties"], emb={
    "type": "dense_vector", "dims": DIMS, "similarity": "cosine",
    "index_options": {"type": "ivf_pq"}})}
#: the mesh (two slots) and the host loop
WS_INDICES = {"wsm": {"number_of_shards": 2},
              "wsh": {"number_of_shards": 1,
                      "index": {"search": {"mesh": False}}}}

#: one node process of 5s: ``role`` a records (builds the indices, serves
#: the bodies, closes), b restarts over the data path with an empty
#: kernel build directory and waits for its warmup, c restarts with the
#: libraries built and no census; the build directory is passed in as
#: ``ops.build._BUILD_DIR``
_WS_CHILD = r"""
import json, sys, time
role, data, build_dir, spec_path = sys.argv[1:5]
t_start = time.perf_counter()
import torch
from elasticsearch_tpu_torch.ops import build
build._BUILD_DIR = build_dir
from elasticsearch_tpu_torch import Node
from elasticsearch_tpu_torch.monitor import compile_cache, programs
from elasticsearch_tpu_torch.ops import adc, bm25_topk, knn_topk, maxsim_adc
from elasticsearch_tpu_torch.parallel import aot
from elasticsearch_tpu_torch.rest.server import RestServer
spec = json.load(open(spec_path))
mods = {"bm25_dense_topk": bm25_topk, "knn_topk": knn_topk,
        "adc_scores": adc, "maxsim_adc": maxsim_adc}
t0 = time.perf_counter()
node = Node(name="ws-" + role, data_path=data, device="cuda")
t_open = time.perf_counter() - t0
out = {"role": role, "open_s": t_open}
if role == "a":
    for name, settings in spec["indices"].items():
        node.create_index(name, {"settings": settings,
                                 "mappings": spec["mapping"]})
        lines = []
        for d, src in spec["docs"]:
            lines += [{"index": {"_index": name, "_id": d}}, src]
        node.bulk(lines)
        node.indices[name].refresh()
        node.indices[name].flush()
    torch.cuda.synchronize()
server = None
if role != "a":
    server = RestServer(node, port=0)
    server.start(background=True)  # kicks the boot warmup
    out["warmup_idle"] = node.serving.warmup.wait_idle(timeout=120.0)
    out["warmup"] = node.serving.warmup.stats()["runs"]
l0 = {k: m.LAUNCHES for k, m in mods.items()}
answers, first_ms, lat = [], None, []
for name in spec["indices"]:
    for body in spec["bodies"]:
        t = time.perf_counter()
        r = node.search(name, json.loads(json.dumps(body)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        lat.append(ms)
        if first_ms is None:
            first_ms = ms
        answers.append({"hits": {"total": r["hits"]["total"], "hits": [
            {"_id": h["_id"], "_score": h["_score"]}
            for h in r["hits"]["hits"]]}})
out["launches"] = {k: m.LAUNCHES - l0[k] for k, m in mods.items()}
out["first_ms"] = first_ms
out["latency_ms"] = lat
out["answers"] = answers
rows = node.metrics.summaries().get("estpu_search_duration_seconds", [])
out["labels"] = {}
for r in rows:
    lab = r["labels"]["warmup"]
    out["labels"][lab] = out["labels"].get(lab, 0) + r["count"]
out["events"] = compile_cache.events_snapshot()
out["seconds"] = compile_cache.seconds_snapshot()
out["libraries"] = aot.stats()
out["programs"] = [r for r in programs.REGISTRY.snapshot()
                   if r["program"] != "_other_"]
out["backend"] = programs.backend_fingerprint()
if server is not None:
    server.stop()
node.close()
out["total_s"] = time.perf_counter() - t_start
print("RESULT " + json.dumps(out), flush=True)
"""


def _ws_bodies(np, vecs, seed):
    """WS_MATCH head-term match bodies, WS_KNN brute-force and IVF-PQ knn
    bodies near seeded rows, WS_HYBRID hybrids with a PQ re-rank."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, WS_HEAD + 1) ** 1.1
    p /= p.sum()

    def near():
        q = vecs[int(rng.integers(0, len(vecs)))] \
            + 0.3 * rng.standard_normal(DIMS)
        return [float(x) for x in q.astype(np.float32)]

    def terms():
        return " ".join(f"t{t}" for t in np.unique(
            rng.choice(WS_HEAD, size=int(rng.integers(2, 5)), p=p)))

    out = [{"query": {"match": {"body": terms()}}, "size": 10}
           for _ in range(WS_MATCH)]
    for _ in range(WS_KNN):
        out.append({"query": {"knn": {"field": "emb", "ann": False,
                                      "query_vector": near()}}, "size": 10})
        out.append({"query": {"knn": {"field": "emb", "query_vector": near(),
                                      "num_candidates": 200}}, "size": 10})
    for _ in range(WS_HYBRID):
        out.append({"query": {"hybrid": {
            "query": {"match": {"body": terms()}},
            "knn": {"field": "emb", "query_vector": near(), "k": 10,
                    "num_candidates": 50, "ann": False},
            "fusion": {"method": "rrf", "rank_constant": 60},
            "rerank": {"query_vectors": [near() for _ in range(WS_TOKENS)],
                       "window_size": 10, "pq": True}}}, "size": 10})
    return out


def _ws_run(root, env, role, data, build_dir, spec_path):
    """One 5s process: its RESULT record and its wall seconds."""
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", _WS_CHILD, role, data,
                        build_dir, spec_path], cwd=root, env=env,
                       capture_output=True, text=True, timeout=WS_PROC_S)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    _hold(p.returncode == 0 and line, f"process {role} exited "
          f"{p.returncode}: {p.stderr[-3000:]}", "5s")
    return json.loads(line[-1][len("RESULT "):]), time.perf_counter() - t


def phase_warm(np, card):
    """Phase 5s: (a) a node process builds a mesh index and a host-loop
    index of WS_DOCS docs, serves bodies reaching B1-B4 and closes,
    storing its census and library blobs; (b) a second process over the
    data path with an empty kernel build directory starts its
    RestServer, waits for the boot warmup and answers the same bodies:
    every library from the blob tier (``aot_hit``, ``fresh`` 0), every
    request ``warmup="false"``, the hits (a)'s; (c) a third over a copy
    of the data without the census and with the libraries built: the
    cold first request. Returns the launches of each kernel in the three
    processes."""
    import tempfile

    t_phase = time.perf_counter()
    from elasticsearch_tpu_torch.ops import build
    from elasticsearch_tpu_torch.parallel import aot

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("ESTPU_WARMUP", None)
    docs, vecs = rp_sources(np, WS_DOCS, SEED + 140)
    bodies = _ws_bodies(np, vecs, SEED + 141)
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump({"docs": docs, "bodies": bodies, "mapping": WS_MAPPING,
                       "indices": WS_INDICES}, fh)
        data, cold = os.path.join(tmp, "data"), os.path.join(tmp, "cold")
        a, a_s = _ws_run(root, env, "a", data, build._BUILD_DIR, spec_path)
        ivf = os.path.join(data, "_ivf")
        kso = sorted(f for f in os.listdir(ivf) if f.endswith(".kso"))
        census_files = [f for f in os.listdir(ivf)
                        if f.endswith(".census")]
        _hold(len(kso) == 5 and len(census_files) == 2,
              f"(a) stored {kso} and {census_files}", "5s")
        shutil.copytree(data, cold, ignore=shutil.ignore_patterns(
            "*.census"))
        b, b_s = _ws_run(root, env, "b", data, os.path.join(tmp, "empty"),
                         spec_path)
        c, c_s = _ws_run(root, env, "c", cold, build._BUILD_DIR, spec_path)
    n = len(bodies) * len(WS_INDICES)
    ev = b["events"]
    _hold(ev["aot_hit"] == 5 and ev["fresh"] == 0
          and ev["build_dir_hit"] == 0
          and all(r["source"] == "aot_hit" for r in b["libraries"].values())
          and set(b["libraries"]) == set(build.SOURCES) | {"codec"},
          f"(b) library sources {b['libraries']}, events {ev}", "5s")
    runs = b["warmup"]
    _hold(b["warmup_idle"] and set(runs) == set(WS_INDICES)
          and all(r["status"] == "complete" and r["replayed"] == len(bodies)
                  and r["errors"] == 0 for r in runs.values()),
          f"(b) warmup runs {runs}", "5s")
    _hold(b["labels"] == {"prewarm": n, "false": n},
          f"(b) search labels {b['labels']}", "5s")
    _hold(c["labels"].get("true", 0) >= 1 and "prewarm" not in c["labels"]
          and c["events"]["fresh"] == 0,
          f"(c) search labels {c['labels']}, events {c['events']}", "5s")
    for other, tag in ((b, "b"), (c, "c")):
        for i, (got, want) in enumerate(zip(other["answers"], a["answers"])):
            check_hits(got, want, f"5s({tag}) body {i}")
    launches = {}
    for k in ("bm25_dense_topk", "knn_topk", "adc_scores", "maxsim_adc"):
        each = [x["launches"][k] for x in (a, b, c)]
        _hold(all(each), f"{k} launches {each} in (a), (b), (c)", "5s")
        launches[k] = sum(each)
    _hold(b["backend"].endswith("/n=1") and b["backend"].startswith("cuda/"),
          f"backend {b['backend']}", "5s")
    log(f"[5s] (a) {WS_DOCS} docs in {', '.join(WS_INDICES)} (the mesh, 2 "
        f"slots; the host loop), {n} bodies (B1 {a['launches']['bm25_dense_topk']}"
        f", B2 {a['launches']['knn_topk']}, B3 {a['launches']['adc_scores']}, "
        f"B4 {a['launches']['maxsim_adc']} launches); close stored "
        f"{len(kso)} library blobs and {len(census_files)} censuses "
        f"({a_s:.1f} s); its libraries {a['events']}")
    log(f"[5s] (b) restart, empty build directory: events "
        f"{dict((k, v) for k, v in ev.items() if v)}, warmup replayed "
        f"{sum(r['replayed'] for r in runs.values())} bodies in "
        f"{sum(r['took_ms'] for r in runs.values()):.1f} ms; labels "
        f"{b['labels']}; hits equal (a)'s ({b_s:.1f} s)")
    log(f"[5s] (c) restart, libraries built, no census: labels "
        f"{c['labels']}; hits equal (a)'s ({c_s:.1f} s)")
    for tag, x in (("warmed (b)", b), ("cold (c)", c)):
        log(f"[5s] first request {tag}: {x['first_ms']:.3f} ms; p50 of the "
            f"{n} requests {_p50(np, np.asarray(x['latency_ms']))}; node open "
            f"{x['open_s']:.3f} s")
    built = aot.stats()
    for name in sorted(b["libraries"]):
        rec = built.get(name, {})
        build_s = (f"{rec['seconds']:.3f} s (phase 2)"
                   if rec.get("source") == "fresh" else
                   f"not measured ({rec.get('source', 'not loaded')} in "
                   f"this process)")
        log(f"[5s] library {name}: load from the blob tier "
            f"{b['libraries'][name]['seconds'] * 1e3:.3f} ms (b), from the "
            f"build directory {c['libraries'][name]['seconds'] * 1e3:.3f} "
            f"ms (c); build {build_s}")
    for tag, x in (("b", b), ("c", c)):
        for r in x["programs"]:
            log(f"[5s] ({tag}) {r['program']} {r['shapes']}: first call "
                f"{r['compile_seconds'] * 1e3:.3f} ms ({r['compiles']}), "
                f"execute p50 {r['execute_p50_seconds'] * 1e3:.3f} ms over "
                f"{r['calls']}, cache {r['cache_sources'] or '-'}")
    log(f"[5s] phase 5s took {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


CL_MEMBERS = 3             # (a): launcher processes on the one card
CL_SHARDS = 3              # (b): one primary and one replica a member
CL_REPLICAS = 1
CL_DOCS = 1 << 12          # (b): 5h's log recipe (cut from 2^16, PERF.md §6)
CL_BULK = 4096             # (b): docs a _bulk request
CL_BODIES = 64             # (c): match and bool bodies a coordinator
CL_HEAD = 32               # (c): body terms from t0..t31, B1's dense rows
CL_KILL_BULK = 64          # (d): docs a _bulk request while the master dies
CL_KILL_REQS = 48          # (d): such requests, through one survivor
CL_SAMPLED = 64            # (d): acknowledged ids read back by GET
CL_HBM_BYTES = 8 << 30     # each member's ESTPU_HBM_BYTES: three fit the card
CL_DEVICE = "cuda"
CL_BOOT_S = 180.0          # (a): every member bound and joined
CL_ELECT_S = 60.0          # (d): the survivors' new master
CL_MAPPING = WP_MAPPING

#: a bulk client in a process of its own: one keep-alive connection
#: sends ``[path, ndjson]`` requests in order and writes, per request,
#: its latency, status and the ids its items acknowledged; a line on
#: stdout after each request lets the caller act mid-stream
_CL_BULK = r"""
import http.client, json, sys, time
port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3]
with open(src) as f:
    reqs = json.load(f)
out, t0 = [], time.perf_counter()
c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
for path, body in reqs:
    t = time.perf_counter()
    try:
        c.request("POST", path, body=body,
                  headers={"Content-Type": "application/x-ndjson"})
        r = c.getresponse()
        data = json.loads(r.read())
        st = r.status
    except Exception as e:
        c.close()
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, data = 0, {"error": str(e)}
    acked = [it[op]["_id"] for it in data.get("items", [])
             for op in it if it[op].get("status") in (200, 201)]
    out.append([time.perf_counter() - t, st, acked])
    print(len(out), flush=True)
c.close()
with open(dst, "w") as f:
    json.dump({"wall": time.perf_counter() - t0, "reqs": out}, f)
"""


def _cl_free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cl_bulk_client(port, reqs, d, name):
    """Start ``_CL_BULK`` over ``reqs`` [(path, ndjson)]; (process, the
    file its answer lands in)."""
    src, dst = os.path.join(d, f"{name}.in"), os.path.join(d, f"{name}.out")
    with open(src, "w") as f:
        json.dump(reqs, f)
    proc = subprocess.Popen([sys.executable, "-c", _CL_BULK, str(port), src,
                             dst], stdout=subprocess.PIPE, text=True)
    return proc, dst


def _cl_bulk_requests(docs, index, per):
    return [("/_bulk", _nd(x for d, src in docs[i: i + per]
                            for x in ({"index": {"_index": index,
                                                 "_id": d}}, src)))
            for i in range(0, len(docs), per)]


def _cl_members(card):
    """(a): the members, started together; [(process, http, role,
    transport address, queue of (arrival, line) of its output)] once
    each has joined and bound."""
    import queue
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ESTPU_HBM_BYTES=str(CL_HBM_BYTES),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    rendezvous, transport = _cl_free_port(), _cl_free_port()
    procs = []
    for rank in range(CL_MEMBERS):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "elasticsearch_tpu_torch.server",
             "--device", CL_DEVICE, "--port", "0", "--name",
             f"member{rank}", "--coordinator", f"127.0.0.1:{rendezvous}",
             "--num-processes", str(CL_MEMBERS), "--process-id", str(rank),
             "--transport-port", str(transport)],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    members = []
    try:
        deadline = time.monotonic() + CL_BOOT_S
        for proc in procs:
            # every line the member prints, stamped on arrival: (d)
            # reads its fault detection and election from them
            q: "queue.Queue[tuple]" = queue.Queue()
            threading.Thread(target=lambda p=proc, q=q: [
                q.put((time.monotonic(), x)) for x in p.stdout],
                daemon=True).start()
            role = addr = port = None
            seen = []
            while port is None:
                try:
                    _, line = q.get(timeout=max(0.1,
                                                deadline - time.monotonic()))
                except queue.Empty:
                    raise AssertionError(f"5q(a): a member did not join and "
                                         f"bind in {CL_BOOT_S} s: {seen}")
                seen.append(line.rstrip())
                m = re.search(r"joined cluster as (\w+) .*transport "
                              r"([\d.]+:\d+)", line)
                if m:
                    role, addr = m.group(1), m.group(2)
                m = re.search(r"listening on http://127\.0\.0\.1:(\d+) "
                              r"\(device (\S+)\)", line)
                if m:
                    port = int(m.group(1))
                    _hold(m.group(2).startswith(CL_DEVICE),
                          f"(a) a member serves from {m.group(2)}", "5q")
            members.append((proc, _Rest(port), role, addr, q))
    except BaseException:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        raise
    return members


def _cl_metric(http, family, label) -> float:
    st, _, text = http("GET", "/_prometheus/metrics")
    return sum(float(x.rsplit(" ", 1)[1]) for x in text.splitlines()
               if x.startswith(family + "{") and label in x)


def _cl_b1(http) -> dict:
    """Each member's B1 launches, from its own ``_nodes/stats`` (one
    coordinator's ``_nodes/stats`` merges the members' own answers)."""
    st, _, ns = http("GET", "/_nodes/stats")
    return {nid: x["indices"]["search"]["launches"]["bm25_dense_topk"]
            for nid, x in ns["nodes"].items()}


def _cl_same_ranking(got, want, body) -> float:
    """The cluster's page against one node's deeper page of the same
    body: the same score at every rank (at B1's bf16 band), and at each
    rank an id from the node's group of docs with that exact score. Docs
    tied on the score rank by their order within the shard, which is the
    order they were indexed in: the cluster's three coordinators index
    concurrently, so its ties may come in another order. Returns the
    worst relative score difference."""
    worst, i = 0.0, 0
    _hold(len(got) <= len(want), f"(c) {len(got)} hits against "
          f"{len(want)} for {body}", "5q")
    for x, y in zip(got, want):
        worst = max(worst, abs(x["_score"] - y["_score"])
                    / abs(y["_score"]))
    while i < len(got):
        j = i
        while j < len(want) and want[j]["_score"] == want[i]["_score"]:
            j += 1
        group = {y["_id"] for y in want[i:j]}
        _hold({x["_id"] for x in got[i:j]} <= group,
              f"(c) ranks {i}-{j - 1} of {body}: "
              f"{[x['_id'] for x in got[i:j]]} not among {sorted(group)}",
              "5q")
        i = j
    _hold(worst <= 2.0 ** -7, f"(c) score band {worst} for {body}", "5q")
    return worst


def _cl_bodies(np, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, CL_HEAD + 1) ** 1.1
    p /= p.sum()
    out = []
    for i in range(CL_BODIES):
        terms = " ".join(f"t{t}" for t in np.unique(
            rng.choice(CL_HEAD, size=int(rng.integers(2, 5)), p=p)))
        if i % 4 == 3:
            lo = int(rng.integers(0, 500_000))
            out.append({"query": {"bool": {
                "must": [{"match": {"body": terms}}],
                "filter": [{"range": {"n": {"gte": lo,
                                            "lt": lo + 400_000}}}]}},
                "size": 10})
        else:
            out.append({"query": {"match": {"body": terms}}, "size": 10})
    return out


def phase_cluster(torch, np, dev, card):
    """Phase 5q (module docstring); returns the B1 launches of the three
    members' processes over (c), read from their own ``_nodes/stats``,
    and of this process's in-process node."""
    import signal
    import tempfile

    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import bm25_topk

    t_phase = time.perf_counter()
    t = time.perf_counter()
    members = _cl_members(card)
    boot_s = time.perf_counter() - t
    try:
        https = [m[1] for m in members]
        roles = [m[2] for m in members]
        _hold(roles == ["master"] + ["data"] * (CL_MEMBERS - 1),
              f"(a) roles {roles}", "5q")
        health = [h("GET", "/_cluster/health")[2] for h in https]
        _hold(all(x["number_of_nodes"] == CL_MEMBERS and x["term"] == 1
                  and x["master_node"] == health[0]["master_node"]
                  and not x["no_master_block"] for x in health),
              f"(a) health {health}", "5q")
        st, _, _ = https[1]("PUT", "/cl", {"settings": {
            "number_of_shards": CL_SHARDS,
            "number_of_replicas": CL_REPLICAS}, "mappings": CL_MAPPING})
        _hold(st == 200, f"(b) the create answered {st}", "5q")
        versions = [h("GET", "/_cluster/state/version,master_node")[2]
                    for h in https]
        _hold(len({(v["version"], v["master_node"]) for v in versions}) == 1,
              f"(a) state versions {versions}", "5q")

        # (b) the bulk, one client process a coordinator, all at once
        docs = wp_docs(np, CL_DOCS, SEED + 120)
        tx0 = sum(_cl_metric(h, "estpu_transport_bytes_total", "tx")
                  for h in https)
        third = -(-CL_DOCS // CL_MEMBERS)
        with tempfile.TemporaryDirectory() as d:
            t = time.perf_counter()
            clients = [_cl_bulk_client(
                h.port, _cl_bulk_requests(
                    docs[i * third: (i + 1) * third], "cl", CL_BULK), d,
                f"b{i}") for i, h in enumerate(https)]
            outs = []
            for proc, dst in clients:
                proc.stdout.read()
                _hold(proc.wait(timeout=900) == 0, "(b) a bulk client "
                      "failed", "5q")
                with open(dst) as f:
                    outs.append(json.load(f))
            bulk_s = time.perf_counter() - t
        acked = [x for o in outs for r in o["reqs"] for x in r[2]]
        _hold(len(acked) == CL_DOCS and all(r[1] == 200 for o in outs
                                            for r in o["reqs"]),
              f"(b) {len(acked)} of {CL_DOCS} docs acknowledged", "5q")
        t = time.perf_counter()
        st, _, _ = https[0]("POST", "/cl/_refresh")
        refresh_ms = (time.perf_counter() - t) * 1e3
        tx = sum(_cl_metric(h, "estpu_transport_bytes_total", "tx")
                 for h in https) - tx0
        st, _, cnt = https[2]("POST", "/cl/_count", {"query": {
            "match_all": {}}})
        _hold(st == 200 and cnt["count"] == CL_DOCS,
              f"(b) count {cnt}", "5q")

        # (c) the same bodies to every coordinator, against one node
        bodies = _cl_bodies(np, SEED + 121)
        b1_before = _cl_b1(https[0])
        raws, lat = [], []
        for h in https:
            got, ms = [], []
            for b in bodies:
                t = time.perf_counter()
                st, raw, _ = h("POST", "/cl/_search", b)
                ms.append((time.perf_counter() - t) * 1e3)
                _hold(st == 200, f"(c) a search answered {st}", "5q")
                got.append(_TOOK.sub(b'"took": 0', raw))
            raws.append(got)
            lat.append(np.asarray(ms))
        b1_after = _cl_b1(https[0])
        _hold(len(b1_after) == CL_MEMBERS, f"(c) _nodes/stats lists "
              f"{sorted(b1_after)}", "5q")
        b1_members = [b1_after[k] - b1_before[k] for k in sorted(b1_after)]
        _hold(all(r == raws[0] for r in raws[1:]),
              "(c) the coordinators' answers differ", "5q")
        _hold(all(b > 0 for b in b1_members),
              f"(c) B1 launches a member {b1_members}", "5q")
        b1_self = bm25_topk.LAUNCHES
        node = Node(name="cl-single", device=dev)
        try:
            node.create_index("cl", {"settings": {
                "number_of_shards": CL_SHARDS, "number_of_replicas": 0},
                "mappings": CL_MAPPING})
            for i in range(0, CL_DOCS, CL_BULK):
                node.bulk([x for d, src in docs[i: i + CL_BULK]
                           for x in ({"index": {"_index": "cl", "_id": d}},
                                     src)])
            node.refresh("cl")
            one_ms, worst = [], 0.0
            for b, raw in zip(bodies, raws[0]):
                t = time.perf_counter()
                want = node.search("cl", dict(b))
                torch.cuda.synchronize()
                one_ms.append((time.perf_counter() - t) * 1e3)
                # a deeper page of the same body: a tie across the
                # page's end may rank either of its docs first
                deep = node.search("cl", dict(b, size=b["size"] + 32))
                got = json.loads(raw)
                _hold(got["hits"]["total"] == want["hits"]["total"],
                      f"(c) totals {got['hits']['total']} and "
                      f"{want['hits']['total']} for {b}", "5q")
                worst = max(worst, _cl_same_ranking(
                    got["hits"]["hits"], deep["hits"]["hits"], b))
        finally:
            node.close()
        b1_self = bm25_topk.LAUNCHES - b1_self
        one_ms = np.asarray(one_ms)
        # the support bundle merges every member's part
        t = time.perf_counter()
        st, raw, diag = https[2]("GET", "/_cluster/diagnostics")
        diag_ms = (time.perf_counter() - t) * 1e3
        _hold(st == 200 and diag["_nodes"] == {
            "total": CL_MEMBERS, "successful": CL_MEMBERS, "failed": 0}
              and len(diag["nodes"]) == CL_MEMBERS and all(
                  {"flight", "watchdog", "incidents", "hot_threads",
                   "programs"} <= set(x) for x in diag["nodes"].values()),
              f"(c) /_cluster/diagnostics answered {st} with "
              f"{diag.get('_nodes')}", "5q")

        # (d) the master killed while a survivor streams _bulk
        kill_docs = wp_docs(np, CL_KILL_BULK * CL_KILL_REQS, SEED + 122,
                            start=CL_DOCS)
        old_master = health[0]["master_node"]
        with tempfile.TemporaryDirectory() as d:
            proc, dst = _cl_bulk_client(
                https[1].port, _cl_bulk_requests(kill_docs, "cl",
                                                 CL_KILL_BULK), d, "kill")
            for _ in range(CL_KILL_REQS // 4):
                proc.stdout.readline()
            members[0][0].send_signal(signal.SIGKILL)
            t = time.perf_counter()
            t_kill = time.monotonic()
            members[0][0].wait()
            elect_s = None
            while time.perf_counter() - t < CL_ELECT_S:
                h = https[1]("GET", "/_cluster/health")[2]
                if h["term"] >= 2 and h["master_node"] not in (
                        None, old_master):
                    elect_s = time.perf_counter() - t
                    break
                time.sleep(0.05)
            _hold(elect_s is not None, f"(d) no new master in "
                  f"{CL_ELECT_S} s: {h}", "5q")
            proc.stdout.read()
            _hold(proc.wait(timeout=600) == 0, "(d) the bulk client failed",
                  "5q")
            with open(dst) as f:
                kill_out = json.load(f)
        acked_d = [x for r in kill_out["reqs"] for x in r[2]]
        # the survivors' own account, stamped on arrival: when each
        # declared the master dead, when the election ended
        events = []
        for _, _, _, _, q in members[1:]:
            while not q.empty():
                at, line = q.get()
                if re.search(r"failed fault detection|elected master|"
                             r"stepping down", line):
                    events.append(f"{at - t_kill:+.3f} s {line.strip()}")
        survivors = https[1:]
        health_d = [h("GET", "/_cluster/health")[2] for h in survivors]
        # the new master's flight recorder holds its election
        flights = [h("GET", "/_nodes/_local/flight")[2]["flight"]
                   for h in survivors]
        elected = [e for f in flights
                   if f["node"] == health_d[0]["master_node"]
                   for e in f["rings"]["cluster"]
                   if e.get("event") == "elected"]
        _hold(elected and elected[-1]["term"] == health_d[0]["term"],
              f"(d) the new master's cluster ring {elected}", "5q")
        _hold(all(x["term"] == health_d[0]["term"] >= 2
                  and x["master_node"] == health_d[0]["master_node"]
                  and x["number_of_nodes"] == CL_MEMBERS - 1
                  for x in health_d), f"(d) survivors' health {health_d}",
              "5q")
        st, _, _ = survivors[0]("POST", "/cl/_refresh")
        st, _, cnt = survivors[1]("POST", "/cl/_count", {"query": {
            "match_all": {}}})
        want_n = CL_DOCS + len(acked_d)
        _hold(st == 200 and cnt["count"] == want_n,
              f"(d) count {cnt} after {len(acked_d)} acknowledged of "
              f"{len(kill_docs)}", "5q")
        every = sorted(set(acked) | set(acked_d))
        rng = np.random.default_rng(SEED + 123)
        sample = sorted(rng.choice(every, CL_SAMPLED, replace=False))
        src_of = dict(docs + kill_docs)
        for doc_id in sample:
            st, _, got = survivors[1]("GET", f"/cl/_doc/{doc_id}")
            _hold(st == 200 and got["found"]
                  and got["_source"] == src_of[doc_id],
                  f"(d) GET of acknowledged id {doc_id} answered {st}",
                  "5q")
        t = time.perf_counter()
        for proc, *_ in members[1:]:
            proc.send_signal(signal.SIGTERM)
        codes = [proc.wait(timeout=60) for proc, *_ in members[1:]]
        stop_s = time.perf_counter() - t
        _hold(codes == [0] * (CL_MEMBERS - 1), f"(d) SIGTERM: exits {codes}",
              "5q")
    finally:
        for proc, *_ in members:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cl = np.concatenate(lat)
    log(f"[5q] (a) {CL_MEMBERS} members of python -m "
        f"elasticsearch_tpu_torch.server --device {CL_DEVICE} on {card} "
        f"joined and bound in {boot_s:.3f} s: one master, "
        f"{CL_MEMBERS} nodes, term 1 and state version "
        f"{versions[0]['version']} on each")
    log(f"[5q] (b) _bulk of {CL_DOCS} docs into {CL_SHARDS} shards x "
        f"{1 + CL_REPLICAS} copies through {CL_MEMBERS} coordinators at "
        f"once: {bulk_s:.3f} s ({CL_DOCS / bulk_s:.1f} docs/s), refresh "
        f"{refresh_ms:.3f} ms; transport bytes sent {tx:.0f} "
        f"({tx / CL_DOCS:.1f} a doc)")
    log(f"[5q] (c) {CL_BODIES} match/bool bodies to each coordinator: "
        f"byte-equal across the {CL_MEMBERS}, equal to one in-process node "
        f"(ids, order, totals; worst score rel {worst:.3e}); p50/p99 "
        f"{_pcts(np, cl)} over HTTP against {_pcts(np, one_ms)} in "
        f"process on one node; B1 launches a member {b1_members} (their "
        f"_nodes/stats), {b1_self} in the one node; /_cluster/diagnostics "
        f"merged {CL_MEMBERS} members' parts ({len(raw)} bytes) in "
        f"{diag_ms:.3f} ms")
    log(f"[5q] (d) master SIGKILLed after {CL_KILL_REQS // 4} of "
        f"{CL_KILL_REQS} _bulk requests: a new master at term "
        f"{health_d[0]['term']} in {elect_s:.3f} s; "
        f"{len(acked_d)} of {len(kill_docs)} docs acknowledged, all "
        f"{want_n} acknowledged docs counted and {CL_SAMPLED} sampled ids "
        f"read back; the new master's flight ring holds its election at "
        f"term {elected[-1]['term']}; SIGTERM to exit 0 in {stop_s:.3f} s; "
        f"phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for e in events:
        log(f"[5q] (d) after the SIGKILL: {e}")
    return sum(b1_members) + b1_self


# ---------------------------------------------------------------------------
# phase 5t: the dual encoder (ROADMAP A12)
# ---------------------------------------------------------------------------

EN_BATCH = 4096            # (a): passages an encode call
EN_TOK_CHECK = 1024        # (a): passages tokenized both ways
EN_CPU_CHECK = 256         # (a): passages encoded on the CPU too
EN_LONG = 4096             # (c): the ring's max_len
EN_SLOTS = 8               # (c): sequence slots
EN_LONG_ROWS = (4096, 3000, 2049, 1000)  # (c): the rows' lengths
EN_PAIRS = 64              # (d): (query, passage) pairs a step
EN_STEPS = 20              # (d): train steps
EN_QUERY_SPAN = (8, 40)    # (d): a pair's query is this span of its passage
EN_MAPPING = {"properties": {  # dims: the default config's embed_dim
    "emb": {"type": "dense_vector", "dims": 128, "similarity": "cosine"}}}


def en_token_table(np, cfg, vocab):
    """Term id -> the tokenizer's bucket of the term's text ``t<id>``,
    built once with ``SimpleTokenizer``'s crc32 rule."""
    from elasticsearch_tpu_torch.models import SimpleTokenizer

    tok = SimpleTokenizer(cfg)
    return np.array([tok.bucket(f"t{t}") for t in range(vocab)], np.int32)


def en_passage_ids(np, doc_len, terms, table, L):
    """[n, L] bucket ids and f32 mask of every passage, cut at L tokens."""
    n = doc_len.shape[0]
    start = np.zeros(n + 1, np.int64)
    start[1:] = np.cumsum(doc_len)
    doc = np.repeat(np.arange(n), doc_len)
    pos = np.arange(terms.shape[0]) - start[doc]
    keep = pos < L
    ids = np.zeros((n, L), np.int32)
    ids[doc[keep], pos[keep]] = table[terms[keep]]
    mask = (np.arange(L)[None, :] < np.minimum(doc_len, L)[:, None]).astype(
        np.float32)
    return ids, mask, start


def _en_timed(torch, fn, reps=3):
    """(result, median ms of ``reps`` runs after a warm one, peak bytes
    allocated above the entry's allocation)."""
    out = fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return out, sorted(ms)[reps // 2], torch.cuda.max_memory_allocated() - base


def _en_profile(torch, fn) -> str:
    """One call of ``fn`` under the profiler: its host ms there, the
    device ms, the kernels launched, the GEMMs' share and the top
    kernels by device time."""
    for _ in range(2):  # a session that records nothing is tried again
        with _profiled(torch, cpu=True) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rows = _device_rows(prof)
        dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
        if dev_ms > 0:
            break
    else:
        return "device time not measured (the profiler recorded none twice)"
    gemm = sum(e.self_device_time_total for e in rows if any(
        g in e.key.lower() for g in ("gemm", "nvjet", "xmma", "cutlass"))
    ) / 1e3
    n = sum(e.count for e in rows if not e.key.startswith(("Memcpy",
                                                           "Memset")))
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:4]
    return (f"{dev_ms:.3f} ms of device time in {wall:.3f} ms under the "
            f"profiler ({100 * dev_ms / wall:.1f}% busy), {n} kernels, "
            f"GEMMs {gemm:.3f} ms ({100 * gemm / dev_ms:.1f}%); top: "
            + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}"
                        f" ms x{e.count}" for e in top))


def phase_encoder(torch, np, dev, card, corpus_df):
    """Phase 5t (module docstring); returns B2's launches on the encoded
    index and what phase 5v reuses: the config, (d)'s batch, first loss
    and steps/s, (c)'s long rows, one-device ring and dense embeddings
    and the ring's ms."""
    from elasticsearch_tpu_torch import Node
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays
    from elasticsearch_tpu_torch.models import (DualEncoderConfig,
                                                SimpleTokenizer, encode,
                                                init_params, make_train_step)
    from elasticsearch_tpu_torch.models.ring_encoder import (build_sp_mesh,
                                                             ring_encode)
    from elasticsearch_tpu_torch.ops import knn_topk
    from elasticsearch_tpu_torch.search import queries

    t_phase = time.perf_counter()
    cfg = DualEncoderConfig()
    L = cfg.max_len

    # (a) phase 5's passages through the tokenizer's table, then encoded
    t = time.perf_counter()
    doc_len, terms = corpus_tokens(np, N_DOCS, VOCAB, SEED)
    table = en_token_table(np, cfg, VOCAB)
    ids, mask, start = en_passage_ids(np, doc_len, terms, table, L)
    texts = [" ".join(f"t{x}" for x in terms[start[d]:start[d + 1]])
             for d in range(EN_TOK_CHECK)]
    want_ids, want_mask = SimpleTokenizer(cfg)(texts)
    _hold(np.array_equal(ids[:EN_TOK_CHECK], want_ids)
          and np.array_equal(mask[:EN_TOK_CHECK], want_mask),
          "(a) the term table's ids differ from SimpleTokenizer's", "5t")
    n_tok = int(np.minimum(doc_len, L).sum())
    log(f"[5t] (a) {N_DOCS} passages cut at {L} tokens ({n_tok} "
        f"tokens, {int((doc_len > L).sum())} cut) through a {VOCAB}-term "
        f"bucket table in {time.perf_counter() - t:.1f} s; the first "
        f"{EN_TOK_CHECK} equal SimpleTokenizer's ids and mask")
    model = init_params(cfg, seed=0, device=dev)
    _hold(model.device.type == "cuda", f"(a) the model is on {model.device}",
          "5t")
    ids_d = torch.from_numpy(ids).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    emb = torch.empty((N_DOCS, cfg.embed_dim), dtype=torch.float32,
                      device=dev)
    encode(model, ids_d[:EN_BATCH], mask_d[:EN_BATCH])  # first touch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for a in range(0, N_DOCS, EN_BATCH):
        emb[a:a + EN_BATCH] = encode(model, ids_d[a:a + EN_BATCH],
                                     mask_d[a:a + EN_BATCH])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    _hold(bool(torch.isfinite(emb).all()) and float(
        (torch.linalg.norm(emb, dim=1) - 1).abs().max()) < 1e-3,
          "(a) embeddings not finite and unit-norm", "5t")
    cpu = encode(init_params(cfg, seed=0, device="cpu"),
                 ids[:EN_CPU_CHECK], mask[:EN_CPU_CHECK]).numpy()
    cos = np.sum(cpu * emb[:EN_CPU_CHECK].cpu().numpy(), axis=1)
    _hold(bool(np.all(cos > 0.999)), f"(a) card vs CPU cosine {cos.min()}",
          "5t")
    log(f"[5t] (a) encode on {card}: {N_DOCS} passages in "
        f"{N_DOCS // EN_BATCH} calls of {EN_BATCH} in {enc_s * 1e3:.1f} ms: "
        f"{N_DOCS / enc_s:.1f} passages/s, {n_tok / enc_s:.1f} "
        f"tokens/s ({N_DOCS * L / enc_s:.1f} with the padding); peak "
        f"{peak / 2**20:.1f} MiB allocated above the inputs and outputs' "
        f"{base / 2**20:.1f}; {EN_CPU_CHECK} passages against the CPU "
        f"encode: cosine >= {cos.min():.6f}")
    log(f"[5t] (a) one call of {EN_BATCH}: " + _en_profile(
        torch, lambda: encode(model, ids_d[:EN_BATCH], mask_d[:EN_BATCH])))
    del ids_d, mask_d

    # (b) the embeddings as a one-shard cosine dense_vector index, knn k=10
    t = time.perf_counter()
    vecs = emb.cpu().numpy()
    del emb
    exists = np.ones(N_DOCS, bool)
    node = Node(name="encoded", device=dev)
    node.create_index("passages", {"settings": {"number_of_shards": 1},
                                   "mappings": EN_MAPPING})
    node.get_index("passages").shards[0].engine.add_segment(
        segment_from_arrays({
            "num_docs": N_DOCS, "max_docs": N_DOCS,
            "vectors": {"emb": {"vecs": vecs, "exists": exists,
                                "dims": cfg.embed_dim,
                                "similarity": "cosine"}}},
            node.residency))
    qterms = make_queries(np, N_QUERIES, VOCAB, corpus_df, SEED)
    q_ids, q_mask = SimpleTokenizer(cfg)([" ".join(f"t{x}" for x in q)
                                          for q in qterms])
    qv = encode(model, q_ids, q_mask).cpu().numpy()
    bodies = [{"query": {"knn": {"field": "emb", "k": 10,
                                 "query_vector": [float(x) for x in v]}},
               "size": 10} for v in qv]
    node.search("passages", copy.deepcopy(bodies[0]))  # first-use set-up
    setup_s = time.perf_counter() - t
    knn_topk.LAUNCHES = 0
    got, ms, per = [], [], []
    for body in bodies:
        n0 = knn_topk.LAUNCHES
        body = copy.deepcopy(body)
        t = time.perf_counter()
        got.append(node.search("passages", body))
        ms.append((time.perf_counter() - t) * 1e3)
        per.append(knn_topk.LAUNCHES - n0)
    b2 = knn_topk.LAUNCHES
    _hold(per == [1] * len(bodies), f"(b) B2 launches a query {per}", "5t")
    ids10, sc10, full = exact_cosine_top(np, vecs, exists, qv, 10)
    for n, r in enumerate(got):
        _hold(r["hits"]["total"] == 100, f"(b) query {n} total "
              f"{r['hits']['total']}", "5t")
        check_oracle(np, r, ids10[n], sc10[n], full[n], f"5t(b) query {n}")
    real = queries.knn_topk
    queries.knn_topk = functools.partial(real, plain=True)
    try:
        for n, body in enumerate(bodies):
            twin = node.search("passages", copy.deepcopy(body))
            _hold(twin["hits"] == got[n]["hits"],
                  f"(b) query {n} differs on B2's twin", "5t")
    finally:
        queries.knn_topk = real
    node.close()
    del node, vecs, full
    torch.cuda.empty_cache()
    ms = np.array(ms)
    log(f"[5t] (b) {N_QUERIES} encoded queries as knn k=10 through "
        f"Node.search over the {N_DOCS} x {cfg.embed_dim} encoded passages "
        f"on {card}: p50 {np.percentile(ms, 50):.3f} ms, p99 "
        f"{np.percentile(ms, 99):.3f} ms; B2 launched {b2} times, once a "
        f"query; hits match the exact f64 oracle and equal B2's twin's bit "
        f"for bit; set-up {setup_s:.1f} s")

    # (c) the ring encode at max_len 4096 over 8 slots against dense
    lcfg = DualEncoderConfig(max_len=EN_LONG)
    lmodel = init_params(lcfg, seed=0, device=dev)
    B = len(EN_LONG_ROWS)
    lids = np.zeros((B, EN_LONG), np.int32)
    lmask = np.zeros((B, EN_LONG), np.float32)
    for r, n in enumerate(EN_LONG_ROWS):
        lids[r, :n] = table[terms[r * EN_LONG:r * EN_LONG + n]]
        lmask[r, :n] = 1.0
    lids_d = torch.from_numpy(lids).to(dev)
    lmask_d = torch.from_numpy(lmask).to(dev)
    mesh = build_sp_mesh(EN_SLOTS, dev)
    dense, dense_ms, dense_peak = _en_timed(
        torch, lambda: encode(lmodel, lids_d, lmask_d))
    ring, ring_ms, ring_peak = _en_timed(
        torch, lambda: ring_encode(lcfg, lmodel, lids_d, lmask_d, mesh))
    cos = (dense * ring).sum(1).cpu().numpy()
    _hold(bool(np.all(cos > 0.999)), f"(c) ring vs dense cosine {cos}", "5t")
    en = {"cfg": cfg, "lcfg": lcfg, "lids": lids, "lmask": lmask,
          "ring": ring.cpu().numpy(), "dense": dense.cpu().numpy(),
          "ring_ms": ring_ms}
    log(f"[5t] (c) max_len {EN_LONG}, B={B} rows of {list(EN_LONG_ROWS)} "
        f"tokens on {card}: dense {dense_ms:.3f} ms, peak "
        f"{dense_peak / 2**20:.1f} MiB allocated; ring over {EN_SLOTS} "
        f"slots {ring_ms:.3f} ms, peak {ring_peak / 2**20:.1f} MiB; "
        f"cosine ring vs dense >= {cos.min():.6f}")
    log("[5t] (c) one ring encode: " + _en_profile(
        torch, lambda: ring_encode(lcfg, lmodel, lids_d, lmask_d, mesh)))
    del lmodel, lids_d, lmask_d, dense, ring
    torch.cuda.empty_cache()

    # (d) 20 contrastive steps on one batch of (span, passage) pairs
    t = time.perf_counter()
    step, _opt = make_train_step(cfg, lr=1e-3, device=dev)
    setup_s = time.perf_counter() - t
    a, b = EN_QUERY_SPAN
    d_ids, d_mask = ids[:EN_PAIRS], mask[:EN_PAIRS]
    q_ids = np.zeros_like(d_ids)
    q_mask = np.zeros_like(d_mask)
    q_ids[:, :b - a] = d_ids[:, a:b]
    q_mask[:, :b - a] = d_mask[:, a:b]
    batch = tuple(torch.from_numpy(x).to(dev)
                  for x in (q_ids, q_mask, d_ids, d_mask))
    t = time.perf_counter()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    losses += [step(*batch) for _ in range(EN_STEPS - 1)]
    torch.cuda.synchronize()
    steady = (EN_STEPS - 1) / (time.perf_counter() - t)
    losses = [float(x) for x in losses]
    _hold(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(d) losses {losses}", "5t")
    log(f"[5t] (d) {EN_STEPS} train steps at B={EN_PAIRS} pairs, L={L}, "
        f"bf16, on {card}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; model "
        f"and optimizer set up in {setup_s:.1f} s, first step "
        f"{first_ms:.1f} ms, then {steady:.2f} steps/s "
        f"({steady * EN_PAIRS:.1f} pairs/s)")
    log("[5t] (d) one train step: " + _en_profile(torch, lambda: step(*batch)))
    log(f"[5t] phase 5t took {time.perf_counter() - t_phase:.1f} s")
    en.update(batch=batch, first_loss=losses[0], steps_s=steady)
    return b2, en


EN_MESH_NAMED = 8          # 5v: mesh devices on a machine with one card
EN_PARITY_STEPS = 3        # 5v(b): f32 steps under each mesh
EN_FLOOR_SHARE = 0.1       # 5v(b): most entries left to the losses


def _en_peaks(torch, devs) -> str:
    """Each distinct card's peak allocated bytes since the last reset."""
    return ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2**20:.1f}"
                     f" MiB" for d in sorted({str(d) for d in devs}))


def _en_reset_peaks(torch, devs) -> None:
    for d in {str(d) for d in devs}:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)


def _en_sync(torch, sharded, one) -> None:
    """Set every shard's parameters to the one-device step's (not the
    AdamW moments, which each side keeps): 5v(b) holds each step's
    update, free of the drift that free-running steps grow from
    reordered sums (an entry whose gradient's sign rounding flips takes
    Adam's opposite first step, and that perturbs every later
    gradient)."""
    params = dict(one.model.named_parameters())
    tp = sharded.mesh.tp
    with torch.no_grad():
        for row in sharded.shards:
            for r, sh in enumerate(row):
                for name, leaf in sh.items():
                    d = sharded.dims[name]
                    p = params[name]
                    leaf.copy_(p if d is None else torch.chunk(p, tp, d)[r])


def _en_mesh_grads(torch, sharded) -> dict:
    """The mesh step's summed gradients gathered whole on its first
    device: group 0's slices concatenated in rank order."""
    out = {}
    for name, d in sharded.dims.items():
        row = sharded.shards[0]
        out[name] = row[0][name].grad if d is None else torch.cat(
            [sh[name].grad.to(sharded.mesh.device) for sh in row], d)
    return out


def phase_encoder_mesh(torch, np, dev, card, en) -> None:
    """Phase 5v (module docstring): training and the ring across devices,
    on 5t's config, token table, batch and long rows (``en``)."""
    import dataclasses

    from elasticsearch_tpu_torch.models import init_params, make_train_step
    from elasticsearch_tpu_torch.models.ring_encoder import (build_sp_mesh,
                                                             ring_encode)
    from elasticsearch_tpu_torch.parallel.mesh import training_mesh

    t_phase = time.perf_counter()
    cfg, batch = en["cfg"], en["batch"]

    # (a) the device list and the mesh over it
    n = torch.cuda.device_count()
    if n >= 2:
        devs, form = [f"cuda:{i}" for i in range(n)], f"every card ({n})"
    else:
        devs = [str(dev)] * EN_MESH_NAMED
        form = f"one card named {EN_MESH_NAMED} times (the machine has one)"
    mesh = training_mesh(len(devs), device=devs)
    log(f"[5v] (a) {form}: device list {', '.join(devs)}; "
        f"training_mesh({len(devs)}) = {mesh.shape}, its positions on "
        f"{len(set(map(str, mesh.devices)))} distinct card(s); "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # (b) f32 parity: the first step free, the next ones from the same
    # parameters; each side keeps its own AdamW moments
    t = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    one, _ = make_train_step(
        cfg32, model=init_params(cfg32, seed=0, device=dev),
        mesh=training_mesh(1, device=dev))
    sharded, _ = make_train_step(cfg32, model=init_params(
        cfg32, seed=0, device=dev), mesh=mesh)
    l_one, l_mesh, worst, worst_g = [], [], 0.0, 0.0
    noisy = {}
    for i in range(EN_PARITY_STEPS):
        if i:
            _en_sync(torch, sharded, one)
        l_one.append(float(one(*batch)))
        l_mesh.append(float(sharded(*batch)))
        want, got = one.model.state_dict(), sharded.state_dict()
        grads = {k: p.grad for k, p in one.model.named_parameters()}
        mgrads = _en_mesh_grads(torch, sharded)
        g_top = max(float(g.norm()) for g in grads.values())
        for k, a in want.items():
            g, h = grads[k], mgrads[k]
            # each leaf's summed gradient against the one-device one: a
            # lost, doubled or misplaced slice moves its norm
            gerr, gbar = float((h - g).norm()), \
                1e-3 * float(g.norm()) + 1e-5 * g_top
            worst_g = max(worst_g, gerr / gbar)
            _hold(gerr <= gbar, f"(b) step {i + 1}: gradient of {k} off "
                  f"by {gerr:.3e} (its norm {float(g.norm()):.3e})", "5v")
            # the rounding floor, from the one-device gradient: under
            # 1e-5 in this step or an earlier one (Adam's moments carry
            # it); an exact zero on both sides is held
            floor = (g.abs() < 1e-5) & ((g != 0) | (h != 0))
            noisy[k] = noisy[k] | floor if k in noisy else floor
            ok = ~noisy[k]
            excess = ((got[k] - a).abs() - 1e-5 * a.abs().max()) \
                / a.abs().clamp_min(1e-30)
            w = float(excess[ok].max()) if bool(ok.any()) else 0.0
            worst = max(worst, w)
            _hold(w <= 1e-4, f"(b) step {i + 1}: parameter {k} off by "
                  f"{w:.3e} relative", "5v")
    rel = [abs(a - b) / abs(b) for a, b in zip(l_mesh, l_one)]
    _hold(max(rel) <= 1e-4, f"(b) f32 losses {l_mesh} against {l_one}",
          "5v")
    n_all = sum(p.numel() for p in one.model.parameters())
    n_noisy = sum(int(x.sum()) for x in noisy.values())
    _hold(n_noisy <= EN_FLOOR_SHARE * n_all, f"(b) {n_noisy} of {n_all} "
          f"entries at the rounding floor", "5v")
    del one, sharded, want, got, grads, mgrads, noisy
    torch.cuda.empty_cache()
    log(f"[5v] (b) f32, B={EN_PAIRS}, L={cfg.max_len}, {EN_PARITY_STEPS} "
        f"steps under {mesh.shape} and under training_mesh(1) on {card}, "
        f"the first free, each later one from the same parameters, each "
        f"side's own AdamW moments: losses "
        f"{[round(x, 6) for x in l_mesh]} against "
        f"{[round(x, 6) for x in l_one]} (worst {max(rel):.3e} "
        f"relative); every leaf's summed gradient within 1e-3 of the "
        f"one-device one's norm plus 1e-5 of the largest leaf's (worst "
        f"{worst_g:.3f} of that bar); each "
        f"step's parameters within rtol 1e-4 (worst excess {worst:.3e}) "
        f"outside the {n_noisy} of {n_all} entries "
        f"({100 * n_noisy / n_all:.2f}%, at most "
        f"{100 * EN_FLOOR_SHARE:.0f}%) whose one-device gradient sat under "
        f"1e-5 in some step; {time.perf_counter() - t:.1f} s")

    # (c) 5t(d)'s bf16 steps under the mesh
    t = time.perf_counter()
    step, _ = make_train_step(cfg, lr=1e-3, model=init_params(
        cfg, seed=0, device=dev), mesh=mesh)
    setup_s = time.perf_counter() - t
    _en_reset_peaks(torch, devs)
    t = time.perf_counter()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    losses += [step(*batch) for _ in range(EN_STEPS - 1)]
    torch.cuda.synchronize()
    steady = (EN_STEPS - 1) / (time.perf_counter() - t)
    peaks = _en_peaks(torch, devs)
    losses = [float(x) for x in losses]
    _hold(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(c) losses {losses}", "5v")
    _hold(abs(losses[0] - en["first_loss"]) <= 1e-2 * abs(en["first_loss"]),
          f"(c) first loss {losses[0]} against 5t(d)'s {en['first_loss']}",
          "5v")
    log(f"[5v] (c) {EN_STEPS} bf16 train steps at B={EN_PAIRS}, "
        f"L={cfg.max_len} under {mesh.shape} on {card}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (5t(d): first "
        f"{en['first_loss']:.4f}); shards set up in {setup_s:.1f} s, "
        f"first step {first_ms:.1f} ms, then {steady:.2f} steps/s against "
        f"5t(d)'s {en['steps_s']:.2f} ({en['steps_s'] / steady:.2f}x "
        f"slower); peak allocated {peaks}")
    log("[5v] (c) one mesh step: " + _en_profile(torch, lambda: step(*batch)))
    del step
    torch.cuda.empty_cache()

    # (d) the ring at max_len 4096 over EN_SLOTS slots over the devices
    lcfg = en["lcfg"]
    lmodel = init_params(lcfg, seed=0, device=dev)
    lids_d = torch.from_numpy(en["lids"]).to(dev)
    lmask_d = torch.from_numpy(en["lmask"]).to(dev)
    smesh = build_sp_mesh(EN_SLOTS, devs)
    ring_encode(lcfg, lmodel, lids_d, lmask_d, smesh)  # first touch
    _en_reset_peaks(torch, devs)
    ms = []
    for _ in range(3):
        t = time.perf_counter()
        ring = ring_encode(lcfg, lmodel, lids_d, lmask_d, smesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    peaks = _en_peaks(torch, devs)
    ring = ring.cpu().numpy()
    cos_one = np.sum(ring * en["ring"], axis=1)
    cos_dense = np.sum(ring * en["dense"], axis=1)
    _hold(bool(np.all(cos_one > 0.99999)),
          f"(d) ring over the devices vs 5t(c)'s ring: cosine {cos_one}",
          "5v")
    _hold(bool(np.all(cos_dense > 0.999)),
          f"(d) ring over the devices vs dense: cosine {cos_dense}", "5v")
    log(f"[5v] (d) the ring at max_len {EN_LONG}, B={len(EN_LONG_ROWS)} over "
        f"{EN_SLOTS} slots on {smesh.n_devices} mesh devices ({form}) on "
        f"{card}: {sorted(ms)[1]:.3f} ms (5t(c) one device "
        f"{en['ring_ms']:.3f}); peak allocated {peaks}; cosine against "
        f"5t(c)'s ring >= {cos_one.min():.7f}, against dense >= "
        f"{cos_dense.min():.6f}")
    del lmodel, lids_d, lmask_d
    torch.cuda.empty_cache()
    log(f"[5v] phase 5v took {time.perf_counter() - t_phase:.1f} s")


def profile_read(torch, node, index, bodies, wall_ms, tag):
    """Device time of the same searches under torch.profiler, over the
    host time of the unprofiled run: the device's busy share."""
    for _ in range(2):  # a session that records nothing is tried again
        with _profiled(torch, cpu=True) as prof:
            for body in bodies:
                node.search(index, copy.deepcopy(body))
        dev = _device_rows(prof)
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        if busy_ms > 0:
            break
    else:
        log(f"[{tag}] device busy share: not measured (the profiler "
            "recorded no device time twice)")
        return
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[{tag}] device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms host "
        f"time ({100 * busy_ms / wall_ms:.1f}% busy); top device time: "
        + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                    f" x{e.count}" for e in top))


def device_ops(torch, fn):
    """{name: count} of the device kernels and copies one call of ``fn``
    runs, from torch.profiler (a session that records none is tried once
    more); None when none is recorded."""
    for _ in range(2):
        with _profiled(torch) as prof:
            fn()
        ops = {e.key: e.count for e in _device_rows(prof)}
        if ops:
            return ops
    return None


#: spin-kernel launches that open every profiler session: late in this
#: process the profiler drops the first records of a session (a few, up
#: to all of a short session's), so these take the loss, not the work
PRIMERS = 16
#: (sessions, sessions that dropped primers, primers dropped)
PRIMER_LOSS = [0, 0, 0]


@contextlib.contextmanager
def _profiled(torch, cpu=False):
    """A torch.profiler session (device activity, and host with ``cpu``)
    around the block, which ``PRIMERS`` spin kernels precede. Read it
    with ``_device_rows``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(PRIMERS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def _device_rows(prof):
    """The device rows of a ``_profiled`` session's ``key_averages()``,
    the primers left out and their loss tallied in ``PRIMER_LOSS``."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    seen = sum(e.count for e in rows if "spin_kernel" in e.key)
    PRIMER_LOSS[0] += 1
    if seen < PRIMERS:
        PRIMER_LOSS[1] += 1
        PRIMER_LOSS[2] += PRIMERS - seen
    return [e for e in rows if "spin_kernel" not in e.key]


def _time_ms(torch, fn, iters, warm=3):
    """Mean ms per call by CUDA events, after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(torch, fn, iters):
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler: the call time without the host's share. A session
    that records no device time is tried once more in a fresh one; if
    that reads 0 too, None (not measured). A kernel whose records are not
    a whole multiple of the calls (a record lost past the primers) is
    logged with the CUDA events of the same window."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with _profiled(torch) as prof:
            a.record()
            for _ in range(iters):
                fn()
            b.record()
        rows = _device_rows(prof)
        ms = sum(e.self_device_time_total for e in rows) / 1e3 / iters
        if any(e.count % iters for e in rows):
            log(f"[timing] the profiler's records over {iters} calls: "
                + "; ".join(f"{e.key[:40]} x{e.count} "
                            f"{e.self_device_time_total / 1e3:.4f} ms"
                            for e in rows)
                + f"; CUDA events in the same window "
                  f"{a.elapsed_time(b) / iters:.4f} ms a call")
        if ms > 0:
            return ms
    log("[timing] the profiler recorded no device time twice: not measured")
    return None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_timing(torch, dev, card):
    """B1 at the main path's shape, the rows form with the count: one
    query, R = 8 rows of a whole 256-row block (1 GiB), D = 2^20, k = 10;
    each call takes the next 8 rows, so its rows come from device memory
    (32 sets of 32 MiB pass the 50 MB L2). Also the all-rows form at its
    PR 4 shape (8 gathered rows, rotated past the L2 likewise) and the
    batched form as ``fused_bm25_topk_batch`` calls it (all 256 rows, the
    count, packed) at Q = 32, 256 and 1,024 and on an input where every
    doc ties. Returns the rows form's row."""
    from elasticsearch_tpu_torch.ops.bm25_topk import bm25_dense_topk

    out = {}
    D, k = 1 << 20, 10
    # the rows form: one block, the rows rotate
    qw, block, mask = _b1_inputs(torch, dev, 1, 256, D, 7)
    R = 8
    sets = [(qw[:, :R].contiguous(),
             torch.arange(R * j, R * j + R, dtype=torch.int32, device=dev))
            for j in range(256 // R)]
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(sets)
        return sets[it[0]]

    def kernel():
        w, rows = nxt()
        return bm25_dense_topk(w, block, mask, k=k, rows=rows, count=True,
                               packed=True)

    def lib():  # the same function in PyTorch calls
        w, rows = nxt()
        sub = block.index_select(0, rows.long())
        s = w.to(torch.bfloat16) @ sub.to(torch.bfloat16)
        top = torch.topk(torch.where(mask, s.float(), -torch.inf), k)
        return top, ((sub != 0).any(0) & mask).sum()

    def twin():
        w, rows = nxt()
        return bm25_dense_topk(w, block, mask, k=k, rows=rows, count=True,
                               plain=True)

    kern = _time_ms(torch, kernel, 50)
    plain = _time_ms(torch, twin, 5)
    library = _time_ms(torch, lib, 50)
    kern_dev = _device_ms(torch, kernel, 50)
    lib_dev = _device_ms(torch, lib, 50)
    b = _bound(R * D * 4 + D + R * 8, 2 * k * 4 + 8, 2 * R * D,
               BF16_FLOP_PER_S)
    out["rows"] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                   "library_ms": library, **b}
    log(f"[timing] bm25_dense_topk rows form + count Q=1 R={R} of 256 rows "
        f"D={D} k={k} on {card}: kernel {kern:.4f} ms, plain {plain:.4f} "
        f"ms, library (index_select + bf16 matmul + topk + count) "
        f"{library:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
        f"device time per call: kernel {_fmt(kern_dev)}, library "
        f"{_fmt(lib_dev)}")
    del qw, block, mask, sets
    torch.cuda.empty_cache()

    # the all-rows form at one query over 8 gathered rows (the CUDA-core
    # pass), rotated past the L2
    Q, F = 1, 8
    in_bytes = Q * F * 4 + F * D * 4 + D
    n_buf = max(1, -(-200_000_000 // (F * D * 4)))
    bufs = [_b1_inputs(torch, dev, Q, F, D, 7 + j) for j in range(n_buf)]
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % n_buf
        return bufs[it[0]]

    def lib():
        qw, impact, mask = nxt()
        s = qw.to(torch.bfloat16) @ impact.to(torch.bfloat16)
        return torch.topk(torch.where(mask, s.float(), -torch.inf), k)

    kern = _time_ms(torch, lambda: bm25_dense_topk(*nxt(), k=k), 50)
    plain = _time_ms(torch, lambda: bm25_dense_topk(*nxt(), k=k, plain=True),
                     5)
    library = _time_ms(torch, lib, 50)
    kern_dev = _device_ms(torch, lambda: bm25_dense_topk(*nxt(), k=k), 50)
    lib_dev = _device_ms(torch, lib, 50)
    b = _bound(in_bytes, Q * k * 8, 2 * Q * F * D, BF16_FLOP_PER_S)
    out["all rows"] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                       "library_ms": library, **b}
    log(f"[timing] bm25_dense_topk all rows Q={Q} F={F} D={D} k={k} on "
        f"{card}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
        f"(bf16 matmul + topk) {library:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); device time per "
        f"call: kernel {_fmt(kern_dev)}, library {_fmt(lib_dev)}")
    del bufs
    torch.cuda.empty_cache()
    for Q in (32, 256, 1024):
        out[f"batched {Q}"] = _time_b1_batched(torch, dev, card, Q, D, k)
    out["batched 256, all tied"] = _time_b1_batched(torch, dev, card, 256, D,
                                                    k, tied=True)
    return out["rows"]


def _time_b1_batched(torch, dev, card, Q, D, k, tied=False):
    """B1's batched form as tier 1 of ``_msearch`` calls it: qw[Q, 256]
    over all rows of a 256-row block (1 GiB: every call reads it from
    device memory), the count, the packed result; against the same
    function in PyTorch calls (bf16 matmul + ``topk``, and the count as a
    product of the 0/1 indicators) and the twin. ``tied``: every impact 1
    and each query's weights equal, so every live doc ties."""
    from elasticsearch_tpu_torch.ops.bm25_topk import (
        bm25_dense_topk, bm25_dense_topk_rescored)

    F = 256
    qw, impact, mask = _b1_inputs(torch, dev, Q, F, D, 7)
    if tied:
        qw = qw[:, :1].expand(-1, F).contiguous()
        impact.fill_(1.0)

    def kernel():
        return bm25_dense_topk(qw, impact, mask, k=k, count=True, packed=True)

    def lib():
        s = qw.to(torch.bfloat16) @ impact.to(torch.bfloat16)
        top = torch.topk(torch.where(mask, s.float(), -torch.inf), k)
        hit = ((qw != 0).to(torch.bfloat16)
               @ (impact != 0).to(torch.bfloat16)) > 0
        return top, (hit & mask).sum(1)

    iters = 20 if Q <= 256 and not tied else 5
    kern = _time_ms(torch, kernel, iters)
    plain = _time_ms(torch, lambda: bm25_dense_topk(
        qw, impact, mask, k=k, count=True, packed=True, plain=True), 1,
        warm=0)
    library = _time_ms(torch, lib, iters)
    kern_dev = _device_ms(torch, kernel, iters)
    lib_dev = _device_ms(torch, lib, iters)
    _, resc = bm25_dense_topk_rescored(qw, impact, mask, k=k)
    r = resc.double()
    b = _bound(Q * F * 4 + F * D * 4 + D, Q * (2 * k + 2) * 4, 2 * Q * F * D,
               BF16_FLOP_PER_S)
    row = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
           "library_ms": library, "rescored_mean": r.mean().item(),
           "rescored_max": int(r.max()), **b}
    log(f"[timing] bm25_dense_topk batched + count Q={Q} F={F} D={D} k={k}"
        f"{', every doc tied' if tied else ''} on {card}: kernel {kern:.4f} "
        f"ms, plain {plain:.4f} ms, library (bf16 matmul + topk + the count "
        f"as an indicator product) {library:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
        f"{b['bound_ms'] / kern:.1%} of it; device time per call: kernel "
        f"{_fmt(kern_dev)}, library {_fmt(lib_dev)}; docs rescored a query "
        f"mean {r.mean().item():.1f} max {int(r.max())}")
    del qw, impact, mask
    torch.cuda.empty_cache()
    return row


def _bound(in_bytes, out_bytes, ops, peak):
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timing_knn(torch, dev, card):
    """B2 at the brute-force kNN shape of the slice: Q = 1 (and Q = 8,
    MaxSim; Q = 32 and 64, phase 5e's kNN and MaxSim batches), D = 2^20,
    dims = 128, f32 (precise), k = 100, cosine. The
    slab (512 MiB) is ten times the L2, so every call reads it from
    device memory."""
    import torch.nn.functional as F

    from elasticsearch_tpu_torch.ops.knn_topk import knn_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    D, dims, k = 1 << 20, DIMS, 100
    out = {}
    # Q = 32 and 64: _msearch's kNN batch and MaxSim batch (8 x 8 tokens)
    for Q in (1, 8, 32, 64):
        q, v, mask = _b2_inputs(torch, dev, Q, D, dims, 17)

        def lib():
            s = F.normalize(q, dim=1) @ F.normalize(v, dim=1).T
            s = torch.where(mask[None, :], (1.0 + s) * 0.5, -torch.inf)
            return torch.topk(s, k)

        def kernel():
            return knn_topk(q, v, mask, k=k, metric="cosine", precise=True)

        kern = _time_ms(torch, kernel, 20)
        plain = _time_ms(torch, lambda: knn_topk(
            q, v, mask, k=k, metric="cosine", precise=True, plain=True), 2)
        library = _time_ms(torch, lib, 20)
        kern_dev = _device_ms(torch, kernel, 20)
        lib_dev = _device_ms(torch, lib, 20)
        # f32 ops: the row norm (2 per element), the division (1), the
        # dot (2 per element and query)
        b = _bound(D * dims * 4 + D + Q * dims * 4, Q * k * 8,
                   D * dims * (3 + 2 * Q), F32_FLOP_PER_S)
        out[Q] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                  "library_ms": library, **b}
        log(f"[timing] knn_topk Q={Q} D={D} dims={dims} k={k} cosine f32 on "
            f"{card}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
            f"(normalize + f32 matmul + topk) {library:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); device time per "
            f"call: kernel {_fmt(kern_dev)}, library {_fmt(lib_dev)}")
        del q, v, mask
        torch.cuda.empty_cache()
    return out[1]


def timing_adc(torch, dev, card, case):
    """B3 at its PR 4 shape, the table-sum over W = 81,920 gathered rows
    of M = 32 codes (K = 256), and at the IVF-PQ query's shape, the fused
    form: one query's probed slots ``case["cand"]`` (W = nprobe * Lmax,
    pads at D) over the whole code table ``case["codes"]`` with its LUT
    and pre-filter words, as phase 5b runs it. The fused form is also
    timed against what the caller ran before it: the code gather, the
    table-sum and the mask. Returns the fused form's row."""
    from elasticsearch_tpu_torch.ops.adc import adc_scores
    from elasticsearch_tpu_torch.ops.bitvec import test_bits

    codes, cand, words, lut = (case[n] for n in ("codes", "cand", "words",
                                                 "lut"))
    N, M = codes.shape
    K = lut.shape[1]
    W = cand.shape[0]
    rows = torch.arange(M, device=dev)
    out = {}

    g = torch.Generator(device=dev).manual_seed(23)
    gathered = torch.randint(0, K, (W, M), generator=g, device=dev,
                             dtype=torch.int64).to(torch.uint8)
    kern = _time_ms(torch, lambda: adc_scores(gathered, lut), 200)
    plain = _time_ms(torch, lambda: adc_scores(gathered, lut, plain=True), 20)
    library = _time_ms(torch, lambda: lut[rows, gathered.long()].sum(1), 200)
    kern_dev = _device_ms(torch, lambda: adc_scores(gathered, lut), 200)
    lib_dev = _device_ms(torch, lambda: lut[rows, gathered.long()].sum(1),
                         200)
    b = _bound(W * M + M * K * 4, W * 4, W * M, F32_FLOP_PER_S)
    out["table"] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                    "library_ms": library, **b}
    log(f"[timing] adc_scores table-sum W={W} M={M} K={K} on {card}: kernel "
        f"{kern:.4f} ms, plain {plain:.4f} ms, library (gather + sum) "
        f"{library:.4f} ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']}); "
        f"device time per call: kernel {_fmt(kern_dev)}, library "
        f"{_fmt(lib_dev)}")

    def fused():
        return adc_scores(codes, lut, cand=cand, filter_words=words)

    def composed(table_sum):  # gather, table-sum, mask
        valid = cand < N
        safe = torch.where(valid, cand, torch.zeros_like(cand)).long()
        valid = valid & test_bits(words, safe)
        return torch.where(valid, table_sum(codes[safe]), -torch.inf)

    def lib():
        return composed(lambda c: lut[rows, c.long()].sum(1))

    def before():  # the caller's sequence up to PR 4
        return composed(lambda c: adc_scores(c, lut))

    kern = _time_ms(torch, fused, 200)
    plain = _time_ms(torch, lambda: adc_scores(
        codes, lut, cand=cand, filter_words=words, plain=True), 20)
    library = _time_ms(torch, lib, 200)
    prev = _time_ms(torch, before, 200)
    kern_dev = _device_ms(torch, fused, 200)
    lib_dev = _device_ms(torch, lib, 200)
    prev_dev = _device_ms(torch, before, 200)
    live = (cand < N) & test_bits(words, torch.where(
        cand < N, cand, torch.zeros_like(cand)).long())
    n_live = int(live.sum())
    n_words = int(torch.unique(cand[cand < N] >> 5).numel())
    b = _bound(W * 4 + n_live * M + n_words * 4 + M * K * 4, W * 4,
               n_live * M, F32_FLOP_PER_S)
    out["fused"] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                    "library_ms": library, **b}
    log(f"[timing] adc_scores fused N={N} W={W} ({n_live} live) M={M} K={K} "
        f"on {card}: kernel {kern:.4f} ms, plain {plain:.4f} ms, library "
        f"(gather + sum + test_bits + where) {library:.4f} ms, PR 4's "
        f"caller (gather + B3 + test_bits + where) {prev:.4f} ms, bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}); device time per call: "
        f"kernel {_fmt(kern_dev)}, library {_fmt(lib_dev)}, PR 4's caller "
        f"{_fmt(prev_dev)}")
    return out["fused"]


def timing_maxsim(torch, dev, card):
    """B4 at the re-rank's shape: a window of W = 100 candidates (and the
    largest window, W = 10,000) of M = 32 codes, T = 32 token tables of
    K = 256. Returns the W = 100 row."""
    from elasticsearch_tpu_torch.ops.maxsim_adc import maxsim_adc

    M, K, T = 32, 256, RERANK_TOKENS
    rows = torch.arange(M, device=dev)
    out = {}
    for W in (RERANK_WINDOW, 10_000):
        g = torch.Generator(device=dev).manual_seed(29)
        codes = torch.randint(0, K, (W, M), generator=g, device=dev,
                              dtype=torch.int64).to(torch.uint8)
        luts = torch.randn(T, M, K, generator=g, device=dev)

        def lib():
            return luts[:, rows[None, :], codes.long()].sum(2).amax(0)

        kern = _time_ms(torch, lambda: maxsim_adc(codes, luts), 200)
        plain = _time_ms(torch, lambda: maxsim_adc(codes, luts, plain=True),
                         20)
        library = _time_ms(torch, lib, 200)
        kern_dev = _device_ms(torch, lambda: maxsim_adc(codes, luts), 200)
        lib_dev = _device_ms(torch, lib, 200)
        b = _bound(W * M + T * M * K * 4, W * 4, W * T * M, F32_FLOP_PER_S)
        out[W] = {"ms": kern, "device_ms": kern_dev, "plain_ms": plain,
                  "library_ms": library, **b}
        log(f"[timing] maxsim_adc W={W} M={M} K={K} T={T} on {card}: kernel "
            f"{kern:.4f} ms, plain {plain:.4f} ms, library (gather + sum + "
            f"amax) {library:.4f} ms, bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}); device time per call: kernel "
            f"{_fmt(kern_dev)}, library {_fmt(lib_dev)}")
    return out[RERANK_WINDOW]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    dev, card = phase_device(torch)
    phase_build()
    err = phase_kernels(torch, dev)
    phase_write(torch, np, dev)
    # each corpus is generated once and shared by the phases that read it
    t = time.perf_counter()
    corpus = build_corpus(np, N_DOCS, VOCAB, SEED)
    sift = make_sift(np, N_VECS, DIMS, SEED)
    log(f"[data] MS-MARCO-shaped postings and SIFT-shaped vectors generated"
        f" in {time.perf_counter() - t:.1f} s")
    b1_read, read_node = phase_read(torch, np, dev, card, corpus)
    launches = {"bm25_dense_topk": b1_read}
    # phase 5o's match bodies on this node: pure-dense term groups (B1)
    dense_rows = read_node.get_index("msmarco").shards[0].segments[0] \
        .inverted["body"].dense_block()[0]
    read_bodies = [{"query": {"match": {"body": " ".join(
        f"t{t}" for t in q)}}, "size": 10} for q in make_queries(
            np, FD_READ_BODIES, VOCAB, corpus[4], SEED + 70,
            dense_only=dense_rows >= 0)]
    # phase 5p's bodies: phase 5's match bodies and 5e(a)'s pure-dense ones
    rest_match = [{"query": {"match": {"body": " ".join(
        f"t{t}" for t in q)}}, "size": 10} for q in make_queries(
            np, N_QUERIES, VOCAB, corpus[4], SEED)]
    rest_dense = [{"query": {"match": {"body": " ".join(
        f"t{t}" for t in q)}}, "size": 10} for q in make_queries(
            np, MSEARCH_BATCH, VOCAB, corpus[4], SEED,
            dense_only=np.asarray(dense_rows[:VOCAB]) >= 0)]
    # phase 5r(d)'s and 5u(e)'s tail-term bodies: no term of the dense block
    tail = np.asarray(dense_rows[:VOCAB]) < 0
    tail &= np.asarray(corpus[4][:tail.size]) > 0
    tail_bodies = [{"query": {"match": {"body": " ".join(
        f"t{t}" for t in q)}}, "size": 10} for q in make_queries(
            np, WD_GENERIC, VOCAB, corpus[4], SEED + 135, dense_only=tail)]
    (launches["knn_topk"], launches["adc_scores"], b3_case, ivf_index,
     pq_parts) = phase_vectors(torch, np, dev, card, sift)
    hyb = phase_hybrid(torch, np, dev, card, corpus, sift, ivf_index,
                       pq_parts)
    launches["maxsim_adc"] = hyb["maxsim_adc"]
    b1_mesh, b2_mesh, mesh_node, shard_text = phase_mesh(
        torch, np, dev, card, corpus, sift, rest_dense[:MULTI_MSEARCH],
        tail_bodies)
    launches["bm25_dense_topk"] += b1_mesh
    launches["knn_topk"] += b2_mesh
    b1_ms, b2_ms = phase_msearch(torch, np, dev, card, corpus, sift,
                                 read_node, mesh_node, shard_text)
    launches["bm25_dense_topk"] += b1_ms
    launches["knn_topk"] += b2_ms
    mesh_node.close()
    corpus_df = corpus[4]  # phase 5r's bodies
    del corpus, mesh_node, shard_text
    torch.cuda.empty_cache()
    taxi_node, taxis = phase_aggs(torch, np, dev, card)
    launches["bm25_dense_topk"] += phase_sort(torch, np, dev, card,
                                              taxi_node, taxis)
    taxi_node.close()
    del taxi_node, taxis
    torch.cuda.empty_cache()
    launches["bm25_dense_topk"] += phase_writepath(torch, np, dev, card)
    torch.cuda.empty_cache()
    launches["bm25_dense_topk"] += phase_fulltext(torch, np, dev, card)
    torch.cuda.empty_cache()
    launches["bm25_dense_topk"] += phase_joins_geo(torch, np, dev, card)
    torch.cuda.empty_cache()
    launches["bm25_dense_topk"] += phase_a9d(torch, np, dev, card)
    torch.cuda.empty_cache()
    b1, b2, b3 = phase_durability(torch, np, dev, card)
    launches["bm25_dense_topk"] += b1
    launches["knn_topk"] += b2
    launches["adc_scores"] += b3
    torch.cuda.empty_cache()
    b1, b2 = phase_replicas(torch, np, dev, card)
    launches["bm25_dense_topk"] += b1
    launches["knn_topk"] += b2
    torch.cuda.empty_cache()
    b1, b2, b3 = phase_fielddata(torch, np, dev, card, sift, ivf_index,
                                 pq_parts, read_node, read_bodies)
    launches["bm25_dense_topk"] += b1
    launches["knn_topk"] += b2
    launches["adc_scores"] += b3
    torch.cuda.empty_cache()
    b1, b2, b3 = phase_rest(torch, np, dev, card, sift, ivf_index, pq_parts,
                            read_node, rest_match, rest_dense)
    launches["bm25_dense_topk"] += b1
    launches["knn_topk"] += b2
    launches["adc_scores"] += b3
    b1, b2 = phase_watchdog(torch, np, dev, card, read_node, corpus_df)
    launches["bm25_dense_topk"] += b1
    launches["knn_topk"] += b2
    read_node.close()
    del sift, ivf_index, pq_parts, read_node
    torch.cuda.empty_cache()
    for name, n in phase_warm(np, card).items():
        launches[name] += n
    launches["bm25_dense_topk"] += phase_cluster(torch, np, dev, card)
    torch.cuda.empty_cache()
    b2_en, en = phase_encoder(torch, np, dev, card, corpus_df)
    launches["knn_topk"] += b2_en
    torch.cuda.empty_cache()
    phase_encoder_mesh(torch, np, dev, card, en)
    del en
    torch.cuda.empty_cache()
    timing = {"bm25_dense_topk": phase_timing(torch, dev, card),
              "knn_topk": timing_knn(torch, dev, card),
              "adc_scores": timing_adc(torch, dev, card, b3_case),
              "maxsim_adc": timing_maxsim(torch, dev, card)}
    del b3_case
    log(f"[done] the profiler dropped primer records in {PRIMER_LOSS[1]} "
        f"of {PRIMER_LOSS[0]} sessions ({PRIMER_LOSS[2]} of "
        f"{PRIMERS * PRIMER_LOSS[0]})")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    replaces = {"bm25_dense_topk": 150, "knn_topk": 39, "adc_scores": 415,
                "maxsim_adc": 585}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"elasticsearch_tpu_torch/csrc/{name}.cu",
        "replaces": f"elasticsearch_tpu/ops/pallas_kernels.py:{line}",
        "launches": launches[name], "max_abs_err": err[name],
        **timing[name]} for name, line in replaces.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
