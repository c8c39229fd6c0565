#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: one card, ~8.4 M pairs

Phases, each printing JSON lines:

1. build:   nvcc builds the thirteen CUDA kernels from ``src/repro_torch``
            (the twelve ports of the Pallas kernels and ssm_scan_bwd);
            prints build seconds, the card (nvidia-smi), torch and CUDA.
2. main:    the port's main path through ``LSMTree`` at the paper's
            section 5.1 shapes (16-byte keys, 256-byte values from a
            vocabulary of NDV ratio 0.01, uniform; 32 MiB files, T=10,
            L0 limit 4): put_batch ingest with inline flushes and
            compactions, deletes, one filter_many of K=16 predicates and a
            batch of gets; then a clustered phase (key-correlated values)
            where zone maps let the filter kernel skip tiles.  Results are
            held against a plain host reference written here (numpy
            last-write-wins + byte compares), independent of the port.
            Kernel launch counts are reset just before and read just
            after; each of the four kernels of that path must have launched.
3. serve:   the main tree with its filter backend switched by configuration
            (the write path does not depend on it).  serve.jax_packed: a
            ``ScanServer`` (max_batch 16) fed the 16 predicates interleaved
            with 2 selective aggregates; serve.jax: the 16 predicates through
            ``filter_many`` on the same snapshot, also equal to the 'fused'
            answers; serve.numpy: the same under 'numpy' (the codes unpacked
            and compared on the host), also equal to 'fused'.  Answers are
            held against the plain host model.  Each phase resets the launch
            counts just before its checked call and reads them just after:
            serve.jax_packed must have launched multi_range_filter_packed,
            serve.jax range_filter_codes and unpack_codes, neither the fused
            filter, and serve.numpy no kernel at all.  serve.turns: the four
            filter backends' ``filter_many`` in turns on the warm main and
            clustered trees, each answer equal to 'fused'.
4. agg:     the analytics path through ``LSMTree.aggregate_many`` (COUNT,
            SUM, MIN/MAX, GROUP BY prefix with top-k and by 16 buckets):
            agg.general on the main tree (overlapping levels: the fused
            filter and the host visibility merge), agg.fast on a new tree
            of the main configuration loaded with sequential keys and
            compacted (the fast path: fused_zone_agg and zone_histogram),
            agg.clustered on the clustered tree (tiles skipped and taken in
            closed form).  Answers, bucket edges included, are held
            against the plain host model.  Each phase resets the launch
            counts just before its checked ``aggregate_many`` and reads
            them just after: agg.general must have launched the fused
            filter, agg.fast and agg.clustered both aggregate kernels.
5. compact: the main phase's write stream replayed into a tree under
            each other compaction backend: compact.jax (the remap_codes
            kernel) and compact.numpy (the remap on the host).  Every SCT of
            every level must equal the main ('jax_packed') tree's, and
            filter_many (K=16) the host model.  Each phase resets the launch
            counts before its ingest and reads them after its filter:
            compact.jax must have launched remap_codes, unpack_codes and
            pack_codes, compact.numpy not remap_codes, and neither
            remap_pack_codes.
6. range:   main.range: ``range_lookup`` on the main tree over 8 windows of
            1/64 of the key space (one on a snapshot pinned before a few
            overwrites), an empty and an inverted window, each held key for
            key and byte for byte against the host model; host code, no
            kernel launches.
7. fig5:    the paper's Figure-5 pipeline (``examples/filter_analytics.py``)
            on every SCT of the main tree for its 16 predicates: numpy on
            the host-unpacked codes, range_filter_codes on the code column
            and range_filter_packed on the packed words, all equal to each
            other and to the host model; it must launch range_filter_packed.
            fig5.example: the example itself on the port at its own
            configuration (200,000 puts, 128-byte values, 1 MiB files,
            'numpy' backends), through filter, filter_many (K=16) and a
            ScanServer (max_batch 8), every answer held against the host
            model.
8. codecs:  one seeded stream (the main phase's generator at 2^20 pairs
            and 2,048 deletes, ``--codec-pairs``) into a tree of the main
            configuration for each of the harness's five systems: 'opd',
            'plain', 'heavy', 'blob' and 'blob' with blob_compress
            (codecs.blob_zstd), the paper's baselines beside its design:
            filter_many (K=16) and aggregate_many (the agg phase's 6 specs)
            under 'fused' and under 'numpy', range_lookup over 8 windows
            and get of 1,024 keys (768 present, 128 deleted, 128 missing;
            'blob_zstd', whose every read decompresses a whole log, reads
            the first 48, 8 and 8 of them and is compared with 'opd' at
            those 64).
            The five trees must give the same answers, each equal to the
            host model; one line per codec carries ingest seconds and
            ops/s, compaction, filter and aggregate stage seconds ('decode'
            included), the range_lookup median, disk bytes per level, blob
            GC counters and logs, and the launch counts of its window,
            which must be 0 for the four competitors.  Then each blob tree
            takes a snapshot and a burst overwriting most live keys twice
            (codecs.<codec>.burst): compaction and GC run while the
            snapshot pins its logs, filter_many and the 1,024 gets at the
            snapshot return the answers from before the burst, current
            reads the burst's values (128 gets; 'blob_zstd' its 64), and
            once the snapshot is released the next GC pass leaves no log
            past the threshold.  codecs.done gives the phase's wall
            seconds.
9. durable: the main configuration with wal_sync='group' and a spill
            directory, the main phase's generator at 2^20 pairs and 2,048
            deletes (``--durable-pairs``): the crash point
            compact.before_manifest armed, the stream ingested until it
            fires, the WAL's unsynced tail dropped
            (``simulate_power_loss``) and the tree abandoned;
            ``LSMTree.restore`` on the card must recover a seqno K between
            the WAL's durable floor and the mutations issued and answer
            filter_many (K=16), range_lookup over 8 windows, get of the
            codec probe's 1,024 keys and aggregate_many (6 specs) as the
            host model of the first K mutations; then the rest of the
            stream, the same reads against the whole model, and a planned
            ``close`` and second restore after which every SCT equals its
            counterpart (torch.equal on the packed words) and every answer
            the one before.  The window from the first restore to the end
            of the ingest must launch fused_zone_filter, unpack_codes,
            remap_pack_codes and pack_codes.  durable.done carries the
            WAL's appends, syncs and bytes, the spill files and bytes,
            the restores' seconds by stage (store, manifest, build,
            wal_replay), ingest ops/s with the WAL on and io_report under
            the three device models.
10. background: the main configuration with maintenance='background',
            the main phase's generator at 2^20 pairs and 2,048 deletes
            (``--background-pairs``): put_batch in calls of 2^16 pairs while
            the flush and compaction workers launch pack_codes,
            unpack_codes and remap_pack_codes off the writer's thread and
            a reader thread, from the first flushed run on, drives a
            ScanServer(maintenance='background') in batches of the 16
            predicates and 2 selective aggregates, each on its own
            snapshot and checked against the stream written so far (keys
            sorted and unique, values satisfying their predicates, every
            pair one the stream wrote, and every scan and aggregate equal
            to the host model of the stream's first snapshot-seqno
            mutations); each batch records whether a flush or compaction
            job was in flight at its start and end, and the reader's
            fused_zone_filter must launch at least once while one is.
            After
            drain(): filter_many (K=16), 8 range_lookup windows, 1,024
            gets and the 6 aggregate specs equal to the host model, and one
            ScanServer(maintenance='sync') batch too; at least one flush
            and one compaction ran on the workers.  The launch counts are
            reset before the ingest and read after drain(), so the
            workers' launches fall inside the window: pack_codes,
            unpack_codes, remap_pack_codes and fused_zone_filter must each
            have launched.  background.done carries ingest seconds and
            ops/s, the workers' flushes and compactions, the throttle's
            slowdowns and stalls, the reader's batches with their median
            wall seconds and queue wait, the launches, and the codecs
            phase's 'opd' ingest (the same configuration in sync mode)
            beside them.
11. policy: the main configuration, the main phase's generator at 2^20
            pairs and 2,048 deletes (``POLICY_PAIRS``).  A tiered tree
            (tier_runs 4) takes the stream and compact(): a level below L0
            must hold stacked runs (run depth >= 2); filter_many (K=16), 8
            range_lookup windows, 1,024 gets and the 6 aggregate specs
            equal to the host model, a snapshot pinned.  set_policy to
            leveling and compact(): the stacked level merges whole into the
            level below, every level at run depth <= 1, the same reads equal
            to the model now and at the pinned snapshot.  The launch counts
            are reset before the tiered ingest and read after those checks:
            pack_codes, unpack_codes, remap_pack_codes and
            fused_zone_filter must each have launched, a fused_zone_filter
            launch over the stacked level among them.  Then a tree with
            policy_autotune: the stream and compact() (a write-only
            window), 1,024 gets and a filter_many (a scan window) and
            compact(); the tuner must retune at least twice, each window's
            reads equal to the model.  policy.done carries each part's
            seconds, merges and compaction bytes (beside the codecs phase's
            leveled 'opd' tree), shape_report before and after the
            migration, the tuner's decisions and the launches.
12. sharded: the range-sharded engine (``repro_torch.shard``) in the main
            configuration, every shard on the one card.  sharded.engine:
            4 shards over [0, 4 n), 4 workers, the codecs phase's stream
            (2^20 pairs, 2,048 deletes) through ``put_batch`` and
            ``compact_all()``: filter_many (K=16), aggregate_many (the 6
            specs, bucket edges resolved once over every shard), 8
            range_lookup windows (2 across a shard boundary) and 1,024
            gets equal to the host model, and a ``ScanServer`` on
            'jax_packed' (16 scans, 2 aggregates) too.  sharded.splits: 2
            shards with a spill directory, wal_sync='group' and a
            ``RebalanceConfig`` (32 MiB, skew 1.5, at most 4 shards), 2^18
            puts in put_batch calls of 2^16, 3/4 of the keys in the lowest
            1/8 of the key space, a snapshot pinned after the first
            quarter: at least one hot-shard split (``merge_scts`` under a
            key range a half), the reads at the snapshot equal to the
            model of that quarter and the current ones to the model of
            the stream, then ``close()``, ``ShardedLSM.restore`` on the
            card and the current reads again.  Each part resets the launch
            counts before its ingest and reads them after its checks;
            pack_codes, unpack_codes, remap_pack_codes, fused_zone_filter,
            fused_zone_agg, zone_histogram and multi_range_filter_packed
            must each launch in the phase.  Each part's line carries its
            seconds, the shapes (shards, splits, boundaries, levels per
            shard), its launches and the card; sharded.done the phase's
            seconds.
13. replica: a ``ReplicatedShard`` (``repro_torch.replica``) of the main
            configuration with wal_sync='group': a leader and 2 followers
            on the card, ReadPolicy(max_lag_seqnos=0), auto_pump off.
            2^17 puts (``REPLICA_PAIRS``, seed + 11) in put_batch calls of
            2^14, each followed by a pump() timed apart, link 2
            partitioned for the middle four batches, then n / 512
            deletes: every watermark at the head, link 2 blocked and
            resumed once, every replica flushed on the card.  A routed
            snapshot from a follower at lag 0: filter_many (K=16), 8
            range_lookup windows, 1,024 gets and the 6 aggregate specs
            equal to the host model, and a ScanServer batch.
            kill_leader() + promote(best_follower()): nothing acknowledged
            lost, EPOCH.json at epoch 2 with leader 1, downtime_ms from
            the kill to the first routed snapshot, a server batch.
            compact() on the new leader, the reads routed to the follower
            and, with prefer_follower off, to the compacted leader (the
            aggregates' fast path).  resync_follower(0) (LSMTree.restore
            on the card), 2^14 more puts shipped, every replica equal to
            the leader and to the model; close(), ReplicatedShard.restore
            on the card at epoch 2 with leader 1, the reads again.  The
            launch counts are reset before the ingest and read after the
            checks: pack_codes, unpack_codes, remap_pack_codes,
            fused_zone_filter, fused_zone_agg and zone_histogram must each
            have launched, and the phase must end within 30 s.
            replica.done carries the leader's ingest seconds and ops/s,
            the shipping seconds, each follower's records applied, the
            retention log, the downtime, the compact, resync and restore
            seconds, the shapes and the launches.
14. lm:      the serve path of examples/htap_serve.py on the port.  A
            TokenStore on the card (2^18 samples, meta_width 48, the five
            domains of tests/test_pipeline.py, payloads of 64-256 token
            ids, 1/16 then deleted or re-ingested): its flushes and
            compactions must launch pack_codes, unpack_codes and
            remap_pack_codes; select(prefix 'code/') for each of 4 ranks
            equal to the host model, disjoint and complete, launching
            fused_zone_filter; batches equal to the host model give the
            prompts.  A PrefixCacheIndex on the card (2^14 prefixes of 32
            tokens, two tenants, hot and cold tags, retags and evictions):
            keys, lookups, scans and eviction candidates equal to a host
            dictionary, the scans launching fused_zone_filter.  llama3-8b
            at its published widths: 2 layers in float32 (TF32 off),
            decode logits within 2e-4 of forward logits at 16 positions;
            then 32 layers in bfloat16 drawn on the card from a seeded
            generator, a ServingEngine (4 slots, max_seq 64) serving 8
            requests of 16-token prompts and 16 new tokens, the first four
            checked against a teacher-forced decode replay, forward and
            the float32 forward of the same weights (TF32 off): decode
            within 0.25 of forward, the served tokens equal to the
            replay's and to the forward's argmax past a 0.5 margin, the
            decode no farther from float32 than twice the forward, its
            argmax equal to float32's past twice that distance.
            lm.done carries the weights' GB, init seconds, peak memory,
            the median decode-step ms beside its bound (weight bytes over
            the card's bandwidth), a profiled step's device busy share,
            tokens/s, the stores' figures and launches, the card and the
            build's seconds; the phase within 60 s.
15. lm.families: the moe, ssm and hybrid families on the port, after
            lm with its weights freed.  falcon-mamba-7b, hymba-1.5b and
            granite-moe-1b-a400m, each at its published widths and depth
            in bfloat16, weights drawn on the card from a seeded
            generator: 2 layers in float32 (TF32 off; moe capacity_factor
            E / k, so the forward drops nothing) with decode logits within
            2e-4 of forward logits at 16 positions; then lm's serve run on
            lm's prompts modulo the vocabulary, with lm's checks and
            limits.  falcon-mamba-7b and hymba-1.5b, whose bf16 forwards
            lie 6.3 and 0.33 from their float32 forwards at full depth,
            hold lm's bf16 checks on their first 2 layers (the same
            weights, the same sequences) and keep the full depth's figures
            beside the replay check; their depth sweep gives the bf16
            forward's distance from float32 at 1, 2, 4, ... 64 layers
            through ssm_scan and through ssm_scan_plain, the first no more
            than twice the second.  Every SSM forward (the float32
            check's, the served one's) must launch ssm_scan once a layer,
            and falcon-mamba-7b's first-layer scan operands from the
            served forward are held against ssm_scan_plain (y within 1e-4,
            the final state bit for bit) and timed: the ssm_scan row's
            ``path``.  granite's line counts the assignments a forward
            over the 4 x 32 batch drops at the published capacity_factor
            1.25 (C = 40).  phi3.5-moe-42b-a6.6b, whose 83.75 GB of bf16
            weights exceed the card, runs the float32 check alone.  A line
            a model (parameters, weight GB, init seconds, peak memory, the
            median decode-step ms beside its bound, tokens/s, a profiled
            step's device busy time and top kernels) and
            lm.families.done (the phase's seconds beside the build's); the
            phase within 90 s.
16. lm.encdec: the encoder-decoder on the port, after lm.families with
            its weights freed: whisper-small at its published widths and
            depth (12 + 12 layers, d_model 768), 4 slots, frames standing
            in for the conv frontend as in both packages ([4, 1500, 768]
            from the seed: whisper's 30 s window) beside a teacher-forced
            prefix of dec_len_for(1500) = 187 tokens.  In float32 (TF32
            off): prefill fills the cross K/V, then 187 decode steps, each
            within 2e-4 of decode_train.  In bf16, weights drawn on the
            card from a seeded generator: prefill timed beside its bound
            (bytes, or bf16, float32 and exp operations over their rates),
            the 187 steps on the prefilled cache timed beside theirs (the
            decoder's weights, the head and the cache over the bandwidth),
            held by lm's bf16 checks against decode_train in bf16 and
            float32 (one float32-argmax position or more); then a
            ServingEngine (4 slots, max_seq 64) serving lm's 8 requests of
            16 + 16 tokens as the reference's engine does (no prefill: zero
            cross K/V, enc_len 64, a self cache of 16 slots that rolls),
            the served tokens equal to a teacher-forced replay on that
            cache; then ``repro_torch.launch.serve.main`` for whisper-small
            on the card (its [serve] line).  The line carries init seconds,
            peak memory, prefill and step ms beside their bounds, a
            profiled step's device busy time and top kernels, tokens/s and
            the card; the phase within 40 s.  The path launches none of the
            repository's kernels (its einsums and attention are plain
            PyTorch, as the reference's are outside Pallas).
17. train: hymba-1.5b trained on the port, after lm.encdec with its
            weights freed, through ``make_train_state``,
            ``make_train_step``, ``train.loop.run`` and
            ``launch.train.main``: (a) 2 of 32 layers at full width in
            float32 (TF32 off), one step of B 2 x S 256 in 2 microbatches,
            its gradients through ssm_scan / ssm_scan_bwd against
            ssm_scan_plain under autograd (loss and every leaf within 1e-4
            of its largest magnitude), the launches counted (forward and
            remat's recompute each launch ssm_scan once a layer a
            microbatch, the backward ssm_scan_bwd once); (b) full width and
            depth in bf16: a TokenStore of repeated motifs whose batches
            launch fused_zone_filter, then 8 steps of B 4 x S 1,024 in 2
            microbatches (AdamW lr 1e-3, warmup 2) on one batch, the loss
            dropping by 0.3 or more, every metric finite, every leaf's
            moment nonzero and every leaf changed unless a unit step rounds
            back in bf16; the step's median ms beside its bound, the last
            step profiled, peak memory, tokens/s; (c) ssm_scan_bwd against
            ssm_scan_bwd_plain on the first layer's scan operands and dy
            from (b) (B 2, L 1,024, D 3,200, N 16; bf16, u laid out
            steps first, B and C the projection's strided slices, all read
            in place) within 1e-4 of each output's
            magnitude, the same bits twice and on the operands' float32
            copies, both timed beside the bound, its layout and ptxas
            resources; (d) 2 of 32 layers in bf16 through ``train.loop.run``
            with AsyncCheckpointer every 3 steps and failures injected at
            steps 2 (before the first checkpoint) and 5, the final loss
            within rtol 1e-4 of a failure-free run, the last checkpoint
            restored onto the card bit for bit the live state; (e) the
            launcher on the reduced config for 4 steps.  One line with the
            phase's seconds beside the build's; within 60 s.  Then
            train.mesh: hymba-1.5b's step on the (1, 1) host mesh (a
            one-rank NCCL group) bit for bit the mesh-less step, within
            40 s; and train.mesh.moe: granite-moe-1b-a400m at full width
            and depth in bf16, a step on the host mesh under moe_impl
            'gather' at the published capacity_factor (assignments drop)
            and under 'ep' at E / k, each bit for bit the mesh-less step,
            the mesh step's warm ms, peak memory and device idle share;
            within 40 s.  Then lm.mesh: the paths that only the dry-run
            reaches on a mesh, each off the host mesh and on it under
            ShardCtx from one set of weights, bit for bit: whisper-small
            (bf16, 12 + 12 layers) prefill of 4 x 1,500 stub frames and
            16 decode steps against its cross K/V, then one train step of
            4 x (1,500 frames, 187 tokens) (loss, metrics, every leaf of
            the new state); hymba-1.5b (4 of its 32 layers, full width)
            prefill of a 64-token prompt (ssm_scan launched once a layer
            on both paths) and hymba-1.5b's and granite-moe-1b-a400m's (4
            of 24 layers) 16 decode steps under serving_layout 'batch'
            and 'tp2d'; every step's ms on and off the mesh; within 40 s.
18. bench:   the kernel micro-bench's entry points
            (``benchmarks/bench_kernels.py``): range_filter_packed on 2^20
            codes at widths 8 and 16, bloom_probe on a 2^14-bit bloom and
            on the largest documented one (2,048 words, 2^20 keys, no false
            negative), ssm_scan at falcon-mamba-7b's width (d_inner 8192,
            d_state 16, 2,048 tokens), held against host models.
19. kernels: each kernel against its plain PyTorch version on the card, on
            operands recorded from the main path, the serve phases,
            agg.fast, compact.jax and fig5, and at bench's shapes
            (bit-identical required; ssm_scan within rtol = atol = 1e-4),
            with CUDA-event medians, the plain version's time and the bound:
            the larger of the bytes over the card's data-sheet bandwidth
            and, for range_filter_packed, bloom_probe and ssm_scan, the
            operations over the card's integer, float32 or exp rate.
            pack_codes and unpack_codes have one row per pack width the
            main path packed (unpacked), with that width's launches
            (main.pack_by_width, main.unpack_by_width; remap_pack_codes'
            in main.remap_by_width), and pack_codes one at compact.jax's
            largest pack (a width-32 merge output) and at width 16 on the
            same codes; at width 32 the pack and the unpack sit beside
            codes.clone() and words[:n].clone() (the same functions there);
            remap_codes and fused_zone_agg with SUM carry their gathers' L2
            sector bytes.  These four kernels, fused_zone_agg,
            zone_histogram, the four filters, bloom_probe and ssm_scan
            are also timed in CUDA graphs with their operands in L2
            (graph_ms) and from device memory (cold_graph_ms), both remaps
            with every entry dead (streams_only_cold_graph_ms: no gather),
            and the width-32 unpack and clone at 8 times its n
            (cold_graph_ms_8n, library_cold_graph_ms_8n).  ssm_scan is also
            timed cold at state dimensions 1, 8 and 32 on the same u and
            delta (state_dim_cold_graph_ms), and fused_zone_agg cold at K
            = 1 and 2 on the same tiles in its 1- and 2-slot
            instantiations and in its 8-slot one (slots_cold_graph_ms);
            zone_histogram cold in both bin buckets at 16 and 64 bins
            (buckets_cold_graph_ms), bloom_probe cold at the largest
            prime below its nbits (odd_nbits_cold_graph_ms), both with
            the SASS instructions per code or key of their hot loop
            (cuobjdump -sass).  range_filter_codes and
            range_filter_packed are timed in CUDA graphs at each cluster
            size the build instantiates (4 and 8 blocks a tile; their
            grids are tiles x cluster), cold on the input padded to whole
            tiles, beside a copy of the same traffic cold (codes.to(
            torch.int8), words.clone()), and through their ops entry
            point cold on the input as it is and with the pad copy that
            entry point made before.  Their rows
            carry the registers, shared memory and spills of every
            instantiation of their kernel at that width, from the build's
            -Xptxas=-v log.  ssm_scan's launches are those of the SSM
            forwards of lm.families (its model path; bench's one is
            bench_launches), and its row carries lm.families' ``path``:
            the kernel against plain at falcon-mamba-7b's first layer in
            the served forward.  ssm_scan_bwd's row is train's part (c),
            its launches those of train.full's 8 steps.

A ``total`` line gives the run's wall seconds.  The last three lines are
the card (nvidia-smi name, power limit), the kernel table ``{"kernels": [...]}`` and ``{"ok": true, "device": ...}``.
Any mismatch or error exits non-zero before them.  The script imports
only torch, numpy and the port; it exits non-zero with no result when no
CUDA card is available or when it stands outside the repository.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's rates (bandwidth, FP32, bf16, exp and int32 per clock) come
# from repro_torch.launch.card, which the dry-run's roofline reads too

KERNELS = {
    "pack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                   "src/repro/kernels/bitpack.py:57"),
    "unpack_codes": ("src/repro_torch/kernels/csrc/bitpack.cu",
                     "src/repro/kernels/bitpack.py:75"),
    "fused_zone_filter": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                          "src/repro/kernels/fused_scan.py:115"),
    "remap_pack_codes": ("src/repro_torch/kernels/csrc/merge_remap.cu",
                         "src/repro/kernels/merge_remap.py:141"),
    "fused_zone_agg": ("src/repro_torch/kernels/csrc/agg_scan.cu",
                       "src/repro/kernels/agg_scan.py:228"),
    "zone_histogram": ("src/repro_torch/kernels/csrc/agg_scan.cu",
                       "src/repro/kernels/agg_scan.py:344"),
    "multi_range_filter_packed": ("src/repro_torch/kernels/csrc/multi_filter.cu",
                                  "src/repro/kernels/multi_filter.py:77"),
    "range_filter_codes": ("src/repro_torch/kernels/csrc/opd_filter.cu",
                           "src/repro/kernels/opd_filter.py:49"),
    "remap_codes": ("src/repro_torch/kernels/csrc/merge_remap.cu",
                    "src/repro/kernels/merge_remap.py:109"),
    "range_filter_packed": ("src/repro_torch/kernels/csrc/packed_filter.cu",
                            "src/repro/kernels/packed_filter.py:63"),
    "bloom_probe": ("src/repro_torch/kernels/csrc/bloom_probe.cu",
                    "src/repro/kernels/bloom_probe.py:73"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:83"),
    # no Pallas counterpart: the backward of row ssm_scan, which the
    # reference takes by XLA's autodiff of selective_scan_seq
    "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                     "src/repro/models/ssm.py:40"),
}
MAIN_KERNELS = ("pack_codes", "unpack_codes", "fused_zone_filter",
                "remap_pack_codes")
AGG_KERNELS = ("fused_zone_agg", "zone_histogram")
SYMBOLS = {"pack_codes": "pack_codes_kernel",
           "unpack_codes": "unpack_codes_kernel",
           "fused_zone_filter": "fused_zone_filter_kernel",
           "remap_pack_codes": "remap_pack_codes_kernel",
           "fused_zone_agg": "fused_zone_agg_kernel",
           "zone_histogram": "zone_histogram_kernel",
           "multi_range_filter_packed": "multi_range_filter_kernel",
           "range_filter_codes": "range_filter_codes_kernel",
           "remap_codes": "remap_codes_kernel",
           "range_filter_packed": "range_filter_packed_kernel",
           "bloom_probe": "bloom_probe_kernel",
           "ssm_scan": "ssm_scan_kernel",
           "ssm_scan_bwd": "ssm_scan_bwd_kernel"}
INT32_MAX = 2**31 - 1
NO_LIBRARY = ("no single PyTorch call computes this bit-field function; "
              "its plain version is several calls")
LIBRARY_WHY = {"range_filter_codes": (
    "no single PyTorch call gives the range mask with per-tile counts; its "
    "plain version is four calls"), "remap_codes": (
    "no single PyTorch call computes a gather with -1 kept at dead entries "
    "and per-source offsets; its plain version is several calls"),
    "bloom_probe": (
        "no single PyTorch call hashes keys and tests their bloom bits; its "
        "plain version is several calls per hash"),
    "ssm_scan": (
        "no single PyTorch call computes a selective scan (sequential in L); "
        "its plain version is several calls per time step"),
    "ssm_scan_bwd": (
        "no single PyTorch call computes a selective scan's gradient; its "
        "plain version is several calls per time step, both ways")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------- #
# workload (paper section 5.1 as benchmarks/_harness.py encodes it)
# --------------------------------------------------------------------------- #
def make_vocab(ndv: int, width: int, rng) -> np.ndarray:
    """ndv distinct width-byte values 'cat_%05d_' + random letters."""
    fill = rng.integers(97, 123, (ndv, width - 10)).astype(np.uint8)
    out = np.zeros((ndv, width), np.uint8)
    for i in range(ndv):
        out[i, :10] = np.frombuffer(b"cat_%05d_" % (i % 1000), np.uint8)
    out[:, 10:] = fill
    vocab = out.view(f"S{width}").reshape(-1)
    check(np.unique(vocab).shape[0] == ndv, "vocabulary values collide")
    return vocab


def matches(value: bytes, kind: str, a: bytes, b: bytes) -> bool:
    """Plain predicate semantics over NUL-stripped bytes."""
    v = value.rstrip(b"\x00")
    if kind == "eq":
        return v == a
    if kind == "prefix":
        return v.startswith(a)
    if kind == "range":
        return a <= v <= b
    if kind == "ge":
        return v >= a
    if kind == "le":
        return v <= b
    raise ValueError(kind)


class Reference:
    """Plain host model of the tree over a value vocabulary: operations in
    order, the last write to a key wins, a delete removes the key."""

    def __init__(self, vocab: np.ndarray) -> None:
        self.vocab = vocab
        self.ops = []   # (keys uint64, vocabulary index; -1 = delete)
        self.live = None

    def put(self, keys: np.ndarray, idx: np.ndarray) -> None:
        self.ops.append((np.asarray(keys, np.uint64), np.asarray(idx, np.int64)))
        self.live = None

    def delete(self, keys) -> None:
        keys = np.asarray(keys, np.uint64)
        self.ops.append((keys, np.full(keys.shape[0], -1, np.int64)))
        self.live = None

    def state(self):
        """(keys sorted, vocabulary index) of the live keys."""
        if self.live is None:
            keys = np.concatenate([k for k, _ in self.ops])
            idx = np.concatenate([i for _, i in self.ops])
            # last occurrence of each key: unique over the reversed stream
            uk, first = np.unique(keys[::-1], return_index=True)
            last = idx[keys.shape[0] - 1 - first]
            keep = last >= 0
            self.live = (uk[keep], last[keep])
        return self.live

    def filter(self, kind: str, a: bytes, b: bytes):
        keys, idx = self.state()
        hit = np.asarray([matches(bytes(v), kind, a, b) for v in self.vocab],
                         bool)
        sel = hit[idx]
        return keys[sel], self.vocab[idx[sel]]

    def get(self, key: int):
        keys, idx = self.state()
        i = int(np.searchsorted(keys, np.uint64(key)))
        if i < keys.shape[0] and keys[i] == np.uint64(key):
            return bytes(self.vocab[idx[i]])
        return None


def run_filter_check(tree, ref: Reference, preds, label: str) -> dict:
    import torch
    from repro_torch import Predicate

    tp = [Predicate(kind, a, b) for kind, a, b in preds]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tree.filter_many(tp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_match = check_filters(got, ref, preds, label)
    return {"filter_many_s": dt, "k": len(preds), "rows_matched": n_match}


def check_filters(got, ref: Reference, preds, label: str) -> int:
    """Hold each ``FilterResult`` against the host model; returns the rows
    matched."""
    n_match = 0
    for (kind, a, b), r in zip(preds, got):
        keys, vals = ref.filter(kind, a, b)
        check(np.array_equal(r.keys, keys),
              f"{label}: filter {kind} {a!r} {b!r} keys differ "
              f"({r.keys.shape[0]} vs {keys.shape[0]})")
        check(r.values.tolist() == vals.tolist(),
              f"{label}: filter {kind} {a!r} values differ")
        n_match += int(keys.shape[0])
    return n_match


def run_get_check(tree, ref: Reference, keys: np.ndarray, label: str) -> dict:
    t0 = time.perf_counter()
    for k in keys.tolist():
        want = ref.get(k)
        got = tree.get(k)
        check(got == want,
              f"{label}: get({k}) = {got!r}, expected {want!r}")
    return {"gets": int(keys.shape[0]),
            "get_us": (time.perf_counter() - t0) / max(1, keys.shape[0]) * 1e6}


def main_config():
    """The main phase's configuration: the paper's section 5.1 shapes."""
    from repro_torch import LSMConfig

    return LSMConfig(key_bytes=16, value_width=256, file_bytes=32 * 2**20,
                     size_ratio=10, l0_limit=4)


def make_stream(rng, n: int, width: int) -> tuple:
    """(keys, vocabulary, vocabulary index per put, deleted keys): n puts
    of width-byte values uniform over NDV ratio 0.01, keys uniform over
    [0, 4 n), then n / 512 deletes of written keys."""
    ndv = max(1, int(n * 0.01))
    vocab = make_vocab(ndv, width, rng)
    keys = rng.integers(0, 4 * n, n, dtype=np.uint64)
    vidx = rng.integers(0, ndv, n)
    dels = rng.choice(keys, max(1, n // 512), replace=False)
    return keys, vocab, vidx, dels


def make_preds(vocab: np.ndarray) -> list:
    """The 16 filter predicates over a ``make_vocab`` vocabulary."""
    preds = [("prefix", b"cat_%05d_" % (37 * i + 5), b"") for i in range(11)]
    preds += [("range", b"cat_00100_", b"cat_00104_\xff"),
              ("eq", bytes(vocab[vocab.shape[0] // 2]).rstrip(b"\x00"), b""),
              ("ge", b"cat_00996_", b""), ("le", b"", b"cat_00002_\xff"),
              ("prefix", b"zzz", b"")]
    return preds


def main_phase(args, device: str):
    """Uniform phase then clustered phase; returns the launch counts and
    the trees with their host models for the analytics phases."""
    import torch
    from repro_torch import LSMTree, Predicate
    from repro_torch.kernels import ops

    rng = np.random.default_rng(args.seed)
    n, cfg = args.pairs, main_config()
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    ndv = vocab.shape[0]
    emit({"phase": "main", "reduced": "pairs 6.4e7 -> %.1e (host-side memtable "
          "ingest within the smoke's time limit)" % n, "pairs": n,
          "value_width": cfg.value_width, "ndv": ndv,
          "file_bytes": cfg.file_bytes})

    ops.reset_launches()
    tree = LSMTree(cfg, device=device)
    ingest_s = ingest(tree, stream)
    ref = Reference(vocab)
    ref.put(keys, vidx)
    ref.delete(dels)
    emit({"phase": "main.ingest", **ingest_report(tree, stream, ingest_s)})

    preds = make_preds(vocab)
    res = run_filter_check(tree, ref, preds, "main")
    res["filter_stages_s"] = dict(tree.filter_stats.seconds)
    c = tree.filter_stats.counts
    res.update({k: c[k] for k in ("fused_launches", "zone_tiles_total",
                                  "zone_tiles_skipped", "zone_blocks_total",
                                  "zone_blocks_skipped")})
    # the same batch again under the profiler: the card's busy time
    res.update(device_busy(lambda: tree.filter_many(
        [Predicate(kind, a, b) for kind, a, b in preds])))
    emit({"phase": "main.filter", **res})
    probe = np.concatenate([rng.choice(keys, 1536), dels[:256],
                            rng.integers(4 * n, 8 * n, 256, dtype=np.uint64)])
    emit({"phase": "main.get", **run_get_check(tree, ref, probe, "main")})

    # clustered phase: values follow keys, so zone maps prune tiles
    n2 = args.clustered_pairs
    ck = np.arange(n2, dtype=np.uint64)
    cv = np.char.add(b"ts_", np.char.zfill(
        (ck // 4).astype(np.int64).astype("S12"), 12)).astype(f"S{cfg.value_width}")
    ctree = LSMTree(cfg, device=device)
    cvocab, cidx = np.unique(cv, return_inverse=True)
    cref = Reference(cvocab)
    t0 = time.perf_counter()
    ctree.put_batch(ck, cv)
    cref.put(ck, cidx.reshape(-1))
    ctree.compact()
    torch.cuda.synchronize()
    cingest = time.perf_counter() - t0
    cpreds = [("range", b"ts_%012d" % lo, b"ts_%012d" % (lo + 5))
              for lo in ((i * 997) % max(1, n2 // 8) for i in range(16))]
    cres = run_filter_check(ctree, cref, cpreds, "clustered")
    cc = ctree.filter_stats.counts
    cres.update({k: cc[k] for k in ("fused_launches", "zone_tiles_total",
                                    "zone_tiles_skipped", "zone_blocks_total",
                                    "zone_blocks_skipped")})
    check(cc["zone_tiles_skipped"] > 0, "clustered phase skipped no tile")
    emit({"phase": "clustered", "pairs": n2, "ingest_s": cingest,
          "levels": ctree.shape_report()["levels"], **cres})

    launches = dict(ops.LAUNCHES)
    emit({"phase": "main.launches", **launches})
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")
    return launches, {"cfg": cfg, "tree": tree, "ref": ref, "vocab": vocab,
                      "preds": preds, "ctree": ctree, "cref": cref,
                      "cpreds": cpreds, "stream": stream}


def ingest(tree, stream) -> float:
    """The main phase's write stream into ``tree``: puts in batches of 2^20,
    then the deletes; returns the seconds (ending in a synchronize)."""
    import torch

    keys, vocab, vidx, dels = stream
    t0 = time.perf_counter()
    batch = 1 << 20
    for i in range(0, keys.shape[0], batch):
        tree.put_batch(keys[i:i + batch], vocab[vidx[i:i + batch]])
    for k in dels.tolist():
        tree.delete(k)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ingest_report(tree, stream, seconds: float) -> dict:
    n_ops = stream[0].shape[0] + stream[3].shape[0]
    shape = tree.shape_report()
    return {"ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
            "flush_s": tree.flush_stats.total(),
            "compaction_s": tree.compaction_stats.total(),
            "compaction_stages_s": dict(tree.compaction_stats.seconds),
            "n_flushes": shape["n_flushes"],
            "n_compactions": shape["n_compactions"],
            "levels": shape["levels"],
            "pack_widths": sorted({s.code_bits for s in tree.all_runs()}),
            "dict_sizes": sorted({s.opd.size for s in tree.all_runs()})[-3:],
            "disk_bytes": shape["disk_bytes"]}


# --------------------------------------------------------------------------- #
# serving path: the batched scan server on the staged filter backends
# --------------------------------------------------------------------------- #
# selective aggregates: the general path's host merge sees few candidates
SERVE_AGGS = [
    ("count", ("prefix", b"cat_00042_", b""), None, None),
    ("sum", ("range", b"cat_00100_", b"cat_00101_\xff"), None, None),
]


def serve_phase(state, recs) -> dict:
    """serve.jax_packed, serve.jax and serve.numpy on the main tree, its
    filter backend switched by configuration (the write path does not
    depend on it); returns each phase's launch counts by the kernel it
    exercises."""
    import dataclasses

    import torch
    from repro_torch import Predicate, ScanServer

    tree, ref, preds = state["tree"], state["ref"], state["preds"]
    fused_cfg = tree.cfg
    snap = tree.snapshot()
    for r in recs.values():
        r.active = True

    # serve.jax_packed: the server, 16 scans interleaved with 2 aggregates
    tree.cfg = dataclasses.replace(fused_cfg, filter_backend="jax_packed")
    srv = ScanServer(tree, max_batch=16)
    specs = make_specs(SERVE_AGGS)
    rids = srv.submit_many([Predicate(*p) for p in preds[:8]])
    agg_rids = [srv.submit_agg(specs[0])]
    rids += srv.submit_many([Predicate(*p) for p in preds[8:]])
    agg_rids.append(srv.submit_agg(specs[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, packed_launches = launch_window(srv.drain)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(packed_launches["multi_range_filter_packed"] > 0,
          "serve.jax_packed: multi_range_filter_packed never launched")
    check(packed_launches["fused_zone_filter"] == 0,
          "serve.jax_packed: the fused filter launched")
    n_match = check_filters([out[r] for r in rids], ref, preds,
                            "serve.jax_packed")
    check_aggs([out[r] for r in agg_rids], state["vocab"], ref.state()[1],
               SERVE_AGGS, "serve.jax_packed")
    st = srv.stats
    emit({"phase": "serve.jax_packed", "requests": st.n_served,
          "scans": len(rids), "aggregates": len(agg_rids),
          "batches": st.n_batches, "batch_sizes": st.batch_sizes,
          "mean_batch": st.mean_batch, "wall_s": wall,
          "wall_s_per_batch": wall / st.n_batches,
          "wait_s_median": statistics.median(st.wait_seconds),
          "rows_matched": n_match, "launches": packed_launches,
          **device_busy(lambda: tree.filter_many(
              [Predicate(*p) for p in preds], snapshot=snap))})

    # serve.jax: the same scans through filter_many on the same snapshot,
    # equal to the host model and to the 'fused' answers
    tp = [Predicate(*p) for p in preds]
    tree.cfg = dataclasses.replace(fused_cfg, filter_backend="jax")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged, codes_launches = launch_window(
        lambda: tree.filter_many(tp, snapshot=snap))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in recs.values():
        r.active = False
    for name in ("range_filter_codes", "unpack_codes"):
        check(codes_launches[name] > 0, f"serve.jax: {name} never launched")
    check(codes_launches["fused_zone_filter"] == 0,
          "serve.jax: the fused filter launched")
    n_match = check_filters(staged, ref, preds, "serve.jax")
    tree.cfg = fused_cfg
    fused = tree.filter_many(tp, snapshot=snap)
    for p, a, b in zip(preds, staged, fused):
        check(np.array_equal(a.keys, b.keys) and
              a.values.tolist() == b.values.tolist(),
              f"serve.jax: {p} differs from the fused backend")
    emit({"phase": "serve.jax", "filter_many_s": dt, "k": len(preds),
          "rows_matched": n_match, "launches": codes_launches,
          "equal_to_fused": True})

    # serve.numpy: the same scans on the host (the reference's default
    # backend): each SCT's packed words come to the host once, no kernel
    tree.cfg = dataclasses.replace(fused_cfg, filter_backend="numpy")
    before = dict(tree.filter_stats.seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, host_launches = launch_window(
        lambda: tree.filter_many(tp, snapshot=snap))
    dt = time.perf_counter() - t0
    tree.cfg = fused_cfg
    check(sum(host_launches.values()) == 0,
          f"serve.numpy: kernels launched {host_launches}")
    n_match = check_filters(host, ref, preds, "serve.numpy")
    for p, a, b in zip(preds, host, fused):
        check(np.array_equal(a.keys, b.keys) and
              a.values.tolist() == b.values.tolist(),
              f"serve.numpy: {p} differs from the fused backend")
    emit({"phase": "serve.numpy", "filter_many_s": dt, "k": len(preds),
          "rows_matched": n_match, "launches": host_launches,
          "stages_s": {k: v - before.get(k, 0.0)
                       for k, v in tree.filter_stats.seconds.items()},
          "equal_to_fused": True})
    emit({"phase": "serve.turns", **backend_turns(state)})
    return {"multi_range_filter_packed":
            packed_launches["multi_range_filter_packed"],
            "range_filter_codes": codes_launches["range_filter_codes"]}


FILTER_BACKENDS = ("fused", "jax_packed", "jax", "numpy")


def backend_turns(state) -> dict:
    """``filter_many`` under each filter backend in turns (A B C D D C B A
    A B C D) on the warm main and clustered trees, one snapshot each; every
    answer must equal the turn's first ('fused', held against the host
    model by main.filter and clustered).  Returns the wall seconds per
    backend and their medians."""
    import dataclasses

    import torch
    from repro_torch import Predicate

    order = FILTER_BACKENDS + FILTER_BACKENDS[::-1] + FILTER_BACKENDS
    out = {"order": order}
    for label, tree, preds in (("main", state["tree"], state["preds"]),
                               ("clustered", state["ctree"],
                                state["cpreds"])):
        tp = [Predicate(*p) for p in preds]
        snap, base = tree.snapshot(), tree.cfg
        secs = {b: [] for b in FILTER_BACKENDS}
        first = None
        for b in order:
            tree.cfg = dataclasses.replace(base, filter_backend=b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tree.filter_many(tp, snapshot=snap)
            torch.cuda.synchronize()
            secs[b].append(time.perf_counter() - t0)
            first = first or got
            for p, x, y in zip(preds, got, first):
                check(np.array_equal(x.keys, y.keys) and
                      x.values.tolist() == y.values.tolist(),
                      f"serve.turns: {label} {b} {p} differs from 'fused'")
        tree.cfg = base
        out[label] = {"filter_many_s": secs, "median_s": {
            b: statistics.median(v) for b, v in secs.items()}}
    return out


# --------------------------------------------------------------------------- #
# analytics path: aggregates held against the plain host model
# --------------------------------------------------------------------------- #
# (op, predicate (kind, a, b) or None, group ("prefix", len) or ("bucket", n)
# or None, top_k)
AGG_TABLE = [
    ("count", ("prefix", b"cat_00042_", b""), None, None),
    ("sum", ("range", b"cat_00100_", b"cat_00199_\xff"), None, None),
    ("min", None, None, None),
    ("max", None, None, None),
    ("group_count", None, ("prefix", 7), 5),
    ("group_count", None, ("bucket", 16), None),
]


def numeric(value: bytes) -> int:
    """SUM weight of a value: its first run of ASCII digits as an integer,
    clipped to int32 max; no digit -> 0."""
    m = re.search(rb"[0-9]+", value)
    return min(int(m.group()), INT32_MAX) if m else 0


def vocab_hits(vocab: np.ndarray, pred) -> np.ndarray:
    """Which vocabulary values a predicate matches (numpy byte compares;
    values hold no NUL, so NUL padding orders as the shorter string)."""
    if pred is None:
        return np.ones(vocab.shape[0], bool)
    kind, a, b = pred
    lo, hi = (np.asarray([x], vocab.dtype)[0] for x in (a, b))
    return {"eq": lambda: vocab == lo,
            "prefix": lambda: np.char.startswith(vocab, a),
            "range": lambda: (vocab >= lo) & (vocab <= hi),
            "ge": lambda: vocab >= lo,
            "le": lambda: vocab <= hi}[kind]()


def equi_depth_edges(domain: np.ndarray, n_buckets: int) -> tuple:
    """Interior edges of n equi-depth buckets over a sorted unique domain."""
    d = domain.shape[0]
    idx = np.unique((np.arange(1, n_buckets) * d) // n_buckets)
    idx = idx[(idx > 0) & (idx < d)]
    return tuple(bytes(v) for v in np.unique(domain[idx]))


def expected_groups(vocab, sel, group, edges, top_k):
    """Sorted (label, count) groups of the rows with vocabulary indices
    ``sel``: by value prefix, or by bucket (#(edges <= value))."""
    if group[0] == "prefix":
        labels = np.asarray([bytes(v)[:group[1]] for v in vocab], object)
    else:
        cut = np.searchsorted(np.asarray(edges, vocab.dtype), vocab,
                              side="right")
        names = [b""] + list(edges)
        labels = np.asarray([names[c] for c in cut], object)
    uniq, inv = np.unique(labels, return_inverse=True)
    counts = np.bincount(inv[sel], minlength=uniq.shape[0])
    items = sorted(((bytes(uniq[i]), int(c)) for i, c in enumerate(counts)
                    if c), key=lambda kv: (-kv[1], kv[0]))
    return items[:top_k] if top_k is not None else items


def make_specs(table) -> list:
    from repro_torch import AggSpec, GroupBy, Predicate

    specs = []
    for op, pred, group, top_k in table:
        g = None
        if group is not None:
            g = (GroupBy("prefix", prefix_len=group[1]) if group[0] == "prefix"
                 else GroupBy("bucket", n_buckets=group[1]))
        specs.append(AggSpec(op, Predicate(*pred) if pred else None, g, top_k))
    return specs


def run_agg_check(tree, vocab, idx, table, label, domain=None) -> dict:
    """One ``aggregate_many`` of ``table`` against the live rows (vocabulary
    indices ``idx``): counts, sums, min/max values and group lists must
    equal the host model's.  Bucket edges are equi-depth over ``domain``
    (``pinned_domain``); without one they are read back from the result's
    labels, and only the counts are checked under them."""
    import torch

    specs = make_specs(table)
    before = dict(tree.agg_stats.seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tree.aggregate_many(specs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stages = {k: v - before.get(k, 0.0)
              for k, v in tree.agg_stats.seconds.items()}
    check_aggs(got, vocab, idx, table, label, domain)
    return {"aggregate_many_s": dt, "specs": len(specs), "stages_s": stages}


def check_aggs(got, vocab, idx, table, label, domain=None) -> None:
    """Hold each aggregate of ``table`` against the live rows (vocabulary
    indices ``idx``) of the host model."""
    weights = np.asarray([numeric(bytes(v)) for v in vocab], np.int64)
    rank = np.empty(vocab.shape[0], np.int64)
    rank[np.argsort(vocab)] = np.arange(vocab.shape[0])
    for (op, pred, group, top_k), r in zip(table, got):
        sel = idx[vocab_hits(vocab, pred)[idx]]
        what = f"{label}: {op} {pred} {group}"
        check(r.count == sel.shape[0],
              f"{what}: count {r.count} != {sel.shape[0]}")
        if op == "sum":
            want = int(weights[sel].sum())
            check(r.total == want, f"{what}: sum {r.total} != {want}")
        if op in ("min", "max"):
            want = ((bytes(vocab[sel[np.argmin(rank[sel])]]),
                     bytes(vocab[sel[np.argmax(rank[sel])]]))
                    if sel.shape[0] else (None, None))
            check((r.min_value, r.max_value) == want,
                  f"{what}: min/max {r.min_value!r}/{r.max_value!r}")
        if op == "group_count":
            edges = ()
            if group[0] == "bucket":
                edges = (equi_depth_edges(domain, group[1])
                         if domain is not None else
                         tuple(sorted(lab for lab, _ in r.groups if lab)))
                check(len(edges) < group[1], f"{what}: {len(edges)} edges")
            want = expected_groups(vocab, sel, group, edges, top_k)
            check(r.groups == want, f"{what}: groups differ")


def pinned_domain(ref: Reference):
    """The bucket domain of a tree built from ``ref``'s operations, or None
    where the host model cannot pin it.  The port's domain is the union of
    the runs' dictionaries and the memtable's newest live values: it holds
    every live row's value and nothing that was never written.  Where every
    written value still has a live row, both sides are the same set."""
    written = np.unique(np.concatenate([i for _, i in ref.ops]))
    written = written[written >= 0]
    live = np.unique(ref.state()[1])
    if not np.array_equal(written, live):
        return None
    return np.unique(ref.vocab[live])


def launch_window(fn):
    """Run ``fn`` with the kernel launch counts set to 0 just before and
    read just after; returns (fn's result, the counts)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    out = fn()
    return out, dict(ops.LAUNCHES)


def agg_counts(tree) -> dict:
    c = tree.agg_stats.counts
    return {k: c[k] for k in sorted(c) if k.startswith("agg_")}


def agg_phase(args, state, recs, device: str) -> dict:
    """agg.general, agg.fast and agg.clustered; returns the launch counts
    of agg.fast's checked call, the aggregate kernels' main path."""
    import torch
    from repro_torch import LSMTree

    vocab, cfg = state["vocab"], state["cfg"]

    # agg.general: overlapping levels and memtable rows
    tree, ref = state["tree"], state["ref"]
    domain = pinned_domain(ref)
    res, launches = launch_window(lambda: run_agg_check(
        tree, vocab, ref.state()[1], AGG_TABLE, "agg.general", domain))
    c = agg_counts(tree)
    check(c.get("agg_fallback_runs", 0) > 0, "agg.general: not the general path")
    check(launches["fused_zone_filter"] > 0,
          "agg.general: the fused filter never launched")
    emit({"phase": "agg.general", **res, **c,
          "bucket_edges": "host model" if domain is not None else
          "read back from the result (domain not pinned by the host model)",
          "launches": launches})

    # agg.fast: an append-only log (sequential keys), compacted
    rng = np.random.default_rng(args.seed + 1)
    n = args.fast_pairs
    fidx = rng.integers(0, vocab.shape[0], n)
    ftree = LSMTree(cfg, device=device)
    t0 = time.perf_counter()
    batch = 1 << 20
    for i in range(0, n, batch):
        ftree.put_batch(np.arange(i, min(n, i + batch), dtype=np.uint64),
                        vocab[fidx[i:i + batch]])
    ftree.compact()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    # distinct keys: every written value is live
    domain = np.sort(vocab[np.unique(fidx)])
    for r in recs.values():
        r.active = True      # the kernel phase replays agg.fast's operands
    res, fast_launches = launch_window(lambda: run_agg_check(
        ftree, vocab, fidx, AGG_TABLE, "agg.fast", domain))
    for r in recs.values():
        r.active = False
    c = agg_counts(ftree)
    for key in ("agg_fastpath_runs", "agg_launches", "agg_tiles_evaluated"):
        check(c.get(key, 0) > 0, f"agg.fast: {key} is 0")
    for name in AGG_KERNELS:
        check(fast_launches[name] > 0, f"agg.fast: kernel {name} never launched")
    emit({"phase": "agg.fast", "reduced": "pairs 6.4e7 -> %.1e (host-side "
          "ingest within the smoke's time limit)" % n, "pairs": n,
          "ingest_s": ingest_s, "levels": ftree.shape_report()["levels"],
          "pack_widths": sorted({s.code_bits for s in ftree.all_runs()}),
          **res, **c, "launches": fast_launches})
    # the same batch again (per-SCT facts now cached), then under the
    # profiler: the card's busy time
    specs = make_specs(AGG_TABLE)
    before = dict(ftree.agg_stats.seconds)
    t0 = time.perf_counter()
    ftree.aggregate_many(specs)
    torch.cuda.synchronize()
    again = {"repeat_s": time.perf_counter() - t0,
             "repeat_stages_s": {k: v - before.get(k, 0.0) for k, v in
                                 ftree.agg_stats.seconds.items()}}
    emit({"phase": "agg.fast.profiled", **again,
          **device_busy(lambda: ftree.aggregate_many(specs))})

    # agg.clustered: narrow ranges skip tiles, a wide one and the buckets
    # take the closed form
    ctree, cref, cpreds = state["ctree"], state["cref"], state["cpreds"]
    n2 = args.clustered_pairs
    table = [(op, pred, None, None) for pred in cpreds
             for op in ("count", "sum", "min", "max")]
    table += [("count", ("range", b"ts_%012d" % (n2 // 8),
                         b"ts_%012d" % (n2 // 4 - 1)), None, None),
              ("group_count", None, ("bucket", 16), None)]
    cdomain = pinned_domain(cref)
    check(cdomain is not None, "agg.clustered: host model holds dead values")
    res, claunches = launch_window(lambda: run_agg_check(
        ctree, cref.vocab, cref.state()[1], table, "agg.clustered", cdomain))
    c = agg_counts(ctree)
    for key in ("agg_fastpath_runs", "agg_tiles_skipped",
                "agg_tiles_shortcircuit"):
        check(c.get(key, 0) > 0, f"agg.clustered: {key} is 0")
    for name in AGG_KERNELS:
        check(claunches[name] > 0,
              f"agg.clustered: kernel {name} never launched")
    emit({"phase": "agg.clustered", **res, **c, "launches": claunches})
    return fast_launches


# --------------------------------------------------------------------------- #
# compaction backends: the main write stream under 'jax' and 'numpy'
# --------------------------------------------------------------------------- #
# backend: (kernels that must launch in the phase's window, kernels that
# must not)
COMPACT_LAUNCHES = {
    "jax": (("remap_codes", "unpack_codes", "pack_codes"),
            ("remap_pack_codes",)),
    "numpy": (("pack_codes",), ("remap_codes", "remap_pack_codes")),
}


def check_same_tree(got, want, label: str) -> int:
    """Every SCT of every level of ``got`` equals ``want``'s: file ids,
    keys, seqnos, tombstones, packed words, code width, dictionary, zones
    and weight sums.  Returns the number of SCTs compared."""
    import torch

    ids = [[[s.file_id for s in lvl] for lvl in t.levels] for t in (got, want)]
    check(ids[0] == ids[1], f"{label}: file ids {ids[0]} vs {ids[1]}")
    n = 0
    for la, lb in zip(got.levels, want.levels):
        for a, b in zip(la, lb):
            what = f"{label}: SCT {a.file_id}"
            check((a.code_bits, a.disk_bytes) == (b.code_bits, b.disk_bytes),
                  f"{what}: width or size differs")
            for f in ("keys", "seqnos", "tombs"):
                check(np.array_equal(getattr(a, f), getattr(b, f)),
                      f"{what}: {f} differ")
            check(np.array_equal(a.opd.values, b.opd.values),
                  f"{what}: dictionary differs")
            check(torch.equal(a.packed, b.packed), f"{what}: words differ")
            for f in ("code_lo", "code_hi", "weight_sums"):
                check(torch.equal(getattr(a.blocks, f), getattr(b.blocks, f)),
                      f"{what}: {f} differ")
            n += 1
    return n


def compact_phase(state, backend: str, device: str) -> dict:
    """compact.<backend>: the main phase's write stream into a tree of the
    main configuration under compaction ``backend``; every SCT must equal
    the main ('jax_packed') tree's and filter_many the host model.  Returns
    the launch counts of the phase's window (ingest and filter)."""
    import dataclasses

    from repro_torch import LSMTree

    label = f"compact.{backend}"
    tree = LSMTree(dataclasses.replace(state["cfg"],
                                       compaction_backend=backend),
                   device=device)

    def drive():
        seconds = ingest(tree, state["stream"])
        return seconds, run_filter_check(tree, state["ref"], state["preds"],
                                         label)

    (seconds, res), launches = launch_window(drive)
    n_scts = check_same_tree(tree, state["tree"], label)
    must, must_not = COMPACT_LAUNCHES[backend]
    for name in must:
        check(launches[name] > 0, f"{label}: {name} never launched")
    for name in must_not:
        check(launches[name] == 0, f"{label}: {name} launched")
    emit({"phase": label, **ingest_report(tree, state["stream"], seconds),
          "scts_equal_to_main": n_scts, **res, "launches": launches})
    return launches


# --------------------------------------------------------------------------- #
# range scans on the main tree
# --------------------------------------------------------------------------- #
def range_phase(args, state) -> None:
    """main.range: ``range_lookup`` over 8 windows of 1/64 of the key space
    (the 4th on a snapshot pinned before overwrites and deletes in it, and
    then again after them), an empty and an inverted window; each held key
    for key and byte for byte against the host model."""
    import torch

    tree, ref, vocab = state["tree"], state["ref"], state["vocab"]
    space = 4 * args.pairs           # keys are uniform over [0, 4 * pairs)
    width = space // 64
    windows = [(i * space // 8 + space // 32,
                i * space // 8 + space // 32 + width - 1) for i in range(8)]
    pinned_state, snap = ref.state(), tree.snapshot()
    keys, _ = pinned_state
    lo, hi = windows[3]
    inside = keys[(keys >= lo) & (keys <= hi)]
    rng = np.random.default_rng(args.seed + 2)
    over = rng.choice(inside, 64, replace=False)
    over_idx = rng.integers(0, vocab.shape[0], 64)
    gone = rng.choice(np.setdiff1d(inside, over), 16, replace=False)
    for k, j in zip(over.tolist(), over_idx.tolist()):
        tree.put(k, bytes(vocab[j]))
    ref.put(over, over_idx)
    for k in gone.tolist():
        tree.delete(k)
    ref.delete(gone)

    def expect(state_, lo, hi):
        k, idx = state_
        sel = (k >= np.uint64(lo)) & (k <= np.uint64(hi)) if lo <= hi else             np.zeros(k.shape[0], bool)
        return k[sel], vocab[idx[sel]]

    reads = [(w, None) for w in windows]
    reads[3] = (windows[3], snap)
    reads += [(windows[3], None), ((space, space + width), None),
              ((windows[0][1], windows[0][0]), None)]

    def drive():
        out = []
        for (lo, hi), sn in reads:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tree.range_lookup(lo, hi, snapshot=sn)
            out.append((got, time.perf_counter() - t0))
        return out

    out, launches = launch_window(drive)
    rows = []
    for ((lo, hi), sn), ((gk, gv), dt) in zip(reads, out):
        wk, wv = expect(pinned_state if sn is not None else ref.state(),
                        lo, hi)
        what = f"main.range [{lo}, {hi}]" + (" pinned" if sn else "")
        check(np.array_equal(gk, wk), f"{what}: keys differ "
              f"({gk.shape[0]} vs {wk.shape[0]})")
        check(gv.dtype == wv.dtype and np.array_equal(gv, wv),
              f"{what}: values differ")
        rows.append({"lo": lo, "hi": hi, "pinned": sn is not None,
                     "rows": int(gk.shape[0]), "seconds": dt})
    check(rows[8]["rows"] == rows[3]["rows"] - 16 and rows[9]["rows"] == 0
          and rows[10]["rows"] == 0, "main.range: window row counts")
    check(sum(launches.values()) == 0, f"main.range: launches {launches}")
    emit({"phase": "main.range", "window_keys": width,
          "median_s_per_window": statistics.median(r["seconds"]
                                                   for r in rows[:8]),
          "overwrites": int(over.shape[0]), "deletes": int(gone.shape[0]),
          "lookup_stages_s": dict(tree.lookup_stats.seconds),
          "windows": rows, "launches": launches})


# --------------------------------------------------------------------------- #
# the competitor codecs: one stream into the harness's five systems' trees
# --------------------------------------------------------------------------- #
# benchmarks/_harness.py's SYSTEMS by their configuration: LSM-OPD, RocksDB
# plain and heavy (zlib a block), BlobDB and BlobDB with compressed logs
CODECS = {"opd": {"codec": "opd"}, "plain": {"codec": "plain"},
          "heavy": {"codec": "heavy"}, "blob": {"codec": "blob"},
          "blob_zstd": {"codec": "blob", "blob_compress": True}}
# the blob burst overwrites this share of the live keys twice, each pass
# independently: the logs of the first pass hold about 60 % garbage once
# merged with the second, so GC rewrites them while the snapshot pins the
# logs it reads
BURST_SHARE = 0.6
# current gets after the burst (filter_many checks the current values of
# every key its predicates match): every 'blob_zstd' get decompresses a
# whole log of ~30 MB
CURRENT_GETS = 128
# the codec probe: PROBE_PARTS keys present, deleted and missing, in that
# order.  'blob_zstd' reads the first READ_PARTS of each part (64 keys):
# its every read decompresses a whole log, ~128 ms a key; its current gets
# after the burst are those 64 too
PROBE_PARTS = (768, 128, 128)
READ_PARTS = {"blob_zstd": (48, 8, 8)}


def read_plan(rng, stream) -> tuple:
    """(the 16 predicates, 8 range_lookup windows of 1/64 of the key space,
    the probe keys: ``PROBE_PARTS`` present, deleted and missing) for a
    ``make_stream`` stream, whose keys are uniform over [0, 4 n)."""
    keys, vocab, _vidx, dels = stream
    n = keys.shape[0]
    space = 4 * n
    windows = [(i * space // 8 + space // 32,
                i * space // 8 + space // 32 + space // 64 - 1)
               for i in range(8)]
    present, deleted, missing = PROBE_PARTS
    probe = np.concatenate([rng.choice(keys, present), dels[:deleted],
                            rng.integers(4 * n, 8 * n, missing,
                                         dtype=np.uint64)])
    return make_preds(vocab), windows, probe


def probe_positions(name: str) -> np.ndarray:
    """The positions in the codec probe that codec ``name`` reads."""
    parts = READ_PARTS.get(name, PROBE_PARTS)
    starts = np.cumsum((0,) + PROBE_PARTS[:-1])
    return np.concatenate([np.arange(a, a + m) for a, m in zip(starts, parts)])


def agg_answers(got) -> list:
    return [(r.op, r.count, r.total, r.min_value, r.max_value, r.groups)
            for r in got]


def codec_run(cfg, name: str, stream, ref: Reference, preds, windows,
              probe, device: str) -> tuple:
    """codecs.<name>: the stream into a tree of ``cfg`` under the codec
    ``CODECS[name]``; filter_many (K=16) and aggregate_many (``AGG_TABLE``)
    under 'fused' and under 'numpy', range_lookup over ``windows`` and get
    over ``probe``, each held against the host model.  Returns (the JSON
    line, the answers, the tree)."""
    import dataclasses

    import torch
    from repro_torch import LSMTree, Predicate

    label = f"codecs.{name}"
    t_run = time.perf_counter()
    tree = LSMTree(dataclasses.replace(cfg, **CODECS[name]), device=device)
    vocab = ref.vocab
    specs = make_specs(AGG_TABLE)

    def timed(fn, stats):
        before = dict(stats.seconds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0, {
            k: v - before.get(k, 0.0) for k, v in stats.seconds.items()}

    def drive():
        out = {"ingest_s": ingest(tree, stream)}
        for backend in ("fused", "numpy"):
            tree.cfg = dataclasses.replace(tree.cfg, filter_backend=backend)
            out[backend] = timed(
                lambda: tree.filter_many([Predicate(*p) for p in preds]),
                tree.filter_stats)
            out[f"agg.{backend}"] = timed(lambda: tree.aggregate_many(specs),
                                          tree.agg_stats)
        tree.cfg = dataclasses.replace(tree.cfg, filter_backend="fused")
        out["range"] = []
        for lo, hi in windows:
            t0 = time.perf_counter()
            got = tree.range_lookup(lo, hi)
            out["range"].append((got, time.perf_counter() - t0))
        t0 = time.perf_counter()
        out["get"] = [tree.get(k) for k in probe.tolist()]
        out["get_s"] = time.perf_counter() - t0
        return out

    out, launches = launch_window(drive)
    n_match = 0
    for backend in ("fused", "numpy"):
        n_match = check_filters(out[backend][0], ref, preds,
                                f"{label} {backend}")
        check_aggs(out[f"agg.{backend}"][0], vocab, ref.state()[1],
                   AGG_TABLE, f"{label} agg {backend}", pinned_domain(ref))
    check(agg_answers(out["agg.fused"][0]) == agg_answers(out["agg.numpy"][0]),
          f"{label}: aggregates differ between 'fused' and 'numpy'")
    live_keys, live_idx = ref.state()
    for (lo, hi), ((gk, gv), _) in zip(windows, out["range"]):
        sel = (live_keys >= np.uint64(lo)) & (live_keys <= np.uint64(hi))
        check(np.array_equal(gk, live_keys[sel]) and gv.dtype == vocab.dtype
              and np.array_equal(gv, vocab[live_idx[sel]]),
              f"{label}: range_lookup [{lo}, {hi}] differs")
    for k, got in zip(probe.tolist(), out["get"]):
        check(got == ref.get(k), f"{label}: get({k}) = {got!r}")
    if name == "opd":
        for kernel in ("pack_codes", "fused_zone_filter"):
            check(launches[kernel] > 0, f"{label}: {kernel} never launched")
    else:
        check(sum(launches.values()) == 0, f"{label}: launches {launches}")
    shape = tree.shape_report()
    n_ops = stream[0].shape[0] + stream[3].shape[0]
    line = {"phase": label, **CODECS[name], "ops": n_ops,
            "ingest_s": out["ingest_s"],
            "ops_per_s": n_ops / out["ingest_s"],
            "flush_s": tree.flush_stats.total(),
            "compaction_stages_s": dict(tree.compaction_stats.seconds),
            "n_flushes": shape["n_flushes"],
            "n_compactions": shape["n_compactions"],
            "compaction_in_bytes": tree.compaction_in_bytes,
            "compaction_out_bytes": tree.compaction_out_bytes,
            "levels": shape["levels"], "level_bytes": shape["level_bytes"],
            "disk_bytes": shape["disk_bytes"], "k": len(preds),
            "rows_matched": n_match,
            "filter_many_s": {b: out[b][1] for b in ("fused", "numpy")},
            "filter_stages_s": {b: out[b][2] for b in ("fused", "numpy")},
            "aggregate_many_s": {b: out[f"agg.{b}"][1]
                                 for b in ("fused", "numpy")},
            "agg_stages_s": {b: out[f"agg.{b}"][2]
                             for b in ("fused", "numpy")},
            "agg_counts": agg_counts(tree),
            "range_median_s": statistics.median(dt for _, dt in out["range"]),
            "range_rows": [int(gk.shape[0]) for (gk, _), _ in out["range"]],
            "gets": int(probe.shape[0]),
            "get_us": out["get_s"] / probe.shape[0] * 1e6,
            "launches": launches}
    if tree.blob_mgr is not None:
        line.update(blob_report(tree))
    line["seconds"] = time.perf_counter() - t_run
    answers = ([(r.keys, r.values) for b in ("fused", "numpy")
                for r in out[b][0]], [got for got, _ in out["range"]],
               out["get"], agg_answers(out["agg.fused"][0]))
    return line, answers, tree


def blob_report(tree) -> dict:
    mgr = tree.blob_mgr
    return {"gc_runs": mgr.gc_runs,
            "gc_bytes_rewritten": mgr.gc_bytes_rewritten,
            "blob_logs": len(mgr.live),
            "blob_log_bytes": sum(tree.store.size_of(f) for f in mgr.live)}


def blob_burst(tree, name: str, ref: Reference, preds, probe, before,
               rng) -> None:
    """codecs.<name>.burst, on a blob tree after the cross-tree comparison:
    a snapshot, then two passes that each overwrite ``BURST_SHARE`` of the
    live keys, and a full compaction, so that compaction and GC run while
    the snapshot pins its logs.  At the snapshot, filter_many and the gets
    of ``probe`` must return ``before`` (the tree's answers before the
    burst); current reads the burst's values.  Released (``del`` and
    ``gc.collect()``), the snapshot's logs go at the next GC pass."""
    import gc

    import torch
    from repro_torch import Predicate

    label = f"codecs.{name}.burst"
    t_run = time.perf_counter()
    live_keys = ref.state()[0]
    m = int(BURST_SHARE * live_keys.shape[0])
    passes = [(np.sort(rng.choice(live_keys, m, replace=False)),
               rng.integers(0, ref.vocab.shape[0], m)) for _ in range(2)]
    after = Reference(ref.vocab)
    after.ops = list(ref.ops) + passes
    tp = [Predicate(*p) for p in preds]
    mgr = tree.blob_mgr
    current = min(CURRENT_GETS, probe.shape[0])
    snap = tree.snapshot()
    runs0 = mgr.gc_runs

    def drive():
        t0 = time.perf_counter()
        for keys, idx in passes:
            tree.put_batch(keys, ref.vocab[idx])
        tree.compact()
        torch.cuda.synchronize()
        out = {"burst_s": time.perf_counter() - t0,
               "gc_runs_pinned": mgr.gc_runs - runs0,
               "pinned_candidates": len(mgr.gc_candidates())}
        t0 = time.perf_counter()
        out["snap_filter"] = tree.filter_many(tp, snapshot=snap)
        out["snap_get"] = [tree.get(k, snapshot=snap)
                           for k in probe.tolist()]
        out["snap_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["filter"] = tree.filter_many(tp)
        out["get"] = [tree.get(k) for k in probe[:current].tolist()]
        out["current_s"] = time.perf_counter() - t0
        return out

    out, launches = launch_window(drive)
    fa, _, ga, _ = before
    check(all(np.array_equal(r.keys, ka) and np.array_equal(r.values, va)
              for r, (ka, va) in zip(out["snap_filter"], fa)),
          f"{label}: filter_many at the snapshot differs from before")
    check(out["snap_get"] == ga, f"{label}: gets at the snapshot differ")
    n_match = check_filters(out["filter"], after, preds, label)
    for k, got in zip(probe[:current].tolist(), out["get"]):
        check(got == after.get(k), f"{label}: get({k}) = {got!r}")
    check(out["gc_runs_pinned"] > 0, f"{label}: GC never ran")
    check(out["pinned_candidates"] > 0,
          f"{label}: no log past the threshold was pinned")
    check(sum(launches.values()) == 0, f"{label}: launches {launches}")
    del snap
    gc.collect()
    t0 = time.perf_counter()
    runs1 = mgr.gc_runs
    tree._gc_blobs()
    released_s = time.perf_counter() - t0
    check(mgr.gc_candidates() == [],
          f"{label}: logs left past the threshold after the release")
    check(mgr.gc_runs > runs1, f"{label}: the release freed nothing")
    emit({"phase": label, "puts": 2 * m, "burst_s": out["burst_s"],
          "n_flushes": tree.n_flushes, "n_compactions": tree.n_compactions,
          "gc_runs_pinned": out["gc_runs_pinned"],
          "pinned_candidates": out["pinned_candidates"],
          "gc_runs_released": mgr.gc_runs - runs1, "gc_released_s": released_s,
          **blob_report(tree), "disk_bytes": tree.disk_bytes,
          "snapshot_reads_s": out["snap_s"],
          "current_reads_s": out["current_s"],
          "snapshot_gets": int(probe.shape[0]),
          "current_gets": current,
          "rows_matched": n_match, "launches": launches,
          "seconds": time.perf_counter() - t_run})


def codecs_phase(args, device: str) -> dict:
    """codecs: one seeded stream (the main phase's generator at
    ``--codec-pairs`` pairs) into a tree of the main configuration for
    each of the harness's five systems; the five must give the same
    answers, each equal to the host model, and the four competitors launch
    no kernel.  Then each blob tree takes its burst (``blob_burst``).
    Returns the 'opd' tree's ingest figures (sync maintenance), which the
    background phase prints beside its own."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 3)
    n, cfg = args.codec_pairs, main_config()
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    ref = Reference(vocab)
    ref.put(keys, vidx)
    ref.delete(dels)
    preds, windows, probe = read_plan(rng, stream)
    check(pinned_domain(ref) is not None,
          "codecs: a written value has no live row (bucket edges unpinned)")
    emit({"phase": "codecs", "reduced": "pairs 6.4e7 -> %.1e ('heavy' "
          "compaction's zlib within the smoke's time limit)" % n, "pairs": n,
          "deletes": int(dels.shape[0]), "value_width": cfg.value_width,
          "ndv": int(vocab.shape[0]), "file_bytes": cfg.file_bytes,
          "codecs": list(CODECS), "burst_share": BURST_SHARE})
    first = None
    for name in CODECS:
        at = probe_positions(name)
        line, answers, tree = codec_run(cfg, name, stream, ref, preds,
                                        windows, probe[at], device)
        emit(line)
        if name == "opd":
            opd_ingest = {k: line[k] for k in (
                "ops", "ingest_s", "ops_per_s", "n_flushes", "n_compactions",
                "compaction_in_bytes", "compaction_out_bytes")}
        if first is None:
            first = answers
        else:
            # the gets are compared at the probe positions this codec read
            (fa, ra, ga, aa), (fb, rb, gb, ab) = first, answers
            check(all(np.array_equal(ka, kb) and np.array_equal(va, vb)
                      for (ka, va), (kb, vb) in zip(fa + ra, fb + rb))
                  and [ga[i] for i in at.tolist()] == gb and aa == ab,
                  f"codecs.{name}: answers differ from 'opd'")
        if tree.blob_mgr is not None:
            # both blob trees take the same burst
            blob_burst(tree, name, ref, preds, probe[at], answers,
                       np.random.default_rng(args.seed + 4))
        del tree
    emit({"phase": "codecs.done", "seconds": time.perf_counter() - t_phase})
    return opd_ingest


# --------------------------------------------------------------------------- #
# durability in sync mode: spill files, manifest, WAL, a crash and restores
# --------------------------------------------------------------------------- #
def prefix_model(stream, k: int) -> Reference:
    """The host model of the stream's first ``k`` mutations (the puts in
    order, then the deletes)."""
    keys, vocab, vidx, dels = stream
    n = keys.shape[0]
    model = Reference(vocab)
    model.put(keys[:min(k, n)], vidx[:min(k, n)])
    model.delete(dels[:max(0, k - n)])
    return model


def durable_checks(tree, model: Reference, preds, windows, probe,
                   label: str, snapshot=None) -> tuple:
    """filter_many (K=16) under 'fused', range_lookup over ``windows``, get
    over ``probe`` and aggregate_many (``AGG_TABLE``), each at ``snapshot``
    (the latest when None) and held against ``model``; returns (the
    answers, the seconds)."""
    import torch
    from repro_torch import Predicate

    t0 = time.perf_counter()
    got = tree.filter_many([Predicate(*p) for p in preds], snapshot=snapshot)
    check_filters(got, model, preds, label)
    live_keys, live_idx = model.state()
    vocab = model.vocab
    ranges = []
    for lo, hi in windows:
        gk, gv = tree.range_lookup(lo, hi, snapshot=snapshot)
        sel = (live_keys >= np.uint64(lo)) & (live_keys <= np.uint64(hi))
        check(np.array_equal(gk, live_keys[sel]) and gv.dtype == vocab.dtype
              and np.array_equal(gv, vocab[live_idx[sel]]),
              f"{label}: range_lookup [{lo}, {hi}] differs")
        ranges.append((gk, gv))
    gets = [tree.get(k, snapshot=snapshot) for k in probe.tolist()]
    for k, g in zip(probe.tolist(), gets):
        check(g == model.get(k), f"{label}: get({k}) = {g!r}")
    aggs = tree.aggregate_many(make_specs(AGG_TABLE), snapshot=snapshot)
    check_aggs(aggs, vocab, live_idx, AGG_TABLE, f"{label} agg",
               pinned_domain(model))
    torch.cuda.synchronize()
    return ([(r.keys, r.values) for r in got], ranges, gets,
            agg_answers(aggs)), time.perf_counter() - t0


def same_answers(a, b) -> bool:
    (fa, ra, ga, aa), (fb, rb, gb, ab) = a, b
    return (all(np.array_equal(ka, kb) and np.array_equal(va, vb)
                for (ka, va), (kb, vb) in zip(fa + ra, fb + rb))
            and ga == gb and aa == ab)


def spill_report(spill: str, trees) -> dict:
    """The spill directory's files by kind, and the stores' spill writes."""
    import os

    kinds = collections.defaultdict(lambda: [0, 0])
    for name in os.listdir(spill):
        kind = ("sct_or_log" if name.endswith(".bin") else "wal"
                if name.endswith(".wal") else "manifest"
                if name.endswith(".log") else "other")
        kinds[kind][0] += 1
        kinds[kind][1] += os.path.getsize(os.path.join(spill, name))
    return {"files": {k: {"files": v[0], "bytes": v[1]}
                      for k, v in sorted(kinds.items())},
            "spill_writes_s": sum(t.store.spill_seconds for t in trees),
            "spill_write_bytes": sum(t.store.spill_bytes for t in trees)}


def wal_report(tree) -> dict:
    r = tree.shape_report()
    return {k: r[k] for k in ("wal_appends", "wal_syncs", "wal_bytes",
                              "wal_replayed")}


def durable_phase(args, device: str) -> None:
    """durable: the main configuration with ``wal_sync='group'`` and a
    spill directory, the main phase's generator at ``--durable-pairs``.
    ``compact.before_manifest`` is armed and the stream ingested until it
    fires; the WAL loses its unsynced tail (``simulate_power_loss``) and
    the tree is dropped.  ``LSMTree.restore`` on the card must recover a
    seqno K between the WAL's durable floor and the mutations issued, and
    the restored tree answer as the host model of the first K mutations;
    then it takes the rest of the stream and must answer as the whole
    model, its launch window (restore, reads, ingest) holding
    fused_zone_filter, unpack_codes, remap_pack_codes and pack_codes.  A
    planned ``close`` and a second restore must give every SCT back equal
    (the packed words by ``torch.equal``) and the same answers."""
    import dataclasses
    import gc
    import tempfile

    import torch
    from repro_torch import LSMTree
    from repro_torch.storage.devices import DEVICES
    from repro_torch.testing.crashpoints import CRASH, SimulatedCrash

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 5)
    n, cfg = args.durable_pairs, dataclasses.replace(main_config(),
                                                     wal_sync="group")
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    n_muts = n + dels.shape[0]
    preds, windows, probe = read_plan(rng, stream)
    emit({"phase": "durable", "reduced": "pairs 6.4e7 -> %.1e (host-side "
          "ingest with a WAL record per write, twice restored, within the "
          "smoke's time limit; halved from 2^21 to keep the whole smoke "
          "within 720 s)" % n, "pairs": n,
          "deletes": int(dels.shape[0]), "value_width": cfg.value_width,
          "file_bytes": cfg.file_bytes, "wal_sync": cfg.wal_sync,
          "wal_group_bytes": cfg.wal_group_bytes,
          "crash_point": "compact.before_manifest"})
    line = {"phase": "durable.done"}
    with tempfile.TemporaryDirectory() as spill:
        tree = LSMTree(cfg, spill_dir=spill, device=device)
        t0 = time.perf_counter()
        with CRASH.armed("compact.before_manifest"):
            try:
                ingest(tree, stream)
            except SimulatedCrash:
                pass
            check(CRASH.fired == "compact.before_manifest",
                  "durable: compact.before_manifest never fired")
            floor, issued = tree.wal.durable_seqno, tree._seqno
            tree.wal.simulate_power_loss()
        line["crash"] = {"ingest_s": time.perf_counter() - t0,
                         "issued": issued, "durable_floor": floor,
                         "n_flushes": tree.n_flushes,
                         "levels": tree.shape_report()["levels"],
                         **wal_report(tree), **spill_report(spill, [tree])}
        crashed_fids = set(tree.store.fids())
        del tree
        gc.collect()

        def drive():
            out = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = LSMTree.restore(cfg, spill, device=device)
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
            out["orphans"] = len(crashed_fids - set(back.store.fids()))
            k = back._seqno
            check(floor <= k <= issued, f"durable: recovered seqno {k} "
                  f"outside [{floor}, {issued}]")
            out["k"] = k
            _, out["checks_s"] = durable_checks(
                back, prefix_model(stream, k), preds, windows, probe,
                "durable.restored")
            t0 = time.perf_counter()
            batch = 1 << 20
            for i in range(min(k, n), n, batch):
                j = min(n, i + batch)
                back.put_batch(keys[i:j], vocab[vidx[i:j]])
            for d in dels[max(0, k - n):].tolist():
                back.delete(d)
            torch.cuda.synchronize()
            out["resume_s"] = time.perf_counter() - t0
            out["answers"], out["final_checks_s"] = durable_checks(
                back, prefix_model(stream, n_muts), preds, windows, probe,
                "durable.resumed")
            return back, out

        (back, out), launches = launch_window(drive)
        for kernel in ("fused_zone_filter", "unpack_codes",
                       "remap_pack_codes", "pack_codes"):
            check(launches[kernel] > 0,
                  f"durable: {kernel} never launched on the restored tree")
        check(back._seqno == n_muts, f"durable: seqno {back._seqno}")
        k = out["k"]
        resumed = issued - k + (n_muts - issued)
        line.update({
            "recovered_seqno": k, "mutations": n_muts,
            "restore": {"seconds": out["restore_s"],
                        "stages_s": dict(back.restore_stats.seconds),
                        "orphans_deleted": out["orphans"],
                        "wal_replayed": back.wal_replayed},
            "checks_s": out["checks_s"],
            "resume": {"ops": resumed, "seconds": out["resume_s"],
                       "ops_per_s": resumed / out["resume_s"],
                       "n_flushes": back.n_flushes,
                       "n_compactions": back.n_compactions,
                       "flush_s": back.flush_stats.total(),
                       "compaction_stages_s": dict(
                           back.compaction_stats.seconds),
                       **wal_report(back)},
            "ingest_ops_per_s_with_wal": (issued + resumed) / (
                line["crash"]["ingest_s"] + out["resume_s"]),
            "final_checks_s": out["final_checks_s"],
            "levels": back.shape_report()["levels"],
            "io_report": {name: back.io_report(dev)
                          for name, dev in sorted(DEVICES.items())},
            "launches": launches})
        before = {s.file_id: s for s in back.all_runs()}
        back.close()
        line["closed"] = spill_report(spill, [back])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = LSMTree.restore(cfg, spill, device=device)
        torch.cuda.synchronize()
        line["reopen"] = {"seconds": time.perf_counter() - t0,
                          "stages_s": dict(again.restore_stats.seconds),
                          "wal_replayed": again.wal_replayed}
        check(again._seqno == n_muts, f"durable: reopened at {again._seqno}")
        ids = [[s.file_id for s in lvl] for lvl in again.levels]
        check(ids == [[s.file_id for s in lvl] for lvl in back.levels],
              f"durable: file ids after the reopen {ids}")
        for s in again.all_runs():
            old, what = before[s.file_id], f"durable: SCT {s.file_id}"
            check(torch.equal(s.packed, old.packed), f"{what}: words differ")
            check(s.code_bits == old.code_bits
                  and s.disk_bytes == old.disk_bytes,
                  f"{what}: width or size differs")
            for f in ("keys", "seqnos", "tombs"):
                check(np.array_equal(getattr(s, f), getattr(old, f)),
                      f"{what}: {f} differ")
            check(np.array_equal(s.opd.values, old.opd.values),
                  f"{what}: dictionary differs")
            for f in ("code_lo", "code_hi", "weight_sums"):
                check(torch.equal(getattr(s.blocks, f),
                                  getattr(old.blocks, f)),
                      f"{what}: {f} differ")
        answers, line["reopen"]["checks_s"] = durable_checks(
            again, prefix_model(stream, n_muts), preds, windows, probe,
            "durable.reopened")
        check(same_answers(answers, out["answers"]),
              "durable: answers after the reopen differ from before")
        line["reopen"]["scts_equal"] = len(before)
        again.close()
        del back, again, before
        gc.collect()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)


# --------------------------------------------------------------------------- #
# background maintenance: the workers launch the kernels off the writer's
# thread while a reader thread serves batches
# --------------------------------------------------------------------------- #
BACKGROUND_BATCH = 1 << 16   # pairs a put_batch call


def background_phase(args, recs, sync_ingest: dict, device: str) -> None:
    """background: the main configuration with ``maintenance='background'``
    and the main phase's generator at ``--background-pairs``.  The writer
    ingests with put_batch while a reader thread, once the first flush has
    installed a run, drives a ``ScanServer(maintenance='background')`` in
    batches of the 16 predicates and 2 selective aggregates, each batch on
    its own snapshot and checked against the stream written so far (keys
    sorted and unique, every value satisfying its predicate, every pair
    one the stream wrote) and against the host model of the stream's
    first ``snap.seqno`` mutations (every scan and aggregate equal).  Each
    batch records whether a flush or compaction job was in flight at its
    start and end, and each of the reader's fused_zone_filter calls
    whether one was as it launched: at least one must have been.  After
    ``drain`` the tree must answer filter_many
    (K=16), 8 range_lookup windows, 1,024 gets and the 6 aggregate specs
    as the host model, and so must one ``ScanServer(maintenance='sync')``
    batch; the scheduler must have run a flush and a compaction.  The
    launch counts are reset before the ingest and read after ``drain``, so
    the workers' launches fall inside the window: pack_codes,
    unpack_codes, remap_pack_codes and fused_zone_filter must each be
    above 0.  Every Recorder stays off: the workers call the wrappers
    from their own threads."""
    import dataclasses
    import gc
    import threading

    import torch
    from repro_torch import LSMTree, Predicate, ScanServer
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    for r in recs.values():
        r.active = False
    rng = np.random.default_rng(args.seed + 6)
    n = args.background_pairs
    cfg = dataclasses.replace(main_config(), maintenance="background")
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    preds, windows, probe = read_plan(rng, stream)
    model = prefix_model(stream, n + dels.shape[0])
    # a written pair as key * ndv + vocabulary index, with the position of
    # its first write; a vocabulary value's index by a sorted search
    ndv = vocab.shape[0]
    pairs, first = np.unique(keys.astype(np.int64) * ndv + vidx,
                             return_index=True)
    order = np.argsort(vocab)
    sorted_vocab = vocab[order]
    hits = [vocab_hits(vocab, p) for p in preds]
    emit({"phase": "background", "reduced": "pairs 6.4e7 -> %.1e (host-side "
          "ingest beside a reader thread, within the smoke's time limit)" % n,
          "pairs": n, "deletes": int(dels.shape[0]),
          "value_width": cfg.value_width, "file_bytes": cfg.file_bytes,
          "maintenance": cfg.maintenance, "put_batch": BACKGROUND_BATCH,
          "l0_slowdown": cfg.l0_slowdown_trigger,
          "l0_stop": cfg.l0_stop_trigger,
          "max_immutables": cfg.max_immutables})

    def check_batch(out, scan_rids, upto: int, label: str) -> int:
        """Each scan of a batch against the first ``upto`` puts."""
        rows = 0
        for hit, rid in zip(hits, scan_rids):
            r = out[rid]
            k = r.keys.astype(np.int64)
            check(np.all(k[1:] > k[:-1]),
                  f"{label}: keys not sorted and unique")
            pos = np.searchsorted(sorted_vocab, r.values)
            pos = np.minimum(pos, ndv - 1)
            check(np.array_equal(sorted_vocab[pos], r.values),
                  f"{label}: a value outside the vocabulary")
            idx = order[pos]
            check(bool(hit[idx].all()),
                  f"{label}: a value fails its predicate")
            at = np.minimum(np.searchsorted(pairs, k * ndv + idx),
                            pairs.shape[0] - 1)
            check(bool(np.all(pairs[at] == k * ndv + idx))
                  and bool(np.all(first[at] < upto)),
                  f"{label}: a pair the stream had not written")
            rows += int(k.shape[0])
        return rows

    def submit_batch(srv):
        specs = make_specs(SERVE_AGGS)
        rids = srv.submit_many([Predicate(*p) for p in preds[:8]])
        agg_rids = [srv.submit_agg(specs[0])]
        rids += srv.submit_many([Predicate(*p) for p in preds[8:]])
        agg_rids.append(srv.submit_agg(specs[1]))
        return rids, agg_rids

    done = threading.Event()
    errors, walls, rows = [], [], []
    # per reader batch: its snapshot's runs and seqno, and whether a flush
    # or compaction job was in flight on the workers at its start and end
    runs_seen, seqnos, busy_start, busy_end = [], [], [], []
    line = {"phase": "background.done"}
    ops.reset_launches()
    with LSMTree(cfg, device=device) as tree:
        srv = ScanServer(tree, max_batch=len(preds) + len(SERVE_AGGS),
                         maintenance="background")
        sched = tree._sched

        def busy() -> bool:
            return bool(sched._flush_inflight or sched._compact_inflight)

        def idle() -> bool:
            return not (busy() or tree._pending_flushes()
                        or tree._compaction_debt() > 0.0)

        # the reader's fused_zone_filter calls, each noting whether a
        # worker job was in flight as it launched (the wrapper the
        # Recorder holds is called as before)
        fused = ops.fused_zone_filter
        beside = []

        def fused_noting(*a, **k):
            if threading.current_thread().name == "reader":
                beside.append(busy())
            return fused(*a, **k)

        def reader():
            # waits for the first flushed run, then serves until the writer
            # is done and the fused filter launched beside a worker job
            # (or the workers are idle, which the checks then refuse)
            try:
                while not tree.all_runs() and not (done.is_set()
                                                   and idle()):
                    time.sleep(0.005)
                while not (done.is_set() and (any(beside) or idle())):
                    rids, agg_rids = submit_batch(srv)
                    t0 = time.perf_counter()
                    busy_start.append(busy())
                    snap = tree.snapshot()
                    runs_seen.append(len(snap.runs))
                    seqnos.append(snap.seqno)
                    out = srv.step(snapshot=snap)
                    torch.cuda.synchronize()
                    busy_end.append(busy())
                    walls.append(time.perf_counter() - t0)
                    # the snapshot holds exactly the stream's first
                    # snap.seqno mutations
                    rows.append(check_batch(out, rids, min(snap.seqno, n),
                                            "background.reader"))
                    at = prefix_model(stream, snap.seqno)
                    check_filters([out[r] for r in rids], at, preds,
                                  "background.reader")
                    check_aggs([out[r] for r in agg_rids], vocab,
                               at.state()[1], SERVE_AGGS,
                               "background.reader")
            except BaseException as e:   # SystemExit from check included
                errors.append(e)

        th = threading.Thread(target=reader, name="reader")
        ops.fused_zone_filter = fused_noting
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for i in range(0, n, BACKGROUND_BATCH):
                j = min(n, i + BACKGROUND_BATCH)
                tree.put_batch(keys[i:j], vocab[vidx[i:j]])
                if i == 0:   # the reader's batches never see an empty tree
                    th.start()
            for k in dels.tolist():
                tree.delete(k)
            torch.cuda.synchronize()
            ingest_s = time.perf_counter() - t0
        finally:
            done.set()
            if th.is_alive():
                th.join(timeout=120)
            ops.fused_zone_filter = fused
        reader_s = time.perf_counter() - t0
        check(not th.is_alive(), "background: the reader never stopped")
        if errors:
            fail(f"background: the reader failed: {errors[0]!r}")
        check(any(beside),
              f"background: the reader's fused_zone_filter never launched "
              f"beside a worker job ({beside}; runs {runs_seen}, in flight "
              f"at the start {busy_start} and the end {busy_end})")
        t1 = time.perf_counter()
        tree.drain(timeout=300)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t1
        launches = dict(ops.LAUNCHES)
        for kernel in MAIN_KERNELS:
            check(launches[kernel] > 0,
                  f"background: {kernel} never launched ({launches}; reader "
                  f"batches over {runs_seen} runs)")
        check(sched.n_bg_flushes >= 1 and sched.n_bg_compactions >= 1,
              f"background: {sched.n_bg_flushes} flushes and "
              f"{sched.n_bg_compactions} compactions on the workers")
        check(tree._pending_flushes() == 0
              and tree._compaction_debt() == 0.0,
              "background: drain left work behind")
        _, checks_s = durable_checks(tree, model, preds, windows, probe,
                                     "background.drained")
        sync_srv = ScanServer(tree, max_batch=len(preds) + len(SERVE_AGGS),
                              maintenance="sync")
        rids, agg_rids = submit_batch(sync_srv)
        t2 = time.perf_counter()
        out = sync_srv.step()
        sync_batch_s = time.perf_counter() - t2
        check(not sync_srv.queue, "background: the sync batch left requests")
        check_filters([out[r] for r in rids], model, preds,
                      "background.sync_server")
        check_aggs([out[r] for r in agg_rids], vocab, model.state()[1],
                   SERVE_AGGS, "background.sync_server")
        shape = tree.shape_report()
        n_ops = n + int(dels.shape[0])
        st = srv.stats
        line.update({
            "ops": n_ops, "ingest_s": ingest_s, "ops_per_s": n_ops / ingest_s,
            "reader_until_s": reader_s, "drain_s": drain_s,
            "n_bg_flushes": sched.n_bg_flushes,
            "n_bg_compactions": sched.n_bg_compactions,
            "n_flushes": shape["n_flushes"],
            "n_compactions": shape["n_compactions"],
            "write_slowdowns": shape["write_slowdowns"],
            "slowdown_seconds": shape["slowdown_seconds"],
            "write_stalls": shape["write_stalls"],
            "stall_seconds": shape["stall_seconds"],
            "throttle_s": dict(tree.throttle_stats.seconds),
            "flush_s": tree.flush_stats.total(),
            "compaction_stages_s": dict(tree.compaction_stats.seconds),
            "levels": shape["levels"],
            "reader": {"batches": st.n_batches, "runs_seen": runs_seen,
                       "seqnos": seqnos, "busy_start": busy_start,
                       "busy_end": busy_end,
                       "fused_calls": len(beside),
                       "fused_calls_beside_a_worker": sum(beside),
                       "batch_sizes": sorted(set(st.batch_sizes)),
                       "wall_s_median": statistics.median(walls),
                       "wall_s_max": max(walls),
                       "wait_s_median": statistics.median(st.wait_seconds),
                       "rows_checked": sum(rows)},
            "checks_s": checks_s, "sync_batch_s": sync_batch_s,
            "launches": launches,
            "sync_codecs_opd_ingest": sync_ingest})
    del tree, srv, sync_srv
    gc.collect()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)


# --------------------------------------------------------------------------- #
# compaction policies: a tiered tree, its migration to leveling, the tuner
# --------------------------------------------------------------------------- #
# pairs of the policy stream: 2^20 make 8 memtable rotations, and two
# stacked L1 runs under tier_runs=4 need more than 4, so no flag lowers it
POLICY_PAIRS = 1 << 20


def policy_phase(args, recs, leveled: dict, device: str) -> None:
    """policy: the main configuration and the main phase's generator at
    ``POLICY_PAIRS``.  (a) A tiered tree (``tier_runs=4``) takes the
    stream and ``compact()``: some level below L0 must hold stacked runs
    (run depth >= 2); filter_many (K=16), 8 range_lookup windows, 1,024
    gets and the 6 aggregate specs (the general path) must equal the host
    model, and a snapshot is pinned.  (b) ``set_policy`` to leveling and
    ``compact()``: the whole stacked level merges into the level below,
    every level ends at run depth <= 1 and the same reads equal the model,
    now and at the snapshot pinned in (a).  The launch counts are reset
    before (a)'s ingest and read after (b)'s checks: pack_codes,
    unpack_codes, remap_pack_codes and fused_zone_filter must each have
    launched, and a fused_zone_filter launch must have read the stacked
    level.  (c) A tree with ``policy_autotune`` takes the stream and
    ``compact()`` (a write-only window), then 1,024 gets and one
    filter_many checked against the model and ``compact()`` (a scan
    window): the tuner must have retuned at least twice, and the reads
    after it equal the model.  policy.done carries each part's wall
    seconds, merges and compaction bytes beside the codecs phase's leveled
    'opd' tree (``leveled``), ``shape_report`` before and after the
    migration, the tuner's decisions and the launches."""
    import dataclasses
    import gc

    import torch
    from repro_torch import LSMTree, Predicate
    from repro_torch.core import CompactionPolicy
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    for r in recs.values():
        r.active = False
    rng = np.random.default_rng(args.seed + 7)
    n, base = POLICY_PAIRS, main_config()
    stream = make_stream(rng, n, base.value_width)
    dels = stream[3]
    preds, windows, probe = read_plan(rng, stream)
    model = prefix_model(stream, n + dels.shape[0])
    cfg = dataclasses.replace(base, compaction_policy="tiered", tier_runs=4)
    emit({"phase": "policy", "reduced": "pairs 6.4e7 -> %.1e (host-side "
          "ingest of three trees within the smoke's time limit)" % n,
          "pairs": n, "deletes": int(dels.shape[0]),
          "value_width": cfg.value_width, "file_bytes": cfg.file_bytes,
          "policy": cfg.compaction_policy, "tier_runs": cfg.tier_runs,
          "l0_limit": cfg.l0_limit, "size_ratio": cfg.size_ratio})

    def merges(tree) -> dict:
        return {"n_flushes": tree.n_flushes,
                "n_compactions": tree.n_compactions,
                "compaction_in_bytes": tree.compaction_in_bytes,
                "compaction_out_bytes": tree.compaction_out_bytes}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the fused_level_filter calls that read a run of the stacked level
    stacked_ids = set()
    stacked_reads = []
    fused_level = ops.fused_level_filter

    def fused_noting(packed_list, *a, **k):
        hit = sum(id(p) in stacked_ids for p in packed_list)
        if hit:
            stacked_reads.append(hit)
        return fused_level(packed_list, *a, **k)

    line = {"phase": "policy.done"}

    def tiered_then_leveled():
        tree = LSMTree(cfg, device=device)
        out = {"ingest_s": ingest(tree, stream), "ingest": merges(tree)}
        _, out["compact_s"] = timed(tree.compact)
        out["tiered"] = merges(tree)
        shape = tree.shape_report()
        out["shape_tiered"] = shape
        deep = [i for i, d in enumerate(shape["run_depths"]) if i and d >= 2]
        check(bool(deep), f"policy: no level below L0 stacked runs "
              f"(run depths {shape['run_depths']})")
        out["stacked_level"] = deep[0]
        stacked_ids.update(id(s.packed) for s in tree.levels[deep[0]])
        ops.fused_level_filter = fused_noting
        try:
            answers, out["tiered_checks_s"] = durable_checks(
                tree, model, preds, windows, probe, "policy.tiered")
        finally:
            ops.fused_level_filter = fused_level
        snap = tree.snapshot()
        tree.set_policy(CompactionPolicy(kind="leveled"))
        _, out["migrate_s"] = timed(tree.compact)
        out["migrated"] = merges(tree)
        shape = tree.shape_report()
        out["shape_leveled"] = shape
        check(max(shape["run_depths"]) <= 1, f"policy: run depths "
              f"{shape['run_depths']} after the migration")
        now, out["leveled_checks_s"] = durable_checks(
            tree, model, preds, windows, probe, "policy.migrated")
        pinned, out["snapshot_checks_s"] = durable_checks(
            tree, model, preds, windows, probe, "policy.snapshot",
            snapshot=snap)
        check(same_answers(answers, now) and same_answers(answers, pinned),
              "policy: answers moved across the migration")
        return out

    out, launches = launch_window(tiered_then_leveled)
    for kernel in MAIN_KERNELS:
        check(launches[kernel] > 0,
              f"policy: {kernel} never launched ({launches})")
    check(bool(stacked_reads),
          "policy: no fused_zone_filter launch read the stacked level")
    gc.collect()

    tree = LSMTree(dataclasses.replace(base, policy_autotune=True),
                   device=device)
    tuner = {"ingest_s": ingest(tree, stream)}
    _, tuner["write_window_compact_s"] = timed(tree.compact)
    tuner["after_write_window"] = tree.policy.describe()

    def scans():
        gets = [tree.get(k) for k in probe.tolist()]
        for k, g in zip(probe.tolist(), gets):
            check(g == model.get(k), f"policy.tuner: get({k}) = {g!r}")
        check_filters(tree.filter_many([Predicate(*p) for p in preds]),
                      model, preds, "policy.tuner")

    _, tuner["scan_window_s"] = timed(scans)
    _, tuner["scan_window_compact_s"] = timed(tree.compact)
    _, tuner["final_checks_s"] = timed(scans)
    shape = tree.shape_report()
    check(shape["n_retunes"] >= 2,
          f"policy.tuner: {shape['n_retunes']} retunes")
    tuner.update({"decisions": [dataclasses.asdict(d)
                                for d in tree.tuner.history],
                  "n_retunes": shape["n_retunes"],
                  "n_policy_switches": shape["n_policy_switches"],
                  "policy": shape["policy"], "levels": shape["levels"],
                  "run_depths": shape["run_depths"], **merges(tree)})
    del tree
    gc.collect()
    line.update({**out, "fused_launches_reading_the_stacked_level":
                 len(stacked_reads), "stacked_runs_per_launch": stacked_reads,
                 "launches": launches, "tuner": tuner, "leveled": leveled,
                 "seconds": time.perf_counter() - t_phase})
    emit(line)


# --------------------------------------------------------------------------- #
# range sharding: a sharded engine on the card, a hot-shard split, restore
# --------------------------------------------------------------------------- #
SHARD_KERNELS = ("pack_codes", "unpack_codes", "remap_pack_codes",
                 "fused_zone_filter", "fused_zone_agg", "zone_histogram",
                 "multi_range_filter_packed")
SPLIT_PAIRS = 1 << 18        # part (b)'s puts
SPLIT_BATCH = 1 << 16        # pairs a put_batch call in part (b)
SPLIT_THRESHOLD = 32 << 20   # ingest bytes since a shard's last split


def shard_windows(space: int, boundaries) -> list:
    """6 of ``read_plan``'s windows of 1/64 of the key space and 2 of that
    width centred on the first and the last inner shard boundary."""
    w = space // 64
    windows = [(i * space // 8 + space // 32,
                i * space // 8 + space // 32 + w - 1) for i in range(6)]
    return windows + [(b - w // 2, b + w // 2 - 1)
                      for b in (boundaries[0], boundaries[-2])]


def shard_probe(rng, keys: np.ndarray, dels: np.ndarray, space: int):
    """``PROBE_PARTS`` probe keys (present, deleted, missing) inside the
    engine's key space: the router takes no key past ``key_max``."""
    present, deleted, missing = PROBE_PARTS
    pool = rng.integers(0, space, 4 * missing, dtype=np.uint64)
    pool = pool[~np.isin(pool, keys)][:missing]
    gone = dels[:deleted] if dels.shape[0] else np.zeros(0, np.uint64)
    return np.concatenate([rng.choice(keys, present), gone, pool])


def shard_shape(eng) -> dict:
    rep = eng.shape_report()
    return {"n_shards": rep["n_shards"], "n_splits": rep["n_splits"],
            "boundaries": rep["boundaries"],
            "levels": [s["levels"] for s in rep["per_shard"]],
            "n_flushes": rep["n_flushes"],
            "n_compactions": rep["n_compactions"],
            "disk_bytes": rep["disk_bytes"]}


def sharded_phase(args, recs, card: str, device: str) -> None:
    """sharded: the range-sharded engine (``repro_torch.shard``) in the
    main configuration, all shards on the one card.  (a) sharded.engine:
    4 shards over [0, 4 n) with 4 workers take the codecs phase's stream
    (``--codec-pairs`` pairs, 2,048 deletes) through ``put_batch`` and
    ``compact_all()``; filter_many (K=16), aggregate_many (the 6 specs,
    the bucket edges resolved once over every shard), 8 range_lookup
    windows (2 across a shard boundary) and 1,024 gets must equal the host
    model, and a ``ScanServer`` over the engine on 'jax_packed' (16 scans,
    2 aggregates) too.  (b) sharded.splits: 2 shards with a spill
    directory, ``wal_sync='group'`` and a ``RebalanceConfig`` (threshold
    32 MiB, skew 1.5, at most 4 shards) take ``SPLIT_PAIRS`` puts in
    ``put_batch`` calls of ``SPLIT_BATCH``, 3/4 of the keys in the lowest
    1/8 of the key space, a snapshot pinned after the first quarter; at
    least one split must run, the reads at the snapshot equal the model of
    that quarter and the current ones the model of the stream; then
    ``close()``, ``ShardedLSM.restore`` on the card and the current reads
    again.  Each part resets the launch counts before its ingest and reads
    them after its checks; over the phase, each of ``SHARD_KERNELS`` must
    have launched."""
    import dataclasses
    import gc
    import tempfile

    import torch
    from repro_torch import Predicate, ScanServer
    from repro_torch.shard import RebalanceConfig, ShardedLSM

    t_phase = time.perf_counter()
    for r in recs.values():
        r.active = False
    cfg = main_config()
    total = collections.Counter()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) 4 shards, the codecs phase's stream
    rng = np.random.default_rng(args.seed + 3)
    n = args.codec_pairs
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    model = prefix_model(stream, n + dels.shape[0])
    preds = make_preds(vocab)
    space = 4 * n
    eng = ShardedLSM(cfg, n_shards=4, key_max=space, n_workers=4,
                     device=device)
    windows = shard_windows(space, eng.router.uppers)
    probe = shard_probe(np.random.default_rng(args.seed + 8), keys, dels,
                        space)
    line = {"phase": "sharded.engine", "card": card, "pairs": n,
            "deletes": int(dels.shape[0]), "key_max": space,
            "n_workers": 4, "reduced": "pairs 6.4e7 -> %.1e (the smoke's "
            "time limit)" % n}

    def engine_part():
        out = {"ingest_s": ingest(eng, stream)}
        _, out["compact_all_s"] = timed(eng.compact_all)
        _, out["checks_s"] = durable_checks(
            eng, model, preds, windows, probe, "sharded.engine")
        fused_cfg = eng.cfg
        packed_cfg = dataclasses.replace(fused_cfg,
                                         filter_backend="jax_packed")
        eng.cfg = packed_cfg
        for t in eng.shards:
            t.cfg = packed_cfg
        srv = ScanServer(eng, max_batch=16)
        rids = srv.submit_many([Predicate(*p) for p in preds])
        aids = srv.submit_aggs(make_specs(SERVE_AGGS))
        got, out["server_s"] = timed(srv.drain)
        eng.cfg = fused_cfg
        for t in eng.shards:
            t.cfg = fused_cfg
        check_filters([got[r] for r in rids], model, preds,
                      "sharded.engine server")
        check_aggs([got[r] for r in aids], vocab, model.state()[1],
                   SERVE_AGGS, "sharded.engine server")
        check(srv.stats.batch_sizes == [16, 2],
              f"sharded.engine: server batches {srv.stats.batch_sizes}")
        out["server_batches"] = srv.stats.batch_sizes
        return out

    t0 = time.perf_counter()
    out, launches = launch_window(engine_part)
    line.update(out)
    line.update({"seconds": time.perf_counter() - t0, **shard_shape(eng),
                 "agg_counts": agg_counts(eng),
                 "windows": windows, "launches": launches})
    check(eng.n_shards == 4 and all(s["levels"][0] == 0 for s in
                                    eng.shape_report()["per_shard"]),
          "sharded.engine: compact_all left L0 runs")
    total.update(launches)
    emit(line)
    eng.close()
    del eng
    gc.collect()

    # (b) 2 shards, a skewed stream, a split, a restore
    rng = np.random.default_rng(args.seed + 9)
    n = SPLIT_PAIRS
    space = 4 * n
    vocab = make_vocab(max(1, int(n * 0.01)), cfg.value_width, rng)
    hot = rng.random(n) < 0.75
    keys = np.where(hot, rng.integers(0, space // 8, n),
                    rng.integers(0, space, n)).astype(np.uint64)
    vidx = rng.integers(0, vocab.shape[0], n)
    dels = np.zeros(0, np.uint64)
    stream = (keys, vocab, vidx, dels)
    preds = make_preds(vocab)
    probe = shard_probe(np.random.default_rng(args.seed + 10), keys, dels,
                        space)
    wal_cfg = dataclasses.replace(cfg, wal_sync="group")
    reb = RebalanceConfig(split_threshold_bytes=SPLIT_THRESHOLD,
                          skew_factor=1.5, max_shards=4)
    pin_at = n // 4
    line = {"phase": "sharded.splits", "card": card, "pairs": n,
            "batch": SPLIT_BATCH, "key_max": space, "hot_share": 0.75,
            "hot_keys": space // 8, "wal_sync": wal_cfg.wal_sync,
            "rebalance": dataclasses.asdict(reb), "pinned_after": pin_at,
            "reduced": "pairs 6.4e7 -> %.1e (the smoke's time limit)" % n}

    def split_part(spill):
        out = {}
        eng = ShardedLSM(wal_cfg, n_shards=2, key_max=space,
                         rebalance=reb, spill_dir=spill, device=device)
        snap = None
        t0 = time.perf_counter()
        for i in range(0, n, SPLIT_BATCH):
            eng.put_batch(keys[i:i + SPLIT_BATCH],
                          vocab[vidx[i:i + SPLIT_BATCH]])
            if i + SPLIT_BATCH == pin_at:
                snap = eng.snapshot()
                out["splits_at_pin"] = eng.n_splits
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        out.update(shard_shape(eng))
        check(eng.n_splits >= 1, "sharded.splits: no split ran")
        check(out["splits_at_pin"] < eng.n_splits,
              f"sharded.splits: every split ({eng.n_splits}) ran before "
              "the pin, so the pinned reads cross none")
        win = shard_windows(space, eng.router.uppers)
        out["windows"] = win
        pinned = prefix_model(stream, pin_at)
        now = prefix_model(stream, n)
        _, out["snapshot_checks_s"] = durable_checks(
            eng, pinned, preds, win, probe, "sharded.splits pinned",
            snapshot=snap)
        answers, out["checks_s"] = durable_checks(
            eng, now, preds, win, probe, "sharded.splits")
        del snap
        eng.close()
        back, out["restore_s"] = timed(
            lambda: ShardedLSM.restore(wal_cfg, spill, device=device))
        check(back.router.uppers == out["boundaries"],
              "sharded.splits: restored boundaries differ")
        out["wal_replayed"] = sum(t.wal_replayed for t in back.shards)
        again, out["restored_checks_s"] = durable_checks(
            back, now, preds, win, probe, "sharded.splits restored")
        check(same_answers(answers, again),
              "sharded.splits: answers moved across the restore")
        back.close()
        return out

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sharded-") as spill:
        out, launches = launch_window(lambda: split_part(spill))
    line.update({**out, "seconds": time.perf_counter() - t0,
                 "launches": launches})
    total.update(launches)
    emit(line)
    gc.collect()
    for kernel in SHARD_KERNELS:
        check(total[kernel] > 0,
              f"sharded: {kernel} never launched ({dict(total)})")
    emit({"phase": "sharded.done", "card": card,
          "seconds": time.perf_counter() - t_phase,
          "launches": dict(total)})


# --------------------------------------------------------------------------- #
# replication: a leader and two followers on the card, failover, resync
# --------------------------------------------------------------------------- #
REPLICA_KERNELS = ("pack_codes", "unpack_codes", "remap_pack_codes",
                   "fused_zone_filter", "fused_zone_agg", "zone_histogram")
REPLICA_PAIRS = 1 << 17      # 1.1 memtables of 32 MiB: one flush a replica
REPLICA_BATCH = 1 << 14      # pairs a put_batch call, pumped after each
REPLICA_LIMIT_S = 30.0       # the phase's own time limit


def replica_phase(args, recs, card: str, device: str) -> None:
    """replica: a ``ReplicatedShard`` (``repro_torch.replica``) of the main
    configuration with ``wal_sync='group'``, a leader and 2 followers on
    the one card in a temporary root, ``ReadPolicy(max_lag_seqnos=0)``,
    ``auto_pump=False``.  ``REPLICA_PAIRS`` puts of the main phase's
    generator (seed + 11) in ``put_batch`` calls of ``REPLICA_BATCH``, each
    followed by a ``pump()`` timed apart, link 2 partitioned for the middle
    four batches, then n / 512 deletes: every watermark reaches the head,
    link 2 shows blocked pumps and one resume.  Reads (filter_many K=16, 8
    range_lookup windows, 1,024 gets, the 6 aggregate specs) at a routed
    snapshot must come from a follower at lag 0 and equal the host model,
    and a ``ScanServer`` batch over the group too.  ``kill_leader()`` and
    ``promote(best_follower())``: nothing acknowledged lost, the EPOCH file
    at epoch 2 with leader 1, ``downtime_ms`` from the kill to the first
    routed snapshot (``benchmarks/bench_replica.py``'s), a server batch
    on the new epoch.  ``compact()`` on the new leader (its flush, then an
    L0 -> L1 merge) and the reads again, routed to the follower and, under
    ``ReadPolicy(prefer_follower=False)``, to the compacted leader (the
    aggregates' fast path).  ``resync_follower(0)`` (a copy of the
    leader's directory, ``LSMTree.restore`` on the card), ``REPLICA_BATCH``
    more puts shipped to both followers, and every replica's reads equal to
    the leader's and to the model.  ``close()``, ``ReplicatedShard.restore``
    on the card: epoch 2, leader 1, the reads again.  The launch counts are
    reset before the ingest and read after the checks: each of
    ``REPLICA_KERNELS`` must have launched.  Cut from the harness's 6.4e7
    pairs to ``REPLICA_PAIRS`` (the phase's 30 s): three replicas share one
    card and one host, and the phase claims no scaling."""
    import dataclasses
    import gc
    import json
    import os
    import tempfile

    import torch
    from repro_torch import Predicate, ScanServer
    from repro_torch.replica import EPOCH_FILE, ReadPolicy, ReplicatedShard

    t_phase = time.perf_counter()
    for r in recs.values():
        r.active = False
    cfg = dataclasses.replace(main_config(), wal_sync="group")
    rng = np.random.default_rng(args.seed + 11)
    n = REPLICA_PAIRS
    stream = make_stream(rng, n, cfg.value_width)
    keys, vocab, vidx, dels = stream
    n_muts = n + dels.shape[0]
    preds, windows, probe = read_plan(rng, stream)
    extra_keys = rng.integers(0, 4 * n, REPLICA_BATCH, dtype=np.uint64)
    extra_idx = rng.integers(0, vocab.shape[0], REPLICA_BATCH)
    model = prefix_model(stream, n_muts)
    policy = ReadPolicy(max_lag_seqnos=0)
    on = torch.device(device).type
    line = {"phase": "replica.done", "card": card, "pairs": n,
            "deletes": int(dels.shape[0]), "batch": REPLICA_BATCH,
            "n_followers": 2, "wal_sync": cfg.wal_sync,
            "read_policy": dataclasses.asdict(policy),
            "reduced": "pairs 6.4e7 -> %.1e (the phase's %.0f s; one flush "
            "a replica)" % (n, REPLICA_LIMIT_S)}

    def synced(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def routed_checks(grp, label, want_follower=True):
        snap = grp.snapshot()
        check(snap.follower == want_follower and snap.lag == 0,
              f"{label}: routed to replica {snap.replica} (follower "
              f"{snap.follower}) at lag {snap.lag}")
        got, dt = durable_checks(grp, model, preds, windows, probe, label,
                                 snapshot=snap)
        return got, dt, snap.replica

    def serve(grp, label):
        srv = ScanServer(grp, max_batch=16)
        rids = srv.submit_many([Predicate(*p) for p in preds])
        aids = srv.submit_aggs(make_specs(SERVE_AGGS))
        got, dt = synced(srv.drain)
        check_filters([got[r] for r in rids], model, preds, label)
        check_aggs([got[r] for r in aids], vocab, model.state()[1],
                   SERVE_AGGS, label)
        check(srv.stats.batch_sizes == [16, 2],
              f"{label}: server batches {srv.stats.batch_sizes}")
        return dt

    def part(root):
        out = {}
        grp = ReplicatedShard(cfg, root, n_followers=2, read_policy=policy,
                              auto_pump=False, device=device)
        ingest_s = ship_s = 0.0
        n_batches = n // REPLICA_BATCH
        for b, i in enumerate(range(0, n, REPLICA_BATCH)):
            _, dt = synced(grp.put_batch, keys[i:i + REPLICA_BATCH],
                           vocab[vidx[i:i + REPLICA_BATCH]])
            ingest_s += dt
            if b == n_batches // 2 - 2:
                grp.links[2].partition()
            _, dt = synced(grp.pump)
            ship_s += dt
            if b == n_batches // 2 + 1:
                grp.links[2].heal()
        t0 = time.perf_counter()
        for k in dels.tolist():
            grp.delete(k)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        _, dt = synced(grp.pump)
        ship_s += dt
        rep = grp.replication_report()
        out.update({"ingest_s": ingest_s,
                    "ingest_ops_per_s": n_muts / ingest_s, "ship_s": ship_s,
                    "applied": {i: lk.shipped for i, lk in grp.links.items()},
                    "links": rep["links"], "log_retained": rep["log_retained"],
                    "log_floor": rep["log_floor"],
                    "n_flushes": {i: t.n_flushes
                                  for i, t in grp.replicas.items()}})
        check(rep["head_seqno"] == n_muts and
              set(rep["watermarks"].values()) == {n_muts},
              f"replica: watermarks {rep['watermarks']} != head {n_muts}")
        check(rep["links"][2]["blocked"] > 0 and
              rep["links"][2]["resumes"] == 1,
              f"replica: partitioned link 2 reports {rep['links'][2]}")
        check(all(t.n_flushes >= 1 for t in grp.replicas.values()),
              f"replica: a replica never flushed ({out['n_flushes']})")
        # (2) a routed read at lag 0, and a server batch, before the kill
        answers, out["follower_checks_s"], out["follower_read_by"] = \
            routed_checks(grp, "replica.follower")
        check(grp.read_stats.counts["read_lag_max"] == 0,
              "replica: a follower read saw lag")
        out["server_before_s"] = serve(grp, "replica.server before")
        # (3) failover
        t_kill = time.perf_counter()
        out["killed"] = grp.kill_leader()
        best = grp.best_follower()
        w, out["promote_s"] = synced(grp.promote, best)
        grp.snapshot()   # the first routed read on the new epoch
        out["downtime_ms"] = (time.perf_counter() - t_kill) * 1e3
        check(w == n_muts, f"replica: promote lost {n_muts - w} acked "
              "mutations")
        with open(os.path.join(root, EPOCH_FILE)) as f:
            epoch = json.load(f)
        check(epoch["epoch"] == 2 and epoch["leader"] == 1 == best,
              f"replica: EPOCH {epoch}, best follower {best}")
        out["epoch_file"] = epoch
        out["server_after_s"] = serve(grp, "replica.server after")
        # (4) the new leader compacts on the card
        _, out["compact_s"] = synced(grp.compact)
        lvl = grp.leader.shape_report()["levels"]
        check(lvl[0] == 0 and lvl[1] > 0,
              f"replica: the compacted leader holds levels {lvl}")
        got, out["compacted_follower_checks_s"], _ = routed_checks(
            grp, "replica.compacted follower")
        check(same_answers(answers, got), "replica: answers moved across "
              "the promote")
        grp.read_policy = ReadPolicy(prefer_follower=False)
        got, out["compacted_leader_checks_s"], _ = routed_checks(
            grp, "replica.compacted leader", want_follower=False)
        check(same_answers(answers, got), "replica: the compacted leader "
              "answers otherwise")
        grp.read_policy = policy
        out["leader_agg_counts"] = agg_counts(grp.leader)
        # (5) the old leader back through a snapshot resync, more writes
        t, out["resync_s"] = synced(grp.resync_follower, 0)
        check(all(s.packed.device.type == on for s in t.all_runs()),
              "replica: the resynced follower's runs are not on the card")
        grp.put_batch(extra_keys, vocab[extra_idx])
        model.put(extra_keys, extra_idx)
        _, out["ship_extra_s"] = synced(grp.pump)
        head = grp.leader._seqno
        check(head == n_muts + REPLICA_BATCH and all(
            grp.replicas[i]._seqno == head for i in (0, 1, 2)),
              f"replica: after the resync {grp.replication_report()}")
        per = {}
        for i in (1, 0, 2):
            got, per[i] = durable_checks(grp.replicas[i], model, preds,
                                         windows, probe, f"replica.r{i}")
            if i == 1:
                answers = got
            check(same_answers(answers, got),
                  f"replica: r{i} answers otherwise than the leader")
        out["replica_checks_s"] = per
        out["report"] = grp.replication_report()
        out["levels"] = {i: t.shape_report()["levels"]
                         for i, t in grp.replicas.items()}
        # (6) the group closed and restored on the card
        grp.close()
        del grp
        back, out["restore_s"] = synced(
            lambda: ReplicatedShard.restore(cfg, root, read_policy=policy,
                                            auto_pump=False, device=device))
        check(back.epoch == 2 and back.leader_idx == 1 and
              back.live_followers() == [0, 2],
              f"replica: restored at epoch {back.epoch}, leader "
              f"{back.leader_idx}, followers {back.live_followers()}")
        check(all(s.packed.device.type == on
                  for t in back.replicas.values() for s in t.all_runs()),
              "replica: a restored run is not on the card")
        got, out["restored_checks_s"], _ = routed_checks(
            back, "replica.restored")
        check(same_answers(answers, got),
              "replica: answers moved across the group restore")
        out["reads"] = dict(back.read_stats.counts)
        back.close()
        return out

    with tempfile.TemporaryDirectory(prefix="replica-") as root:
        out, launches = launch_window(lambda: part(root))
    gc.collect()
    seconds = time.perf_counter() - t_phase
    line.update({**out, "launches": launches, "seconds": seconds})
    emit(line)
    for kernel in REPLICA_KERNELS:
        check(launches.get(kernel, 0) > 0,
              f"replica: {kernel} never launched ({launches})")
    check(seconds <= REPLICA_LIMIT_S,
          f"replica: the phase took {seconds:.1f} s of its "
          f"{REPLICA_LIMIT_S:.0f} s")


# --------------------------------------------------------------------------- #
# lm: the engine's two consumers feeding a dense LM served at full width
# --------------------------------------------------------------------------- #
LM_ARCH = "llama3-8b"
LM_DOMAINS = (b"web/high", b"web/low", b"code/high", b"code/low",
              b"math/high")                # tests/test_pipeline.py's
LM_SAMPLES = 1 << 18         # TokenStore samples
LM_PREFIXES = 1 << 14        # PrefixCacheIndex prefixes of LM_PREFIX_LEN
LM_PREFIX_LEN = 32
LM_DP = 4                    # data-parallel ranks of the selection
LM_PROMPT, LM_NEW, LM_REQUESTS = 16, 16, 8
LM_SLOTS, LM_MAX_SEQ = 4, 64
LM_F32_LAYERS, LM_F32_TOL = 2, 2e-4   # tests/test_models_smoke.py's 2e-4
# A served token must equal the forward's argmax wherever the forward's
# top-two margin exceeds this (logits, bf16).  It is twice the largest
# |decode - forward| logit difference a bf16 run may show, which the phase
# measures on the same sequences and checks: bf16 rounds logits of 4-8 to
# steps of 2^-5, and 32 layers of bf16 products add to that.
LM_BF16_TOL = 0.5
LM_LIMIT_S = 60.0
# the store's flushes and compactions ('jax_packed')
LM_INGEST_KERNELS = ("pack_codes", "unpack_codes", "remap_pack_codes")


def np_splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over uint64, the host model of the stores'
    key hash."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def lm_store_part(rng, vocab: int, device: str):
    """A TokenStore on the card: LM_SAMPLES samples (payloads of 64-256
    token ids), 1/16 of them then deleted or re-ingested; ``select`` per
    rank and ``batches`` against the host model.  Returns (the line's
    fields, the store's first batch of LM_DP rank 0: the prompts)."""
    import torch
    from repro_torch.core import Predicate
    from repro_torch.pipeline import TokenStore

    n = LM_SAMPLES
    lens = rng.integers(64, 257, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    flat = rng.integers(0, vocab, int(offs[-1])).astype(np.int32)
    dom = rng.integers(0, len(LM_DOMAINS), n)
    churn = rng.choice(n, n // 16, replace=False)
    redo = rng.random(churn.shape[0]) < 0.5
    new_dom = rng.integers(0, len(LM_DOMAINS), churn.shape[0])
    new_src = rng.integers(0, n, churn.shape[0])
    payload = {i: (offs[i], offs[i + 1]) for i in range(n)}
    meta = dom.copy()
    live = np.ones(n, bool)

    store = TokenStore(device=device)

    def ingest():
        for i in range(n):
            store.put_sample(i, flat[offs[i]:offs[i + 1]], LM_DOMAINS[dom[i]])
        for j, i in enumerate(churn.tolist()):
            if redo[j]:
                s = int(new_src[j])
                store.put_sample(i, flat[offs[s]:offs[s + 1]],
                                 LM_DOMAINS[new_dom[j]])
                payload[i] = (offs[s], offs[s + 1])
                meta[i], live[i] = new_dom[j], True
            else:
                store.delete_sample(i)
                payload.pop(i, None)
                live[i] = False
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    _, ingest_launches = launch_window(ingest)
    ingest_s = time.perf_counter() - t0
    for kernel in LM_INGEST_KERNELS:
        check(ingest_launches.get(kernel, 0) > 0,
              f"lm.store: the ingest never launched {kernel} "
              f"({ingest_launches})")
    check(len(store) == int(live.sum()),
          f"lm.store: {len(store)} samples, the model {int(live.sum())}")

    ids = np.arange(n, dtype=np.uint64)
    code = live & np.isin(meta, [2, 3])          # b"code/..." domains
    owner = np_splitmix64(ids) % np.uint64(LM_DP)
    pred = Predicate("prefix", b"code/")
    t0 = time.perf_counter()
    parts, sel = launch_window(
        lambda: [store.select(pred, r, LM_DP) for r in range(LM_DP)])
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    for r, got in enumerate(parts):
        want = ids[code & (owner == np.uint64(r))]
        check(got.dtype == np.uint64 and np.array_equal(got, want),
              f"lm.store: rank {r} selected {got.shape[0]} keys, the model "
              f"{want.shape[0]}")
    union = np.concatenate(parts)
    check(np.unique(union).shape[0] == union.shape[0] == int(code.sum()),
          "lm.store: the ranks' selections are not disjoint and complete")
    check(sel.get("fused_zone_filter", 0) > 0,
          f"lm.store: select launched no fused_zone_filter ({sel})")

    batch = next(store.batches(pred, LM_REQUESTS, LM_PROMPT, dp_rank=0,
                               dp_size=LM_DP, seed=1))
    keys = parts[0].copy()
    np.random.default_rng(1).shuffle(keys)
    need = LM_REQUESTS * (LM_PROMPT + 1)
    stream, total = [], 0
    for k in keys.tolist():
        a, b = payload[k]
        stream.append(flat[a:b])
        total += b - a
        if total >= need:
            break
    block = np.concatenate(stream)[:need].reshape(LM_REQUESTS, LM_PROMPT + 1)
    check(np.array_equal(batch["tokens"], block[:, :-1]) and
          np.array_equal(batch["labels"], block[:, 1:]),
          "lm.store: batches differ from the host model")
    fields = {"samples": n, "churn": int(churn.shape[0]),
              "deleted": int((~redo).sum()), "store_ingest_s": ingest_s,
              "store_select_s": select_s,
              "selected": [int(p.shape[0]) for p in parts],
              "store_flushes": store.lsm.n_flushes,
              "store_compactions": store.lsm.n_compactions,
              "store_levels": store.lsm.shape_report()["levels"],
              "store_ingest_launches": ingest_launches,
              "store_select_launches": sel}
    return fields, batch["tokens"]


def lm_prefix_part(rng, vocab: int, device: str) -> dict:
    """A PrefixCacheIndex on the card: LM_PREFIXES prefixes, two tenants,
    hot and cold tags; lookups, retags, evictions, ``scan`` and
    ``eviction_candidates`` against a host dictionary."""
    import torch
    from repro_torch.core import Predicate
    from repro_torch.serving.prefix_cache import PrefixCacheIndex

    n = LM_PREFIXES
    prompts = rng.integers(0, vocab, (n, LM_PREFIX_LEN))
    h = np.full(n, 0xCBF29CE484222325, np.uint64)
    for t in range(LM_PREFIX_LEN):
        h = np_splitmix64(h ^ prompts[:, t].astype(np.uint64))
    tags = [b"tenantA/hot", b"tenantA/cold", b"tenantB/hot", b"tenantB/cold"]
    tag = rng.integers(0, 4, n)
    idx = PrefixCacheIndex(device=device)
    t0 = time.perf_counter()
    for i in range(n):
        k = idx.admit(prompts[i], [2 * i, 2 * i + 1], tags[tag[i]])
        check(k == int(h[i]), f"lm.prefix: key of prefix {i} is {k}, the "
              f"host model's {int(h[i])}")
    admit_s = time.perf_counter() - t0
    demote = rng.choice(np.flatnonzero(tag % 2 == 0), 256, replace=False)
    for i in demote.tolist():
        idx.retag(prompts[i], tags[tag[i] + 1])
        tag[i] += 1
    evicted = rng.choice(n, 512, replace=False)
    idx.evict_prefixes(list(prompts[evicted]))
    live = np.ones(n, bool)
    live[evicted] = False

    t0 = time.perf_counter()
    for i in rng.choice(n, 1024, replace=False).tolist():
        want = (tags[tag[i]], [2 * i, 2 * i + 1]) if live[i] else None
        check(idx.lookup(prompts[i]) == want, f"lm.prefix: lookup {i}")
    check(idx.lookup(rng.integers(0, vocab, LM_PREFIX_LEN)) is None,
          "lm.prefix: an unknown prefix was found")
    lookup_s = time.perf_counter() - t0

    def window():
        got = {}
        for pre in (b"tenantA/", b"tenantB/hot"):
            got[pre] = idx.scan(Predicate("prefix", pre))
        got["cold"] = idx.eviction_candidates(b"tenantA/cold")
        return got

    t0 = time.perf_counter()
    got, launches = launch_window(window)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    name = np.asarray([t.decode() for t in tags])[tag]
    for pre in (b"tenantA/", b"tenantB/hot"):
        want = np.sort(h[live & np.char.startswith(name, pre.decode())])
        check(np.array_equal(got[pre], want),
              f"lm.prefix: scan {pre!r} found {got[pre].shape[0]}, the "
              f"host model {want.shape[0]}")
    cold = live & (name == "tenantA/cold")
    order = np.argsort(h[cold])
    want = [[2 * i, 2 * i + 1] for i in np.flatnonzero(cold)[order].tolist()]
    check(got["cold"] == want, "lm.prefix: eviction candidates differ")
    check(launches.get("fused_zone_filter", 0) > 0,
          f"lm.prefix: the scans launched no fused_zone_filter ({launches})")
    stats = idx.stats
    check(stats["prefixes"] == int(live.sum()), f"lm.prefix: {stats}")
    return {"prefixes": n, "retagged": int(demote.shape[0]),
            "evicted": int(evicted.shape[0]), "prefix_admit_s": admit_s,
            "prefix_lookup_s": lookup_s, "prefix_scan_s": scan_s,
            "prefix_flushes": idx.lsm.n_flushes, "prefix_stats": stats,
            "prefix_scan_launches": launches}


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN's
    convolutions (the mamba block's causal conv), restored after."""
    import torch

    precision = torch.get_float32_matmul_precision()
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = conv_tf32


def no_drops(cfg):
    """``cfg`` with capacity_factor E / k for a moe config: the forward's
    capacity is then T, so it drops nothing, as decode's dropless one."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                              / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=moe)


def lm_f32_check(cfg, seed: int, device: str, label: str = "lm") -> dict:
    """LM_F32_LAYERS layers at the published widths in float32 (TF32 off for
    matmuls and cuDNN's convolutions; a moe config without drops): decode
    logits against forward logits at every position of a 16-token
    sequence, within the reference test's LM_F32_TOL.  An SSM config's
    forward must launch ``ssm_scan`` once a layer."""
    import dataclasses

    import torch
    from repro_torch.models import build_model, transformer

    cfg32 = dataclasses.replace(no_drops(cfg), n_layers=LM_F32_LAYERS,
                                dtype="float32")
    with no_tf32():
        model = build_model(cfg32)
        params = model.init(torch.Generator(device=device).manual_seed(seed),
                            device=device)
        tok = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (2, LM_PROMPT))).to(device)
        with torch.inference_mode():
            (full, _), fwd = launch_window(
                lambda: transformer.forward(params, tok, cfg32))
            cache = model.init_cache(2, LM_PROMPT, device=device)
            worst, err = 0.0, 0.0
            for t in range(LM_PROMPT):
                lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
                diff = (lg - full[:, t]).abs()
                err = max(err, float(diff.max()))
                worst = max(worst, float((diff - LM_F32_TOL * full[:, t].abs())
                                         .max()))
    check(worst <= LM_F32_TOL,
          f"{label}.f32: decode and forward logits differ by {err} (past "
          f"rtol = atol = {LM_F32_TOL})")
    out = {"f32_layers": LM_F32_LAYERS, "f32_positions": LM_PROMPT,
           "f32_max_abs_err": err, "f32_tol": LM_F32_TOL,
           "f32_logit_max": float(full.abs().max())}
    if cfg.has_ssm:
        out["f32_ssm_scan_launches"] = fwd.get("ssm_scan", 0)
        check(out["f32_ssm_scan_launches"] == LM_F32_LAYERS,
              f"{label}.f32: the forward launched ssm_scan "
              f"{out['f32_ssm_scan_launches']} times over {LM_F32_LAYERS} "
              "layers")
    del params, full, cache
    return out


def first_layers(params, cfg, k: int):
    """The model cut after its first ``k`` layers: views of ``params``'s
    ``[L, ...]`` leaves with the embedding, final norm and head, and
    ``cfg`` at depth ``k``."""
    import dataclasses

    from repro_torch.models import transformer

    tree = transformer.as_tree(params)
    flat = transformer.flatten_tree(tree["layers"])
    cut = transformer.nest_tree({n: v[:k] for n, v in flat.items()})
    return {**tree, "layers": cut}, dataclasses.replace(cfg, n_layers=k)


def as_f32(params):
    """A float32 copy of the (bf16) weights, as a tree."""
    from repro_torch.models import transformer

    return transformer.nest_tree({k: v.float() for k, v in
                                  transformer.flatten_tree(
                                      transformer.as_tree(params)).items()})


def f32_forward(p32, tok, cfg):
    """The forward in float32 (TF32 off; a moe config without drops) on
    float32 weights: the logits a bf16 model of the same weights rounds."""
    import dataclasses

    from repro_torch.models import transformer

    with no_tf32():
        return transformer.forward(p32, tok, dataclasses.replace(
            no_drops(cfg), dtype="float32"))[0]


def lm_params(cfg, seed: int, device: str, label: str):
    """``cfg`` at its published widths and depth, drawn on the card from a
    seeded generator one leaf at a time.  Returns (its parameters, the
    line's fields)."""
    import torch
    from repro_torch.models import build_model, transformer

    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    want = sum(int(np.prod(s)) for s in transformer.leaf_shapes(cfg).values())
    check(n_params == want, f"{label}: {n_params} parameters, the model's "
          f"leaves hold {want}")
    on = torch.device(device).type
    check(all(p.dtype == torch.bfloat16 and p.device.type == on
              for p in params.parameters()),
          f"{label}: a weight is not bf16 on the card")
    return params, {
        "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "dtype": cfg.dtype, "params": n_params,
        "param_count_without_norms": cfg.param_count()[0],
        "weights_gb": weight_bytes / 1e9, "init_s": init_s}


def bf16_checks(params, tok, cfg, out, label: str,
                tol: float = LM_BF16_TOL) -> dict:
    """lm's bf16 checks of ``cfg`` (its own depth) on the sequences ``tok``
    [LM_SLOTS, LM_PROMPT + LM_NEW]: the bf16 forward (a moe config without
    drops; its kernel launches counted), a teacher-forced bf16
    ``decode_step`` and the float32 forward of the same weights
    (``f32_forward``), over the first LM_PROMPT + LM_NEW - 1 positions.
    ``out`` [LM_SLOTS, LM_NEW] are the tokens held at the generated
    positions (the served ones; None: the decode's own).  Returns the
    line's fields, the checks as (condition, message) pairs, the decode's
    tokens at the generated positions and its cache.  The checks: the
    decode within ``tol`` / 2 of the forward; ``out`` equal to the
    forward's argmax wherever its top-two margin exceeds ``tol``; the
    decode no farther from float32 than twice the forward; the decode's
    argmax equal to float32's at every position where float32's margin
    exceeds twice the forward's distance from float32 there, at one
    position or more."""
    import torch
    from repro_torch.models import transformer

    B, n_pos = tok.shape[0], tok.shape[1] - 1
    (full, _), fwd_launches = launch_window(
        lambda: transformer.forward(params, tok, no_drops(cfg)))
    full = full[:, :n_pos].float()
    cache = transformer.init_cache(cfg, B, LM_MAX_SEQ, tok.device)
    steps = []
    for t in range(n_pos):
        lg, cache = transformer.decode_step(params, cache, tok[:, t:t + 1], t,
                                            cfg)
        steps.append(lg.float())
    replay = torch.stack(steps, 1)
    truth = f32_forward(as_f32(params), tok, cfg)[:, :n_pos]
    fields, checks, mine = logit_checks(
        full, replay, truth, out, LM_PROMPT - 1, tol,
        f"{label} ({cfg.n_layers} layers)")
    fields = {"check_layers": cfg.n_layers, **fields}
    if cfg.has_ssm:
        fields["forward_ssm_scan_launches"] = fwd_launches.get("ssm_scan", 0)
    return {"fields": fields, "checks": checks, "tokens": mine,
            "cache": cache}


def logit_checks(full, replay, truth, out, gen_from: int, tol: float,
                 at: str):
    """lm's bf16 verdict on float32 views of [B, n_pos, V] logits: the bf16
    forward ``full``, the teacher-forced bf16 decode ``replay`` and the
    float32 forward ``truth`` of the same weights.  ``out`` are the tokens
    held at positions ``gen_from`` on (None: the decode's own).  Returns
    (the fields, the checks as (condition, message) pairs, the decode's
    argmax from ``gen_from`` on); the checks are ``bf16_checks``'."""
    err = float((replay - full).abs().max())
    fwd = float((full - truth).abs().max())
    dec = float((replay - truth).abs().max())
    tokens = replay.argmax(-1)
    mine = tokens[:, gen_from:].cpu().numpy()
    out = mine if out is None else out
    top2 = full[:, gen_from:].topk(2, dim=-1)
    margin = (top2.values[..., 0] - top2.values[..., 1]).cpu().numpy()
    argmax = top2.indices[..., 0].cpu().numpy()
    clear = margin > tol
    mismatch = int(((out != argmax) & clear).sum())
    t2 = truth.topk(2, dim=-1)
    f32_clear = (t2.values[..., 0] - t2.values[..., 1]) > \
        2 * (full - truth).abs().amax(-1)
    f32_mismatch = int(((tokens != t2.indices[..., 0]) & f32_clear).sum())
    n_f32 = int(f32_clear.sum())
    fields = {
        "bf16_decode_vs_forward_max_abs": err,
        "bf16_forward_vs_f32_max_abs": fwd,
        "bf16_decode_vs_f32_max_abs": dec,
        "f32_logit_max": float(truth.abs().max()),
        "bf16_margin_tol": tol,
        "checked_positions": int(clear.sum()),
        "positions_under_margin": int((~clear).sum()),
        "mismatches_under_margin": int(((out != argmax) & ~clear).sum()),
        "top2_margin_quantiles": np.quantile(margin, [0.1, 0.5, 0.9]).tolist(),
        "f32_checked_positions": n_f32, "f32_positions": tokens.numel(),
        "f32_mismatches": f32_mismatch}
    checks = [
        (err <= tol / 2,
         f"{at}: bf16 decode and forward logits differ by {err}, past half "
         f"the margin tolerance {tol}"),
        (mismatch == 0, f"{at}: {mismatch} tokens differ from the forward's "
         f"argmax where its margin exceeds {tol}"),
        (dec <= 2 * fwd, f"{at}: bf16 decode lies {dec} from the float32 "
         f"forward, past twice the bf16 forward's {fwd}"),
        (n_f32 > 0 and f32_mismatch == 0,
         f"{at}: {f32_mismatch} of {n_f32} decoded tokens differ from the "
         "float32 forward's argmax where its margin exceeds twice the bf16 "
         "forward's distance")]
    return fields, checks, mine


def lm_serve_part(cfg, params, prompts: np.ndarray, device: str, bw: float,
                  label: str, check_layers: int = 0,
                  tol: float = LM_BF16_TOL):
    """``cfg``'s ``params`` served by ``ServingEngine(batch_size=LM_SLOTS,
    max_seq=LM_MAX_SEQ)``: LM_REQUESTS requests of the LM_PROMPT-token
    ``prompts``, LM_NEW new tokens each, the decode steps timed.  The
    LM_SLOTS requests served from pos 0 in fresh slots are held by
    ``bf16_checks`` at full depth, their served tokens equal to its
    teacher-forced replay; then one more step under torch.profiler.  With
    ``check_layers`` under the model's depth, the full depth's figures are
    kept in the line unchecked (but for the replay) and ``bf16_checks``
    holds the model cut after its first ``check_layers`` layers on the same
    sequences.  ``tol`` is ``bf16_checks``' margin.  Returns (the line's
    fields, the checks as (condition, message) pairs, the [LM_SLOTS,
    LM_PROMPT + LM_NEW] token batch); the caller owns ``params``."""
    import gc

    import torch
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request, ServingEngine

    engine = ServingEngine(cfg, params, batch_size=LM_SLOTS,
                           max_seq=LM_MAX_SEQ, device=device)
    step_s = []
    decode = engine.model.decode_step

    def timed_step(*a):
        t = time.perf_counter()
        out = decode(*a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    engine.model.decode_step = timed_step
    reqs = [Request(rid=i, prompt=prompts[i].astype(np.int32),
                    max_new_tokens=LM_NEW) for i in range(LM_REQUESTS)]
    t0 = time.perf_counter()
    served = engine.run(reqs)
    serve_s = time.perf_counter() - t0
    engine.model.decode_step = decode
    del engine
    check(sorted(served) == list(range(LM_REQUESTS)) and
          all(len(v) == LM_NEW for v in served.values()),
          f"{label}: served {({k: len(v) for k, v in served.items()})}")
    check(all(0 <= t < cfg.padded_vocab for v in served.values() for t in v),
          f"{label}: a served token lies outside the padded vocabulary")

    # the first LM_SLOTS requests ran from pos 0 in fresh slots
    seq = np.stack([np.concatenate([prompts[i], served[i]])
                    for i in range(LM_SLOTS)])
    tok = torch.from_numpy(seq).to(device)
    n_pos = seq.shape[1] - 1
    out = seq[:, LM_PROMPT:]
    cut = check_layers and check_layers < cfg.n_layers
    with torch.inference_mode():
        res = bf16_checks(params, tok, cfg, out, label, tol)
        # one more step, profiled: the card's share of a decode step
        profiled = device_busy(lambda: transformer.decode_step(
            params, res["cache"], tok[:, n_pos:], n_pos, cfg), top=8)
        del res["cache"]
        checks = [(np.array_equal(out, res["tokens"]), f"{label}: served "
                   "tokens differ from a teacher-forced replay of the same "
                   "decode steps")]
        fields = {**res["fields"], "full_depth_checked": not cut}
        if cut:
            p_cut, cfg_cut = first_layers(params, cfg, check_layers)
            shallow = bf16_checks(p_cut, tok, cfg_cut, None, label, tol)
            fields["first_layers_checked"] = shallow["fields"]
            checks += shallow["checks"]
            del shallow
        else:
            checks += res["checks"]
    n_fwd = fields.get("forward_ssm_scan_launches")
    if n_fwd is not None:
        checks.append((n_fwd == cfg.n_layers, f"{label}: the forward "
                       f"launched ssm_scan {n_fwd} times over {cfg.n_layers} "
                       "layers"))
    gc.collect()
    torch.cuda.empty_cache()

    gen_tokens = sum(len(v) for v in served.values())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    fields.update({
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "requests": len(served), "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ,
        "decode_steps": len(step_s), "serve_s": serve_s,
        "decode_step_ms_median": statistics.median(step_s) * 1e3,
        "decode_step_ms_min": min(step_s) * 1e3,
        "decode_step_bound_ms": weight_bytes / bw * 1e3,
        "bandwidth_Bps": bw, "tokens_generated": gen_tokens,
        "tokens_per_s": gen_tokens / serve_s,
        "replay_mismatches": int((out != res["tokens"]).sum()),
        "decode_step_profiled": profiled})
    return fields, checks, tok


def lm_phase(args, recs, card: str, device: str, bw: float,
             build_s: float) -> np.ndarray:
    """lm: the serve path of ``examples/htap_serve.py`` on the port: an
    LSM-OPD store whose selection scans run on packed codes feeds prompts
    to a served LM.  (1) A ``TokenStore`` on the card (LM_SAMPLES samples,
    ``meta_width`` 48, the five domains of tests/test_pipeline.py,
    payloads of 64-256 token ids, 1/16 deleted or re-ingested): its
    flushes and compactions launch pack, unpack and remap-pack;
    ``select(prefix 'code/')`` for each of LM_DP ranks equal to the host
    model, disjoint and complete, launching ``fused_zone_filter``;
    ``batches`` (rank 0) equal to the host model gives the prompts.  (2) A
    ``PrefixCacheIndex`` on the card (LM_PREFIXES prefixes of 32 tokens,
    two tenants, hot and cold tags, 256 demoted, 512 evicted): every key
    equal to the host hash, 1,024 lookups, the scans and
    ``eviction_candidates`` equal to a host dictionary, the scans
    launching ``fused_zone_filter``.  (3) llama3-8b at its published
    widths: LM_F32_LAYERS layers in float32 with decode logits against
    forward logits within 2e-4; then all 32 layers in bfloat16, drawn on
    the card from a seeded generator one leaf at a time, served by
    ``ServingEngine(batch_size=4, max_seq=64)``: 8 requests of 16-token
    prompts, 16 new tokens each.  The four requests served from pos 0 in
    fresh slots are rerun through ``forward`` on prompt + output, through
    teacher-forced ``decode_step`` (the same computation as the served
    one, whose argmax must give every served token) and through the
    float32 forward of the same weights (``bf16_checks``): the decode and
    forward logits must differ by at most half LM_BF16_TOL, every served
    token must equal the forward's argmax wherever the forward's top-two
    margin exceeds LM_BF16_TOL (positions under the margin are counted),
    the decode must lie no farther from float32 than twice the forward,
    and its argmax must equal float32's at every position where
    float32's margin exceeds twice the forward's distance there, at one
    position or more.  One more decode step runs under torch.profiler
    (the card's busy share).  lm.done carries the weights' GB, init
    seconds, the peak allocated memory, the median decode-step ms beside
    the step's bound (weight bytes over the card's bandwidth), tokens/s,
    the requests served, the launches of the store and prefix parts, the
    card and the build's seconds; the phase within LM_LIMIT_S.  Returns
    the prompts."""
    import gc

    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    for r in recs.values():
        r.active = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(LM_ARCH)
    rng = np.random.default_rng(args.seed + 12)
    line = {"phase": "lm.done", "card": card, "arch": LM_ARCH,
            "build_s": build_s, "held_before_gb": held_gb,
            "reduced": f"depth 32 kept; {LM_F32_LAYERS} of 32 layers for "
            "the float32 check; random weights (the repository holds none)"}

    store_fields, prompts = lm_store_part(rng, cfg.vocab, device)
    line.update(store_fields)
    line.update(lm_prefix_part(rng, cfg.vocab, device))
    line.update(lm_f32_check(cfg, args.seed + 13, device))
    gc.collect()
    torch.cuda.empty_cache()

    params, fields = lm_params(cfg, args.seed + 14, device, "lm")
    line.update(fields)
    fields, checks, _ = lm_serve_part(cfg, params, prompts, device, bw, "lm")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line.update(fields)
    line["seconds"] = seconds = time.perf_counter() - t_phase
    emit(line)
    for cond, msg in checks:
        check(cond, msg)
    check(seconds <= LM_LIMIT_S,
          f"lm: the phase took {seconds:.1f} s of its {LM_LIMIT_S:.0f} s")
    return prompts


# --------------------------------------------------------------------------- #
# lm.families: the moe, ssm and hybrid families served at full width
# --------------------------------------------------------------------------- #
FAMILY_ARCHS = ("falcon-mamba-7b", "hymba-1.5b", "granite-moe-1b-a400m")
# 83.75 GB of bf16 weights by param_count(), more than the card's 80 GB:
# the float32 check only
FAMILY_F32_ONLY = ("phi3.5-moe-42b-a6.6b",)
FAMILY_SCAN_ARCH = "falcon-mamba-7b"   # the ssm_scan row at the path's shape
FAMILY_LIMIT_S = 90.0
# An SSM model's bf16 checks hold the model cut after its first
# LM_F32_LAYERS layers, as many as the float32 check runs; at full depth
# its figures are kept and only the replay is checked.  On the H100, served at full depth,
# falcon-mamba-7b's bf16 decode differed from its bf16 forward by
# 5.89-6.28 at 64 layers (logits up to 6.7), hymba-1.5b's by 0.386-0.417
# at 32, past lm's 0.25; the bf16 forward itself lay 6.32-6.66 and
# 0.332-0.368 from the float32 forward of the same weights.  The reference
# does the same: tests/test_torch_ssm_bf16.py finds its bf16 distance from
# float32 growing 18x (falcon) and 9x (hymba) from one layer to all at
# width 256, the port's within a factor of 2 of it; ``depth_sweep``
# measured on the H100 falcon's 0.205, 0.267, 0.714, 2.66, 3.70, 5.80,
# 6.66 at 1, 2, 4, ... 64 layers through ssm_scan and the same within
# 0.89-1.12x through ssm_scan_plain.  On 2 layers hymba's decode lay 0.119
# from its forward, within lm's limits; falcon's 0.297, its forward 0.267
# from float32 (one bf16 mamba layer at falcon's width already lies 0.205
# from float32, 3 % of the logits), so falcon keeps a margin of its own
# there, FAMILY_BF16_TOL: its decode within 0.5 of its forward, under a
# sixth of the logits' 6.54 at 2 layers.
FAMILY_BF16_TOL = {"falcon-mamba-7b": 1.0}
FAMILY_SWEEP = (1, 2, 4, 8, 16, 32, 64)     # layers of the depth sweep


def scan_recorder():
    """Wrap ``repro_torch.kernels.ssm_scan.ssm_scan``, the wrapper the mamba
    block calls, keeping the operands (u, delta, A, B, C) of its first
    call.  Returns (the kept list, a function restoring the wrapper)."""
    from repro_torch.kernels import ssm_scan as scan_kernel

    wrapper, kept = scan_kernel.ssm_scan, []

    def record(*args, **kw):
        if not kept:
            kept.append(args[:5])
        return wrapper(*args, **kw)

    scan_kernel.ssm_scan = record
    return kept, lambda: setattr(scan_kernel, "ssm_scan", wrapper)


def scan_path_row(operands, bw: float, rates: dict) -> dict:
    """ssm_scan against ssm_scan_plain on the operands the served forward
    gave FAMILY_SCAN_ARCH's first layer (bf16 u, delta, B and C; float32
    A): y within SSM_TOL, the final state bit for bit, both timed, beside
    the bound (the operands read and y and the state written once, or one
    exp and 6 float32 operations a (b, t, d, n))."""
    import torch
    from repro_torch.kernels import ssm_scan

    u, dt, A, Bm, Cm = operands
    B, L, D = u.shape
    N = A.shape[1]
    elems = B * L * D * N
    exp_ms = elems / rates["exp_per_s"] * 1e3
    flop_ms = 6 * elems / rates["fp32_flops"] * 1e3
    nbytes = sum(t.numel() * t.element_size() for t in operands) \
        + 4 * (B * L * D + B * D * N)
    shape = (f"B={B} L={L} D={D} N={N} ({FAMILY_SCAN_ARCH}'s first layer in "
             "the served forward)")
    row = compare("ssm_scan", lambda: ssm_scan.ssm_scan(*operands),
                  lambda: ssm_scan.ssm_scan_plain(*operands), nbytes, bw, 0,
                  shape, tol=SSM_TOL, op_bound_ms=max(exp_ms, flop_ms))
    got, want = ssm_scan.ssm_scan(*operands), ssm_scan.ssm_scan_plain(*operands)
    check(torch.equal(got[1], want[1]), f"ssm_scan ({shape}): the final "
          "state differs from plain")
    keep = ("shape", "max_abs_err", "max_rel_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "bytes", "tolerance")
    return {**{k: row[k] for k in keep}, "state_bit_equal": True,
            "exp_ms": exp_ms, "flop_ms": flop_ms}


def moe_drops(params, tok, cfg) -> dict:
    """One forward at the published capacity_factor over ``tok``, counting
    each layer's dropped assignments (``moe.dispatch``'s ``keep``)."""
    from repro_torch.models import moe, transformer

    dispatch, layers = moe.dispatch, []

    def record(gate_idx, C, E):
        order, slot, keep = dispatch(gate_idx, C, E)
        layers.append((C, int((~keep).sum())))
        return order, slot, keep

    moe.dispatch = record
    try:
        transformer.forward(params, tok, cfg)
    finally:
        moe.dispatch = dispatch
    T = tok.numel()
    return {"drop_forward_tokens": T,
            "drop_capacity_factor": cfg.moe.capacity_factor,
            "drop_capacity": layers[0][0],
            "dropped_assignments": sum(d for _, d in layers),
            "assignments": T * cfg.moe.top_k * len(layers),
            "dropped_by_layer": [d for _, d in layers]}


def depth_sweep(params, tok, cfg, label: str):
    """The bf16 forward's distance from the float32 forward of the same
    weights (``f32_forward``) on ``tok``, the model cut after each layer
    count of FAMILY_SWEEP up to its depth: through ``ssm_scan`` (the
    kernel) and through ``ssm_scan_plain``.  Returns (one row a depth, the
    checks: at every depth the kernel's path no farther from float32 than
    twice the plain one's)."""
    import torch
    from repro_torch.kernels import ssm_scan as scan_kernel
    from repro_torch.models import transformer

    p32, rows, checks = as_f32(params), [], []
    wrapper = scan_kernel.ssm_scan
    with torch.inference_mode():
        for k in (d for d in FAMILY_SWEEP if d <= cfg.n_layers):
            cut, cfg_k = first_layers(params, cfg, k)
            truth = f32_forward(first_layers(p32, cfg, k)[0], tok, cfg_k)
            kern = transformer.forward(cut, tok, cfg_k)[0].float()
            scan_kernel.ssm_scan = scan_kernel.ssm_scan_plain
            try:
                plain = transformer.forward(cut, tok, cfg_k)[0].float()
            finally:
                scan_kernel.ssm_scan = wrapper
            row = {"layers": k,
                   "kernel_vs_f32": float((kern - truth).abs().max()),
                   "plain_vs_f32": float((plain - truth).abs().max()),
                   "kernel_vs_plain": float((kern - plain).abs().max()),
                   "f32_logit_max": float(truth.abs().max())}
            rows.append(row)
            checks.append((row["kernel_vs_f32"] <= 2 * row["plain_vs_f32"],
                           f"{label}: at {k} layers the bf16 forward through "
                           f"ssm_scan lies {row['kernel_vs_f32']} from "
                           "float32, past twice its "
                           f"{row['plain_vs_f32']} through ssm_scan_plain"))
    del p32
    return rows, checks


def families_phase(args, prompts: np.ndarray, card: str, device: str,
                   bw: float, rates: dict, build_s: float) -> dict:
    """lm.families: the moe, ssm and hybrid families on the port, each at
    its published widths and depth in bf16, weights drawn on the card.  For
    each of FAMILY_ARCHS: LM_F32_LAYERS layers in float32 (TF32 off; moe
    capacity_factor E / k, so the forward drops nothing) with decode
    against forward within LM_F32_TOL, an SSM forward launching ssm_scan
    once a layer; then ``lm_serve_part`` on ``prompts`` modulo the vocab
    (8 requests of 16 + 16 tokens, 4 slots, 64 positions): the served
    tokens equal to a teacher-forced replay, the served forward launching
    ssm_scan once an SSM layer, and lm's bf16 checks and limits
    (``bf16_checks``; FAMILY_BF16_TOL's margin for falcon-mamba-7b) at
    full depth, or for an SSM model on its first LM_F32_LAYERS layers, the
    full depth's figures kept.  An SSM model's ``depth_sweep`` follows.  FAMILY_SCAN_ARCH's
    first-layer scan operands from the served forward are held against
    ``ssm_scan_plain`` (``scan_path_row``); granite's line counts the
    assignments a forward over the 4 x 32 batch drops at the published
    capacity_factor.  FAMILY_F32_ONLY runs the float32 check alone.  One
    line a model, ``lm.families.done`` with the phase's seconds beside the
    build's; the phase within FAMILY_LIMIT_S.  Returns the ssm_scan
    launches of the models' forwards and the path row."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    scan_launches, path, lines = 0, None, {}
    for i, arch in enumerate(FAMILY_ARCHS + FAMILY_F32_ONLY):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        label = f"lm.families.{arch}"
        bf16_gb = 2 * sum(int(np.prod(s)) for s in
                          transformer.leaf_shapes(cfg).values()) / 1e9
        line = {"phase": label, "card": card, "arch": arch,
                "family": cfg.family, "source": cfg.source,
                "bf16_weights_gb": bf16_gb}
        f32_only = arch in FAMILY_F32_ONLY
        line["reduced"] = (
            f"float32 check only, {LM_F32_LAYERS} of {cfg.n_layers} layers: "
            f"{bf16_gb:.2f} GB of bf16 weights exceed the card's memory"
            if f32_only else
            f"depth {cfg.n_layers} kept; {LM_F32_LAYERS} of {cfg.n_layers} "
            "layers for the float32 check; random weights (the repository "
            "holds none)")
        seed = args.seed + 20 + 2 * i
        line.update(lm_f32_check(cfg, seed, device, label))
        scan_launches += line.get("f32_ssm_scan_launches", 0)
        gc.collect()
        torch.cuda.empty_cache()
        checks = []
        if not f32_only:
            params, fields = lm_params(cfg, seed + 1, device, label)
            line.update(fields)
            kept, restore = scan_recorder()
            try:
                fields, checks, tok = lm_serve_part(
                    cfg, params, prompts % cfg.vocab, device, bw, label,
                    LM_F32_LAYERS if cfg.has_ssm else 0,
                    FAMILY_BF16_TOL.get(arch, LM_BF16_TOL))
            finally:
                restore()
            line.update(fields)
            scan_launches += fields.get("forward_ssm_scan_launches", 0)
            with torch.inference_mode():
                if cfg.moe is not None:
                    line.update(moe_drops(params, tok, cfg))
            if cfg.has_ssm:
                line["depth_sweep"], more = depth_sweep(params, tok, cfg,
                                                        label)
                checks += more
            if arch == FAMILY_SCAN_ARCH:
                path = scan_path_row(kept[0], bw, rates)
                line["ssm_scan_path"] = path
            del kept, params, tok
            gc.collect()
            torch.cuda.empty_cache()
        line["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        lines[arch] = line
        for cond, msg in checks:
            check(cond, msg)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm.families.done", "card": card, "build_s": build_s,
          "held_before_gb": held_gb, "models": list(lines),
          "seconds_by_model": {a: ln["seconds"] for a, ln in lines.items()},
          "ssm_scan_launches": scan_launches, "seconds": seconds})
    check(path is not None, f"lm.families: no {FAMILY_SCAN_ARCH} scan "
          "operands were recorded")
    check(seconds <= FAMILY_LIMIT_S, f"lm.families: the phase took "
          f"{seconds:.1f} s of its {FAMILY_LIMIT_S:.0f} s")
    return {"ssm_scan_launches": scan_launches, "path": path}


# --------------------------------------------------------------------------- #
# lm.encdec: the encoder-decoder (whisper-small) at full width
# --------------------------------------------------------------------------- #
ENCDEC_ARCH = "whisper-small"
ENCDEC_FRAMES = 1500         # whisper's 30 s window after its stride-2 conv
ENCDEC_LIMIT_S = 40.0


def encdec_f32_check(cfg, frames, tok, seed: int, device: str,
                     label: str) -> dict:
    """``cfg`` at its published widths and depth in float32 (TF32 off):
    ``prefill`` fills the cross K/V of a cache of ``frames.shape[1]``
    frames, then teacher-forced ``decode_step`` over ``tok`` (the cache's
    ``dec_len`` positions), each step's logits within LM_F32_TOL of
    ``decode_train`` on the prefill's ``enc_out``."""
    import dataclasses

    import torch
    from repro_torch.models import build_model, encdec

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, S = tok.shape
    with no_tf32(), torch.inference_mode():
        model = build_model(cfg32)
        params = model.init(torch.Generator(device=device).manual_seed(seed),
                            device=device)
        enc_out, xk, xv = model.prefill(params, {"frames": frames})
        full = encdec.decode_train(params, tok, enc_out, cfg32)
        cache = model.init_cache(B, frames.shape[1], device=device)
        check(cache["k"].shape[2] == S, f"{label}.f32: a self cache of "
              f"{cache['k'].shape[2]} slots, not {S}")
        cache["xk"], cache["xv"] = xk, xv
        worst, err = 0.0, 0.0
        for t in range(S):
            lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
            diff = (lg - full[:, t]).abs()
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff - LM_F32_TOL * full[:, t].abs())
                                     .max()))
    check(worst <= LM_F32_TOL,
          f"{label}.f32: decode and decode_train logits differ by {err} "
          f"(past rtol = atol = {LM_F32_TOL})")
    out = {"f32_layers": [cfg.n_enc_layers, cfg.n_layers],
           "f32_decode_steps": S, "f32_max_abs_err": err, "f32_tol": LM_F32_TOL,
           "f32_logit_max": float(full.abs().max())}
    del params, full, cache, enc_out, xk, xv
    return out


def prefill_bound(cfg, B: int, S: int, bw: float, rates: dict) -> dict:
    """The least time of ``prefill`` on B x S frames: the bytes (the
    encoder's and the cross projections' weights and the frames read once,
    enc_out, xk and xv written once) over the bandwidth, or the operations
    over the card's rate for their type, whichever is larger.  Counted as
    the port computes them: the projections, the MLP and P.V in bf16, the
    scores Q.K in float32 (TF32 off), one exp a score; the flash path's
    padding past S frames is not work the frames need."""
    D, F, H, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    proj = 2 * B * S * D * H * dh
    bf16 = Le * (4 * proj + 3 * 2 * B * S * D * F + 2 * B * H * S * S * dh) \
        + Ld * 2 * proj
    fp32 = Le * 2 * B * H * S * S * dh
    exps = Le * B * H * S * S
    weights = Le * (4 * D * H * dh + 3 * D * F + 2 * D) + D \
        + Ld * 2 * D * H * dh
    nbytes = 2 * weights + 4 * B * S * D + 2 * B * S * D * (1 + 2 * Ld)
    times = {"bytes": nbytes / bw * 1e3,
             "bf16": bf16 / rates["bf16_flops"] * 1e3,
             "fp32": fp32 / rates["fp32_flops"] * 1e3,
             "exp": exps / rates["exp_per_s"] * 1e3}
    by = max(times, key=times.get)
    return {"prefill_bound_ms": times[by], "prefill_bound_by": by,
            "prefill_bound_parts_ms": times, "prefill_bf16_flop": bf16,
            "prefill_fp32_flop": fp32, "prefill_bytes": nbytes}


def step_bytes(params, cache) -> int:
    """Bytes a decode step must move: the decoder's weights, its final
    norm, the head and a row of the embedding a slot, and the whole cache
    (self K/V and positions, cross K/V) read once."""
    from repro_torch.models import transformer

    tree = transformer.as_tree(params)
    dec = transformer.flatten_tree(tree["dec_layers"])
    slots = cache["k"].shape[1]
    return (sum(t.numel() * t.element_size() for t in dec.values())
            + sum(tree[k].numel() * tree[k].element_size()
                  for k in ("dec_norm", "lm_head"))
            + slots * tree["embed"].shape[1] * tree["embed"].element_size()
            + sum(t.numel() * t.element_size() for t in cache.values()))


def encdec_real_path(cfg, params, frames, tok, device: str, bw: float,
                     rates: dict, label: str):
    """The encoder-decoder's own path in bf16: ``prefill`` (timed beside
    ``prefill_bound``), then teacher-forced ``decode_step`` over ``tok``
    on the prefilled cache (each step timed; the median beside its bytes
    over the bandwidth), held by lm's bf16 verdict (``logit_checks``)
    against ``decode_train`` in bf16 and in float32 (TF32 off, a float32
    copy of the same weights, enc_out from the float32 encoder); then one
    more step under torch.profiler.  Returns (the fields, the checks)."""
    import dataclasses

    import torch
    from repro_torch.models import build_model, encdec

    model = build_model(cfg)
    B, S = tok.shape
    batch = {"frames": frames}
    (enc_out, xk, xv), launches = launch_window(
        lambda: model.prefill(params, batch))
    prefill_ms = event_median_ms(lambda: model.prefill(params, batch),
                                 inner=1, reps=11)
    prefill_busy = device_busy(lambda: model.prefill(params, batch))
    cache = model.init_cache(B, frames.shape[1], device=device)
    cache["xk"], cache["xv"] = xk, xv
    steps, step_s = [], []
    for t in range(S):
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(lg.float())
    replay = torch.stack(steps, 1)
    full = encdec.decode_train(params, tok, enc_out, cfg).float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = as_f32(params)
    with no_tf32():
        truth = encdec.decode_train(p32, tok, encdec.encode(p32, frames, cfg32),
                                    cfg32)
    del p32
    fields, checks, _ = logit_checks(
        full, replay, truth, None, 0, LM_BF16_TOL,
        f"{label} ({cfg.n_enc_layers} + {cfg.n_layers} layers)")
    nbytes = step_bytes(params, cache)
    flop = 2 * B * sum(p.numel() for n, p in params.named_parameters()
                       if n.startswith("dec_layers.") or n == "lm_head")
    profiled = device_busy(lambda: model.decode_step(
        params, cache, tok[:, -1:], S), top=8)
    fields.update({
        "frames": frames.shape[1], "dec_len": S, "slots": B,
        "repo_kernel_launches": {k: v for k, v in launches.items() if v},
        "enc_out_dtype": str(enc_out.dtype).split(".")[-1],
        "prefill_ms_median": prefill_ms,
        "prefill_device_busy_ms": prefill_busy["device_busy_s"] * 1e3,
        "prefill_kernels": prefill_busy["kernels"],
        **prefill_bound(cfg, B, frames.shape[1], bw, rates),
        "decode_steps": S,
        "decode_step_ms_median": statistics.median(step_s) * 1e3,
        "decode_step_ms_min": min(step_s) * 1e3,
        "decode_step_bytes": nbytes,
        "decode_step_bound_ms": max(nbytes / bw,
                                    flop / rates["bf16_flops"]) * 1e3,
        "decode_step_bound_by": "bytes" if nbytes / bw >=
        flop / rates["bf16_flops"] else "operations",
        "decode_step_profiled": profiled})
    del cache, enc_out, xk, xv, full, replay, truth
    return fields, checks


def encdec_served(cfg, params, prompts: np.ndarray, device: str, bw: float,
                  label: str):
    """``ServingEngine(batch_size=LM_SLOTS, max_seq=LM_MAX_SEQ)`` serving
    ``cfg`` as the reference's engine does (no prefill: zero cross K/V over
    ``enc_len = max_seq``, a self cache of ``dec_len_for(max_seq)`` slots
    that rolls): LM_REQUESTS requests of the LM_PROMPT-token ``prompts``,
    LM_NEW new tokens each, the steps timed.  The LM_SLOTS requests served
    from pos 0 in fresh slots must equal a teacher-forced replay of
    ``decode_step`` on the cache the engine builds.  Returns (the fields,
    the checks)."""
    import torch
    from repro_torch.models.encdec import dec_len_for
    from repro_torch.serving.engine import Request, ServingEngine

    engine = ServingEngine(cfg, params, batch_size=LM_SLOTS,
                           max_seq=LM_MAX_SEQ, device=device)
    decode, step_s = engine.model.decode_step, []

    def timed_step(*a):
        t = time.perf_counter()
        out = decode(*a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    engine.model.decode_step = timed_step
    reqs = [Request(rid=i, prompt=prompts[i].astype(np.int32),
                    max_new_tokens=LM_NEW) for i in range(LM_REQUESTS)]
    t0 = time.perf_counter()
    served = engine.run(reqs)
    serve_s = time.perf_counter() - t0
    model = engine.model
    model.decode_step = decode
    check(sorted(served) == list(range(LM_REQUESTS)) and
          all(len(v) == LM_NEW for v in served.values()),
          f"{label}: served {({k: len(v) for k, v in served.items()})}")
    seq = np.stack([np.concatenate([prompts[i], served[i]])
                    for i in range(LM_SLOTS)])
    tok = torch.from_numpy(seq).to(device)
    cache = model.init_cache(LM_SLOTS, LM_MAX_SEQ, device=device)
    replay = []
    for t in range(seq.shape[1] - 1):
        lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
        replay.append(lg.argmax(-1))
    mine = torch.stack(replay, 1)[:, LM_PROMPT - 1:].cpu().numpy()
    out = seq[:, LM_PROMPT:]
    gen = sum(len(v) for v in served.values())
    nbytes = step_bytes(params, cache)
    fields = {"served_requests": len(served), "served_max_seq": LM_MAX_SEQ,
              "served_enc_len": cache["xk"].shape[2],
              "served_dec_len": cache["k"].shape[2],
              "served_dec_len_for": dec_len_for(LM_MAX_SEQ),
              "served_cross_kv_zero": not (cache["xk"].any() or
                                           cache["xv"].any()),
              "served_steps": len(step_s), "serve_s": serve_s,
              "served_step_ms_median": statistics.median(step_s) * 1e3,
              "served_step_bound_ms": nbytes / bw * 1e3,
              "tokens_generated": gen, "tokens_per_s": gen / serve_s,
              "replay_mismatches": int((out != mine).sum())}
    checks = [(np.array_equal(out, mine), f"{label}: served tokens differ "
               "from a teacher-forced replay of the same decode steps"),
              (fields["served_cross_kv_zero"], f"{label}: the engine's "
               "cross K/V are not zero")]
    return fields, checks


def encdec_phase(args, prompts: np.ndarray, card: str, device: str,
                 bw: float, rates: dict, build_s: float) -> None:
    """lm.encdec: whisper-small at its published widths and depth (12 + 12
    layers, d_model 768), after lm.families with its weights freed.  The
    frames stub whisper's conv frontend as both packages do: [LM_SLOTS,
    ENCDEC_FRAMES, 768] drawn from the seed, beside a teacher-forced
    prefix of ``dec_len_for(ENCDEC_FRAMES)`` tokens.  (1) In float32 (TF32
    off): prefill, then decode against ``decode_train`` within LM_F32_TOL
    (``encdec_f32_check``).  (2) In bf16, weights drawn on the card from a
    seeded generator: the real path (``encdec_real_path``: prefill and
    decode timed beside their bounds, lm's bf16 verdict against the bf16
    and float32 ``decode_train``), (3) the served path
    (``encdec_served``: 8 requests of lm's prompts modulo the vocabulary,
    16 + 16 tokens, equal to their replay), (4) the launcher,
    ``repro_torch.launch.serve.main``, at full width on the card.  One
    line; the phase within ENCDEC_LIMIT_S."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.encdec import dec_len_for, leaf_shapes

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(ENCDEC_ARCH)
    label = "lm.encdec"
    line = {"phase": label, "card": card, "arch": ENCDEC_ARCH,
            "family": cfg.family, "source": cfg.source, "build_s": build_s,
            "held_before_gb": held_gb, "layers": [cfg.n_enc_layers,
                                                  cfg.n_layers],
            "d_model": cfg.d_model, "heads": cfg.n_heads, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab,
            "dtype": cfg.dtype,
            "reduced": "depth 12 + 12 kept; random weights (the repository "
            "holds none); the conv frontend stubbed by frames drawn from the "
            "seed, as in both packages"}
    rng = np.random.default_rng(args.seed + 30)
    S = dec_len_for(ENCDEC_FRAMES)
    frames = torch.from_numpy(rng.standard_normal(
        (LM_SLOTS, ENCDEC_FRAMES, cfg.d_model), dtype=np.float32)).to(device)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_SLOTS, S))).to(device)
    line.update(encdec_f32_check(cfg, frames, tok, args.seed + 31, device,
                                 label))
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(args.seed + 32),
        device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    want = sum(int(np.prod(s)) for s in leaf_shapes(cfg).values())
    check(n_params == want, f"{label}: {n_params} parameters, the model's "
          f"leaves hold {want}")
    on = torch.device(device).type
    check(all(p.dtype == torch.bfloat16 and p.device.type == on
              for p in params.parameters()),
          f"{label}: a weight is not bf16 on the card")
    line.update({"init_s": time.perf_counter() - t0, "params": n_params,
                 "param_count_without_norms": cfg.param_count()[0],
                 "weights_gb": 2 * n_params / 1e9})
    with torch.inference_mode():
        fields, checks = encdec_real_path(cfg, params, frames, tok, device,
                                          bw, rates, label)
        line.update(fields)
        fields, more = encdec_served(cfg, params, prompts % cfg.vocab,
                                     device, bw, label)
        line.update(fields)
        checks += more
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9

    t0 = time.perf_counter()
    launched = serve.main(["--arch", ENCDEC_ARCH, "--device", device])
    line.update({"launcher_s": time.perf_counter() - t0,
                 "launcher_requests": len(launched),
                 "launcher_tokens": sum(len(v) for v in launched.values())})
    checks.append((sorted(launched) == list(range(8)) and
                   all(len(v) == 16 for v in launched.values()),
                   f"{label}: the launcher served "
                   f"{({k: len(v) for k, v in launched.items()})}"))
    gc.collect()
    torch.cuda.empty_cache()
    line["seconds"] = seconds = time.perf_counter() - t_phase
    emit(line)
    for cond, msg in checks:
        check(cond, msg)
    check(seconds <= ENCDEC_LIMIT_S, f"{label}: the phase took "
          f"{seconds:.1f} s of its {ENCDEC_LIMIT_S:.0f} s")


# --------------------------------------------------------------------------- #
# train: hymba-1.5b trained at full width through the port's entry points
# --------------------------------------------------------------------------- #
TRAIN_ARCH = "hymba-1.5b"
TRAIN_LIMIT_S = 60.0
TRAIN_CUT_LAYERS = 2         # parts (a) and (d): 2 of the model's 32 layers
TRAIN_F32_SHAPE = (2, 256)   # part (a): B x S
TRAIN_SHAPE = (4, 1024)      # part (b): B x S, 2 microbatches
TRAIN_STEPS = 8
TRAIN_DROP = 0.3             # tests/test_train.py's margin over its steps
TRAIN_GRAD_TOL = 1e-4        # (a): of each gradient leaf's largest magnitude
TRAIN_BWD_TOL = 1e-4         # (c): of each output's largest magnitude
TRAIN_LOOP_SHAPE = (4, 256)  # part (d): B x S
TRAIN_LOOP_STEPS, TRAIN_LOOP_EVERY = 6, 3
TRAIN_LOOP_FAILS = (2, 5)    # one step before the first checkpoint, one after


class PlainScan:
    """Stands in for ``ssm_scan.SSMScan`` in part (a): ``ssm_scan_plain``
    under autograd, the reference's kind of gradient (autodiff of the
    step-by-step recurrence)."""

    @staticmethod
    def apply(u, dt, A, Bm, Cm, chunk):
        from repro_torch.kernels import ssm_scan

        return ssm_scan.ssm_scan_plain(u, dt, A, Bm, Cm, chunk)[0]


def train_batch(rng, vocab: int, B: int, S: int, device: str) -> dict:
    import torch

    toks = rng.integers(0, vocab, (B, S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device),
            "mask": torch.ones((B, S), dtype=torch.float32, device=device)}


def train_f32_part(cfg, seed: int, device: str) -> tuple:
    """(a) TRAIN_CUT_LAYERS layers at full width in float32 (TF32 off): one
    ``make_train_step`` (2 microbatches) on the card, then its gradients
    (``step.grads``) through the kernels and through ``PlainScan``: the
    loss within TRAIN_GRAD_TOL relative, every leaf within TRAIN_GRAD_TOL
    of its largest magnitude.  Returns (fields, checks)."""
    import dataclasses

    import torch
    from repro_torch.kernels import ssm_scan as scan_kernel
    from repro_torch.models import build_model
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS,
                                dtype="float32")
    model = build_model(cfg32)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    B, S = TRAIN_F32_SHAPE
    n_mb = 2
    with no_tf32():
        state = make_train_state(
            model, ocfg, torch.Generator(device=device).manual_seed(seed),
            device=device)
        batch = train_batch(np.random.default_rng(seed), cfg.vocab, B, S,
                            device)
        step = make_train_step(model, ocfg, num_microbatches=n_mb)
        (new, metrics), launches = launch_window(lambda: step(state, batch))
        torch.cuda.synchronize()
        loss_k, _, g_k = step.grads(state["params"], batch)
        kernel_scan = scan_kernel.SSMScan
        scan_kernel.SSMScan = PlainScan
        try:
            loss_p, _, g_p = step.grads(state["params"], batch)
        finally:
            scan_kernel.SSMScan = kernel_scan
    paths, gk = T.flatten(g_k)
    gp = T.leaves(g_p)
    worst, worst_leaf = 0.0, None
    for path, a, b in zip(paths, gk, gp):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel >= worst:
            worst, worst_leaf = rel, "__".join(path)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    want = {"ssm_scan": 2 * TRAIN_CUT_LAYERS * n_mb,
            "ssm_scan_bwd": TRAIN_CUT_LAYERS * n_mb}
    got = {k: launches.get(k, 0) for k in want}
    fields = {"f32_layers": TRAIN_CUT_LAYERS, "f32_shape": [B, S],
              "f32_microbatches": n_mb,
              "f32_loss": float(loss_k), "f32_loss_plain": float(loss_p),
              "f32_loss_rel_err": loss_rel,
              "f32_grad_max_rel_err": worst, "f32_grad_worst_leaf": worst_leaf,
              "f32_grad_tol": TRAIN_GRAD_TOL,
              "f32_step_metrics_finite": all(
                  np.isfinite(float(v)) for v in metrics.values()),
              "f32_step_launches": got,
              "f32_step_launches_note": "ssm_scan: forward and remat's "
              "recompute, one each a layer a microbatch; ssm_scan_bwd: one a "
              "layer a microbatch"}
    checks = [(loss_rel <= TRAIN_GRAD_TOL, f"train.f32: loss {float(loss_k)} "
               f"through the kernels, {float(loss_p)} through plain"),
              (worst <= TRAIN_GRAD_TOL, f"train.f32: gradient {worst_leaf} "
               f"{worst} of its magnitude from plain's (past "
               f"{TRAIN_GRAD_TOL})"),
              (got == want, f"train.f32: the step launched {got}, not {want}"),
              (fields["f32_step_metrics_finite"], "train.f32: a metric of "
               "the step is not finite")]
    del state, new, g_k, g_p
    return fields, checks


def bwd_recorder(n_calls: int):
    """Wrap ``ssm_scan.ssm_scan_bwd``, keeping the operands of its
    ``n_calls``-th call (a microbatch's backward calls it last layer first,
    so call n_layers is layer 0's), each copied with its strides (B and C
    are slices of one projection).  Returns (kept, restore)."""
    import torch
    from repro_torch.kernels import ssm_scan as scan_kernel

    wrapper, kept, seen = scan_kernel.ssm_scan_bwd, [], [0]

    def record(*args):
        seen[0] += 1
        if seen[0] == n_calls:
            kept.append(tuple(torch.empty_strided(
                t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)
                for t in args))
        return wrapper(*args)

    scan_kernel.ssm_scan_bwd = record
    return kept, lambda: setattr(scan_kernel, "ssm_scan_bwd", wrapper)


def train_step_bound(cfg, n_params: int, B: int, S: int, bw: float,
                     rates: dict) -> dict:
    """The least time of one step: 8 x parameters x tokens FLOP (forward 2,
    remat's recompute 2, backward 4) at the bf16 rate, the causal
    attention's Q.K (float32 in the port) and P.V (bf16) at their rates,
    4 times (forward, recompute, backward twice), plus AdamW's bytes
    (bf16 parameters read and written, float32 gradients read, float32
    moments read and written: 24 a parameter) over the bandwidth."""
    tokens = B * S
    dense = 8 * n_params * tokens
    pairs = B * cfg.n_heads * S * (S + 1) // 2
    attn = 4 * 2 * pairs * cfg.head_dim * cfg.n_layers    # each of Q.K, P.V
    opt_bytes = 24 * n_params
    parts = {"dense_bf16_ms": dense / rates["bf16_flops"] * 1e3,
             "attn_qk_fp32_ms": attn / rates["fp32_flops"] * 1e3,
             "attn_pv_bf16_ms": attn / rates["bf16_flops"] * 1e3,
             "adamw_bytes_ms": opt_bytes / bw * 1e3}
    return {"step_bound_ms": sum(parts.values()), "step_bound_parts_ms": parts,
            "step_dense_flop": dense, "step_attn_flop_each": attn,
            "step_adamw_bytes": opt_bytes}


def below_bf16_step(p, ocfg) -> bool:
    """Whether a unit AdamW step (|mhat| / sqrt(vhat) = 1, plus the decay on
    leaves of 2 dims or more) at the peak lr rounds back to every element
    of the bf16 leaf ``p``: lr x (1 + weight decay x |p|) under the
    element's half spacing downwards (bf16 keeps 8 significant bits)."""
    import torch

    x = p.float().abs()
    m, e = torch.frexp(x)                 # x = m 2^e, m in [0.5, 1)
    half = torch.ldexp(torch.ones_like(x),
                       (e - torch.where(m == 0.5, 10, 9)).to(torch.int32))
    half = torch.where(x == 0, torch.zeros_like(x), half)
    wd = ocfg.weight_decay if p.dim() >= 2 else 0.0
    return bool((ocfg.lr * (1 + wd * x) < half).all())


def train_full_part(cfg, seed: int, device: str, bw: float,
                    rates: dict) -> tuple:
    """(b) ``cfg`` at full width and depth in bf16: a TokenStore of
    repeated motifs (``tests/test_system.py``'s store) whose ``batches``
    launch ``fused_zone_filter``, then TRAIN_STEPS steps of
    ``make_train_step`` (2 microbatches; AdamW lr 1e-3, warmup 2) on one
    batch of TRAIN_SHAPE, the last one profiled.  Returns (fields, checks,
    the first layer's scan operands and dy from the first microbatch,
    the steps' launches)."""
    import torch
    from repro_torch.core.opd import Predicate
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.pipeline.tokenstore import TokenStore, TokenStoreConfig
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    B, S = TRAIN_SHAPE
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    store = TokenStore(TokenStoreConfig(file_bytes=64 * 1024), device=device)
    motif = rng.integers(0, cfg.vocab, 16)
    for i in range(64):
        store.put_sample(i, np.tile(motif, 20).astype(np.int32), b"web/high")
    store.lsm.flush()        # the selection then scans an SCT on the card
    batches, store_launches = launch_window(lambda: list(store.batches(
        Predicate("prefix", b"web/high"), B, S, max_batches=1)))
    store_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).to(device) for k, v in batches[0].items()}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    state = make_train_state(
        model, ocfg, torch.Generator(device=device).manual_seed(seed + 1),
        device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in T.leaves(state["params"]))
    step = make_train_step(model, ocfg, num_microbatches=2)
    start = [t.clone() for t in T.leaves(state["params"])]
    torch.cuda.reset_peak_memory_stats()
    kept, restore = bwd_recorder(cfg.n_layers)
    losses, secs, metrics = [], [], []
    ops.reset_launches()
    try:
        for i in range(TRAIN_STEPS - 1):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["loss_total"].item())
            secs.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        restore()
    box = {}

    def last_step():
        box["state"], box["m"] = step(state, batch)
        box["m"]["loss_total"].item()

    t0 = time.perf_counter()
    profiled = device_busy(last_step, top=8, host=False)
    profile_s = time.perf_counter() - t0
    state, m = box["state"], box["m"]
    launches = {k: v for k, v in dict(ops.LAUNCHES).items() if v}
    losses.append(float(m["loss_total"]))
    metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    paths, end = T.flatten(state["params"])
    mus = T.leaves(state["opt"]["mu"])
    stayed = [("__".join(p), a, mu) for p, a, b, mu in
              zip(paths, end, start, mus) if torch.equal(a, b)]
    frozen = [(name, below_bf16_step(a, ocfg), bool(mu.any()))
              for name, a, mu in stayed]
    del start
    med = statistics.median(secs)
    fields = {"layers": cfg.n_layers, "d_model": cfg.d_model,
              "d_inner": cfg.d_inner, "d_state": cfg.ssm.d_state,
              "vocab": cfg.vocab, "dtype": cfg.dtype, "params": n_params,
              "param_count_without_norms": cfg.param_count()[0],
              "init_s": init_s, "store_s": store_s,
              "store_launches": {k: v for k, v in store_launches.items() if v},
              "batch_shape": [B, S], "microbatches": 2, "steps": TRAIN_STEPS,
              "adamw": {"lr": ocfg.lr, "warmup_steps": ocfg.warmup_steps,
                        "weight_decay": ocfg.weight_decay,
                        "grad_clip": ocfg.grad_clip},
              "losses": losses, "loss_drop": losses[0] - losses[-1],
              "grad_norms": [x["grad_norm"] for x in metrics],
              "lrs": [x["lr"] for x in metrics],
              "step_s": secs, "step_ms_median": med * 1e3,
              "step_ms_min": min(secs) * 1e3,
              "tokens_per_s": B * S / med,
              **train_step_bound(cfg, n_params, B, S, bw, rates),
              "step_profiled": profiled, "profile_s": profile_s,
              "steps_launches": launches,
              "peak_allocated_gb": peak,
              "leaves": len(end), "leaves_changed": len(end) - len(stayed),
              "leaves_unchanged": [[n, f, g] for n, f, g in frozen],
              "leaves_unchanged_note": "[leaf, a unit AdamW step at the peak "
              "lr rounds back to every element in bf16, its first moment "
              "nonzero]",
              "moments_zero": ["__".join(n) for n, mu in zip(paths, mus)
                               if not bool(mu.any())]}
    want = {"ssm_scan": TRAIN_STEPS * 2 * cfg.n_layers * 2,
            "ssm_scan_bwd": TRAIN_STEPS * cfg.n_layers * 2}
    checks = [
        (losses[0] - losses[-1] >= TRAIN_DROP, f"train.full: the loss went "
         f"{losses[0]} -> {losses[-1]} over {TRAIN_STEPS} steps, a drop "
         f"under {TRAIN_DROP}"),
        (all(np.isfinite(v) for x in metrics for v in x.values()),
         f"train.full: a metric is not finite: {metrics}"),
        (all(f and g for _, f, g in frozen), f"train.full: parameter "
         f"leaves unchanged after {TRAIN_STEPS} steps where a unit update "
         f"shows in bf16, or with zero moments: {frozen}"),
        (not fields["moments_zero"], f"train.full: no gradient reached "
         f"{fields['moments_zero']}"),
        (store_launches.get("fused_zone_filter", 0) > 0, "train.full: the "
         "TokenStore's batches launched no fused_zone_filter"),
        ({k: launches.get(k, 0) for k in want} == want, f"train.full: the "
         f"steps launched {launches}, not {want}"),
        (len(kept) == 1, "train.full: no scan backward was recorded")]
    del state, m, box, batch
    return fields, checks, kept[0] if kept else None, launches


def train_bwd_row(operands, bw: float, rates: dict, launches: int) -> dict:
    """(c) ``ssm_scan_bwd`` against ``ssm_scan_bwd_plain`` on the operands
    and dy the first layer's scan took in (b)'s first microbatch (bf16 u,
    delta, B, C; float32 A and dy): every output within TRAIN_BWD_TOL of
    its largest magnitude, the same bits on a rerun and on the operands'
    float32 copies, both timed, beside the bound: two exps a (b, t, d, n)
    at the card's exp rate, or the bytes of u, delta, dy, du and ddelta
    (float32) over the bandwidth.  ``device_ms`` sums every kernel of one
    wrapper call (the scan's kernel and its partials' sum),
    ``kernel_device_ms`` is the scan's kernel alone, ``cold_graph_ms`` the
    call replayed in a CUDA graph on operands that come from device
    memory, copied with their strides (read in place, as on the path)."""
    import dataclasses

    import torch
    from repro_torch.kernels import _build, ops, ssm_scan

    u, dt, A, Bm, Cm, dy = operands
    Bt, L, D = u.shape
    N = A.shape[1]
    before = ops.LAUNCHES["ssm_scan_bwd"]
    got = ssm_scan.ssm_scan_bwd(*operands)
    again = ssm_scan.ssm_scan_bwd(*operands)
    copies = [t.float().contiguous() for t in operands]
    widened = ssm_scan.ssm_scan_bwd(*copies)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["ssm_scan_bwd"] == before + 3,
          "ssm_scan_bwd: the kernel did not launch")
    want = ssm_scan.ssm_scan_bwd_plain(*operands)
    names = ("du", "ddelta", "dA", "dB", "dC")
    errs, rels = {}, {}
    for name, g, w in zip(names, got, want):
        errs[name] = float((g - w).abs().max())
        rels[name] = errs[name] / max(float(w.abs().max()), 1e-30)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    same_f32 = all(torch.equal(a, b) for a, b in zip(got, widened))
    del again, copies, widened
    exp_ms = 2 * Bt * L * D * N / rates["exp_per_s"] * 1e3
    nbytes = 5 * 4 * Bt * L * D
    bytes_ms = nbytes / bw * 1e3
    ms = event_median_ms(lambda: ssm_scan.ssm_scan_bwd(*operands), inner=5)
    plain_ms = event_median_ms(lambda: ssm_scan.ssm_scan_bwd_plain(*operands),
                               inner=1, reps=2, warmup=0)
    call_ms, by_kernel = profiled_call_ms(
        lambda: ssm_scan.ssm_scan_bwd(*operands), SYMBOLS["ssm_scan_bwd"])
    lay = ssm_scan.bwd_layout(Bt, L, D, N)
    log = Path(str(_build.library_path()) + ".log").read_text()
    src, rep = KERNELS["ssm_scan_bwd"]
    row = {"name": "ssm_scan_bwd", "route": "cuda", "source": src,
           "replaces": rep, "launches": launches,
           "max_abs_err": max(errs.values()), "ms": ms,
           "device_ms": call_ms, "device_ms_by_kernel": by_kernel,
           "kernel_device_ms": profiled_device_ms(
               lambda: ssm_scan.ssm_scan_bwd(*operands),
               SYMBOLS["ssm_scan_bwd"]),
           "cold_graph_ms": cold_graph_ms(ssm_scan.ssm_scan_bwd, nbytes,
                                          *operands, keep_strides=True),
           "plain_ms": plain_ms, "bound_ms": max(exp_ms, bytes_ms),
           "bound_by": "operations" if exp_ms > bytes_ms else "bytes",
           "exp_ms": exp_ms, "bytes": nbytes, "bytes_ms": bytes_ms,
           "library_ms": None, "library_why": LIBRARY_WHY["ssm_scan_bwd"],
           "max_abs_err_by_output": errs, "max_rel_err_by_output": rels,
           "tolerance": TRAIN_BWD_TOL, "rerun_bit_equal": same,
           "bf16_equals_f32_copies": same_f32,
           "operand_dtype": str(u.dtype).replace("torch.", ""),
           "strides": {"u": list(u.stride()), "delta": list(dt.stride()),
                       "B": list(Bm.stride()), "C": list(Cm.stride())},
           "layout": {"states_a_lane": ssm_scan.BWD_STATES,
                      "steps_between_checkpoints": ssm_scan.BWD_STEPS,
                      "steps_a_round": ssm_scan.BWD_ROUND,
                      "threads_a_block": ssm_scan.BWD_THREADS,
                      **dataclasses.asdict(lay)},
           "ptxas": [r for r in ptxas_resources(log, SYMBOLS["ssm_scan_bwd"])
                     if f", {lay.lanes}>" in r["function"] or
                     f"Li{lay.lanes}E" in r["function"]],
           "shape": f"B={Bt} L={L} D={D} N={N} ({TRAIN_ARCH}'s first layer, "
           "first microbatch of the first step in train.full; bf16 u, "
           "delta, B, C)"}
    check(max(rels.values()) <= TRAIN_BWD_TOL, f"ssm_scan_bwd: {rels} of "
          f"each output's magnitude from plain (past {TRAIN_BWD_TOL})")
    check(same, "ssm_scan_bwd: a rerun gave other bits")
    check(same_f32, "ssm_scan_bwd: bf16 operands gave other bits than "
          "their float32 copies")
    return row


def train_loop_part(cfg, batches, seed: int, device: str) -> tuple:
    """(d) TRAIN_CUT_LAYERS layers at full width in bf16 through
    ``train.loop.run`` with ``AsyncCheckpointer`` (every TRAIN_LOOP_EVERY
    steps) and failures injected at TRAIN_LOOP_FAILS (before the first
    checkpoint: a restart from init_state; after it: a restore and
    replay), against a failure-free run over the same batches: the final
    loss within rtol 1e-4, and ``ckpt.restore`` of the last checkpoint onto
    the card bit for bit the live state.  Returns (fields, checks)."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import build_model
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.train import tree as T
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    model = build_model(cfg2)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    init = make_train_state(
        model, ocfg, torch.Generator(device=device).manual_seed(seed),
        device=device)
    step = make_train_step(model, ocfg, num_microbatches=2)
    ckpt_bytes = sum(t.numel() * t.element_size() for t in T.leaves(init))
    saves, save, log = [], ckpt.save, []

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = save(*a, **k)
        saves.append(time.perf_counter() - t0)
        return out

    ckpt.save = timed_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = run(step, init, lambda s: batches[s % len(batches)],
                      LoopConfig(total_steps=TRAIN_LOOP_STEPS,
                                 ckpt_dir=f"{tmp}/faulty",
                                 ckpt_every=TRAIN_LOOP_EVERY),
                      injector=FailureInjector(fail_at_steps=TRAIN_LOOP_FAILS),
                      log_every=100, logger=log.append)
            faulty_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            clean = run(step, init, lambda s: batches[s % len(batches)],
                        LoopConfig(total_steps=TRAIN_LOOP_STEPS,
                                   ckpt_dir=f"{tmp}/clean", ckpt_every=100,
                                   async_ckpt=False),
                        log_every=100, logger=log.append)
            clean_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            last, back = ckpt.restore(f"{tmp}/faulty", init, device=device)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            steps_on_disk = ckpt.all_steps(f"{tmp}/faulty")
    finally:
        ckpt.save = save
    equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                zip(T.leaves(back), T.leaves(res.state)))
    a = res.metrics_history[-1]["loss_total"]
    b = clean.metrics_history[-1]["loss_total"]
    fields = {"loop_layers": TRAIN_CUT_LAYERS,
              "loop_shape": list(batches[0]["tokens"].shape),
              "loop_steps": TRAIN_LOOP_STEPS, "loop_ckpt_every":
              TRAIN_LOOP_EVERY, "loop_fail_at": list(TRAIN_LOOP_FAILS),
              "loop_restarts": res.restarts, "loop_log": log,
              "loop_final_loss": a, "loop_clean_final_loss": b,
              "loop_loss_rel_diff": abs(a - b) / abs(b),
              "loop_s": faulty_s, "loop_clean_s": clean_s,
              "ckpt_bytes": ckpt_bytes, "ckpt_save_s": saves,
              "ckpt_restore_s": restore_s, "ckpt_steps_on_disk": steps_on_disk,
              "ckpt_restored_step": last, "ckpt_restore_bit_equal": equal}
    checks = [(res.restarts == len(TRAIN_LOOP_FAILS), f"train.loop: "
               f"{res.restarts} restarts"),
              (int(res.state["step"]) == TRAIN_LOOP_STEPS, "train.loop: "
               f"ended at step {int(res.state['step'])}"),
              (abs(a - b) <= 1e-4 * abs(b), f"train.loop: final loss {a}, "
               f"failure-free {b} (past rtol 1e-4)"),
              (last == TRAIN_LOOP_STEPS and equal, "train.loop: the restored "
               "checkpoint is not the live state bit for bit")]
    del init, res, clean, back
    return fields, checks


def train_phase(args, card: str, device: str, bw: float, rates: dict,
                build_s: float) -> dict:
    """train: TRAIN_ARCH trained on the card through the port's entry
    points (``make_train_state``, ``make_train_step``, ``train.loop.run``,
    ``launch.train.main``), after lm.encdec with its weights freed:
    (a) ``train_f32_part``, (b) ``train_full_part`` at full width and
    depth, (c) ``train_bwd_row`` on (b)'s first-layer scan, (d)
    ``train_loop_part``, (e) the launcher on the reduced config on its
    default ``--mesh host`` (a one-rank NCCL group it starts and ends).  One line,
    the phase within TRAIN_LIMIT_S.  Returns the ssm_scan_bwd row and the
    launches of (b)'s steps."""
    import gc
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(TRAIN_ARCH)
    seed = args.seed + 40
    line = {"phase": "train", "card": card, "arch": TRAIN_ARCH,
            "family": cfg.family, "source": cfg.source, "build_s": build_s,
            "held_before_gb": held_gb,
            "reduced": f"(b) at full width and depth; (a) and (d) on "
            f"{TRAIN_CUT_LAYERS} of {cfg.n_layers} layers at full width; "
            "random weights (the repository holds none); (e) reduced()"}
    t0 = time.perf_counter()
    fields, checks = train_f32_part(cfg, seed, device)
    line.update(fields, f32_s=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fields, more, operands, launches = train_full_part(cfg, seed + 2, device,
                                                       bw, rates)
    line.update(fields, full_s=time.perf_counter() - t0)
    checks += more
    gc.collect()
    torch.cuda.empty_cache()
    for cond, msg in checks:
        check(cond, msg)

    t0 = time.perf_counter()
    row = train_bwd_row(operands, bw, rates, launches.get("ssm_scan_bwd", 0))
    del operands
    line.update(bwd_s=time.perf_counter() - t0,
                bwd_ms=row["ms"], bwd_bound_ms=row["bound_ms"])
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.core.opd import Predicate
    from repro_torch.pipeline.tokenstore import TokenStore, TokenStoreConfig

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 4)
    store = TokenStore(TokenStoreConfig(file_bytes=64 * 1024), device=device)
    motif = rng.integers(0, cfg.vocab, 16)
    for i in range(32):
        store.put_sample(i, np.tile(motif, 20).astype(np.int32), b"web/high")
    store.lsm.flush()
    B, S = TRAIN_LOOP_SHAPE
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in store.batches(Predicate("prefix", b"web/high"), B, S,
                                      max_batches=3)]
    fields, checks = train_loop_part(cfg, batches, seed + 5, device)
    line.update(fields, loop_part_s=time.perf_counter() - t0)
    del batches, store
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = train_launch.main(["--arch", TRAIN_ARCH, "--reduced", "--steps",
                                 "4", "--ckpt", tmp, "--device", device,
                                 "--mesh", "host"])
    line.update(launcher_s=time.perf_counter() - t0,
                launcher_step=int(res.state["step"]),
                launcher_losses=[m["loss_total"] for m in
                                 res.metrics_history])
    checks.append((int(res.state["step"]) == 4 and
                   all(np.isfinite(line["launcher_losses"])),
                   f"train: the launcher ended at step "
                   f"{int(res.state['step'])}, losses "
                   f"{line['launcher_losses']}"))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    line["seconds"] = seconds = time.perf_counter() - t_phase
    emit(line)
    for cond, msg in checks:
        check(cond, msg)
    check(seconds <= TRAIN_LIMIT_S, f"train: the phase took {seconds:.1f} s "
          f"of its {TRAIN_LIMIT_S:.0f} s")
    return {"row": row, "launches": launches}


TRAIN_MESH_LIMIT_S = 40.0


def bits_checksum(state):
    """Two exact integer checksums of each leaf's bits (as integers of the
    leaf's width, widened to int64): their sum and their sum weighted by
    position, both modulo 2^64; a DTensor on the (1, 1) mesh by its local
    tensor, the whole leaf.  One int64 tensor on the host."""
    import torch
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.train import tree as T

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums = []
    for t in T.leaves(state):
        t = t.to_local() if is_dtensor(t) else t
        bits = t.contiguous().view(ints[t.element_size()]).reshape(-1)
        bits = bits.to(torch.int64)
        pos = torch.arange(1, bits.numel() + 1, dtype=torch.int64,
                           device=bits.device)
        sums += [bits.sum(), (bits * pos).sum()]
        del bits, pos
    return torch.stack(sums).cpu()


def train_mesh_phase(args, card: str, device: str, build_s: float) -> dict:
    """train.mesh: TRAIN_ARCH at full width and depth in bf16 (random
    weights from the seed), one step of TRAIN_SHAPE in 2 microbatches
    without a mesh and one on ``make_host_mesh()``'s (1, 1) mesh (a
    one-rank NCCL group, ``ShardCtx`` in the forward, the state and batch
    as DTensors, each SSM layer's scan through ``local_map``), from one
    state: the loss, every metric and every leaf of the new state bit for
    bit (exact integer checksums of the bits: three states do not fit the
    card), ``ssm_scan`` and ``ssm_scan_bwd`` launched as often on the mesh
    path as off it.  The mesh step runs twice more, its caches warm: timed,
    then profiled for the device's busy time (``train`` (b) profiles the
    mesh-less step at this shape).  One line, the phase within TRAIN_MESH_LIMIT_S.  Returns
    the mesh step's launches."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import mesh_axes
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    seed = args.seed + 50
    B, S = TRAIN_SHAPE
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    state = make_train_state(
        model, ocfg, torch.Generator(device=device).manual_seed(seed),
        device=device)
    batch = train_batch(np.random.default_rng(seed), cfg.vocab, B, S, device)
    assert not dist.is_initialized()
    mesh = make_host_mesh(device)
    line = {"phase": "train.mesh", "card": card, "arch": TRAIN_ARCH,
            "source": cfg.source, "build_s": build_s,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "batch_shape": [B, S], "microbatches": 2,
            "mesh": mesh_axes(mesh), "backend": dist.get_backend(),
            "reduced": "none: full width and depth; random weights from the "
            "seed (the repository holds none)"}
    try:
        steps = {"plain": make_train_step(model, ocfg, num_microbatches=2),
                 "mesh": make_train_step(model, ocfg, mesh,
                                         num_microbatches=2)}
        out = {}
        for name, step in steps.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (new, m), launches = launch_window(lambda: step(state, batch))
            loss = m["loss_total"].item()
            out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": loss,
                         "metrics": {k: float(v) for k, v in m.items()},
                         "launches": {k: launches.get(k, 0) for k in
                                      ("ssm_scan", "ssm_scan_bwd")},
                         "peak_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                         "sums": bits_checksum(new)}
            del new, m
        # the mesh step again, its caches warm: timed, then profiled
        box = {}

        def again():
            box["new"], box["m"] = steps["mesh"](state, batch)
            box["m"]["loss_total"].item()

        t0 = time.perf_counter()
        again()
        out["mesh"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
        box.clear()
        profiled = device_busy(again, top=4, host=False)
        del box
    finally:
        dist.destroy_process_group()
    same_bits = torch.equal(out["plain"]["sums"], out["mesh"]["sums"])
    same_metrics = out["plain"]["metrics"] == out["mesh"]["metrics"]
    for v in out.values():
        v["leaf_checksums"] = len(v.pop("sums")) // 2
    line.update(plain=out["plain"], mesh_step=out["mesh"],
                mesh_profiled=profiled, state_bit_equal=same_bits,
                metrics_equal=same_metrics,
                mesh_over_plain_ms=out["mesh"]["warm_ms"] - out["plain"]["ms"])
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    line["seconds"] = seconds = time.perf_counter() - t_phase
    emit(line)
    want = {"ssm_scan": 2 * cfg.n_layers * 2, "ssm_scan_bwd": cfg.n_layers * 2}
    check(out["plain"]["launches"] == out["mesh"]["launches"] == want,
          f"train.mesh: the steps launched {out['plain']['launches']} off "
          f"the mesh and {out['mesh']['launches']} on it, not {want}")
    check(same_metrics, f"train.mesh: the metrics differ: "
          f"{out['plain']['metrics']} off the mesh, "
          f"{out['mesh']['metrics']} on it")
    check(same_bits, "train.mesh: the new state on the mesh is not the "
          "mesh-less one bit for bit")
    check(all(np.isfinite(v) for v in out["mesh"]["metrics"].values()),
          "train.mesh: a metric is not finite")
    check(seconds <= TRAIN_MESH_LIMIT_S, f"train.mesh: the phase took "
          f"{seconds:.1f} s of its {TRAIN_MESH_LIMIT_S:.0f} s")
    return out["mesh"]["launches"]


TRAIN_MESH_MOE_ARCH = "granite-moe-1b-a400m"
TRAIN_MESH_MOE_LIMIT_S = 40.0


def train_mesh_moe_phase(args, card: str, device: str,
                         build_s: float) -> None:
    """train.mesh.moe: TRAIN_MESH_MOE_ARCH at full width and depth in bf16
    (random weights from the seed), steps of TRAIN_SHAPE in 2 microbatches
    from one state, each once without a mesh and once on
    ``make_host_mesh()``'s (1, 1) mesh (a one-rank NCCL group, each moe
    layer's dispatch through ``local_map``): (a) the published
    capacity_factor under ``moe_impl='gather'``, the dropped assignments
    counted (over every dispatch of the step: the forward and remat's
    recompute) and the same on both paths and above 0; (b) capacity_factor E / k under 'ep', whose per-shard capacity
    T drops nothing, as the mesh-less one does not.  The loss, every metric
    and every leaf of the new state bit for bit (``bits_checksum``).  The
    'gather' mesh step runs twice more, its caches warm: timed, then
    profiled for the device's busy time.  The path has no kernel of the
    repository; its launches are read all the same.  One line, the phase
    within TRAIN_MESH_MOE_LIMIT_S."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, flags, moe
    from repro_torch.parallel.sharding import mesh_axes
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_MESH_MOE_ARCH)
    seed = args.seed + 60
    B, S = TRAIN_SHAPE
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    state = make_train_state(
        build_model(cfg), ocfg,
        torch.Generator(device=device).manual_seed(seed), device=device)
    batch = train_batch(np.random.default_rng(seed), cfg.vocab, B, S, device)
    assert not dist.is_initialized()
    mesh = make_host_mesh(device)
    line = {"phase": "train.mesh.moe", "card": card,
            "arch": TRAIN_MESH_MOE_ARCH, "source": cfg.source,
            "build_s": build_s, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "experts": cfg.moe.n_experts,
            "top_k": cfg.moe.top_k, "d_ff": cfg.d_ff, "dtype": cfg.dtype,
            "batch_shape": [B, S], "microbatches": 2,
            "mesh": mesh_axes(mesh), "backend": dist.get_backend(),
            "reduced": "none: full width and depth; random weights from the "
            "seed (the repository holds none)"}
    dispatch, dropped = moe.dispatch, []

    def counting(gate_idx, C, E):
        order, slot, keep = dispatch(gate_idx, C, E)
        dropped.append(torch.stack([(gate_idx < E).sum() - keep.sum(),
                                    (gate_idx < E).sum()]))
        return order, slot, keep

    impl = flags.moe_impl
    parts = {"gather": cfg.moe.capacity_factor,
             "ep": cfg.moe.n_experts / cfg.moe.top_k}
    out: dict = {}
    try:
        moe.dispatch = counting
        for name, cf in parts.items():
            flags.moe_impl = name
            part_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
            model = build_model(part_cfg)
            res = out[name] = {"capacity_factor": cf}
            for path, on in (("plain", None), ("mesh", mesh)):
                step = make_train_step(model, ocfg, on, num_microbatches=2)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dropped.clear()
                t0 = time.perf_counter()
                (new, m), launches = launch_window(lambda: step(state, batch))
                m["loss_total"].item()
                counts = torch.stack(dropped).sum(0).tolist()
                res[path] = {
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "metrics": {k: float(v) for k, v in m.items()},
                    "dropped_assignments": int(counts[0]),
                    "assignments": int(counts[1]),
                    "launches": {k: v for k, v in launches.items() if v},
                    "peak_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                    "sums": bits_checksum(new)}
                del new, m
            if name == "gather":
                moe.dispatch = dispatch
                box, mesh_step = {}, step

                def again():
                    box["new"], box["m"] = mesh_step(state, batch)
                    box["m"]["loss_total"].item()

                t0 = time.perf_counter()
                again()
                res["mesh"]["warm_ms"] = (time.perf_counter() - t0) * 1e3
                box.clear()
                res["mesh_profiled"] = device_busy(again, top=4, host=False)
                box.clear()
                moe.dispatch = counting
    finally:
        moe.dispatch = dispatch
        flags.moe_impl = impl
        dist.destroy_process_group()
    checks = []
    for name, res in out.items():
        plain, on = res["plain"], res["mesh"]
        res["state_bit_equal"] = torch.equal(plain["sums"], on["sums"])
        res["metrics_equal"] = plain["metrics"] == on["metrics"]
        for v in (plain, on):
            v["leaf_checksums"] = len(v.pop("sums")) // 2
        want_drops = "above 0" if name == "gather" else "0"
        drops = (plain["dropped_assignments"], on["dropped_assignments"])
        checks += [
            (res["metrics_equal"], f"train.mesh.moe {name}: the metrics "
             f"differ: {plain['metrics']} off the mesh, {on['metrics']} "
             "on it"),
            (res["state_bit_equal"], f"train.mesh.moe {name}: the new state "
             "on the mesh is not the mesh-less one bit for bit"),
            (all(np.isfinite(v) for v in on["metrics"].values()),
             f"train.mesh.moe {name}: a metric is not finite"),
            (drops[0] == drops[1] and (drops[0] > 0) == (name == "gather"),
             f"train.mesh.moe {name}: {drops} assignments dropped off and "
             f"on the mesh, not {want_drops} on both")]
    line.update(out)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    line["seconds"] = seconds = time.perf_counter() - t_phase
    emit(line)
    for cond, msg in checks:
        check(cond, msg)
    check(seconds <= TRAIN_MESH_MOE_LIMIT_S, f"train.mesh.moe: the phase "
          f"took {seconds:.1f} s of its {TRAIN_MESH_MOE_LIMIT_S:.0f} s")


LM_MESH_LIMIT_S = 40.0
LM_MESH_STEPS = 16           # decode steps of each part
LM_MESH_BATCH = 4
LM_MESH_PROMPT = 64          # hymba's prefill prompt, and the decoders' cache
LM_MESH_ARCHS = ("hymba-1.5b", "granite-moe-1b-a400m")
# their depth in lm.mesh: on an H100 a decode step on the host mesh took
# 31-56 ms a hymba layer and 16-34 ms a granite layer as hosts varied,
# DTensor's dispatch of ~200 ops a layer; at full depth the phase took
# 71.4 s of its 40 s, at 8 layers 53.8 s (PERF.md section 6)
LM_MESH_LAYERS = 4


def timed(fn):
    """(fn's result, its milliseconds on the host clock, the card synced
    before and after)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_decode(model, params, cache, toks, ctx):
    """LM_MESH_STEPS teacher-forced decode steps from ``cache``: (the
    logits of each step gathered whole, the final cache, each step's
    ms)."""
    from repro_torch.parallel.sharding import whole

    logits, ms = [], []
    for t in range(toks.shape[1]):
        (lg, cache), dt = timed(lambda: model.decode_step(
            params, cache, toks[:, t:t + 1], t, ctx))
        logits.append(whole(lg))
        ms.append(dt)
    return logits, cache, ms


def same_decode(a, b) -> bool:
    """Two ``mesh_decode`` results bit for bit: every step's logits and
    every leaf of the final cache."""
    from repro_torch.parallel.sharding import whole

    return (all(torch_equal(x, y) for x, y in zip(a[0], b[0]))
            and sorted(a[1]) == sorted(b[1])
            and all(torch_equal(whole(a[1][k]), whole(b[1][k]))
                    for k in a[1]))


def torch_equal(x, y) -> bool:
    import torch
    return torch.equal(x, y)


def lm_mesh_phase(args, card: str, device: str, build_s: float) -> dict:
    """lm.mesh: the paths that only the dry-run reaches on a mesh, each run
    once without a mesh and once under ``ShardCtx`` on
    ``make_host_mesh()``'s (1, 1) mesh (a one-rank NCCL group), from the
    same weights (bf16, full width and depth, random from the seed) and
    inputs, bit for bit: (a) whisper-small: ``prefill`` of LM_MESH_BATCH x
    ENCDEC_FRAMES stub frames (encoder output and cross K/V), then
    LM_MESH_STEPS ``decode_step``s against that cache (logits and every
    cache leaf), then one train step of LM_MESH_BATCH x (ENCDEC_FRAMES
    frames, ``dec_len_for(ENCDEC_FRAMES)`` tokens): the loss, every metric
    and every leaf of the new state (``bits_checksum``); (b) hymba-1.5b
    at LM_MESH_LAYERS layers (full width): ``prefill`` of an
    LM_MESH_PROMPT-token prompt (logits, and the
    ``ssm_scan`` launches, counted in a window around each prefill, equal
    on and off the mesh, once a layer), then LM_MESH_STEPS decode steps
    from an empty cache under ``serving_layout`` 'batch' and 'tp2d'; (c)
    granite-moe-1b-a400m (moe, dropless) at LM_MESH_LAYERS layers: the
    same decode steps under both layouts.  Each step's ms on and off the mesh in the line.  Returns the
    ``ssm_scan`` launches of hymba's prefill on the mesh."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, flags
    from repro_torch.models.encdec import dec_len_for
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import mesh_axes, whole
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    B, steps = LM_MESH_BATCH, LM_MESH_STEPS
    assert not dist.is_initialized()
    mesh = make_host_mesh(device)
    ctx = ShardCtx(mesh)
    line = {"phase": "lm.mesh", "card": card, "build_s": build_s,
            "mesh": mesh_axes(mesh), "backend": dist.get_backend(),
            "batch": B, "decode_steps": steps,
            "reduced": "full width; whisper-small at full depth, hymba-1.5b "
            "and granite-moe-1b-a400m at LM_MESH_LAYERS layers; random "
            "weights from the seed (the repository holds none); whisper's "
            "frames stubbed as in both packages"}
    checks = []
    layout0 = flags.serving_layout

    def weights(cfg, seed):
        model = build_model(cfg)
        tree = T.map_tree(lambda t: t.detach(), model.init(
            torch.Generator(device=device).manual_seed(seed),
            device=device).tree())
        return model, tree

    def on_mesh(model, tree, layout="batch"):
        return sharding.place_tree(tree, mesh, model.param_specs(
            mesh, layout="serve2d" if layout == "tp2d" else "train"))

    mesh_launches = 0
    try:
        # (a) whisper-small
        cfg = get_config(ENCDEC_ARCH)
        seed = args.seed + 70
        rng = np.random.default_rng(seed)
        model, tree = weights(cfg, seed)
        frames = torch.from_numpy(rng.standard_normal(
            (B, ENCDEC_FRAMES, cfg.d_model), dtype=np.float32)).to(device)
        S = dec_len_for(ENCDEC_FRAMES)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1))
                                ).to(device)
        part = {"arch": ENCDEC_ARCH, "layers": [cfg.n_enc_layers,
                                                cfg.n_layers],
                "d_model": cfg.d_model, "dtype": cfg.dtype,
                "frames": ENCDEC_FRAMES, "tokens": S}
        with torch.inference_mode():
            runs = {}
            for name, p, c in (("plain", tree, None),
                               ("mesh", on_mesh(model, tree), ctx)):
                got, ms = timed(lambda: model.prefill(p, {"frames": frames},
                                                      c))
                got = [whole(t) for t in got]
                cache = model.init_cache(B, ENCDEC_FRAMES, device=device)
                cache["xk"], cache["xv"] = got[1].clone(), got[2].clone()
                dec = mesh_decode(model, p, cache, toks[:, :steps], c)
                runs[name] = (got, dec)
                part[f"{name}_prefill_ms"] = ms
                part[f"{name}_decode_ms"] = dec[2]
            prefill_equal = all(torch.equal(a, b) for a, b in zip(
                runs["plain"][0], runs["mesh"][0]))
            decode_equal = same_decode(runs["plain"][1], runs["mesh"][1])
            del runs, cache, got, dec
        part.update(prefill_bit_equal=prefill_equal,
                    decode_bit_equal=decode_equal)
        checks += [(prefill_equal, "lm.mesh whisper: prefill on the mesh is "
                    "not the mesh-less one bit for bit"),
                   (decode_equal, "lm.mesh whisper: decode on the mesh is "
                    "not the mesh-less one bit for bit")]
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=2)
        state = make_train_state(model, ocfg, torch.Generator(
            device=device).manual_seed(seed + 1), device=device)
        batch = {"frames": frames, "tokens": toks[:, :-1].int(),
                 "labels": toks[:, 1:].int(),
                 "mask": torch.ones((B, S), device=device)}
        train = {}
        for name, on in (("plain", None), ("mesh", mesh)):
            step = make_train_step(model, ocfg, on)
            (new, m), ms = timed(lambda: step(state, batch))
            train[name] = {"ms": ms,
                           "metrics": {k: float(v) for k, v in m.items()},
                           "sums": bits_checksum(new)}
            del new, m
        state_equal = torch.equal(train["plain"]["sums"],
                                  train["mesh"]["sums"])
        metrics_equal = train["plain"]["metrics"] == train["mesh"]["metrics"]
        for v in train.values():
            v["leaf_checksums"] = len(v.pop("sums")) // 2
        part.update(train_step=train, train_state_bit_equal=state_equal,
                    train_metrics_equal=metrics_equal)
        checks += [(state_equal, "lm.mesh whisper: the new state on the mesh "
                    "is not the mesh-less one bit for bit"),
                   (metrics_equal, f"lm.mesh whisper: the metrics differ: "
                    f"{train['plain']['metrics']} off the mesh, "
                    f"{train['mesh']['metrics']} on it"),
                   (all(np.isfinite(v) for v in
                        train["mesh"]["metrics"].values()),
                    "lm.mesh whisper: a metric is not finite")]
        line[ENCDEC_ARCH] = part
        del model, tree, state, batch, frames
        gc.collect()
        torch.cuda.empty_cache()

        # (b), (c) hymba-1.5b and granite-moe-1b-a400m
        for i, arch in enumerate(LM_MESH_ARCHS):
            cfg = dataclasses.replace(get_config(arch),
                                      n_layers=LM_MESH_LAYERS)
            seed = args.seed + 71 + i
            rng = np.random.default_rng(seed)
            model, tree = weights(cfg, seed)
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, (B, LM_MESH_PROMPT))).to(device)
            part = {"arch": arch, "family": cfg.family,
                    "layers": cfg.n_layers, "d_model": cfg.d_model,
                    "dtype": cfg.dtype, "cache": LM_MESH_PROMPT,
                    "reduced": f"depth {get_config(arch).n_layers} -> "
                    f"{cfg.n_layers} (the phase's time: DTensor's dispatch "
                    "a layer a step); full width"}
            with torch.inference_mode():
                if cfg.has_ssm:
                    pre = {}
                    for name, p, c in (("plain", tree, None),
                                       ("mesh", on_mesh(model, tree), ctx)):
                        (lg, ms), launches = launch_window(lambda: timed(
                            lambda: model.prefill(p, {"tokens": toks}, c)))
                        pre[name] = whole(lg)
                        part[f"{name}_prefill_ms"] = ms
                        part[f"{name}_prefill_launches"] = launches["ssm_scan"]
                    mesh_launches = part["mesh_prefill_launches"]
                    equal = torch.equal(pre["plain"], pre["mesh"])
                    part["prefill_bit_equal"] = equal
                    checks += [
                        (equal, f"lm.mesh {arch}: prefill on the mesh is not "
                         "the mesh-less one bit for bit"),
                        (part["plain_prefill_launches"] == mesh_launches
                         == cfg.n_layers, f"lm.mesh {arch}: the prefill "
                         f"launched ssm_scan {part['plain_prefill_launches']}"
                         f" times off the mesh and {mesh_launches} on it, not "
                         f"{cfg.n_layers}")]
                for layout in ("batch", "tp2d"):
                    flags.serving_layout = layout
                    runs = {}
                    for name, p, c in (("plain", tree, None),
                                       ("mesh", on_mesh(model, tree, layout),
                                        ctx)):
                        cache = model.init_cache(B, LM_MESH_PROMPT,
                                                 device=device)
                        runs[name] = mesh_decode(model, p, cache,
                                                 toks[:, :steps], c)
                        part[f"{layout}_{name}_decode_ms"] = runs[name][2]
                    equal = same_decode(runs["plain"], runs["mesh"])
                    part[f"{layout}_decode_bit_equal"] = equal
                    checks.append((equal, f"lm.mesh {arch} {layout}: decode "
                                   "on the mesh is not the mesh-less one bit "
                                   "for bit"))
                    del runs
            flags.serving_layout = layout0
            line[arch] = part
            del model, tree
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        flags.serving_layout = layout0
        dist.destroy_process_group()
    line["seconds"] = seconds = time.perf_counter() - t_phase
    emit(line)
    for cond, msg in checks:
        check(cond, msg)
    check(seconds <= LM_MESH_LIMIT_S, f"lm.mesh: the phase took "
          f"{seconds:.1f} s of its {LM_MESH_LIMIT_S:.0f} s")
    return {"ssm_scan": mesh_launches}


# --------------------------------------------------------------------------- #
# the paper's Figure-5 pipeline: one planned range evaluated three ways
# --------------------------------------------------------------------------- #
def fig5_pipeline(tree, vocab: np.ndarray, preds, label: str) -> dict:
    """For every SCT of ``tree`` and each predicate, the planned code range
    evaluated three ways: numpy on the host-unpacked codes,
    ``range_filter_codes`` on ``SCT.code_column`` and ``range_filter_packed``
    + ``bitmap_to_mask`` on the packed words.  The three masks must be
    equal, and equal to the host model's predicate over the SCT's
    dictionary values (located in the vocabulary), and the matches' codes
    must decode to vocabulary values the predicate holds.  Returns the
    seconds of each way and the counts."""
    import torch
    from repro_torch import Predicate
    from repro_torch.kernels import ops

    svocab = np.sort(vocab)
    hits = [vocab_hits(svocab, p) for p in preds]
    secs = {"numpy": 0.0, "range_filter_codes": 0.0,
            "range_filter_packed": 0.0}
    n_masks = n_match = 0
    runs = tree.all_runs()
    for s in runs:
        codes = s.host_codes()
        live = codes >= 0
        pos = np.searchsorted(svocab, s.opd.values)
        check(bool((pos < svocab.shape[0]).all()) and
              np.array_equal(svocab[np.minimum(pos, svocab.shape[0] - 1)],
                             s.opd.values),
              f"{label}: SCT {s.file_id} holds a value outside the vocabulary")
        col = s.code_column()
        for p, hit in zip(preds, hits):
            lo, hi = s.opd.code_range(Predicate(*p))
            # inclusive bounds; an empty plan as the engine encodes it
            k_lo, k_hi = (lo, hi - 1) if lo < hi else (1, 0)
            t0 = time.perf_counter()
            m_np = (codes >= lo) & (codes < hi)
            t1 = time.perf_counter()
            m_codes = ops.range_filter_codes(col, k_lo, k_hi)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            m_packed = ops.bitmap_to_mask(
                ops.range_filter_packed(s.packed, s.code_bits, k_lo, k_hi),
                s.code_bits, s.n)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            secs["numpy"] += t1 - t0
            secs["range_filter_codes"] += t2 - t1
            secs["range_filter_packed"] += t3 - t2
            what = f"{label}: SCT {s.file_id} {p}"
            check(np.array_equal(m_codes.cpu().numpy(), m_np),
                  f"{what}: range_filter_codes differs from numpy")
            check(np.array_equal(m_packed.cpu().numpy(), m_np),
                  f"{what}: range_filter_packed differs from numpy")
            model = np.zeros(s.n, bool)
            model[live] = hit[pos[codes[live]]]
            check(np.array_equal(m_np, model),
                  f"{what}: mask differs from the host model")
            got = np.unique(codes[m_np])
            dec = s.opd.decode(got)
            where = np.searchsorted(svocab, dec)
            check(bool((where < svocab.shape[0]).all()) and
                  bool(hit[np.minimum(where, svocab.shape[0] - 1)].all()) and
                  np.array_equal(svocab[np.minimum(where,
                                                   svocab.shape[0] - 1)], dec),
                  f"{what}: a decoded match is not a value the host model "
                  "matches")
            n_masks += 1
            n_match += int(m_np.sum())
    return {"scts": len(runs), "predicates": len(preds), "masks": n_masks,
            "entries_matched": n_match, "seconds": secs}


def fig5_phase(state, recs) -> int:
    """fig5: the Figure-5 pipeline over every SCT of the main tree for its
    16 predicates; returns the launches of ``range_filter_packed`` in the
    phase's window."""
    tree = state["tree"]
    recs["packed"].active = True
    res, launches = launch_window(lambda: fig5_pipeline(
        tree, state["vocab"], state["preds"], "fig5"))
    recs["packed"].active = False
    for name in ("range_filter_packed", "range_filter_codes", "unpack_codes"):
        check(launches[name] > 0, f"fig5: {name} never launched")
    emit({"phase": "fig5", **res, "pack_widths": sorted(
        {s.code_bits for s in tree.all_runs()}), "launches": launches})
    return launches["range_filter_packed"]


FIG5_VW, FIG5_PUTS = 128, 200_000


def fig5_example(device: str) -> None:
    """fig5.example: ``examples/filter_analytics.py`` on the port at the
    example's own configuration (``LSMConfig(codec='opd', value_width=128,
    file_bytes=1 MiB)`` with the reference's default backends, 'numpy'
    filter and compaction; 200,000 puts from seed 0 over the 1,000-value
    'commodity/%03d/' + 80 x 'd' vocabulary): the Figure-5 pipeline on
    every SCT for ``prefix b"commodity/00"``, the full-tree ``filter``, K=16
    prefix predicates through ``filter`` and ``filter_many`` on one
    snapshot, and a ``ScanServer(max_batch=8)``, every answer held against
    the host model."""
    import torch
    from repro_torch import LSMConfig, LSMTree, Predicate, ScanServer

    rng = np.random.default_rng(0)
    n = FIG5_PUTS
    cfg = LSMConfig(value_width=FIG5_VW, file_bytes=2**20,
                    filter_backend="numpy", compaction_backend="numpy")
    vocab = np.asarray([b"commodity/%03d/" % i + b"d" * 80
                        for i in range(1000)], f"S{FIG5_VW}")
    keys = rng.integers(0, 10**9, n, dtype=np.uint64)
    vidx = rng.integers(0, 1000, n)
    ref = Reference(vocab)
    ref.put(keys, vidx)
    pred = ("prefix", b"commodity/00", b"")
    preds = [("prefix", b"commodity/%03d" % i, b"") for i in range(16)]

    def drive():
        out = {}
        tree = LSMTree(cfg, device=device)
        t0 = time.perf_counter()
        tree.put_batch(keys, vocab[vidx])
        torch.cuda.synchronize()
        out["ingest_s"] = time.perf_counter() - t0
        out["levels"] = tree.shape_report()["levels"]
        out["pipeline"] = fig5_pipeline(tree, vocab, [pred], "fig5.example")
        one = tree.filter(Predicate(*pred))
        out["filter_rows"] = check_filters([one], ref, [pred], "fig5.example")
        tp = [Predicate(*p) for p in preds]
        snap = tree.snapshot()
        tree.filter_many(tp, snapshot=snap)               # warm
        t0 = time.perf_counter()
        seq = [tree.filter(p, snapshot=snap) for p in tp]
        out["sequential_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bat = tree.filter_many(tp, snapshot=snap)
        out["filter_many_s"] = time.perf_counter() - t0
        for p, a, b in zip(preds, seq, bat):
            check(np.array_equal(a.keys, b.keys) and
                  a.values.tolist() == b.values.tolist(),
                  f"fig5.example: filter_many {p} differs from filter")
        out["rows_matched"] = check_filters(bat, ref, preds, "fig5.example")
        srv = ScanServer(tree, max_batch=8)
        rids = srv.submit_many(tp)
        served = srv.drain()
        check(srv.stats.batch_sizes == [8, 8],
              f"fig5.example: batches {srv.stats.batch_sizes}")
        check_filters([served[r] for r in rids], ref, preds,
                      "fig5.example.server")
        out["server_batches"] = srv.stats.batch_sizes
        return out

    res, launches = launch_window(drive)
    check(launches["range_filter_packed"] > 0,
          "fig5.example: range_filter_packed never launched")
    emit({"phase": "fig5.example", "puts": n, "value_width": FIG5_VW,
          "file_bytes": cfg.file_bytes, "backends": "filter 'numpy', "
          "compaction 'numpy' (the reference's defaults)", **res,
          "launches": launches})


# --------------------------------------------------------------------------- #
# the kernel micro-bench's entry points (benchmarks/bench_kernels.py)
# --------------------------------------------------------------------------- #
BENCH_CODES = 1 << 20
BLOOM_SEEDS32 = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
                 0x9E377969)
# falcon-mamba-7b's mixer at full width: d_inner 8192 = expand 2 x d_model
# 4096, d_state 16 (src/repro/configs/falcon_mamba_7b.py); batch 1, 2,048
# tokens
SSM_SHAPE = (1, 2048, 8192, 16)
SSM_TOL = 1e-4


def np_mix32(x: np.ndarray, seed: int) -> np.ndarray:
    """murmur3's 32-bit finalizer in numpy uint32 arithmetic (the host
    model of the bloom hash)."""
    x = x ^ np.uint32(seed)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def np_bloom_hits(words: np.ndarray, nbits: int, keys: np.ndarray,
                  n_hashes: int = 6) -> np.ndarray:
    """Host model of the bloom probe: a bit past the words is a miss."""
    hits = np.ones(keys.shape[0], bool)
    padded = np.concatenate([words, np.zeros(1, np.uint32)])
    for s in range(n_hashes):
        h = np_mix32(keys, BLOOM_SEEDS32[s]) % np.uint32(nbits)
        w = np.minimum(h >> np.uint32(5), words.shape[0])
        hits &= ((padded[w] >> (h & np.uint32(31))) & np.uint32(1)) == 1
    return hits


def np_ssm(u, dt, A, Bm, Cm):
    """Host model of the selective scan in float64, batch row 0."""
    x = np.zeros(A.shape, np.float64)
    y = np.zeros(u.shape[1:], np.float64)
    for t in range(u.shape[1]):
        d = dt[0, t].astype(np.float64)[:, None]
        x = np.exp(d * A) * x + (d * u[0, t].astype(np.float64)[:, None]) \
            * Bm[0, t].astype(np.float64)[None, :]
        y[t] = x @ Cm[0, t].astype(np.float64)
    return y, x


def bench_phase(args) -> tuple:
    """bench: the kernel micro-bench's three entry points on the port, on
    the card, at its shapes (2^20 codes packed at widths 8 and 16 with the
    range [1, 200]; a 2^14-bit bloom with 4,096 keys; the selective scan at
    falcon-mamba-7b's width), plus the largest documented bloom (2,048
    words) filled by mix32 with 2^20 keys, which must all hit.  Answers are
    held against host models (numpy masks, a numpy bloom, a float64 scan
    over 128 channels).  Returns the launches of the phase's window and the
    operands for the kernel rows."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitpack import pack_codes_plain

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 60000, BENCH_CODES).astype(np.int32)
    words = {w: pack_codes_plain(torch.from_numpy(codes % (1 << w)), w
                                 ).cuda() for w in (8, 16)}
    nbits = 1 << 14
    bloom = rng.integers(0, 2**32, nbits // 32, dtype=np.uint64
                         ).astype(np.uint32)
    bkeys = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    # the largest documented bloom, 10 bits per inserted key (the engine's
    # bloom_bits_per_key), probed with 2^20 keys, the inserted ones first
    big_bits = 2048 * 32
    ins = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    n_ins = big_bits // 10
    big = np.zeros(2048, np.uint32)
    for seed in BLOOM_SEEDS32:
        h = np_mix32(ins[:n_ins], seed) % np.uint32(big_bits)
        np.bitwise_or.at(big, h >> np.uint32(5),
                         np.uint32(1) << (h & np.uint32(31)))
    B, L, D, N = SSM_SHAPE
    u = rng.normal(size=(B, L, D)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, L, D))) * 0.1).astype(np.float32)
    A = -np.abs(rng.normal(size=(D, N))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)

    def u32(a):
        return torch.from_numpy(a.view(np.int32)).cuda()

    dev = {"bloom": (u32(bloom), nbits, u32(bkeys)),
           "big": (u32(big), big_bits, u32(ins)),
           "ssm": tuple(torch.from_numpy(a).cuda()
                        for a in (u, dt, A, Bm, Cm))}
    torch.cuda.synchronize()

    def drive():
        out = {w: ops.range_filter_packed(words[w], w, 1, 200)
               for w in (8, 16)}
        out["bloom"] = ops.bloom_probe(*dev["bloom"])
        out["big"] = ops.bloom_probe(*dev["big"])
        out["ssm"] = ops.ssm_scan(*dev["ssm"], chunk=32)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    out, launches = launch_window(drive)
    wall = time.perf_counter() - t0
    for name, n in (("range_filter_packed", 2), ("bloom_probe", 2),
                    ("ssm_scan", 1)):
        check(launches[name] == n, f"bench: {name} launched "
              f"{launches[name]} times, expected {n}")
    for w in (8, 16):
        c = codes % (1 << w)
        got = ops.bitmap_to_mask(out[w], w, BENCH_CODES).cpu().numpy()
        check(np.array_equal(got, (c >= 1) & (c <= 200)),
              f"bench: range_filter_packed width {w} differs from numpy")
    check(np.array_equal(out["bloom"].cpu().numpy(),
                         np_bloom_hits(bloom, nbits, bkeys)),
          "bench: bloom_probe differs from the host model")
    big_hits = out["big"].cpu().numpy()
    check(bool(big_hits[:n_ins].all()), "bench: an inserted key missed the "
          "bloom")
    check(np.array_equal(big_hits, np_bloom_hits(big, big_bits, ins)),
          "bench: bloom_probe (2,048 words) differs from the host model")
    y, state = out["ssm"]
    check(tuple(y.shape) == (B, L, D) and tuple(state.shape) == (B, D, N)
          and bool(torch.isfinite(y).all()) and
          bool(torch.isfinite(state).all()), "bench: ssm_scan output")
    ch = slice(0, 128)
    wy, ws = np_ssm(u[:, :, ch], dt[:, :, ch], A[ch], Bm, Cm)
    gy, gs = y[0, :, ch].cpu().double().numpy(), \
        state[0, ch].cpu().double().numpy()
    ssm_err = max(float(np.abs(gy - wy).max()), float(np.abs(gs - ws).max()))
    check(bool((np.abs(gy - wy) <= SSM_TOL + SSM_TOL * np.abs(wy)).all()) and
          bool((np.abs(gs - ws) <= SSM_TOL + SSM_TOL * np.abs(ws)).all()),
          f"bench: ssm_scan outside rtol = atol = {SSM_TOL} of the float64 "
          f"host model (max |err| {ssm_err})")
    emit({"phase": "bench", "codes": BENCH_CODES, "bloom_bits": nbits,
          "bloom_keys": int(bkeys.shape[0]),
          "bloom_hit_share": float(out["bloom"].float().mean()),
          "big_bloom_bits": big_bits, "big_bloom_keys": int(ins.shape[0]),
          "big_bloom_inserted": n_ins,
          "big_bloom_hit_share": float(big_hits.mean()),
          "ssm_shape_BLDN": list(SSM_SHAPE),
          "ssm_max_abs_err_vs_float64_model": ssm_err,
          "wall_s": wall, "launches": launches})
    return launches, {"words": words, **dev}


# --------------------------------------------------------------------------- #
# kernels against their plain versions, on operands the main path produced
# --------------------------------------------------------------------------- #
class Recorder:
    """Wraps an ops entry point; keeps the operands of its largest call
    (per key) so the kernel phase can replay the main path's shapes, and
    counts the calls of size > 0 per key in ``launches`` (on the card a
    wrapper launches its kernel once for each such call)."""

    def __init__(self, fn, size, key=lambda *a, **k: 0, active=True):
        self.fn, self.size, self.key, self.calls = fn, size, key, {}
        self.active, self.launches = active, {}

    def __call__(self, *args, **kw):
        if not self.active:
            return self.fn(*args, **kw)
        key, size = self.key(*args, **kw), self.size(*args, **kw)
        old = self.calls.get(key)
        if old is None or size > self.size(*old[0], **old[1]):
            self.calls[key] = (args, kw)
        if size > 0:
            self.launches[key] = self.launches.get(key, 0) + 1
        return self.fn(*args, **kw)


def event_median_ms(fn, inner: int, reps: int = 21, warmup: int = 2) -> float:
    """Median over ``reps`` CUDA-event-timed runs of ``inner`` back-to-back
    calls, per call, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_busy(fn, top: int = 0, host: bool = True) -> dict:
    """Wall seconds of one call and the seconds the card spent in kernels
    during it: torch.profiler's device-side events, as its own table totals
    them.  A host event carries the time of the kernels it launched as
    well, so the sum over every event (``all_events_device_s``, kept for
    comparison with figures taken that way) counts each kernel twice.
    With ``top``, the kernels that took the most device time (name, ms,
    launches).  ``host=False`` traces the card alone (a train step's tens
    of thousands of host events take the profiler longer to total than
    the step itself)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kinds = [ProfilerActivity.CPU] if host else []
    with profile(activities=kinds + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type != DeviceType.CPU and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    out = {"profiled_wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "kernels": sum(e.count for e in dev),
           "all_events_device_s": sum(e.self_device_time_total
                                      for e in events) / 1e6}
    if top:
        dev.sort(key=lambda e: -e.self_device_time_total)
        out["top_kernels"] = [[e.key[:80], e.self_device_time_total / 1e3,
                               e.count] for e in dev[:top]]
    return out


def profiled_device_ms(fn, symbol: str, reps: int = 20, tries: int = 3):
    """Mean device time of the kernel ``symbol`` over ``reps`` calls, from
    torch.profiler's CUDA activity; a trace without the kernel (the
    profiler drops a window's device records now and then) is taken again,
    up to ``tries`` times, then None."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    pat = re.compile(r"(^|[^A-Za-z_])" + symbol + r"\b")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            dt = getattr(e, "device_time_total", None)
            if dt is not None and pat.search(e.key):
                total += dt
                count += e.count
        if count:
            return total / count / 1e3
    return None


def profiled_call_ms(fn, symbol: str, reps: int = 20, tries: int = 3) -> tuple:
    """Device time of one call of ``fn`` summed over every kernel it
    launches, from torch.profiler's CUDA activity, and each kernel's part:
    (ms, {kernel: ms}).  The profiler may drop some of a window's device
    records, so a call is counted by the records of its one launch of the
    kernel ``symbol``; a trace without them is taken again, up to
    ``tries`` times, then (None, {})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pat = re.compile(r"(^|[^A-Za-z_])" + symbol + r"\b")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and
               not e.is_user_annotation and e.self_device_time_total]
        calls = sum(e.count for e in dev if pat.search(e.key))
        if calls:
            per = {e.key[:120]: e.self_device_time_total / calls / 1e3
                   for e in dev}
            return sum(per.values()), per
    return None, {}


def graph_ms(fns, reps: int = 21) -> float:
    """Device time per call of the calls ``fns`` without their host launch
    cost: captured in one CUDA graph, the graph replayed (median of
    ``reps`` CUDA-event-timed replays), per call.  A kernel and the one
    PyTorch call set beside it (a copy) are timed the same way."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    ms = event_median_ms(graph.replay, inner=1, reps=reps) / len(fns)
    del graph
    return ms


# bytes of other calls' traffic between two calls on one copy of the
# operands in cold_graph_ms: 2.5x the 50 MB L2 of an H100
COLD_BYTES = 128 << 20


def hot_graph_ms(fn, *operands) -> float:
    """``graph_ms`` of 20 calls of ``fn`` on the same operands, which stay
    in L2 from one call to the next when they fit there."""
    return graph_ms([lambda: fn(*operands)] * 20)


def cold_graph_ms(fn, nbytes: int, *operands,
                  keep_strides: bool = False) -> float:
    """``graph_ms`` of one call of ``fn`` on each of enough copies of the
    operands that ``COLD_BYTES`` of the other calls' traffic (``nbytes``
    per call) pass between two calls on one copy: every call reads its
    operands from device memory, as a kernel does whose inputs were written
    long before (a flushed SCT's words, a merge's streams).  With
    ``keep_strides`` each copy keeps its operand's strides (a slice stays
    a slice, which ``clone`` would make contiguous)."""
    import torch

    def copy(t):
        if not keep_strides:
            return t.clone()
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device=t.device).copy_(t)

    copies = 1 + -(-COLD_BYTES // nbytes)
    return graph_ms([functools.partial(fn, *(copy(t) for t in operands))
                     for _ in range(copies)])


def ptxas_resources(log: str, symbol: str) -> list:
    """Registers, static shared memory, stack and spills of every compiled
    instantiation of the kernel ``symbol``, from the ``-Xptxas=-v`` output
    that the build keeps; names demangled where ``c++filt`` is found."""
    import shutil

    funcs, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?"
                      r"(?:, (\d+) bytes smem)?", ln)
        if m and cur is not None:
            cur.update(registers=int(m.group(1)),
                       static_smem_bytes=int(m.group(2) or 0))
    names = [f for f in funcs if re.search(r"(?<![A-Za-z_])" + symbol, f)]
    shown = names
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            shown = out.stdout.splitlines()
    return [{"function": d, **funcs[f]} for f, d in zip(names, shown)]


def sass_functions(lib: Path) -> dict:
    """Mangled name -> [(address, opcode, operands)] of every kernel in the
    library's SASS (``cuobjdump -sass``, beside nvcc)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        funcs[chunk.split("\n", 1)[0].strip()] = [
            (int(m.group(1), 16), m.group(3), m.group(4))
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                                 r"([A-Z][A-Z0-9_.]*)([^;]*);", chunk)]
    return funcs


def sass_per_element(funcs: dict, name: str, marker: str,
                     per_marker: int) -> dict:
    """Static SASS instructions per element of the kernel whose mangled
    name contains ``name``: the smallest loop that holds an instruction
    matching ``marker`` (a regex on the opcode, an instruction issued once
    for every ``per_marker`` elements, such as a 16-byte load of 4 keys),
    over the elements of one of its iterations."""
    fn = next((k for k in funcs if name in k), None)
    if fn is None:
        return {"error": f"no kernel {name} in the SASS"}
    ins = funcs[fn]
    loops = []
    for addr, op, args in ins:
        t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) <= addr:
            loops.append([o for a, o, _ in ins
                          if int(t.group(1), 16) <= a <= addr])
    held = [lp for lp in loops if any(re.search(marker, o) for o in lp)]
    if not held:
        return {"error": f"no loop of {fn} holds {marker}"}
    body = min(held, key=len)
    elements = per_marker * sum(bool(re.search(marker, o)) for o in body)
    return {"function": fn, "loop_instructions": len(body),
            "elements_per_iteration": elements,
            "per_element": len(body) / elements,
            "loop_by_opcode": dict(collections.Counter(
                o.split(".")[0] for o in body).most_common())}


def compare(name: str, kernel, plain, nbytes: int, bw: float, launches: int,
            shape: str, tol=None, op_bound_ms: float = 0.0,
            plain_reps: int = 21) -> dict:
    """Run ``kernel`` and ``plain`` on the same operands and time both.
    Without ``tol`` the outputs must agree bit for bit; with ``tol`` every
    element must satisfy |kernel - plain| <= tol + tol * |plain|, and the
    relative error reported is max |kernel - plain| / max |plain|.  The
    bound is the larger of ``nbytes`` over the bandwidth and
    ``op_bound_ms`` (the operations over the card's rates)."""
    import torch
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    check(ops.LAUNCHES[name] > before[name], f"{name}: kernel did not launch")
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, rel = 0, 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: shape/dtype {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if not g.numel():
            continue
        if tol is None:
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
            continue
        d = (g.double() - w.double()).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float(d.max() / w.double().abs().max().clamp(min=tol)))
        check(bool((d <= tol + tol * w.double().abs()).all()),
              f"{name} ({shape}): kernel outside rtol = atol = {tol} of "
              f"plain, max |err| {err}")
    check(tol is not None or err == 0,
          f"{name} ({shape}): kernel differs from plain, max |err| {err}")
    ms = event_median_ms(kernel, inner=10)
    plain_ms = event_median_ms(plain, inner=1, reps=plain_reps, warmup=1)
    bytes_ms = nbytes / bw * 1e3
    src, rep = KERNELS[name]
    row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
           "launches": launches, "max_abs_err": err, "ms": ms,
           "device_ms": profiled_device_ms(kernel, SYMBOLS[name]),
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, op_bound_ms),
           "bytes": nbytes, "bytes_ms": bytes_ms,
           "ops_ms": op_bound_ms,
           "bound_by": "operations" if op_bound_ms > bytes_ms else "bytes",
           "library_ms": None,
           "library_why": LIBRARY_WHY.get(name, NO_LIBRARY),
           "shape": shape}
    if tol is not None:
        row.update({"tolerance": tol, "max_rel_err": rel})
    return row


def pack_row(codes, width: int, bw: float, launches: int, log: str,
             where: str) -> dict:
    """pack_codes against its plain version at one shape, with the CUDA
    graph times (hot: the same codes every call; cold: a fresh copy every
    call) and the registers of its instantiations at that width."""
    from repro_torch.kernels import bitpack

    n = codes.shape[0]
    nbytes = 4 * n + 4 * bitpack.n_words_for(n, width)
    pack = lambda c: bitpack.pack_codes(c, width)  # noqa: E731
    row = compare("pack_codes", lambda: pack(codes),
                  lambda: bitpack.pack_codes_plain(codes, width), nbytes, bw,
                  launches, f"n={n} width={width}{where}")
    row.update({
        "main_path": not where,
        "ptxas": [r for r in ptxas_resources(log, SYMBOLS["pack_codes"])
                  if f"<{width}," in r["function"]],
        "graph_ms": hot_graph_ms(pack, codes),
        "cold_graph_ms": cold_graph_ms(pack, nbytes, codes)})
    return row


def agg_gathers(words, meta, ranges, width: int, k: int, tile_words: int,
                flags) -> int:
    """Weight gathers of fused_zone_agg with SUM: the valid entries of the
    evaluated tiles (flag 1) that fall in any of their tile's K ranges."""
    import torch
    from repro_torch.kernels import agg_scan, bitpack

    ev = torch.nonzero(flags == agg_scan.FLAG_EVALUATED).reshape(-1)
    m = bitpack.from_u32_bits(meta)[ev]
    r = bitpack.from_u32_bits(ranges)
    per = 32 // width
    w = bitpack.from_u32_bits(words).reshape(-1, tile_words)[ev]
    shifts = torch.arange(per, dtype=torch.int64, device=words.device) * width
    f = ((w[:, :, None] >> shifts) & ((1 << width) - 1)).reshape(w.shape[0], -1)
    hit = torch.arange(f.shape[1], device=f.device) < m[:, 3:4]
    any_range = torch.zeros_like(hit)
    for j in range(k):
        lo, hi = r[m[:, 2] + j, 0:1], r[m[:, 2] + j, 1:2]
        any_range |= (f >= lo) & (f <= hi)
    return int((hit & any_range).sum())


def hist_sass(sass: dict, width: int, bins: int) -> dict:
    """SASS instructions per code of zone_histogram's 16-byte-load
    instantiation at ``(width, bins)``: its loop over a tile's whole
    rounds without the padding guard (the smallest that counts), one
    shared atomic a code."""
    return sass_per_element(
        sass, f"zone_histogram_kernelILi{width}ELi{bins}ELb1E", r"^ATOMS", 1)


def bloom_sass(sass: dict) -> dict:
    """SASS instructions per key of bloom_probe at a power-of-two nbits,
    16-byte key loads and the bloom in shared memory: its loop over a
    thread's steps, 4 keys a 16-byte load."""
    return sass_per_element(sass, "bloom_probe_kernelILb1ELb1ELb1E",
                            r"^LDG.*\.128", 4)


def single_filter_extras(kernel, launch, x, tile: int, fill: int,
                         nbytes: int, ptxas: list, yardstick, ops_call,
                         padded_call) -> dict:
    """What a single-range filter row adds (``range_filter_codes``,
    ``range_filter_packed``; ``kernel`` is the wrapper on its operands but
    the column, ``launch`` its module's ``_launch`` the same way, which
    takes the cluster size): the grid (tiles x cluster) and CUDA-graph
    times hot and cold at every cluster size the build instantiates, the
    wrapper's cluster size, the registers and spills of its
    instantiations, a yardstick of the same traffic cold (a copy the
    port never calls), the kernel cold on the input padded with ``fill``
    to whole tiles, and the ``ops`` entry point cold on the input as it is
    and with the pad copy that it made before (both answers equal)."""
    import torch
    from repro_torch.kernels import ops, packed_filter

    n_tiles = -(-x.shape[0] // tile)
    clusters = {}
    for c in packed_filter.CLUSTER_SIZES:
        fn = functools.partial(launch, cluster=c)
        clusters[c] = {"grid": n_tiles * c,
                       "graph_ms": hot_graph_ms(fn, x),
                       "cold_graph_ms": cold_graph_ms(fn, nbytes, x)}
    check(torch.equal(ops_call(x), padded_call(x)),
          "the ops entry point differs with the pad copy")
    whole = ops._pad_to_tiles(x, tile, fill)
    name, yard = yardstick
    mine = clusters[packed_filter.CLUSTER]
    return {"cluster": packed_filter.CLUSTER, "grid": mine["grid"],
            "graph_ms": mine["graph_ms"],
            "cold_graph_ms": mine["cold_graph_ms"], "clusters": clusters,
            "ptxas": ptxas, "yardstick": name,
            "yardstick_cold_graph_ms": cold_graph_ms(yard, nbytes, x),
            "whole_tiles": whole.shape[0],
            "whole_tiles_cold_graph_ms": cold_graph_ms(kernel, nbytes, whole),
            "ops_cold_graph_ms": cold_graph_ms(ops_call, nbytes, x),
            "ops_pad_cold_graph_ms": cold_graph_ms(padded_call, nbytes, x)}


def kernel_phase(recs, launches: dict, bw: float, bench: dict,
                 rates: dict, log: str, sass: dict) -> list:
    import torch
    from repro_torch.kernels import (agg_scan, bitpack, bloom_probe,
                                     fused_scan, merge_remap, multi_filter,
                                     opd_filter, ops, packed_filter,
                                     ssm_scan)

    rows = []
    # one row per pack width the main path packed (its flushes), then
    # compact.jax's largest pack (a merge output) beside codes.clone(), and
    # the same codes at width 16
    for width, ((codes, _w), _) in sorted(recs["pack"].calls.items()):
        rows.append(pack_row(codes, width, bw, recs["pack"].launches[width],
                             log, ""))
    (codes, width), _ = max(recs["pack_compact"].calls.values(),
                            key=lambda c: c[0][0].shape[0])
    n = codes.shape[0]
    where = " (compact.jax's largest pack: a merge output)"
    rows.append(pack_row(codes, width, bw,
                         recs["pack_compact"].launches[width], log, where))
    if width == 32:
        clone = lambda c: c.clone()  # noqa: E731
        check(torch.equal(clone(codes), bitpack.pack_codes(codes, 32)),
              "pack_codes at width 32 differs from codes.clone()")
        rows[-1].update({
            "library_ms": event_median_ms(lambda: clone(codes), inner=10),
            "library_graph_ms": hot_graph_ms(clone, codes),
            "library_cold_graph_ms": cold_graph_ms(clone, 8 * n, codes),
            "library_why": "codes.clone(): the same function only at width "
                           "32, where the pack is a copy"})
    rows.append(pack_row(codes & 0xFFFF, 16, bw, 0, log,
                         f"{where}, low 16 bits"))

    # one row per pack width the main path unpacked, at its largest call;
    # then width 16 at the width-32 row's n (the main path's width-16 SCTs
    # are flushes, a tenth of that size): the same codes repacked
    cases = [(width, words, n, recs["unpack"].launches[width], "")
             for width, ((words, _w, n), _) in sorted(
                 recs["unpack"].calls.items())]
    if 32 in recs["unpack"].calls:
        (w32, _w, n32), _ = recs["unpack"].calls[32]
        cases.append((16, bitpack.pack_codes_plain(w32[:n32] & 0xFFFF, 16),
                      n32, 0, " (the width-32 row's codes, low 16 bits, "
                      "repacked at width 16)"))
    for width, words, n, count, note in cases:
        nbytes = 4 * bitpack.n_words_for(n, width) + 4 * n
        unpack = lambda w: bitpack.unpack_codes(w, width, n)  # noqa: E731
        rows.append(compare(
            "unpack_codes", lambda: unpack(words),
            lambda: bitpack.unpack_codes_plain(words, width, n), nbytes, bw,
            count, f"n={n} width={width}{note}"))
        res = ptxas_resources(log, SYMBOLS["unpack_codes"])
        rows[-1].update({
            "ptxas": [r for r in res if f"<{width}," in r["function"]] or res,
            "main_path": not note,
            # in CUDA graphs, no host launch cost: the same words every call
            # (in L2), and a fresh copy of them every call (device memory)
            "graph_ms": hot_graph_ms(unpack, words),
            "cold_graph_ms": cold_graph_ms(unpack, nbytes, words)})
        if width == 32:
            # at width 32 the unpack is a copy; the port never calls it
            clone = lambda w: w[:n].clone()  # noqa: E731
            check(torch.equal(clone(words), unpack(words)),
                  "unpack_codes at width 32 differs from words[:n].clone()")
            # the same words 8 times over: a launch's fixed cost against
            # the rate the kernel streams at
            big = words[:n].repeat(8)
            rows[-1].update({
                "library_ms": event_median_ms(lambda: clone(words), inner=10),
                "library_graph_ms": hot_graph_ms(clone, words),
                "library_cold_graph_ms": cold_graph_ms(clone, nbytes, words),
                "library_why": "words[:n].clone(): the same function only "
                               "at width 32, where the unpack is a copy",
                "cold_graph_ms_8n": cold_graph_ms(
                    lambda w: bitpack.unpack_codes(w, width, 8 * n),
                    8 * nbytes, big),
                "library_cold_graph_ms_8n": cold_graph_ms(
                    torch.clone, 8 * nbytes, big),
                "bound_ms_8n": 8 * nbytes / bw * 1e3})

    calls = recs["fused"].calls
    biggest = max(calls.values(), key=lambda c: c[0][0].shape[0])
    for width in (8, 16, 32):
        (fw, meta, rng, w0, k, tw), _ = calls.get(width, biggest)
        if w0 != width and width < 32:  # replay another width's words
            rng = rng & ((1 << width) - 1)
        out = fused_scan.fused_zone_filter(fw, meta, rng, width, k, tw)
        torch.cuda.synchronize()
        evaluated = int(out[1].sum())
        n_tiles = meta.shape[0]
        nbytes = (4 * tw * evaluated + 4 * k * fw.shape[0] + 20 * n_tiles
                  + 8 * rng.shape[0])
        rows.append(compare(
            "fused_zone_filter",
            lambda: fused_scan.fused_zone_filter(fw, meta, rng, width, k, tw),
            lambda: fused_scan.fused_zone_filter_plain(fw, meta, rng, width,
                                                       k, tw),
            nbytes, bw, launches["fused_zone_filter"],
            f"words={fw.shape[0]} tiles={n_tiles} evaluated={evaluated} "
            f"K={k} width={width}" + ("" if w0 == width else
                                      f" (words of a width-{w0} level)")))
        filt = functools.partial(fused_scan.fused_zone_filter, width=width,
                                 n_preds=k, tile_words=tw)
        rows[-1].update({"main_path": w0 == width and fw is biggest[0][0],
                         "graph_ms": hot_graph_ms(filt, fw, meta, rng),
                         "cold_graph_ms": cold_graph_ms(filt, nbytes, fw,
                                                        meta, rng)})

    # remap_pack_codes at the main path's largest merge: device time, CUDA
    # graphs hot and cold, and cold with every entry dead (the streams
    # without a gather)
    (evs, srcs, table, offsets, width), _ = max(
        recs["remap"].calls.values(), key=lambda c: c[0][0].shape[0])
    n = evs.shape[0]
    m = bitpack.n_words_for(n, width)
    nbytes = 8 * n + 4 * m + 4 * table.shape[0] + 4 * offsets.shape[0]
    remap_pack = lambda *a: merge_remap.remap_pack_codes(*a, width)  # noqa: E731
    rows.append(compare(
        "remap_pack_codes", lambda: remap_pack(evs, srcs, table, offsets),
        lambda: merge_remap.remap_pack_codes_plain(evs, srcs, table, offsets,
                                                   width),
        nbytes, bw, recs["remap"].launches[width],
        f"n={n} width={width} table={table.shape[0]} "
        f"sources={offsets.shape[0]}"))
    rows[-1].update({
        "ptxas": [r for r in ptxas_resources(log, SYMBOLS["remap_pack_codes"])
                  if f"<{width}," in r["function"]],
        "gathers": int((evs >= 0).sum()),
        "graph_ms": hot_graph_ms(remap_pack, evs, srcs, table, offsets),
        "cold_graph_ms": cold_graph_ms(remap_pack, nbytes, evs, srcs, table,
                                       offsets),
        "streams_only_cold_graph_ms": cold_graph_ms(
            remap_pack, nbytes, torch.full_like(evs, -1), srcs, table,
            offsets)})

    # fused_zone_agg at agg.fast's scalar launch, with and without SUM; in
    # CUDA graphs hot (the same operands, in L2) and cold (a fresh copy per
    # call); with SUM each valid entry of an evaluated tile that matches one
    # of its ranges gathers one weight, a 32-byte L2 sector
    (aw, am, ar, awt, width, k, _ws, tw), _ = recs["agg"].calls[0]
    n_tiles = am.shape[0]
    for with_sum in (True, False):
        flags = agg_scan.fused_zone_agg(aw, am, ar, awt, width, k, with_sum,
                                        tw)[4]
        evaluated = int((flags == 1).sum())
        nbytes = (4 * tw * evaluated + 24 * n_tiles + 8 * ar.shape[0]
                  + 20 * n_tiles * k + 4 * n_tiles
                  + (4 * awt.shape[0] if with_sum else 0))
        agg = functools.partial(agg_scan.fused_zone_agg, width=width,
                                n_preds=k, with_sum=with_sum, tile_words=tw)
        rows.append(compare(
            "fused_zone_agg", lambda: agg(aw, am, ar, awt),
            lambda: agg_scan.fused_zone_agg_plain(aw, am, ar, awt, width, k,
                                                  with_sum, tw),
            nbytes, bw, launches["fused_zone_agg"],
            f"words={aw.shape[0]} tiles={n_tiles} evaluated={evaluated} "
            f"K={k} width={width} sum={with_sum} weights={awt.shape[0]}"))
        slots, vec = agg_scan.agg_route(aw, k, tw)
        rows[-1].update({
            "main_path": with_sum, "slots": slots, "vector_loads": vec,
            "ptxas": [r for r in ptxas_resources(log, SYMBOLS["fused_zone_agg"])
                      if f"<{width}," in r["function"]],
            "graph_ms": hot_graph_ms(agg, aw, am, ar, awt),
            "cold_graph_ms": cold_graph_ms(agg, nbytes, aw, am, ar, awt)})
        # K = 1 and 2 on the same tiles (each tile's first ranges), cold, in
        # the instantiation agg_route picks and in the 8-slot one: what the
        # 1- and 2-slot instantiations are judged by
        if vec:
            rows[-1]["slots_cold_graph_ms"] = {
                f"K={kk} slots={sl}": cold_graph_ms(functools.partial(
                    agg_scan._launch_agg, width=width, n_preds=kk,
                    with_sum=with_sum, tile_words=tw, slots=sl, vec=True),
                    nbytes, aw, am, ar, awt)
                for kk in (1, 2) for sl in (kk, 8)}
        if with_sum:
            gathers = agg_gathers(aw, am, ar, width, k, tw, flags)
            rows[-1].update({"gathers": gathers,
                             "gather_sector_bytes": 32 * gathers})

    # zone_histogram at agg.fast's largest GROUP BY launch; in CUDA graphs
    # hot and cold, with the registers and the SASS instructions per code
    # of its instantiations at that width
    (hw, hm, he, width, n_bins, tw), _ = recs["hist"].calls[0]
    n_tiles = hm.shape[0]
    evaluated = int((agg_scan.zone_histogram(hw, hm, he, width, n_bins,
                                             tw)[1] == 1).sum())
    nbytes = (4 * tw * evaluated + 24 * n_tiles + 4 * he.numel()
              + 4 * n_tiles * n_bins + 4 * n_tiles)
    rows.append(compare(
        "zone_histogram",
        lambda: agg_scan.zone_histogram(hw, hm, he, width, n_bins, tw),
        lambda: agg_scan.zone_histogram_plain(hw, hm, he, width, n_bins, tw),
        nbytes, bw, launches["zone_histogram"],
        f"words={hw.shape[0]} tiles={n_tiles} evaluated={evaluated} "
        f"bins={n_bins} width={width}"))
    hist = functools.partial(agg_scan.zone_histogram, width=width,
                             n_bins=n_bins, tile_words=tw)
    bins, vec = agg_scan.hist_route(hw, n_bins, tw)
    rows[-1].update({
        "bins": bins, "vector_loads": vec,
        "ptxas": [r for r in ptxas_resources(log, SYMBOLS["zone_histogram"])
                  if re.search(f"<{width}[,>]", r["function"])],
        "sass": {f"bins={b}": hist_sass(sass, width, b)
                 for b in agg_scan.HIST_BINS},
        "graph_ms": hot_graph_ms(hist, hw, hm, he),
        "cold_graph_ms": cold_graph_ms(hist, nbytes, hw, hm, he)})
    # both buckets of the 16-byte loads on the same tiles, cold, at
    # agg.fast's edges and at 64 bins (each of its bins cut in 4), each
    # equal to the plain version
    e16 = bitpack.from_u32_bits(he)
    steps = torch.arange(4, device=he.device)
    e64 = torch.cat([(e16[:, :-1, None] + (e16[:, 1:, None] - e16[:, :-1, None])
                      * steps // 4).reshape(e16.shape[0], -1),
                     e16[:, -1:]], dim=1)
    rows[-1]["buckets_cold_graph_ms"] = {}
    for nb, edges in ((n_bins, he), (64, bitpack.to_u32_bits(e64))):
        want = agg_scan.zone_histogram_plain(hw, hm, edges, width, nb, tw)
        for b in agg_scan.HIST_BINS:
            if nb > b:
                continue
            launch = functools.partial(
                agg_scan._launch_hist, width=width, n_bins=nb, tile_words=tw,
                bins=b, vec=True)
            got = launch(hw, hm, edges)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"zone_histogram ({b} bins) differs from plain at {nb} "
                  f"bins")
            rows[-1]["buckets_cold_graph_ms"][f"n_bins={nb} bins={b}"] = \
                cold_graph_ms(launch, nbytes, hw, hm, edges)

    # the staged backends at serve's shapes: the largest SCT of the tree
    (mw, mr, width, tw), _ = recs["multi"].calls[0]
    k, n_tiles = mr.shape[0], mw.shape[0] // tw
    rows.append(compare(
        "multi_range_filter_packed",
        lambda: multi_filter.multi_range_filter(mw, mr, width, tw),
        lambda: multi_filter.multi_range_filter_plain(mw, mr, width, tw),
        4 * mw.shape[0] + 4 * k * mw.shape[0] + 4 * k * n_tiles + 8 * k, bw,
        launches["multi_range_filter_packed"],
        f"words={mw.shape[0]} tiles={n_tiles} K={k} width={width}"))
    multi = functools.partial(multi_filter.multi_range_filter, width=width,
                              tile_words=tw)
    rows[-1].update({
        "graph_ms": hot_graph_ms(multi, mw, mr),
        "cold_graph_ms": cold_graph_ms(multi, rows[-1]["bytes"], mw, mr)})
    # range_filter_codes at serve.jax's largest call: the column as it is
    (cc, lo, hi, tc), _ = recs["codes"].calls[0]
    n_tiles = -(-cc.shape[0] // tc)
    nbytes = 5 * cc.shape[0] + 4 * n_tiles
    rows.append(compare(
        "range_filter_codes",
        lambda: opd_filter.code_range_filter(cc, lo, hi, tc),
        lambda: opd_filter.code_range_filter_plain(cc, lo, hi, tc),
        nbytes, bw, launches["range_filter_codes"],
        f"codes={cc.shape[0]} tiles={n_tiles} lo={lo} hi={hi}"))
    rows[-1].update(single_filter_extras(
        functools.partial(opd_filter.code_range_filter, lo=lo, hi=hi,
                          tile_codes=tc),
        functools.partial(opd_filter._launch, lo=lo, hi=hi, tile_codes=tc),
        cc, tc, -1, nbytes,
        ptxas_resources(log, SYMBOLS["range_filter_codes"]),
        ("codes.to(torch.int8)", lambda c: c.to(torch.int8)),
        lambda c: ops.range_filter_codes(c, lo, hi, tc),
        lambda c: opd_filter.code_range_filter(
            ops._pad_to_tiles(c, tc, -1), lo, hi, tc)[0][:c.shape[0]]
        .view(torch.bool)))

    # the plain remap at compact.jax's largest merge output; each live entry
    # gathers one table slot, a 32-byte L2 sector.  In CUDA graphs: the same
    # operands every call (in L2), a fresh copy every call (device memory),
    # and a fresh copy with every entry dead: the same ev/src streams and
    # stores with no gather, which splits the streams from the gathers
    (evs, srcs, table, offsets), _ = recs["remap_codes"].calls[0]
    n = evs.shape[0]
    dead = int((evs < 0).sum())
    nbytes = 12 * n + 4 * table.shape[0] + 4 * offsets.shape[0]
    rows.append(compare(
        "remap_codes",
        lambda: merge_remap.remap_codes(evs, srcs, table, offsets),
        lambda: merge_remap.remap_codes_plain(evs, srcs, table, offsets),
        nbytes, bw, launches["remap_codes"],
        f"n={n} dead={dead} table={table.shape[0]} "
        f"sources={offsets.shape[0]}"))
    gathers = n - dead
    remap = merge_remap.remap_codes
    rows[-1].update({
        "ptxas": ptxas_resources(log, SYMBOLS["remap_codes"]),
        "gathers": gathers, "gather_sector_bytes": 32 * gathers,
        "graph_ms": hot_graph_ms(remap, evs, srcs, table, offsets),
        "cold_graph_ms": cold_graph_ms(remap, nbytes, evs, srcs, table,
                                       offsets),
        "streams_only_cold_graph_ms": cold_graph_ms(
            remap, nbytes, torch.full_like(evs, -1), srcs, table, offsets)})

    # the Figure-5 kernel at fig5's largest SCT of the main tree, then at
    # the micro-bench's 2^20 codes
    (pw, lo, hi, width, tw), _ = recs["packed"].calls[0]
    cases = [(pw, lo, hi, width, tw, "fig5: the main tree's largest SCT")]
    cases += [(w, 1, 200, wd, packed_filter.DEFAULT_TILE_WORDS, "micro-bench")
              for wd, w in bench["words"].items()]
    for i, (pw, lo, hi, width, tw, where) in enumerate(cases):
        n_tiles = -(-pw.shape[0] // tw)
        nbytes = 8 * pw.shape[0] + 4 * n_tiles
        # per field: shift, mask, subtract, compare, shift-or; per word: a
        # popcount and the count's add
        n_ops = pw.shape[0] * (5 * (32 // width) + 2)
        rows.append(compare(
            "range_filter_packed",
            lambda: packed_filter.packed_range_filter(pw, lo, hi, width, tw),
            lambda: packed_filter.packed_range_filter_plain(pw, lo, hi, width,
                                                            tw),
            nbytes, bw, launches["range_filter_packed"],
            f"words={pw.shape[0]} tiles={n_tiles} width={width} lo={lo} "
            f"hi={hi} ({where})",
            op_bound_ms=n_ops / rates["int32_ops"] * 1e3))
        rows[-1].update({"main_path": i == 0, "int_ops": n_ops})
        rows[-1].update(single_filter_extras(
            functools.partial(packed_filter.packed_range_filter, lo=lo, hi=hi,
                              width=width, tile_words=tw),
            functools.partial(packed_filter._launch, lo=lo, hi=hi,
                              width=width, tile_words=tw),
            pw, tw, -1, nbytes,
            [r for r in ptxas_resources(log, SYMBOLS["range_filter_packed"])
             if f"<{width}," in r["function"]],
            ("words.clone()", torch.clone),
            lambda w: ops.range_filter_packed(w, width, lo, hi, tw),
            lambda w: packed_filter.packed_range_filter(
                ops._pad_to_tiles(w, tw, -1), lo, hi, width,
                tw)[0][:w.shape[0]]))

    # the bloom probe at the micro-bench's bloom, then the largest one; in
    # CUDA graphs hot and cold, with the registers and the SASS
    # instructions per key of its instantiations
    for key, where in (("bloom", "micro-bench"),
                       ("big", "the largest documented bloom")):
        words, nbits, keys = bench[key]
        # per hash: mix32 (9), the modulo, word and bit index, the bit test
        # and the AND into the hit (6)
        n_ops = keys.shape[0] * 6 * 15
        nbytes = 5 * keys.shape[0] + 4 * words.shape[0]
        rows.append(compare(
            "bloom_probe",
            lambda: bloom_probe.bloom_probe(words, nbits, keys),
            lambda: bloom_probe.bloom_probe_plain(words, nbits, keys),
            nbytes, bw, launches["bloom_probe"],
            f"bloom={words.shape[0]} words ({nbits} bits) keys={keys.shape[0]} "
            f"hashes=6 ({where})",
            op_bound_ms=n_ops / rates["int32_ops"] * 1e3))

        def probe(w, k, nbits=nbits):
            return bloom_probe.bloom_probe(w, nbits, k)

        # the same keys and words at an nbits that is not a power of two
        # (the largest prime below it): the magic-number remainder
        odd = next(p for p in range(nbits - 1, 1, -1)
                   if all(p % d for d in range(2, int(p ** 0.5) + 1)))
        check(torch.equal(bloom_probe.bloom_probe(words, odd, keys),
                          bloom_probe.bloom_probe_plain(words, odd, keys)),
              f"bloom_probe at nbits {odd} differs from plain")
        rows[-1].update({
            "main_path": key == "bloom", "int_ops": n_ops,
            "ptxas": ptxas_resources(log, SYMBOLS["bloom_probe"]),
            "sass": bloom_sass(sass),
            "graph_ms": hot_graph_ms(probe, words, keys),
            "cold_graph_ms": cold_graph_ms(probe, nbytes, words, keys),
            "odd_nbits": odd,
            "odd_nbits_cold_graph_ms": cold_graph_ms(
                functools.partial(probe, nbits=odd), nbytes, words, keys)})

    # the selective scan at falcon-mamba-7b's width: bytes of u, delta and
    # y (plus B, C, A and the state) against one exp per (b, t, d, n) at
    # the card's exp rate and 6 float32 operations per (b, t, d, n)
    u, dt, A, Bm, Cm = bench["ssm"]
    B, L, D, N = SSM_SHAPE
    elems = B * L * D * N
    exp_ms = elems / rates["exp_per_s"] * 1e3
    flop_ms = 6 * elems / rates["fp32_flops"] * 1e3
    rows.append(compare(
        "ssm_scan", lambda: ssm_scan.ssm_scan(u, dt, A, Bm, Cm),
        lambda: ssm_scan.ssm_scan_plain(u, dt, A, Bm, Cm),
        4 * (3 * B * L * D + 2 * B * L * N + D * N + B * D * N), bw,
        launches["ssm_scan"],
        f"B={B} L={L} D={D} N={N} (falcon-mamba-7b's d_inner and d_state)",
        tol=SSM_TOL, op_bound_ms=max(exp_ms, flop_ms), plain_reps=5))
    scan = ssm_scan.ssm_scan
    nbytes = rows[-1]["bytes"]
    rows[-1].update({"exps": elems, "exp_ms": exp_ms, "flops": 6 * elems,
                     "flop_ms": flop_ms,
                     "state_lanes": ssm_scan.scan_layout(N),
                     "states_per_lane": ssm_scan.STATES_PER_LANE,
                     "steps_per_round": ssm_scan.STEPS_PER_ROUND,
                     "ptxas": ptxas_resources(log, SYMBOLS["ssm_scan"]),
                     "graph_ms": hot_graph_ms(scan, u, dt, A, Bm, Cm),
                     "cold_graph_ms": cold_graph_ms(
                         scan, nbytes, u, dt, A, Bm, Cm)})
    # the same u and delta with other state dimensions, cold: the streams
    # and y stay while a channel's lanes grow with N
    gen = torch.Generator(device=u.device).manual_seed(1)
    sweep = {}
    for n in (1, 8, 32):
        a_n = -torch.rand((D, n), generator=gen, device=u.device)
        b_n, c_n = (torch.randn((B, L, n), generator=gen, device=u.device)
                    for _ in range(2))
        sweep[n] = cold_graph_ms(scan, nbytes, u, dt, a_n, b_n, c_n)
    rows[-1]["state_dim_cold_graph_ms"] = sweep
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1 << 23)
    ap.add_argument("--clustered-pairs", type=int, default=1 << 20)
    ap.add_argument("--fast-pairs", type=int, default=1 << 22,
                    help="pairs of the agg.fast tree (sequential keys)")
    ap.add_argument("--codec-pairs", type=int, default=1 << 20,
                    help="pairs of the codecs phase's five trees")
    ap.add_argument("--durable-pairs", type=int, default=1 << 20,
                    help="pairs of the durable phase's stream")
    ap.add_argument("--background-pairs", type=int, default=1 << 20,
                    help="pairs of the background phase's stream")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    from repro_torch.launch import card as card_rates
    bw = card_rates.rate(card_rates.BANDWIDTH, device_name)
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"sm_count": sms,
             "exp_per_s": card_rates.EXP_PER_CLOCK_PER_SM * sms * max_mhz * 1e6,
             "int32_ops": card_rates.INT32_PER_CLOCK_PER_SM * sms * max_mhz
             * 1e6,
             "fp32_flops": card_rates.rate(card_rates.FP32_RATE, device_name),
             "bf16_flops": card_rates.rate(card_rates.BF16_RATE, device_name)}

    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    log = Path(str(lib) + ".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "bandwidth_Bps": bw, "sm_count": sms, "max_sm_clock_mhz": max_mhz,
          **rates, "ptxas": ptxas})

    recs = {
        # keyed by pack width, with the launches per width
        "pack": Recorder(ops.pack_codes, lambda c, w: c.shape[0],
                         lambda c, w: w),
        # keyed by pack width, with the launches per width
        "unpack": Recorder(ops.unpack_codes, lambda w, wd, n: n,
                           lambda w, wd, n: wd),
        "fused": Recorder(ops.fused_zone_filter,
                          lambda w, *a: w.shape[0], lambda w, m, r, wd, *a: wd),
        "remap": Recorder(ops.remap_pack_codes, lambda e, *a: e.shape[0],
                          lambda e, s, t, o, w: w),
        # recorded during agg.fast only
        "agg": Recorder(ops.fused_zone_agg, lambda w, *a: w.shape[0],
                        active=False),
        "hist": Recorder(ops.zone_histogram,
                         lambda w, m, e, wd, nb, *a: w.shape[0] * nb,
                         active=False),
        # recorded during the serve phases only
        "multi": Recorder(ops.multi_range_filter,
                          lambda w, r, *a: w.shape[0] * r.shape[0],
                          active=False),
        "codes": Recorder(ops.code_range_filter, lambda c, *a: c.shape[0],
                          active=False),
        # recorded during compact.jax only
        "remap_codes": Recorder(ops.remap_codes, lambda e, *a: e.shape[0],
                                active=False),
        # recorded during fig5 only
        "packed": Recorder(ops.packed_range_filter, lambda w, *a: w.shape[0],
                           active=False),
    }
    # compact.jax's packs (merge outputs among them), keyed by width
    recs["pack_compact"] = Recorder(recs["pack"], lambda c, w: c.shape[0],
                                    lambda c, w: w, active=False)
    ops.pack_codes, ops.unpack_codes = recs["pack_compact"], recs["unpack"]
    ops.fused_zone_filter, ops.remap_pack_codes = recs["fused"], recs["remap"]
    ops.fused_zone_agg, ops.zone_histogram = recs["agg"], recs["hist"]
    ops.multi_range_filter, ops.code_range_filter = recs["multi"], recs["codes"]
    ops.remap_codes, ops.packed_range_filter = (recs["remap_codes"],
                                                recs["packed"])
    launches, state = main_phase(args, "cuda")
    # the pack, unpack and remap rows replay the main path's own calls
    for key in ("pack", "unpack", "remap"):
        recs[key].active = False
    for key, kernel in (("unpack", "unpack_codes"), ("pack", "pack_codes"),
                        ("remap", "remap_pack_codes")):
        by_width = dict(sorted(recs[key].launches.items()))
        emit({"phase": f"main.{key}_by_width", kernel: by_width})
        check(sum(by_width.values()) == launches[kernel], f"{kernel} launches "
              f"by width {by_width} do not sum to {launches[kernel]}")
    launches.update(serve_phase(state, {k: recs[k]
                                        for k in ("multi", "codes")}))
    fast_launches = agg_phase(args, state,
                              {k: recs[k] for k in ("agg", "hist")}, "cuda")
    launches.update({k: fast_launches[k] for k in AGG_KERNELS})
    # the main path's operands stay those of the main tree's own ingest
    recs["fused"].active = False
    recs["remap_codes"].active = recs["pack_compact"].active = True
    launches["remap_codes"] = compact_phase(state, "jax",
                                            "cuda")["remap_codes"]
    recs["remap_codes"].active = recs["pack_compact"].active = False
    compact_phase(state, "numpy", "cuda")
    range_phase(args, state)
    launches["range_filter_packed"] = fig5_phase(state, recs)
    fig5_example("cuda")
    sync_ingest = codecs_phase(args, "cuda")
    durable_phase(args, "cuda")
    background_phase(args, recs, sync_ingest, "cuda")
    policy_phase(args, recs, sync_ingest, "cuda")
    sharded_phase(args, recs, card, "cuda")
    replica_phase(args, recs, card, "cuda")
    del state       # the main trees: the lm phase needs the card's memory
    prompts = lm_phase(args, recs, card, "cuda", bw, build_s)
    families = families_phase(args, prompts, card, "cuda", bw, rates, build_s)
    encdec_phase(args, prompts, card, "cuda", bw, rates, build_s)
    train = train_phase(args, card, "cuda", bw, rates, build_s)
    mesh_launches = train_mesh_phase(args, card, "cuda", build_s)
    train_mesh_moe_phase(args, card, "cuda", build_s)
    lm_mesh = lm_mesh_phase(args, card, "cuda", build_s)
    bench_launches, bench = bench_phase(args)
    launches["bloom_probe"] = bench_launches["bloom_probe"]
    # the scan's main path is now the SSM models' forwards (lm.families)
    launches["ssm_scan"] = families["ssm_scan_launches"]
    rows = kernel_phase(recs, launches, bw, bench, rates, log,
                        sass_functions(lib))
    for r in rows:
        if r["name"] == "ssm_scan":
            r.update(bench_launches=bench_launches["ssm_scan"],
                     path=families["path"],
                     train_launches=train["launches"]["ssm_scan"],
                     mesh_launches=mesh_launches["ssm_scan"],
                     lm_mesh_launches=lm_mesh["ssm_scan"])
    train["row"]["mesh_launches"] = mesh_launches["ssm_scan_bwd"]
    rows.append(train["row"])
    for r in rows:
        emit({"phase": "kernel", **r})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    print(card, flush=True)
    keep = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    # one row per kernel, and for the unpack one per pack width of the main
    # path: for the filter the largest level of the main path, for the
    # aggregate kernel its SUM launch of agg.fast, for the packed range
    # filter fig5's largest SCT, for the bloom probe the micro-bench's
    table = [{**{k: r[k] for k in keep},
              **{k: r[k] for k in ("path", "mesh_launches") if k in r}}
             for r in rows if r.get("main_path", True)]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
